"""Parsing of composition-constraint equation strings.

Counterpart of ``smol_tpu/moca/composition/constraints.py``, whose code it copies. In
this module "the reference" is smol (CederGroupHub/smol).

Mirrors the reference constraint grammar (smol/moca/composition/
constraints.py): strings like ``"2 Ag+(0) + Cl-(1) <= 3 Mn2+ + 4"`` are
parsed into (coefficient vector over the "counts" dimensions, intercept,
relation).  A species without a sublattice index applies to every sublattice
containing it; trailing bare numbers are intercepts.
"""

from __future__ import annotations

import re

import numpy as np

from smol_tpu_torch.cofe.space.domain import Vacancy, get_species
from smol_tpu_torch.moca.occu_utils import get_dim_ids_by_sublattice

__all__ = [
    "parse_constraint_string",
    "handle_side_string",
    "convert_constraint_string",
    "CompositionConstraintsManager",
]

_RELATIONS = ("==", "<=", ">=", "=")

_NUM_RE = re.compile(r"^[+-]?\d+\.?\d*$")
_SUBL_RE = re.compile(r"^([A-Za-z]+.*)\((\d+)\)$")


def handle_side_string(side: str):
    """Tokenize one side of a constraint equation.

    Returns ``(packed, intercept)`` where packed is a list of
    ``(coefficient, Species, sublattice_index_or_None)`` tuples — the
    reference's public tokenizer interface
    (smol/moca/composition/constraints.py:55-124).  Only a trailing bare
    number (or sign) is an intercept.
    """
    literals = []
    for tok in side.split():
        if tok in ("+", "-"):
            literals.append(tok)
        elif _NUM_RE.match(tok):
            num = float(tok)
            literals.append(round(num) if np.isclose(num, round(num)) else num)
        else:
            match = _SUBL_RE.match(tok)
            if match is not None:
                literals.append((get_species(match.group(1)), int(match.group(2))))
            else:
                literals.append((get_species(tok), None))

    def signs_before(idx):
        """Combined sign of the consecutive +/- literals before idx
        (reference constraints.py:13-30: signs multiply)."""
        sign, n_signs = 1, 0
        j = idx - 1
        while j >= 0 and literals[j] in ("+", "-"):
            if literals[j] == "-":
                sign = -sign
            n_signs += 1
            j -= 1
        return sign, n_signs

    def number_before(idx):
        """The single numeric coefficient before idx; more than one
        consecutive number is malformed (reference constraints.py:33-52)."""
        n_nums = 0
        j = idx - 1
        while j >= 0 and isinstance(literals[j], (int, float)):
            n_nums += 1
            j -= 1
        if n_nums == 0:
            return 1, 0
        if n_nums == 1:
            return literals[idx - 1], 1
        raise ValueError(
            f"Species {literals[idx]} preceded by {n_nums} > 1 number "
            "literals, not allowed!"
        )

    intercept = 0
    if literals:
        last = literals[-1]
        if isinstance(last, (int, float)):
            sign, n_signs = signs_before(len(literals) - 1)
            intercept = sign * last
            literals = literals[: -(1 + n_signs)]
        elif last == "+":
            intercept, literals = 1, literals[:-1]
        elif last == "-":
            intercept, literals = -1, literals[:-1]

    packed = []
    for i, lit in enumerate(literals):
        if isinstance(lit, tuple):
            coef, n_nums = number_before(i)
            sign, _ = signs_before(i - n_nums)
            packed.append((sign * coef, *lit))
    return packed, intercept


def convert_constraint_string(entry, bits):
    """Convert a constraint string to (vector, number, relation) counts form.

    ``bits`` is the per-sublattice allowed-species lists (same ordering as
    moca.composition).  Returns the left-side coefficient vector over counts
    dimensions, the simplified right-side number, and the relation symbol —
    the reference's public conversion interface
    (smol/moca/composition/constraints.py:126-231).
    """
    entry = entry.strip()
    sep = re.match(r"^(.*) ([<=>]?=) (.*)$", entry)
    if sep is None:
        raise ValueError(
            f"Constraint {entry!r} must contain <=, >=, == or = wrapped by "
            "single spaces."
        )
    left_string, relation, right_string = sep.groups()
    bits = [list(sl.keys()) if hasattr(sl, "keys") else list(sl) for sl in bits]

    left_pack, left_intercept = handle_side_string(left_string)
    right_pack, right_intercept = handle_side_string(right_string)

    n_dims = sum(len(species) for species in bits)
    dim_ids = get_dim_ids_by_sublattice(bits)
    left_vec = [0] * n_dims

    def _accumulate(pack, factor):
        for coef, spec, sl_id in pack:
            if sl_id is not None:
                if spec not in bits[sl_id]:
                    raise ValueError(
                        f"Species {spec} cannot be found in the specified "
                        f"sub-lattice {sl_id}; its species are {bits[sl_id]}."
                    )
                left_vec[dim_ids[sl_id][bits[sl_id].index(spec)]] += factor * coef
            else:
                hits = 0
                for species, sub_dim_ids in zip(bits, dim_ids):
                    if spec in species:
                        left_vec[sub_dim_ids[species.index(spec)]] += factor * coef
                        hits += 1
                if hits == 0:
                    raise ValueError(
                        f"Species {spec} cannot be found in any sub-lattice."
                    )

    _accumulate(left_pack, 1)
    _accumulate(right_pack, -1)
    return left_vec, right_intercept - left_intercept, relation


def _species_dims(species_str, site_spaces, dim_ids):
    """Dims of a species token, optionally restricted to one sublattice."""
    match = re.match(r"^(.*?)(?:\((\d+)\))?$", species_str.strip())
    sp_str, sublatt = match.group(1), match.group(2)
    sp = get_species(sp_str)
    dims = []
    for sl_id, (sl_species, sl_dims) in enumerate(zip(site_spaces, dim_ids)):
        if sublatt is not None and sl_id != int(sublatt):
            continue
        for s, d in zip(sl_species, sl_dims):
            if (isinstance(sp, Vacancy) and isinstance(s, Vacancy)) or s == sp:
                dims.append(d)
    if not dims:
        raise ValueError(
            f"Species {species_str} not found on any (specified) sublattice."
        )
    return dims


def _parse_side(side_str, site_spaces, dim_ids, num_dims):
    """Parse one side of an equation into (vector a, intercept)."""
    a = np.zeros(num_dims)
    intercept = 0.0
    # operators are space-delimited tokens; species strings may contain +/-
    # operators are standalone space-delimited "+"/"-" words; species strings
    # may themselves contain +/- (e.g. "Li+", "O2-")
    terms, current = [], ["+"]
    for word in side_str.split():
        if word in ("+", "-"):
            if len(current) > 1:
                terms.append(current)
            current = [word]
        else:
            current.append(word)
    if len(current) > 1:
        terms.append(current)
    for term in terms:
        sign, parts = term[0], term[1:]
        factor = 1.0 if sign == "+" else -1.0
        if len(parts) == 1:
            try:
                intercept += factor * float(parts[0])
                continue
            except ValueError:
                coef, species_str = 1.0, parts[0]
        elif len(parts) == 2:
            coef, species_str = float(parts[0]), parts[1]
        else:
            raise ValueError(f"Cannot parse constraint term {' '.join(parts)!r}.")
        for d in _species_dims(species_str, site_spaces, dim_ids):
            a[d] += factor * coef
    return a, intercept


def parse_constraint_string(constraint_str, site_spaces):
    """Parse a constraint string into (a, b, relation).

    Relation is "eq" or "leq" with the constraint in the form a @ n <= b or
    a @ n == b (">=" inputs are negated into "<=").
    """
    dim_ids = get_dim_ids_by_sublattice(site_spaces)
    num_dims = sum(len(s) for s in site_spaces)
    relation = None
    for rel in _RELATIONS:
        if f" {rel} " in constraint_str:
            relation = rel
            left_str, right_str = constraint_str.split(f" {rel} ")
            break
    if relation is None:
        raise ValueError(
            f"Constraint {constraint_str!r} contains no relation symbol "
            f"among {_RELATIONS} (spaces around the symbol are required)."
        )
    a_left, b_left = _parse_side(left_str, site_spaces, dim_ids, num_dims)
    a_right, b_right = _parse_side(right_str, site_spaces, dim_ids, num_dims)
    a = a_left - a_right
    b = b_right - b_left
    if relation in ("==", "="):
        return a, b, "eq"
    if relation == "<=":
        return a, b, "leq"
    return -a, -b, "leq"  # >= becomes <=


class CompositionConstraintsManager:
    """Descriptor normalizing user constraints into {"eq": [...], "leq": [...]}.

    Accepts strings (parsed with the grammar above) or tuples
    ``(a_vector, b, relation)`` / ``(a_vector, b)`` (relation defaults to eq).
    """

    def __set_name__(self, owner, name):
        self.private_name = "_" + name

    def __get__(self, obj, objtype=None):
        return getattr(obj, self.private_name, None)

    def __set__(self, obj, value):
        if value is None:
            setattr(obj, self.private_name, None)
            return
        eqs, leqs = [], []
        for entry in value:
            if isinstance(entry, str):
                a, b, rel = parse_constraint_string(entry, obj.site_spaces)
            elif len(entry) == 3:
                a, b, rel = entry
                a = np.asarray(a, dtype=np.float64)
                if rel == "geq":
                    a, b, rel = -a, -b, "leq"
            else:
                a, b = entry
                a = np.asarray(a, dtype=np.float64)
                rel = "eq"
            (eqs if rel == "eq" else leqs).append((np.asarray(a), float(b)))
        setattr(obj, self.private_name, {"eq": eqs, "leq": leqs})
