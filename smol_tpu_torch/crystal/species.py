"""Species, Element, DummySpecies and Vacancy types plus Composition.

Counterpart of ``smol_tpu/crystal/species.py``, whose code it copies. In
this module "the reference" is smol (CederGroupHub/smol).

Self-contained replacements for the pymatgen species/composition types used
throughout the reference (smol/cofe/space/domain.py).  Only the behavior that
smol relies on is implemented:

- species identity = (symbol, oxidation state),
- total ordering by (electronegativity, symbol, oxidation state) which fixes
  integer site-space encodings (domain.py:158),
- string parsing of species like ``"Li+"``, ``"Mn4+"``, ``"O2-"``,
- :class:`Vacancy` as its own species type that is only equal to other
  vacancies (domain.py:238-291),
- :class:`Composition`: mapping species -> fractional amount.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

from smol_tpu_torch.crystal.data import ELEMENT_DATA, UNDEFINED_X
from smol_tpu_torch.serial import MSONable

__all__ = [
    "Species",
    "Element",
    "DummySpecies",
    "Vacancy",
    "Composition",
    "get_species",
]

_SPECIES_RE = re.compile(r"^([A-Z][a-z]*)(\d*)([+-]?)$")


class Species(MSONable):
    """A chemical species: an element symbol plus an oxidation state."""

    def __init__(self, symbol: str, oxidation_state: float | None = 0):
        if symbol not in ELEMENT_DATA:
            raise ValueError(f"Unknown element symbol: {symbol!r}")
        self._symbol = symbol
        self._oxi_state = oxidation_state

    @property
    def symbol(self) -> str:
        """Element symbol."""
        return self._symbol

    @property
    def oxi_state(self):
        """Oxidation state (may be None for plain elements)."""
        return self._oxi_state

    @property
    def oxidation_state(self):
        """Alias for oxi_state."""
        return self._oxi_state

    @property
    def Z(self) -> int:
        """Atomic number."""
        return ELEMENT_DATA[self._symbol][0]

    @property
    def X(self) -> float:
        """Pauling electronegativity (UNDEFINED_X when tabulated as None)."""
        x = ELEMENT_DATA[self._symbol][1]
        return UNDEFINED_X if x is None else x

    # -- ordering fixes site-space encodings; keep it total and stable --
    def _sort_key(self):
        oxi = self._oxi_state if self._oxi_state is not None else 0.0
        return (self.X, self._symbol, oxi)

    def __lt__(self, other):
        return self._sort_key() < other._sort_key()

    def __eq__(self, other):
        if isinstance(other, Vacancy) or not isinstance(other, Species):
            return False
        return (
            self._symbol == other._symbol
            and _oxi_eq(self._oxi_state, other._oxi_state)
        )

    def __hash__(self):
        return hash((self._symbol, self._oxi_state))

    def __str__(self):
        if self._oxi_state is None or self._oxi_state == 0:
            return self._symbol
        sign = "+" if self._oxi_state > 0 else "-"
        mag = abs(self._oxi_state)
        mag_s = str(int(mag)) if mag != 1 else ""
        return f"{self._symbol}{mag_s}{sign}"

    def __repr__(self):
        return f"Species {self}"

    def as_dict(self) -> dict:
        return {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
            "symbol": self._symbol,
            "oxidation_state": self._oxi_state,
        }

    @classmethod
    def from_dict(cls, d):
        return cls(d["symbol"], d.get("oxidation_state", 0))

    @classmethod
    def from_str(cls, s: str) -> Species:
        m = _SPECIES_RE.match(s.strip())
        if m is None:
            raise ValueError(f"Cannot parse species string {s!r}")
        symbol, mag, sign = m.groups()
        if sign == "":
            return Element(symbol)
        oxi = float(mag) if mag else 1.0
        if sign == "-":
            oxi = -oxi
        return cls(symbol, oxi)


def _oxi_eq(a, b):
    if a is None and b is None:
        return True
    if a is None or b is None:
        # Element("Li") == Species("Li", 0): reference treats a bare element
        # as oxidation state None; these are distinct species in pymatgen.
        return False
    return a == b


class Element(Species):
    """A plain element (no oxidation state)."""

    def __init__(self, symbol: str):
        super().__init__(symbol, None)

    def __str__(self):
        return self._symbol

    def __repr__(self):
        return f"Element {self._symbol}"

    def as_dict(self) -> dict:
        return {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
            "symbol": self._symbol,
        }

    @classmethod
    def from_dict(cls, d):
        return cls(d["symbol"])


class DummySpecies(Species):
    """A placeholder species with an arbitrary symbol, e.g. for vacancies."""

    def __init__(self, symbol: str = "X", oxidation_state: float = 0, spin=None):
        # deliberately bypass Species.__init__ element validation
        self._symbol = symbol
        self._oxi_state = oxidation_state
        self.spin = spin

    @property
    def Z(self):
        return 0

    @property
    def X(self):
        return UNDEFINED_X

    def __eq__(self, other):
        if not isinstance(other, DummySpecies) or isinstance(other, Vacancy):
            return False
        return self._symbol == other._symbol and _oxi_eq(
            self._oxi_state, other._oxi_state
        )

    def __hash__(self):
        return hash(("dummy", self._symbol, self._oxi_state))

    def as_dict(self) -> dict:
        return {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
            "symbol": self._symbol,
            "oxidation_state": self._oxi_state,
        }

    @classmethod
    def from_dict(cls, d):
        return cls(d["symbol"], d.get("oxidation_state", 0))


class Vacancy(DummySpecies):
    """A vacancy treated as its own species.

    Mirrors the reference Vacancy (smol/cofe/space/domain.py:238): only equal
    to other Vacancy instances, always sorts after real species.
    """

    def __init__(self, symbol: str = "A", oxidation_state: float = 0, spin=None):
        super().__init__(symbol, oxidation_state, spin)

    @property
    def X(self):
        return float("inf")  # vacancies always encode last in a site space

    def __eq__(self, other):
        if not isinstance(other, Vacancy):
            return False
        return self._symbol == other._symbol and _oxi_eq(
            self._oxi_state, other._oxi_state
        )

    def __hash__(self):
        return hash("v" + self._symbol)

    def __str__(self):
        return "vac" + super().__str__()

    def __repr__(self):
        return f"Vacancy {self}"


def get_species(obj):
    """Coerce str/Species/iterable into Species objects.

    Mirrors smol/cofe/space/domain.py:85 — strings containing "vac" map to
    Vacancy.
    """
    if isinstance(obj, Vacancy):
        return obj
    if isinstance(obj, Species):
        return obj
    if isinstance(obj, (list, tuple)):
        return [get_species(o) for o in obj]
    if isinstance(obj, str):
        if "vac" in obj.lower():
            return Vacancy()
        return Species.from_str(obj)
    raise ValueError(f"Cannot convert {obj!r} to a species.")


class Composition(Mapping, MSONable):
    """Mapping of species -> fractional amount on one site (or formula unit)."""

    def __init__(self, comp=None, **kwargs):
        data = {}
        if comp is None:
            comp = {}
        if isinstance(comp, Composition):
            data.update(comp._data)
        elif isinstance(comp, Mapping):
            for k, v in comp.items():
                data[get_species(k) if not isinstance(k, Species) else k] = float(v)
        elif isinstance(comp, str):
            raise ValueError("Formula-string parsing not supported; use a dict.")
        for k, v in kwargs.items():
            data[get_species(k)] = float(v)
        self._data = data

    @property
    def num_atoms(self) -> float:
        """Total occupancy summed over species."""
        return float(sum(self._data.values()))

    @property
    def elements(self):
        """List of species in the composition."""
        return list(self._data)

    def charge(self) -> float:
        """Total charge weighted by occupancy."""
        return float(
            sum(
                (sp.oxi_state or 0.0) * amt
                for sp, amt in self._data.items()
            )
        )

    @property
    def formula(self) -> str:
        """Element formula with amounts, e.g. 'Li1 Mn2 O4' (pymatgen parity).

        Species charges are dropped and amounts of the same element merged.
        """
        by_element: dict = {}
        for sp, amt in self._data.items():
            symbol = getattr(sp, "symbol", str(sp))
            by_element[symbol] = by_element.get(symbol, 0.0) + amt
        return " ".join(
            f"{symbol}{amt:g}" for symbol, amt in sorted(by_element.items())
        )

    @property
    def reduced_formula(self) -> str:
        """Formula with amounts scaled to smallest integers (when rational)."""
        from fractions import Fraction
        from math import gcd, lcm

        by_element: dict = {}
        for sp, amt in self._data.items():
            symbol = getattr(sp, "symbol", str(sp))
            by_element[symbol] = by_element.get(symbol, 0.0) + amt
        # same ordering/zero handling as .formula: sorted symbols, zero
        # amounts dropped
        by_element = {
            symbol: amt
            for symbol, amt in sorted(by_element.items())
            if amt != 0.0
        }
        fracs = [
            Fraction(amt).limit_denominator(1000) for amt in by_element.values()
        ]
        mul = lcm(*(f.denominator for f in fracs)) if fracs else 1
        ints = [int(f * mul) for f in fracs]
        g = gcd(*ints) if any(ints) else 1
        return " ".join(
            f"{symbol}{n // g}" for symbol, n in zip(by_element, ints)
        )

    def get_atomic_fraction(self, sp) -> float:
        """Fraction of the total occupancy held by a species."""
        if not isinstance(sp, Species):
            sp = get_species(sp)
        total = self.num_atoms
        return float(self._data.get(sp, 0.0)) / total if total else 0.0

    def __getitem__(self, item):
        if not isinstance(item, Species):
            item = get_species(item)
        return self._data[item]

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def __eq__(self, other):
        if not isinstance(other, Composition):
            return False
        if set(self._data) != set(other._data):
            return False
        return all(abs(v - other._data[k]) < 1e-8 for k, v in self._data.items())

    def __hash__(self):
        return hash(frozenset(self._data))

    def __str__(self):
        return " ".join(f"{sp}{amt:g}" for sp, amt in sorted(self._data.items()))

    def __repr__(self):
        return f"Composition({self})"

    def as_dict(self) -> dict:
        return {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
            "species": [
                {"species": sp.as_dict(), "amount": amt}
                for sp, amt in self._data.items()
            ],
        }

    @classmethod
    def from_dict(cls, d):
        from smol_tpu_torch.serial import process_decoded

        return cls(
            {
                process_decoded(item["species"]): item["amount"]
                for item in d["species"]
            }
        )
