"""Constrained integer composition spaces.

Counterpart of ``smol_tpu/moca/composition/space.py``, whose code it copies. In
this module "the reference" is smol (CederGroupHub/smol).

Mirrors the reference CompositionSpace (smol/moca/composition/space.py):
builds the constraint system A n = b from charge neutrality + sublattice
site conservation + user constraints, solves it over the integers with
Smith normal form, and derives flip tables (with optional basis
optimization and ergodicity augmentation) plus composition-grid
enumeration and format translations.
"""

from __future__ import annotations

import warnings
from itertools import chain

import numpy as np

from smol_tpu_torch.cofe.space.domain import Vacancy
from smol_tpu_torch.crystal.species import Composition, Element
from smol_tpu_torch.moca.composition.constraints import CompositionConstraintsManager
from smol_tpu_torch.moca.occu_utils import get_dim_ids_by_sublattice
from smol_tpu_torch.serial import MSONable, process_decoded
from smol_tpu_torch.utils.math import (
    NUM_TOL,
    get_ergodic_vectors,
    get_natural_centroid,
    get_natural_solutions,
    get_nonneg_float_vertices,
    get_optimal_basis,
    integerize_multiple,
    integerize_vector,
    solve_diophantines,
)

__all__ = ["CompositionSpace", "get_oxi_state", "flip_vec_to_reaction"]


def get_oxi_state(sp) -> int:
    """Oxidation state of a species (0 for plain elements)."""
    if isinstance(sp, Element):
        return 0
    return int(sp.oxi_state or 0)


def flip_vec_to_reaction(u, bits) -> str:
    """Human-readable reaction formula of a flip direction."""
    u = np.asarray(u, dtype=np.int64)
    dim_ids = get_dim_ids_by_sublattice(bits)
    from_strs, to_strs = [], []
    for sl_id, (sl_species, sl_dims) in enumerate(zip(bits, dim_ids)):
        for specie, dim in zip(sl_species, sl_dims):
            if u[dim] < 0:
                from_strs.append(f"{-u[dim]} {specie}({sl_id})")
            elif u[dim] > 0:
                to_strs.append(f"{u[dim]} {specie}({sl_id})")
    return " + ".join(from_strs) + " -> " + " + ".join(to_strs)


class CompositionSpace(MSONable):
    """The constrained integer lattice of compositions.

    Formats ("counts", "coordinates", "compositions", "species-counts") as in
    the reference; see translate_format.
    """

    other_constraints = CompositionConstraintsManager()

    def __init__(
        self,
        site_spaces,
        sublattice_sizes=None,
        charge_neutral=True,
        other_constraints=None,
        optimize_basis=False,
        table_ergodic=False,
    ):
        """Initialize a CompositionSpace.

        Args:
            site_spaces: list (per sublattice) of species lists.
            sublattice_sizes: sites per sublattice per prim (default all 1).
            charge_neutral: add the charge-balance constraint.
            other_constraints: list of constraint strings (see
                composition.constraints) or (a, b, relation) tuples, per prim.
            optimize_basis: optimize flip basis for minimal sizes/max
                connectivity at the minimum supercell size.
            table_ergodic: augment the flip table to be ergodic at the
                minimum supercell size.
        """
        self.site_spaces = [list(s) for s in site_spaces]
        self.num_dims = sum(len(s) for s in self.site_spaces)
        self.dim_ids = get_dim_ids_by_sublattice(self.site_spaces)

        # sorted distinct species; all Vacancy flavors collapse to one slot
        distinct = {
            ("__vacancy__" if isinstance(sp, Vacancy) else sp): sp
            for sp in chain(*self.site_spaces)
        }
        self.species = sorted(distinct.values())
        slot_of = {
            ("__vacancy__" if isinstance(sp, Vacancy) else sp): i
            for i, sp in enumerate(self.species)
        }
        self.species_ids = [
            [
                slot_of["__vacancy__" if isinstance(sp, Vacancy) else sp]
                for sp in sl_species
            ]
            for sl_species in self.site_spaces
        ]

        if sublattice_sizes is None:
            self.sublattice_sizes = [1] * len(self.site_spaces)
        elif len(sublattice_sizes) == len(self.site_spaces):
            self.sublattice_sizes = np.array(sublattice_sizes, dtype=int).tolist()
        else:
            raise ValueError(
                "site_spaces and sublattice_sizes lengths do not match."
            )

        self.charge_neutral = charge_neutral
        self.optimize_basis = optimize_basis
        self.table_ergodic = table_ergodic

        self.other_constraints = other_constraints
        parsed = self.other_constraints or {"eq": [], "leq": []}
        self._A, self._b = self._equality_system(parsed["eq"])
        if np.linalg.matrix_rank(self._A) >= self.num_dims:
            raise ValueError("Valid constraints more than number of dimensions!")
        if parsed["leq"]:
            self._A_leq = np.array([a for a, _ in parsed["leq"]])
            self._b_leq = np.array([bb for _, bb in parsed["leq"]])
        else:
            self._A_leq = None
            self._b_leq = None

        self._prim_vertices = None
        self._min_supercell_size = None
        self._flip_table = None
        self._n0 = None
        self._vs = None
        self._comp_grids = {}

    def _equality_system(self, eq_constraints):
        """The per-prim equality system A n = b.

        Row blocks, in order: one charge-balance row (when requested), one
        site-conservation row per sublattice (built as a single block
        identity-scatter), then the user equality constraints scaled to
        integers.
        """
        blocks, rhs = [], []
        if self.charge_neutral:
            blocks.append(
                np.array(
                    [[get_oxi_state(sp) for sl in self.site_spaces for sp in sl]],
                    dtype=np.int64,
                )
            )
            rhs.append([0])
        conservation = np.zeros(
            (len(self.site_spaces), self.num_dims), dtype=np.int64
        )
        for row, dim_id in enumerate(self.dim_ids):
            conservation[row, dim_id] = 1
        blocks.append(conservation)
        rhs.append(self.sublattice_sizes)
        for a, bb in eq_constraints:
            if len(a) != self.num_dims:
                raise ValueError(
                    f"Constraint length {len(a)} does not match dimensions "
                    f"{self.num_dims}!"
                )
            a_int, scale = integerize_vector(a)
            blocks.append(a_int[None, :].astype(np.int64))
            rhs.append([bb * scale])
        return np.vstack(blocks), np.concatenate(rhs)

    # ---------------- geometry of the space ----------------

    @property
    def prim_vertices(self) -> np.ndarray:
        """Vertex compositions per prim ("counts", float)."""
        if self._prim_vertices is None:
            self._prim_vertices = get_nonneg_float_vertices(self._A, self._b)
        return self._prim_vertices

    @property
    def min_supercell_size(self) -> int:
        """Minimum supercell size making all vertices integral."""
        if self._min_supercell_size is None:
            _, size = integerize_multiple(self.prim_vertices)
            self._min_supercell_size = size
        return self._min_supercell_size

    @property
    def num_unconstrained_compositions(self) -> int:
        return int(
            np.prod(
                [
                    (size * self.min_supercell_size) ** len(species)
                    for species, size in zip(
                        self.site_spaces, self.sublattice_sizes
                    )
                ]
            )
        )

    def get_supercell_base_solution(self, supercell_size=None) -> np.ndarray:
        """An integer solution of A n = b * supercell_size."""
        if supercell_size is None:
            supercell_size = self.min_supercell_size
        _, min_feasible = integerize_vector(self._b)
        if supercell_size % min_feasible != 0:
            raise ValueError(
                "Composition constraints cannot have an integral solution "
                f"in a supercell of {supercell_size} prims!"
            )
        if self._n0 is None:
            n0, _ = solve_diophantines(
                self._A, np.round(self._b * min_feasible).astype(int)
            )
            self._n0 = n0.copy()
        return self._n0 * supercell_size // min_feasible

    @property
    def basis(self) -> np.ndarray:
        """Basis vectors (rows) of the constrained integer grid."""
        if self._vs is None:
            n0, vs = solve_diophantines(
                self._A,
                np.round(self._b * self.min_supercell_size).astype(int),
            )
            if self.optimize_basis:
                if self.num_unconstrained_compositions > 10**6:
                    warnings.warn(
                        "Basis optimization can be very costly at this "
                        "composition space size; do this at your own risk!"
                    )
                xs = get_natural_solutions(n0, vs)
                vs = get_optimal_basis(n0, vs, xs)
            self._vs = vs
        return self._vs

    @property
    def flip_table(self) -> np.ndarray:
        """Flip directions ("counts" format rows)."""
        if self._flip_table is None:
            if not self.table_ergodic:
                self._flip_table = self.basis.copy()
            else:
                if self.num_unconstrained_compositions > 10**6:
                    warnings.warn(
                        "Ergodicity computation can be very costly in this "
                        "composition space; do this at your own risk!"
                    )
                n0 = self.get_supercell_base_solution(self.min_supercell_size)
                self._flip_table = get_ergodic_vectors(
                    n0, self.basis, self.min_supercell_grid
                )
        return self._flip_table

    @property
    def flip_reactions(self) -> list[str]:
        return [flip_vec_to_reaction(u, self.site_spaces) for u in self.flip_table]

    # ---------------- composition grids ----------------

    def get_composition_grid(self, supercell_size=1, step=1) -> np.ndarray:
        """All integer compositions in "coordinates" format."""
        for (k1, k2), grid in self._comp_grids.items():
            if (
                supercell_size % k1 == 0
                and step % k2 == 0
                and supercell_size // k1 == step // k2
            ):
                return grid * (supercell_size // k1)
        s = np.gcd(supercell_size, step)
        if s > 1:
            return (
                self.get_composition_grid(
                    supercell_size=supercell_size // s, step=step // s
                )
                * s
            )
        n0 = self.get_supercell_base_solution(supercell_size)
        grid = get_natural_solutions(n0, self.basis, step=step)
        ns = grid @ self.basis + n0
        if self._A_leq is not None:
            keep = (
                self._A_leq @ ns.T / supercell_size
                <= self._b_leq[:, None] + NUM_TOL
            ).all(axis=0)
        else:
            keep = np.ones(len(ns), dtype=bool)
        self._comp_grids[(supercell_size, step)] = grid[keep]
        return self._comp_grids[(supercell_size, step)]

    @property
    def min_supercell_grid(self) -> np.ndarray:
        return self.get_composition_grid(supercell_size=self.min_supercell_size)

    def get_centroid_composition(self, supercell_size=None) -> np.ndarray:
        """Closest integer composition to the space centroid ("coordinates")."""
        if supercell_size is None:
            supercell_size = self.min_supercell_size
        n0 = self.get_supercell_base_solution(supercell_size)
        return get_natural_centroid(
            n0, self.basis, supercell_size, self._A_leq, self._b_leq
        )

    # ---------------- format translation ----------------

    def translate_format(
        self, c, supercell_size, from_format, to_format="counts", rounding=False
    ):
        """Translate between composition formats (see class docstring)."""
        if from_format == "species-counts":
            raise ValueError("species-counts cannot be converted to other formats!")
        n = self._convert_to_counts(c, from_format, supercell_size, rounding)
        return self._convert_counts_to(n, to_format, supercell_size, rounding)

    def _convert_to_counts(self, c, form, supercell_size, rounding):
        if form == "counts":
            n = np.array(c)
        elif form == "coordinates":
            n = self.basis.T @ np.array(c) + self.get_supercell_base_solution(
                supercell_size
            )
        elif form == "compositions":
            n = []
            for species, size, comp in zip(
                self.site_spaces, self.sublattice_sizes, c
            ):
                if comp.num_atoms > 1 + NUM_TOL or comp.num_atoms < -NUM_TOL:
                    raise ValueError(
                        f"Sub-lattice composition {comp} is not normalized to 1!"
                    )
                for specie in species:
                    if isinstance(specie, Vacancy):
                        novac = Composition(
                            {
                                k: v
                                for k, v in comp.items()
                                if not isinstance(k, Vacancy)
                            }
                        )
                        n.append((1 - novac.num_atoms) * size * supercell_size)
                    else:
                        amt = comp[specie] if specie in comp else 0.0
                        n.append(amt * size * supercell_size)
            n = np.array(n)
        else:
            raise ValueError(f"Composition format {form} not supported!")
        if rounding:
            n_round = np.round(n).astype(int)
            if np.any(np.abs(n_round - n) > NUM_TOL):
                raise ValueError(f"Composition {n} cannot be rounded into integers!")
            n = n_round
        return n

    def _convert_counts_to(self, n, form, supercell_size, rounding):
        n = np.array(n)
        if np.any(n < -NUM_TOL):
            raise ValueError(f"Composition {n} contains negative species count!")
        if np.any(np.abs(self._A @ (n / supercell_size) - self._b) > NUM_TOL):
            raise ValueError(f"Composition {n} violates constraints!")
        if form == "counts":
            c = n.copy()
        elif form == "coordinates":
            dn = n - self.get_supercell_base_solution(supercell_size)
            c = np.linalg.pinv(self.basis.T.astype(np.float64)) @ dn
        elif form == "compositions":
            c = []
            for species, size, dim_id in zip(
                self.site_spaces, self.sublattice_sizes, self.dim_ids
            ):
                n_sl = n[dim_id] / (size * supercell_size)
                c.append(
                    Composition(
                        {
                            sp: amt
                            for sp, amt in zip(species, n_sl)
                            if not isinstance(sp, Vacancy) and amt > 0
                        }
                    )
                )
        elif form == "species-counts":
            c = np.zeros(len(self.species))
            for dim_id, species_ids in zip(self.dim_ids, self.species_ids):
                np.add.at(c, species_ids, n[dim_id])
        else:
            raise ValueError(f"Composition format {form} not supported!")
        if rounding and form != "compositions":
            c_round = np.round(c).astype(int)
            if np.any(np.abs(c - c_round) > NUM_TOL):
                raise ValueError(f"Composition {c} cannot be rounded into integers!")
            c = c_round
        return c

    # ---------------- serialization ----------------

    def as_dict(self) -> dict:
        n_cons = len(self.site_spaces) + (1 if self.charge_neutral else 0)
        eqs = [
            (a, bb, "eq")
            for a, bb in zip(self._A[n_cons:].tolist(), self._b[n_cons:].tolist())
        ]
        leqs = (
            [
                (a, bb, "leq")
                for a, bb in zip(self._A_leq.tolist(), self._b_leq.tolist())
            ]
            if self._A_leq is not None
            else []
        )
        return {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
            "bits": [[sp.as_dict() for sp in sl] for sl in self.site_spaces],
            "sublattice_sizes": self.sublattice_sizes,
            "other_constraints": eqs + leqs,
            "charge_neutral": self.charge_neutral,
            "optimize_basis": self.optimize_basis,
            "table_ergodic": self.table_ergodic,
            "min_supercell_size": self._min_supercell_size,
            "n0": None if self._n0 is None else self._n0.tolist(),
            "vs": None if self._vs is None else self._vs.tolist(),
            "flip_table": (
                None if self._flip_table is None else self._flip_table.tolist()
            ),
        }

    @classmethod
    def from_dict(cls, d):
        bits = [[process_decoded(sp) for sp in sl] for sl in d["bits"]]
        obj = cls(
            bits,
            d.get("sublattice_sizes"),
            charge_neutral=d.get("charge_neutral", True),
            other_constraints=[tuple(c) for c in d.get("other_constraints", [])]
            or None,
            optimize_basis=d.get("optimize_basis", False),
            table_ergodic=d.get("table_ergodic", False),
        )
        obj._min_supercell_size = d.get("min_supercell_size")
        if d.get("n0") is not None:
            obj._n0 = np.array(d["n0"], dtype=np.int64)
        if d.get("vs") is not None:
            obj._vs = np.array(d["vs"], dtype=np.int64)
        if d.get("flip_table") is not None:
            obj._flip_table = np.array(d["flip_table"], dtype=np.int64)
        return obj
