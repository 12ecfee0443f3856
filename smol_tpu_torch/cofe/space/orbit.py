"""Orbit: symmetry-equivalent clusters and their correlation functions.

Counterpart of ``smol_tpu/cofe/space/orbit.py``, whose code it copies. In
this module "the reference" is smol (CederGroupHub/smol).

Mirrors the reference Orbit (smol/cofe/space/orbit.py).  An orbit carries

- the set of symmetry-equivalent clusters of its base cluster,
- the cluster permutations induced by its stabilizer,
- the symmetrically distinct site-function multi-indices (``bit_combos``),
- the flattened correlation tensors consumed by the device kernels:
  ``flat_correlation_tensors [n_bit_combos, prod(site-space sizes)]`` and
  the stride vector ``flat_tensor_indices`` such that the value of
  correlation function (orbit, combo) on a cluster with encoded occupancy
  ``occu[sites]`` is ``flat_correlation_tensors[combo, strides @ occu[sites]]``
  (reference orbit.py:218-275; consumed by evaluator.pyx:121-166).
"""

from __future__ import annotations

from functools import reduce
from itertools import combinations, product

import numpy as np

from smol_tpu_torch.cofe.space.cluster import Cluster
from smol_tpu_torch.constants import SITE_TOL
from smol_tpu_torch.crystal.coord import coord_list_mapping, is_coord_subset
from smol_tpu_torch.serial import MSONable, process_decoded
from smol_tpu_torch.utils.exceptions import SYMMETRY_ERROR_MESSAGE, SymmetryError

__all__ = ["Orbit"]


class Orbit(MSONable):
    """A set of symmetry-equivalent clusters with their orbit functions."""

    def __init__(self, cluster_coords, lattice, bits, site_bases, structure_symops):
        """Initialize an Orbit.

        Args:
            cluster_coords: frac coords of the base cluster sites.
            lattice: Lattice.
            bits: list (per site) of allowed non-constant function indices,
                e.g. [[0, 1], [0, 1]] for two ternary sites.
            site_bases: list of StandardBasis per site.
            structure_symops: symmetry operations of the parent structure.
        """
        if len(cluster_coords) != len(bits) or len(cluster_coords) != len(site_bases):
            raise AttributeError("Numbers of sites, bits and site bases must match.")
        self.bits = [list(b) for b in bits]
        self.site_bases = list(site_bases)
        self.structure_symops = structure_symops
        self.id = None
        self.bit_id = None

        self._equiv = None
        self._symops = None
        self._permutations = None
        self._bit_combos = None
        self._corr_tensors = None

        self.base_cluster = Cluster(
            [sb.site_space for sb in site_bases], cluster_coords, lattice
        )

    # ---------------- basic properties ----------------

    @property
    def basis_type(self) -> str:
        return self.site_bases[0].flavor

    @property
    def basis_orthogonal(self) -> bool:
        return all(b.is_orthogonal for b in self.site_bases)

    @property
    def basis_orthonormal(self) -> bool:
        return all(b.is_orthonormal for b in self.site_bases)

    @property
    def multiplicity(self) -> int:
        """Number of clusters in the orbit per primitive cell."""
        return len(self.clusters)

    @property
    def num_sites(self) -> int:
        return len(self.base_cluster)

    @property
    def site_spaces(self) -> list:
        return [sb.site_space for sb in self.site_bases]

    @property
    def basis_arrays(self) -> tuple:
        """Non-constant site function arrays per site.

        Bit indices index into these rows; the constant function is implicit
        (reference orbit.py:211-215 uses StandardBasis.function_array which
        excludes row 0).
        """
        return tuple(sb.function_array for sb in self.site_bases)

    # ---------------- symmetry ----------------

    @property
    def clusters(self) -> list[Cluster]:
        """Symmetry-equivalent clusters (the orbit itself)."""
        if self._equiv is not None:
            return self._equiv
        equiv = [self.base_cluster]
        spaces = self.site_spaces
        for symop in self.structure_symops:
            new = Cluster(
                spaces,
                symop.operate_multi(self.base_cluster.frac_coords),
                self.base_cluster.lattice,
            )
            if new not in equiv:
                equiv.append(new)
        self._equiv = equiv
        if len(equiv) * len(self.cluster_symops) != len(self.structure_symops):
            self._equiv = None
            raise SymmetryError(SYMMETRY_ERROR_MESSAGE)
        return equiv

    @property
    def cluster_symops(self):
        """Stabilizer symops mapping the base cluster onto itself."""
        if self._symops is None:
            self._gen_cluster_symops()
        return self._symops

    @property
    def cluster_permutations(self) -> np.ndarray:
        """Site permutations of the base cluster under its stabilizer."""
        if self._permutations is None:
            self._gen_cluster_symops()
        return self._permutations

    def _gen_cluster_symops(self):
        symops, permutations = [], []
        spaces = self.site_spaces
        base = self.base_cluster
        for symop in self.structure_symops:
            new = Cluster(
                spaces, symop.operate_multi(base.frac_coords), base.lattice
            )
            if new == base:
                recenter = np.round(base.centroid - new.centroid)
                c_sites = new.frac_coords + recenter
                mapping = coord_list_mapping(base.frac_coords, c_sites, atol=SITE_TOL)
                symops.append(symop)
                permutations.append(mapping)
        self._permutations = np.unique(np.array(permutations, dtype=np.int64), axis=0)
        self._symops = tuple(symops)
        if len(self._symops) * self.multiplicity != len(self.structure_symops):
            raise SymmetryError(SYMMETRY_ERROR_MESSAGE)

    # ---------------- correlation functions ----------------

    @property
    def bit_combos(self) -> tuple:
        """Symmetrically distinct site-function multi-indices.

        Tuple of int32 arrays; each array stacks the symmetry-equivalent
        orderings of one distinct combo (reference orbit.py:138-155).
        """
        if self._bit_combos is None:
            all_combos = []
            seen = set()
            for combo in product(*self.bits):
                if combo in seen:
                    continue
                combo_arr = np.array(combo, dtype=np.int32)
                equiv = np.unique(combo_arr[self.cluster_permutations], axis=0)
                seen.update(tuple(row) for row in equiv)
                all_combos.append(equiv)
            self._bit_combos = tuple(all_combos)
        return self._bit_combos

    @property
    def bit_combo_multiplicities(self) -> list[int]:
        return [bc.shape[0] for bc in self.bit_combos]

    @property
    def correlation_tensors(self) -> np.ndarray:
        """[n_bit_combos, *site_space_sizes] correlation value tensors.

        Entry [k, s0, s1, ...] is the value of orbit function k for a cluster
        occupied by encoded species (s0, s1, ...): the tensor product of
        single-site function rows averaged over the equivalent orderings of
        combo k (reference orbit.py:218-249).
        """
        if self._corr_tensors is None:
            arrays = self.basis_arrays
            shape = (len(self.bit_combos),) + tuple(a.shape[1] for a in arrays)
            tensors = np.zeros(shape, dtype=np.float64)
            for k, combos in enumerate(self.bit_combos):
                for bits in combos:
                    tensors[k] += reduce(
                        lambda a, b: np.tensordot(a, b, axes=0),
                        (arrays[i][b] for i, b in enumerate(bits)),
                    )
                tensors[k] /= len(combos)
            self._corr_tensors = tensors
        return self._corr_tensors

    @property
    def flat_correlation_tensors(self) -> np.ndarray:
        """Correlation tensors flattened to [n_bit_combos, prod(sizes)]."""
        ct = self.correlation_tensors
        return np.ascontiguousarray(
            ct.reshape(ct.shape[0], -1), dtype=np.float64
        )

    @property
    def flat_tensor_indices(self) -> np.ndarray:
        """C-order strides of the flattened correlation tensors (int32)."""
        shape = self.correlation_tensors.shape[2:]
        strides = np.cumprod(np.append(shape, 1)[::-1])[::-1]
        return np.ascontiguousarray(strides, dtype=np.int32)

    @property
    def rotation_array(self) -> np.ndarray:
        """Function-space rotation block from site-basis rotations."""
        n = len(self.bit_combos)
        rot = np.empty((n, n))
        for i, bcombos_i in enumerate(self.bit_combos):
            for j, bcombos_j in enumerate(self.bit_combos):
                total = 0.0
                for bc_i in bcombos_i:
                    for bc_j in bcombos_j:
                        prod_val = 1.0
                        for k, (bi, bj) in enumerate(zip(bc_i, bc_j)):
                            arrays = self.basis_arrays[k]
                            rotated = (
                                self.site_bases[k].rotation_array.T @ arrays[bj]
                            )
                            prod_val *= float(
                                np.dot(
                                    rotated,
                                    self.site_bases[k].measure_vector * arrays[bi],
                                )
                            )
                        total += prod_val
                rot[i, j] = total / len(bcombos_i)
        return rot

    # ---------------- modification ----------------

    def remove_bit_combo(self, bits):
        """Remove the bit combo containing the given ordering.

        Any single symmetrically-equivalent ordering identifies the combo
        (reference orbit.py:306).
        """
        bits = np.asarray(bits, dtype=np.int32)
        inds = [
            i
            for i, bit_combo in enumerate(self.bit_combos)
            if any(np.array_equal(bits, b) for b in bit_combo)
        ]
        if inds:
            self.remove_bit_combos_by_inds(inds)

    def remove_bit_combos_by_inds(self, inds):
        """Remove orbit functions by their local combo indices."""
        if max(inds) > len(self.bit_combos) - 1:
            raise ValueError(
                f"Some indices {inds} out of range for {len(self.bit_combos)} combos"
            )
        self._bit_combos = tuple(
            bc for i, bc in enumerate(self.bit_combos) if i not in inds
        )
        if not self._bit_combos:
            raise RuntimeError(f"All bit_combos removed from orbit {self.id}")
        self.reset_bases()

    def transform_site_bases(self, basis_name: str, orthonormal: bool = False):
        """Swap all site bases for a new flavor."""
        from smol_tpu_torch.cofe.space.basis import basis_factory

        new_bases = []
        for basis in self.site_bases:
            nb = basis_factory(basis_name, basis.site_space)
            if orthonormal:
                nb.orthonormalize()
            new_bases.append(nb)
        self.site_bases = new_bases
        self.reset_bases()

    def reset_bases(self):
        """Invalidate cached correlation tensors."""
        self._corr_tensors = None

    # ---------------- hierarchy ----------------

    def is_sub_orbit(self, orbit: "Orbit") -> bool:
        """True if the given orbit's clusters are subclusters of this one."""
        if len(self.base_cluster) <= len(orbit.base_cluster):
            return False
        if not all(sp in self.site_spaces for sp in orbit.site_spaces):
            return False
        spaces = self.site_spaces
        return any(
            Cluster(
                spaces,
                self.base_cluster.frac_coords[list(inds), :],
                self.base_cluster.lattice,
            )
            in orbit.clusters
            for inds in combinations(
                range(len(self.base_cluster)), len(orbit.base_cluster)
            )
        )

    def sub_orbit_mappings(self, orbit: "Orbit") -> np.ndarray:
        """Site-index mappings from this orbit's clusters to a sub-orbit's."""
        indsets = [
            inds
            for inds in combinations(
                [
                    i
                    for i, space in enumerate(self.site_spaces)
                    if space in orbit.site_spaces
                ],
                len(orbit.site_spaces),
            )
        ]
        mappings = []
        for cluster in self.clusters:
            for inds in indsets:
                centroid = cluster.frac_coords[list(inds)].mean(axis=0)
                recenter = np.round(centroid - orbit.base_cluster.centroid)
                for sub in orbit.clusters:
                    c_sites = sub.frac_coords + recenter
                    if is_coord_subset(c_sites, cluster.frac_coords, atol=SITE_TOL):
                        mappings.append(
                            coord_list_mapping(
                                c_sites, cluster.frac_coords, atol=SITE_TOL
                            )
                        )
        if len(mappings) == 0 and self.is_sub_orbit(orbit):
            raise RuntimeError("Sub-orbit found but no site mappings; inconsistent.")
        if len(mappings) == 0:
            return np.empty((0, len(orbit.site_spaces)), dtype=np.int32)
        return np.unique(np.array(mappings), axis=0).astype(np.int32)

    # ---------------- ids / dunder ----------------

    def assign_ids(self, orbit_id, orbit_bit_id, start_cluster_id):
        """Assign ids; returns (next orbit id, next bit id, next cluster id)."""
        self.id = orbit_id
        self.bit_id = orbit_bit_id
        c_id = start_cluster_id
        for cluster in self.clusters:
            c_id = cluster.assign_ids(c_id)
        return orbit_id + 1, orbit_bit_id + len(self.bit_combos), c_id

    def __len__(self):
        """Number of distinct orbit functions (bit combos)."""
        return len(self.bit_combos)

    def __eq__(self, other):
        """Crystallographic equivalence only."""
        return self.base_cluster in other.clusters

    def __contains__(self, cluster):
        return cluster in self.clusters

    def __repr__(self):
        return (
            f"Orbit(id={self.id}, mult={self.multiplicity}, "
            f"n_funcs={len(self)}, base={self.base_cluster!r})"
        )

    def as_dict(self) -> dict:
        return {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
            "sites": self.base_cluster.frac_coords.tolist(),
            "lattice": self.base_cluster.lattice.as_dict(),
            "bits": self.bits,
            "site_bases": [sb.as_dict() for sb in self.site_bases],
            "structure_symops": [op.as_dict() for op in self.structure_symops],
            "_bit_combos": [bc.tolist() for bc in self.bit_combos],
        }

    @classmethod
    def from_dict(cls, d):
        orbit = cls(
            d["sites"],
            process_decoded(d["lattice"]),
            d["bits"],
            [process_decoded(sb) for sb in d["site_bases"]],
            [process_decoded(op) for op in d["structure_symops"]],
        )
        if d.get("_bit_combos") is not None:
            orbit._bit_combos = tuple(
                np.array(bc, dtype=np.int32) for bc in d["_bit_combos"]
            )
        return orbit
