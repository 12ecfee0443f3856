"""ClusterSubspace: the set of orbits/correlation functions of a CE.

Counterpart of ``smol_tpu/cofe/space/clusterspace.py``, whose code it
copies, without the Potts subspace.
In this module "the reference" is smol (CederGroupHub/smol).

Re-design of the reference workhorse (smol/cofe/space/clusterspace.py).
Host-side responsibilities are unchanged — orbit generation from diameter
cutoffs, structure matching, occupancy encoding, supercell orbit-index
generation and caching — but evaluation routes through numpy reference
kernels here and through packed JAX device kernels in the processor layer
(smol_tpu.ops).

In the port, ``corr_from_occupancy`` and ``corr_from_structure`` evaluate
through the port's packed correlations (``ops/correlations.py``) on the
CPU, and structures are matched to the prim by the port's copy of the
reference's ``StructureMatcher`` (``crystal/matcher.py``).
``PottsSubspace`` and the ``evaluator`` of ``ops/ref.py`` raise
``NotImplementedError`` naming ROADMAP.md Queue 1 item 5(b).
"""

from __future__ import annotations

import warnings
from collections import namedtuple
from itertools import chain, groupby

import numpy as np
import torch

from smol_tpu_torch.cofe.space.basis import basis_factory
from smol_tpu_torch.cofe.space.domain import (
    Vacancy,
    get_allowed_species,
    get_site_spaces,
)
from smol_tpu_torch.cofe.space.orbit import Orbit
from smol_tpu_torch.constants import SITE_TOL
from smol_tpu_torch.crystal import (
    PeriodicSite,
    Structure,
    coord_list_mapping_pbc,
    get_symmetry_operations,
    is_coord_subset,
    is_coord_subset_pbc,
    lattice_points_in_supercell,
)
from smol_tpu_torch.crystal.matcher import StructureMatcher
from smol_tpu_torch.ops import correlations as corr_ops
from smol_tpu_torch.ops.packing import pack_supercell
from smol_tpu_torch.serial import MSONable, process_decoded
from smol_tpu_torch.system import _packed_fields
from smol_tpu_torch.utils.exceptions import (
    SYMMETRY_ERROR_MESSAGE,
    StructureMatchError,
    SymmetryError,
)

__all__ = [
    "ClusterSubspace",
    "invert_mapping",
    "get_complete_mapping",
]

# per-supercell orbit site-index arrays (tuple of [n_clusters, size] int32)
OrbitIndices = namedtuple("OrbitIndices", ["arrays"])


def invert_mapping(mapping) -> list:
    """Invert a list-of-lists mapping (reference clusterspace.py:1728)."""
    inverse = [[] for _ in range(len(mapping))]
    for i, vals in enumerate(mapping):
        for j in vals:
            inverse[j].append(i)
    return inverse


def get_complete_mapping(mapping) -> list:
    """Transitive closure of a one-level forward mapping.

    Each sublist is expanded with every index reachable through any number
    of hops (reference clusterspace.py:1752-1790).  Useful for full
    hierarchy linkages; not stored on ClusterSubspace since CE fits only
    need the one-level mapping.
    """
    complete = [list(vals) for vals in mapping]
    for i in range(len(mapping)):
        frontier = list(mapping[i])
        while frontier:
            nxt = []
            for j in frontier:
                if j not in complete[i]:
                    complete[i].append(j)
                for k in mapping[j]:
                    if k not in complete[i] and k not in nxt:
                        nxt.append(k)
            frontier = nxt
    return complete


class ClusterSubspace(MSONable):
    """A subspace of cluster-expansion correlation functions.

    Attributes:
        symops: symmetry operations of the prim structure.
        num_corr_functions: total correlation functions incl. the empty one.
        num_orbits: total orbits incl. the empty orbit.
        num_clusters: total clusters in the prim.
    """

    def __init__(
        self,
        structure,
        expansion_structure,
        symops,
        orbits,
        supercell_matcher=None,
        site_matcher=None,
        **matcher_kwargs,
    ):
        self._structure = structure
        self._exp_structure = expansion_structure
        self.symops = symops
        self.num_corr_functions = None
        self.num_orbits = None
        self.num_clusters = None

        fcoords = self._structure.frac_coords
        for symop in self.symops:
            if not is_coord_subset_pbc(
                symop.operate_multi(fcoords), fcoords, SITE_TOL
            ):
                raise SymmetryError(SYMMETRY_ERROR_MESSAGE)

        self._sc_matcher = supercell_matcher or StructureMatcher(**matcher_kwargs)
        self._site_matcher = site_matcher or StructureMatcher(**matcher_kwargs)

        self._orbits = orbits
        self._external_terms = []
        self._assign_orbit_ids()
        # cache of orbit site-index arrays per supercell matrix
        self._supercell_orbit_inds = {}

    @classmethod
    def from_cutoffs(
        cls,
        structure,
        cutoffs,
        basis="sinusoid",
        orthonormal=True,
        use_concentration=False,
        supercell_matcher=None,
        site_matcher=None,
        **matcher_kwargs,
    ):
        """Create a ClusterSubspace from diameter cutoffs.

        Args:
            structure: disordered prim Structure.
            cutoffs: {cluster_size: max diameter}, e.g. {2: 5, 3: 4}.  The
                empty orbit is always included; point terms by default
                ({1: None} excludes them).
            basis: site basis flavor name.
            orthonormal: orthonormalize site bases.
            use_concentration: use prim concentrations as the basis measure.

        Returns:
            ClusterSubspace
        """
        symops = get_symmetry_operations(structure)
        sites_to_expand = [
            site
            for site in structure
            if site.species.num_atoms < 0.99 or len(site.species) > 1
        ]
        expansion_structure = Structure.from_sites(sites_to_expand)
        orbits = cls._gen_orbits_from_cutoffs(
            expansion_structure, cutoffs, symops, basis, orthonormal, use_concentration
        )
        return cls(
            structure=structure,
            expansion_structure=expansion_structure,
            symops=symops,
            orbits=orbits,
            supercell_matcher=supercell_matcher,
            site_matcher=site_matcher,
            **matcher_kwargs,
        )

    # ---------------- properties ----------------

    @property
    def structure(self):
        """Prim structure including inactive sites."""
        return self._structure

    @property
    def expansion_structure(self):
        """Prim structure with only active (partially occupied) sites."""
        return self._exp_structure

    @property
    def basis_type(self):
        return self.orbits[0].basis_type

    @property
    def cutoffs(self) -> dict:
        """Tight cutoffs: max diameter per cluster size > 1."""
        return {
            size: max(o.base_cluster.diameter for o in orbs)
            for size, orbs in self._orbits.items()
            if size != 1
        }

    @property
    def orbits(self) -> list[Orbit]:
        """All orbits sorted by size (excludes the empty orbit)."""
        return [o for _, orbs in sorted(self._orbits.items()) for o in orbs]

    @property
    def orbits_by_size(self) -> dict:
        return self._orbits

    @property
    def orbits_by_diameter(self) -> dict:
        key = lambda o: float(np.round(o.base_cluster.diameter, 6))  # noqa: E731
        return {
            d: tuple(orbs)
            for d, orbs in groupby(sorted(self.orbits, key=key), key=key)
        }

    @property
    def orbit_multiplicities(self) -> np.ndarray:
        """Crystallographic multiplicities, leading 1 for the empty orbit."""
        return np.array([1] + [o.multiplicity for o in self.orbits])

    @property
    def num_functions_per_orbit(self) -> np.ndarray:
        return np.array([len(o) for o in self.orbits])

    @property
    def function_orbit_ids(self) -> np.ndarray:
        """Orbit id of each correlation function (0 for the empty function)."""
        ids = [0]
        for orbit in self.orbits:
            ids += len(orbit) * [orbit.id]
        return np.array(ids)

    @property
    def function_inds_by_size(self) -> dict:
        return {
            s: list(range(os[0].bit_id, os[-1].bit_id + len(os[-1])))
            for s, os in self._orbits.items()
        }

    @property
    def function_ordering_multiplicities(self) -> np.ndarray:
        return np.array(
            [1] + [m for o in self.orbits for m in o.bit_combo_multiplicities]
        )

    @property
    def function_total_multiplicities(self) -> np.ndarray:
        return (
            self.orbit_multiplicities[self.function_orbit_ids]
            * self.function_ordering_multiplicities
        )

    @property
    def basis_orthogonal(self) -> bool:
        return all(o.basis_orthogonal for o in self.orbits)

    @property
    def basis_orthonormal(self) -> bool:
        return all(o.basis_orthonormal for o in self.orbits)

    @property
    def external_terms(self) -> list:
        return self._external_terms

    @property
    def site_rotation_matrix(self) -> np.ndarray:
        """Block-diagonal change-of-basis matrix from site-basis rotations."""
        from scipy.linalg import block_diag

        return block_diag([[1]], *[o.rotation_array for o in self.orbits])

    @property
    def species_indices_maps(self) -> list[dict]:
        """Per-site {code: species string} maps for the prim structure."""
        return [
            {i: str(sp) for i, sp in enumerate(space.keys())}
            for space in get_site_spaces(self.structure)
        ]

    # ---------------- selection helpers ----------------

    def orbits_from_cutoffs(self, upper, lower=0) -> list[Orbit]:
        """Orbits with base-cluster diameter within [lower, upper]."""
        upper = upper if isinstance(upper, dict) else {k: upper for k in self._orbits}
        lower = lower if isinstance(lower, dict) else {k: lower for k in self._orbits}
        return [
            o
            for size in upper
            for o in self._orbits.get(size, [])
            if lower[size] <= o.base_cluster.diameter <= upper[size]
        ]

    def function_inds_from_cutoffs(self, upper, lower=0) -> np.ndarray:
        inds = []
        for o in self.orbits_from_cutoffs(upper, lower):
            inds += list(range(o.bit_id, o.bit_id + len(o)))
        return np.array(inds)

    def iterorbits(self):
        return iter(self.orbits)

    def orbits_by_cutoffs(self, upper, lower=0) -> list:
        """Orbits whose base-cluster diameter is within [lower, upper]
        inclusive (reference clusterspace.py:499)."""
        return [
            orbit
            for orbit in self.orbits
            if lower <= orbit.base_cluster.diameter <= upper
        ]

    def get_mapped_site_properties(
        self, structure, scmatrix=None, site_mapping=None
    ) -> dict:
        """Site properties of ``structure`` mapped onto the prim supercell
        site order (reference clusterspace.py:858): for each matched
        supercell site, the property values of the matching input site.
        Unmatched supercell sites (vacancies) contribute no entry.
        """
        if scmatrix is None:
            scmatrix = self.scmatrix_from_structure(structure)
        supercell = self.structure.copy().make_supercell(scmatrix)
        if site_mapping is None:
            site_mapping = self.structure_site_mapping(supercell, structure)
        site_mapping = list(site_mapping)
        site_properties = {p: [] for p in structure.site_properties}
        for i in range(len(supercell)):
            if i in site_mapping:
                src = structure[site_mapping.index(i)]
                for prop in site_properties:
                    site_properties[prop].append(src.properties.get(prop))
        return site_properties

    # ---------------- external terms ----------------

    def add_external_term(self, term):
        """Add an external feature term (e.g. EwaldTerm)."""
        for added in self._external_terms:
            if isinstance(term, type(added)):
                raise ValueError(f"This subspace already has a {type(term)}.")
        self._external_terms.append(term)

    # ---------------- structure evaluation ----------------

    @staticmethod
    def num_prims_from_matrix(scmatrix) -> int:
        return int(round(abs(np.linalg.det(scmatrix))))

    def corr_from_structure(
        self, structure, normalized=True, scmatrix=None, site_mapping=None
    ) -> np.ndarray:
        """Correlation vector for a structure (reference clusterspace.py:668)."""
        if scmatrix is None:
            scmatrix = self.scmatrix_from_structure(structure)
        occu = self.occupancy_from_structure(
            structure, scmatrix=scmatrix, site_mapping=site_mapping, encode=True
        )
        corr = self.corr_from_occupancy(occu, scmatrix)
        size = self.num_prims_from_matrix(scmatrix)

        if self.external_terms:
            supercell = self.structure.copy().make_supercell(scmatrix)
            extras = [
                np.atleast_1d(term.value_from_occupancy(occu, supercell)) / size
                for term in self._external_terms
            ]
            corr = np.concatenate([corr, *extras])
        if not normalized:
            corr = corr * size
        return corr

    def corr_from_occupancy(self, occu, scmatrix) -> np.ndarray:
        """Correlation vector from an encoded occupancy of a known supercell,
        through the port's packed correlations on the CPU."""
        packed = pack_supercell(self, scmatrix)
        tensors = corr_ops.to_device(_packed_fields(packed, packed.size), "cpu")
        occu = torch.as_tensor(np.asarray(occu, dtype=np.int64))
        return corr_ops.corr_from_occupancy(occu[None], tensors)[0].numpy()

    def occupancy_from_structure(
        self, structure, scmatrix=None, site_mapping=None, encode=False
    ):
        """Occupancy string of a structure on the matched prim supercell."""
        if scmatrix is None:
            scmatrix = self.scmatrix_from_structure(structure)
        supercell = self.structure.copy().make_supercell(scmatrix)
        if site_mapping is None:
            site_mapping = self.structure_site_mapping(supercell, structure)

        mapping_list = list(site_mapping)
        occu = []
        for i, allowed in enumerate(get_allowed_species(supercell)):
            if i in mapping_list:
                spec = structure[mapping_list.index(i)].specie
            else:
                spec = Vacancy()
            if spec not in allowed:
                raise StructureMatchError(
                    f"A site in the structure has unrecognized species {spec}."
                )
            occu.append(allowed.index(spec) if encode else spec)
        return np.array(occu, dtype=np.int32) if encode else occu

    def refine_structure(self, structure, scmatrix=None, site_mapping=None):
        """Map a (relaxed) structure onto its ideal prim-supercell sites."""
        if scmatrix is None:
            scmatrix = self.scmatrix_from_structure(structure)
        supercell = self.structure.copy().make_supercell(scmatrix)
        if site_mapping is None:
            site_mapping = self.structure_site_mapping(supercell, structure)
        occu = self.occupancy_from_structure(
            structure, scmatrix=scmatrix, site_mapping=site_mapping
        )
        sites = [
            PeriodicSite(spec, site.frac_coords, supercell.lattice)
            for spec, site in zip(occu, supercell)
            if not isinstance(spec, Vacancy)
        ]
        return Structure.from_sites(sites)

    def scmatrix_from_structure(self, structure) -> np.ndarray:
        """Supercell matrix relating a structure to the prim.

        Lattice geometry can be degenerate (cubic prims admit distinct
        sublattices with identical vector lengths/angles), so when
        several candidates tie the SITE MAPPING picks the right one —
        the disambiguation pymatgen performs inside its full-structure
        fit (reference reliance: smol/cofe/space/clusterspace.py:908).
        """
        cands = self._sc_matcher.get_supercell_matrix_candidates(
            structure, self.structure
        )
        if not cands:
            raise StructureMatchError("Supercell could not be found from structure.")
        cands = [(-m if np.linalg.det(m) < 0 else m) for m in cands]
        if len(cands) > 1:
            for scmatrix in cands:
                supercell = self.structure.copy().make_supercell(scmatrix)
                if self._site_matcher.get_mapping(supercell, structure) is not None:
                    return scmatrix
        return cands[0]

    def structure_site_mapping(self, supercell, structure) -> list:
        """Site mapping of structure onto a prim supercell."""
        mapping = self._site_matcher.get_mapping(supercell, structure)
        if mapping is None:
            raise StructureMatchError("Mapping could not be found from structure.")
        return mapping.tolist()

    # ---------------- supercell orbit indices ----------------

    def get_orbit_indices(self, scmatrix) -> OrbitIndices:
        """Cached per-orbit cluster site-index arrays for a supercell."""
        scmatrix = np.array(scmatrix, dtype=np.int64)
        key = tuple(sorted(tuple(r.tolist()) for r in scmatrix))
        indices = self._supercell_orbit_inds.get(key)
        if indices is None:
            indices = self._gen_orbit_indices(scmatrix)
            self._supercell_orbit_inds[key] = indices
        return indices

    def supercell_orbit_mappings(self, scmatrix):
        return self.get_orbit_indices(scmatrix).arrays

    @property
    def evaluator(self):
        """Host evaluator with the reference extension type's interface.

        Bundles the packed flat orbit tensors (reference clusterspace.py:319
        returns the Cython ClusterSpaceEvaluator; here it is the numpy
        oracle in ops/ref.py — TPU hot paths use the packed device kernels
        instead).  Not ported: the port evaluates through its packed
        correlations.
        """
        raise NotImplementedError(
            "the evaluator of smol_tpu/ops/ref.py is not ported yet "
            "(ROADMAP.md Queue 1 item 5(b)); use corr_from_occupancy")

    def gen_orbit_list(self, scmatrix) -> list:
        """Per-orbit evaluation tuples for a supercell.

        [(bit_id, flat_tensor_indices, flat_correlation_tensors,
        cluster_indices)] — the layout the legacy serial evaluators consume
        (reference clusterspace.py:1265-1296).
        """
        mappings = self.supercell_orbit_mappings(scmatrix)
        return [
            (
                orbit.bit_id,
                orbit.flat_tensor_indices,
                orbit.flat_correlation_tensors,
                cluster_inds,
            )
            for orbit, cluster_inds in zip(self.orbits, mappings)
        ]

    def _gen_orbit_indices(self, scmatrix) -> OrbitIndices:
        """Map every orbit cluster into supercell site indices.

        Mirrors reference clusterspace.py:1329-1366: cluster frac coords of
        every equivalent cluster, translated by each prim lattice point in
        the supercell, are matched to supercell sites modulo 1.
        """
        supercell = self.structure.copy().make_supercell(scmatrix)
        prim_to_supercell = np.linalg.inv(scmatrix)
        supercell_fcoords = np.array(supercell.frac_coords)
        pts = lattice_points_in_supercell(scmatrix)

        orbit_indices = []
        for orbit in self.orbits:
            prim_fcoords = np.array([c.frac_coords for c in orbit.clusters])
            fcoords = np.dot(prim_fcoords, prim_to_supercell)
            # [equiv cluster, translation, site in cluster, xyz]
            tcoords = fcoords[:, None, :, :] + pts[None, :, None, :]
            tcs = tcoords.shape
            inds = coord_list_mapping_pbc(
                tcoords.reshape((-1, 3)), supercell_fcoords, atol=SITE_TOL
            ).reshape((tcs[0] * tcs[1], tcs[2]))
            orbit_indices.append(np.ascontiguousarray(inds, dtype=np.int32))
        return OrbitIndices(tuple(orbit_indices))

    def get_aliased_orbits(self, sc_matrix) -> list:
        """Orbits degenerate under the supercell's translational symmetry."""
        sc_orb_map = self.supercell_orbit_mappings(sc_matrix)
        sorted_maps = [
            {tuple(sorted(c)) for c in orb_map} for orb_map in sc_orb_map
        ]
        aliased_orbits = []
        for i, map_i in enumerate(sorted_maps):
            if i + 1 in chain(*aliased_orbits):
                continue
            group = [i + 1]
            for j in range(i + 1, len(sorted_maps)):
                if j + 1 in chain(*aliased_orbits):
                    continue
                if map_i == sorted_maps[j]:
                    group.append(j + 1)
            if len(group) > 1:
                aliased_orbits.append(tuple(group))
        return sorted(aliased_orbits, key=lambda x: x[0])

    # ---------------- basis modification ----------------

    def change_site_bases(self, new_basis, orthonormal=False):
        """Change all site bases to a new flavor."""
        for orbit in self.orbits:
            orbit.transform_site_bases(new_basis, orthonormal)

    def rotate_site_basis(self, singlet_id, angle, index1=0, index2=1):
        """Rotate the site basis of a point orbit (and all sharing bases)."""
        if singlet_id not in range(1, len(self._orbits[1]) + 1):
            raise ValueError("Orbit id provided is not a valid singlet id.")
        basis = self.orbits[singlet_id - 1].site_bases[0]
        basis.rotate(angle, index1, index2)
        rotated = [basis]
        for orbit in self.orbits:
            for site_basis in orbit.site_bases:
                if (
                    site_basis.site_space == basis.site_space
                    and site_basis not in rotated
                ):
                    site_basis.rotate(angle, index1, index2)
                    rotated.append(site_basis)
            orbit.reset_bases()

    # ---------------- pruning ----------------

    def remove_orbits(self, orbit_ids):
        """Remove whole orbits by id and re-assign ids."""
        if min(orbit_ids) < 0:
            raise ValueError("Negative indices are not allowed.")
        if min(orbit_ids) == 0:
            raise ValueError("The empty orbit cannot be removed.")
        if max(orbit_ids) > self.num_orbits - 1:
            raise ValueError(
                f"Index out of range; total orbits: {self.num_orbits}"
            )
        for size in list(self._orbits):
            self._orbits[size] = [
                o for o in self._orbits[size] if o.id not in orbit_ids
            ]
            if not self._orbits[size]:
                del self._orbits[size]
        self._assign_orbit_ids()
        self._supercell_orbit_inds = {}

    def remove_corr_functions(self, corr_ids):
        """Remove individual correlation functions by id."""
        empty_orbit_ids = []
        corr_ids = np.array(corr_ids, dtype=np.int32)
        for orbit in self.orbits:
            first, last = orbit.bit_id, orbit.bit_id + len(orbit)
            to_remove = corr_ids[(corr_ids >= first) & (corr_ids < last)] - first
            if to_remove.size > 0:
                try:
                    orbit.remove_bit_combos_by_inds(to_remove.tolist())
                except RuntimeError:
                    empty_orbit_ids.append(orbit.id)
                    warnings.warn(
                        f"All bit combos removed from orbit {orbit.id}; "
                        "removing the orbit."
                    )
        if empty_orbit_ids:
            self.remove_orbits(empty_orbit_ids)
        else:
            self._assign_orbit_ids()

    # ---------------- hierarchy ----------------

    def get_sub_orbits(self, orbit_id, level=1, min_size=1) -> list:
        """Sub-orbits of an orbit (reference clusterspace.py:1188)."""
        if orbit_id == 0:
            return []
        size = len(self.orbits[orbit_id - 1].base_cluster)
        if level is None or level < 0 or size - level - 1 < 0:
            stop = 0
        elif min_size > size - level:
            stop = min_size - 1
        else:
            stop = size - level - 1
        return [
            orbit
            for s in range(size - 1, stop, -1)
            for orbit in self._orbits.get(s, [])
            if self.orbits[orbit_id - 1].is_sub_orbit(orbit)
        ]

    def get_sub_function_ids(self, corr_id, level=1, min_size=1) -> list:
        """Ids of sub correlation functions of a correlation function."""
        if corr_id == 0:
            return []
        orbit = self.orbits[self.function_orbit_ids[corr_id] - 1]
        bit_combo = orbit.bit_combos[corr_id - orbit.bit_id]
        sub_fun_ids = []
        for sub_orbit in self.get_sub_orbits(orbit.id, level=level, min_size=min_size):
            inds = orbit.sub_orbit_mappings(sub_orbit)
            if len(inds) == 0:
                continue
            for i, sub_bit_combo in enumerate(sub_orbit.bit_combos):
                if np.any(np.all(sub_bit_combo[0] == bit_combo[:, inds], axis=2)):
                    sub_fun_ids.append(sub_orbit.bit_id + i)
        return sub_fun_ids

    def orbit_hierarchy(self, level=1, min_size=1) -> list:
        sub_ids = [
            [sub.id for sub in self.get_sub_orbits(o.id, level=level, min_size=min_size)]
            for o in self.orbits
        ]
        return [[]] + sub_ids

    def function_hierarchy(self, level=1, min_size=2, invert=False) -> list:
        hierarchy = [
            self.get_sub_function_ids(i, level=level, min_size=min_size)
            for i in range(self.num_corr_functions)
        ]
        return invert_mapping(hierarchy) if invert else hierarchy

    # ---------------- orbit generation ----------------

    def _assign_orbit_ids(self):
        counts = (1, 1, 1)
        for key in sorted(self._orbits):
            for orbit in self._orbits[key]:
                counts = orbit.assign_ids(*counts)
        self.num_orbits, self.num_corr_functions, self.num_clusters = counts

    @staticmethod
    def _gen_orbits_from_cutoffs(
        exp_struct, cutoffs, symops, basis, orthonorm, use_conc
    ) -> dict:
        """Generate {size: [Orbit]} within diameter cutoffs."""
        cutoffs = dict(cutoffs)
        try:
            if cutoffs.pop(1) is None:
                if len(cutoffs) != 0:
                    raise ValueError(
                        f"Cannot generate higher-order clusters {cutoffs} "
                        "with point terms excluded."
                    )
                return {}
        except KeyError:
            pass

        site_spaces = get_site_spaces(exp_struct, include_measure=use_conc)
        site_bases = tuple(basis_factory(basis, space) for space in site_spaces)
        if orthonorm:
            for sb in site_bases:
                sb.orthonormalize()

        nbits = np.array([len(space) - 1 for space in site_spaces], dtype=np.int32)
        orbits = {
            1: ClusterSubspace._gen_point_orbits(exp_struct, site_bases, nbits, symops)
        }
        if len(cutoffs) == 0:
            return orbits
        orbits.update(
            ClusterSubspace._gen_multi_orbits(
                orbits[1], exp_struct, cutoffs, site_bases, nbits, symops
            )
        )
        return orbits

    @staticmethod
    def _gen_point_orbits(exp_struct, site_bases, nbits, symops) -> list[Orbit]:
        pt_orbits = []
        for nbit, site, sbasis in zip(nbits, exp_struct, site_bases):
            new_orbit = Orbit(
                [np.mod(site.frac_coords, 1)],
                exp_struct.lattice,
                [list(range(nbit))],
                [sbasis],
                symops,
            )
            if new_orbit not in pt_orbits:
                pt_orbits.append(new_orbit)
        # higher-symmetry orbits first
        return sorted(pt_orbits, key=lambda x: (-x.multiplicity, len(x)))

    @staticmethod
    def _gen_multi_orbits(point_orbits, exp_struct, cutoffs, site_bases, nbits, symops):
        """Grow orbits size by size within diameter cutoffs.

        Mirrors reference clusterspace.py:1485-1566.
        """
        orbits = {1: point_orbits}
        centroid = exp_struct.lattice.get_cartesian_coords([0.5, 0.5, 0.5])
        coords = exp_struct.lattice.get_cartesian_coords(exp_struct.frac_coords)
        max_lp = (
            float(np.max(np.linalg.norm(coords - centroid, axis=-1))) + SITE_TOL
        )
        for size, diameter in sorted(cutoffs.items()):
            if size - 1 not in orbits:
                break
            new_orbits = []
            neighbors = exp_struct.get_sites_in_sphere(
                centroid, diameter + max_lp, include_index=True
            )
            for orbit in orbits[size - 1]:
                if orbit.base_cluster.diameter > diameter:
                    continue
                for neighbor in neighbors:
                    if is_coord_subset(
                        [neighbor.frac_coords],
                        orbit.base_cluster.frac_coords,
                        atol=SITE_TOL,
                    ):
                        continue
                    new_sites = np.concatenate(
                        [orbit.base_cluster.frac_coords, [neighbor.frac_coords]]
                    )
                    new_orbit = Orbit(
                        new_sites,
                        exp_struct.lattice,
                        orbit.bits + [list(range(nbits[neighbor.index]))],
                        orbit.site_bases + [site_bases[neighbor.index]],
                        symops,
                    )
                    if new_orbit.base_cluster.diameter > diameter + 1e-8:
                        continue
                    if new_orbit not in new_orbits:
                        new_orbits.append(new_orbit)
            if len(new_orbits) > 0:
                orbits[size] = sorted(
                    new_orbits,
                    key=lambda x: (
                        np.round(x.base_cluster.diameter, 6),
                        -x.multiplicity,
                        len(x),
                    ),
                )
        return orbits

    # ---------------- dunder / serialization ----------------

    def copy(self):
        return ClusterSubspace.from_dict(self.as_dict())

    def __eq__(self, other):
        if not isinstance(other, ClusterSubspace):
            return False
        if other.num_corr_functions != self.num_corr_functions:
            return False
        if len(self.external_terms) != len(other.external_terms):
            return False
        if not all(
            isinstance(t1, type(t2))
            for t1, t2 in zip(other.external_terms, self.external_terms)
        ):
            return False
        return all(o1 == o2 for o1, o2 in zip(other.orbits, self.orbits))

    def __len__(self):
        return self.num_corr_functions + len(self.external_terms)

    def __contains__(self, orbit):
        return orbit in self.orbits

    def __repr__(self):
        return (
            f"{type(self).__name__}(num_orbits={self.num_orbits}, "
            f"num_corr_functions={self.num_corr_functions}, "
            f"cutoffs={ {k: round(v, 4) for k, v in self.cutoffs.items()} })"
        )

    def as_dict(self) -> dict:
        return {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
            "structure": self._structure.as_dict(),
            "expansion_structure": self._exp_structure.as_dict(),
            "symops": [op.as_dict() for op in self.symops],
            "orbits": {
                str(s): [o.as_dict() for o in orbs]
                for s, orbs in self._orbits.items()
            },
            "external_terms": [t.as_dict() for t in self._external_terms],
            "_supercell_orbit_inds": [
                (list(key), [a.tolist() for a in val.arrays])
                for key, val in self._supercell_orbit_inds.items()
            ],
        }

    @classmethod
    def from_dict(cls, d):
        subspace = cls(
            structure=process_decoded(d["structure"]),
            expansion_structure=process_decoded(d["expansion_structure"]),
            symops=[process_decoded(op) for op in d["symops"]],
            orbits={
                int(s): [process_decoded(o) for o in orbs]
                for s, orbs in d["orbits"].items()
            },
        )
        for term in d.get("external_terms", []):
            subspace._external_terms.append(process_decoded(term))
        for key, arrays in d.get("_supercell_orbit_inds", []):
            subspace._supercell_orbit_inds[tuple(tuple(r) for r in key)] = (
                OrbitIndices(
                    tuple(np.array(a, dtype=np.int32) for a in arrays)
                )
            )
        return subspace


