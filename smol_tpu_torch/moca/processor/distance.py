"""Distance (target-feature) processors for special-structure generation.

Counterpart of ``smol_tpu/moca/processor/distance.py``: the "energy" of an
occupancy is the SQS score

    d = -w L + sum_f W_f |f_f - T_f|

with f the intensive feature vector (the correlation vector, or the
cluster-interaction vector), T the target, L the largest cluster diameter
up to which every feature matches the target within ``match_tol``
(diameter groups in ascending order), w the match weight and W the target
weights; ``coefs = [-w, *W]``
(https://doi.org/10.1016/j.calphad.2013.06.006).
:class:`CorrelationDistanceProcessor` is built as the reference's is, from
``(subspace, supercell matrix, target vector, match weight, target
weights, match tol)`` (:func:`smol_tpu_torch.system.build_distance_system`),
or loaded from a distance system dict (``from_system``;
:func:`smol_tpu_torch.system.export_distance_system` writes one from the
reference's processor); :class:`ClusterInteractionDistanceProcessor` is
the reference's on the port's decomposition processor, its diameter
groups holding orbit ids.  Both evaluate on their device.

A flip's change of the distance cannot come from local deltas (the L1
distance and the match term are not sums over clusters, as the reference
notes at ``evaluator.pyx:329``): the per-step path's batched
:meth:`DistanceProcessor.delta_energy` and ``delta_features`` are two full
evaluations, before and after the flip, as the reference's
``delta_energy_fn`` and ``delta_features_fn`` (``distance.py:58-69``).
"""

from __future__ import annotations

import numpy as np
import torch

from smol_tpu_torch.moca.processor.base import Processor
from smol_tpu_torch.moca.processor.expansion import ClusterDecompositionProcessor
from smol_tpu_torch.ops import correlations as corr_ops
from smol_tpu_torch.serial import process_decoded
from smol_tpu_torch.system import build_distance_system, pad_local_tables
from smol_tpu_torch.utils.class_utils import get_subclasses

__all__ = [
    "DistanceProcessor",
    "CorrelationDistanceProcessor",
    "ClusterInteractionDistanceProcessor",
]


class DistanceProcessor:
    """Distance-from-target behaviour over a feature processor (the
    reference's public base, ``distance.py:72-209``), mixed before a
    concrete :class:`~smol_tpu_torch.moca.processor.base.Processor`.

    A subclass gives ``_base_features(occupancies [W, N]) -> [W, F]``, the
    extensive feature vectors, and sets ``target_vector``, ``coefs``,
    ``match_tol`` and ``diameter_groups`` (``[(diameter, feature
    indices)]``, ascending) through :meth:`_set_distance`.
    """

    def _set_distance(self, target_vector, coefs, match_tol, diameter_groups):
        self.target_vector = np.asarray(target_vector, dtype=np.float64)
        self.coefs = np.asarray(coefs, dtype=np.float64)
        self.match_tol = float(match_tol)
        self.diameter_groups = [(float(d), list(indices)) for d, indices in diameter_groups]
        self._target_dev = torch.as_tensor(self.target_vector, device=self.device)
        self._coefs_dev = torch.as_tensor(self.coefs, device=self.device)
        self._group_index = [torch.as_tensor(indices, dtype=torch.int64, device=self.device)
                             for _, indices in self.diameter_groups]

    def _base_features(self, occupancies: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def exact_match_max_diameter(self, distance_vector) -> float:
        """Largest diameter up to which every feature matches the target."""
        max_matched = 0.0
        for diameter, indices in self.diameter_groups:
            if np.all(np.asarray(distance_vector)[indices] <= self.match_tol):
                max_matched = diameter
            else:
                break
        return max_matched

    def compute_features(self, occupancies: torch.Tensor) -> torch.Tensor:
        """Distance features [W, F] f64 of occupancies [W, N]: |f - T| with
        slot 0 the exact-match diameter L (0 without a match term), batched
        as the reference's device features (``distance.py`` :38-55)."""
        occupancies = torch.atleast_2d(occupancies).long()
        dist = (self._base_features(occupancies) / self.size - self._target_dev).abs()
        ell = torch.zeros(len(dist), dtype=torch.float64, device=dist.device)
        if self.coefs[0] != 0:
            running = torch.ones_like(ell)
            for (diameter, _), indices in zip(self.diameter_groups, self._group_index):
                matched = (dist[:, indices] <= self.match_tol).all(dim=1)
                running = running * matched.to(running.dtype)
                ell = torch.maximum(ell, diameter * running)
        dist[:, 0] = ell
        return dist

    def compute_scores(self, occupancies: torch.Tensor) -> torch.Tensor:
        """Scores [W] f64, coefs . features, of occupancies [W, N]."""
        return self.compute_features(occupancies) @ self._coefs_dev

    def prepare_deltas(self):
        """Nothing to build: a flip's change is two full evaluations."""

    def _flipped(self, occupancies, sites, codes):
        """[2W, N]: the occupancies, then each with its flip applied."""
        occupancies = occupancies.long()
        after = occupancies.scatter(1, sites.long()[:, None], codes.long()[:, None])
        return torch.cat([occupancies, after])

    def delta_features(self, occupancies, sites, codes):
        """Feature changes [W, F] f64 of one flip a walker: the features after
        the flip less those before (the reference's ``delta_features_fn``)."""
        feats = self.compute_features(self._flipped(occupancies, sites, codes))
        return feats[len(occupancies):] - feats[:len(occupancies)]

    def delta_energy(self, occupancies, sites, codes):
        """Score changes [W] f64 of one flip a walker: the score after less
        the score before (the reference's ``delta_energy_fn``)."""
        scores = self.compute_scores(self._flipped(occupancies, sites, codes))
        return scores[len(occupancies):] - scores[:len(occupancies)]

    def compute_feature_vector(self, occupancy) -> np.ndarray:
        """Distance features of one occupancy [N], as a host array (the
        reference's ``compute_feature_vector``, :115-122)."""
        features = np.abs(self._base_feature_vector(occupancy) / self.size
                          - self.target_vector)
        features[0] = (
            self.exact_match_max_diameter(features) if self.coefs[0] != 0 else 0.0
        )
        return features

    def _base_feature_vector(self, occupancy) -> np.ndarray:
        """The extensive feature vector of one occupancy [N], host f64."""
        occu = torch.as_tensor(np.asarray(occupancy, dtype=np.int64), device=self.device)
        return self._base_features(occu[None, :])[0].cpu().numpy()

    def _distances(self, occupancy, flips, vector) -> tuple[np.ndarray, np.ndarray]:
        """(|f_i - vector|, |f_f - vector|): the intensive feature vector
        before and after a flip list (applied in order on a copy)."""
        occupancy = np.asarray(occupancy, dtype=np.int32)
        occu_f = occupancy.copy()
        for site, code in flips:
            occu_f[site] = code
        vector = np.asarray(vector, dtype=np.float64)
        return tuple(np.abs(self._base_feature_vector(occu) / self.size - vector)
                     for occu in (occupancy, occu_f))

    def compute_feature_vector_distances(self, occupancy, flips) -> np.ndarray:
        """[2, F] |f - T| before and after a flip list, slot 0 zero."""
        dist_i, dist_f = self._distances(occupancy, flips, self.target_vector)
        dist_i[0] = dist_f[0] = 0.0
        return np.stack([dist_i, dist_f])

    def compute_feature_vector_distance_change(
        self, feature_vector, occupancy, flips
    ) -> np.ndarray:
        """Change in |f - feature_vector| (elementwise) from a flip list,
        against any fixed vector instead of the target (the reference's
        ``distance.py:141-161``)."""
        dist_i, dist_f = self._distances(occupancy, flips, feature_vector)
        return dist_f - dist_i

    def compute_feature_vector_change(self, occupancy, flips) -> np.ndarray:
        distances = self.compute_feature_vector_distances(occupancy, flips)
        if self.coefs[0] != 0:
            distances[0, 0] = self.exact_match_max_diameter(distances[0])
            distances[1, 0] = self.exact_match_max_diameter(distances[1])
        return distances[1] - distances[0]

    def as_dict(self) -> dict:
        d = super().as_dict()
        d["target_vector"] = self.target_vector.tolist()
        d["match_weight"] = -float(self.coefs[0])
        d["match_tol"] = self.match_tol
        return d

    @classmethod
    def from_dict(cls, d, device="cuda"):
        """The distance processor of an ``as_dict`` record, by its ``@class``
        (the reference's :186-208)."""
        if type(d) is not dict or "@class" not in d:
            raise ValueError("Expected an as_dict() record with an @class key.")
        try:
            subclass = get_subclasses(DistanceProcessor)[d["@class"]]
        except KeyError as err:
            raise NameError(f"{d['@class']} is not a DistanceProcessor subclass.") from err
        return subclass.from_dict(d, device=device)


class CorrelationDistanceProcessor(DistanceProcessor, Processor):
    """Distance of a supercell occupancy from a target correlation vector.

    Args:
        cluster_subspace: the port's ``ClusterSubspace`` (no external terms).
        supercell_matrix: [3, 3] integer supercell matrix.
        use_concentration: see :class:`~smol_tpu_torch.moca.processor.base.Processor`.
        target_vector: the target correlation vector (by default zeros).
        match_weight: w, the weight of the exact-match diameter.
        target_weights: W, one a correlation function but the first (by
            default ones).
        match_tol: the tolerance of a feature's exact match.
        device: where the packed tables and evaluations live.
    """

    def __init__(self, cluster_subspace, supercell_matrix, use_concentration=False,
                 target_vector=None, match_weight=1.0, target_weights=None,
                 match_tol=1e-5, device="cuda"):
        if target_vector is None:
            target_vector = np.zeros(len(cluster_subspace))
        if target_weights is None:
            target_weights = np.ones(len(cluster_subspace) - 1)
        super().__init__(cluster_subspace, supercell_matrix,
                         np.ones(cluster_subspace.num_corr_functions),
                         use_concentration, device)
        self._load(build_distance_system(
            cluster_subspace, self._scmatrix, target_vector, match_weight, match_tol,
            target_weights, use_concentration))

    @classmethod
    def from_system(cls, system: dict, device="cuda"):
        """The processor of a distance system dict (one supercell shape), its
        tables on ``device``."""
        processor = cls.__new__(cls)
        processor._init_from_system(system, device, system["distance_coefs"])
        processor._load(system)
        return processor

    def _load(self, system):
        self.system = system
        self.num_corr = int(system["num_corr"])
        self.packed = corr_ops.to_device(system, self.device)
        features = np.asarray(system["diameter_group_features"])
        offsets = np.asarray(system["diameter_group_features_offsets"])
        self._set_distance(
            system["target_vector"], system["distance_coefs"], system["match_tol"],
            [(diameter, features[offsets[g]: offsets[g + 1]].tolist())
             for g, diameter in enumerate(system["diameter_group_diameters"])])

    def repad_local_tables(self, width):
        """Pad the local tables to ``width`` local clusters a site, as the
        reference pads the shapes of one search to their widest
        (:func:`smol_tpu_torch.system.pad_local_tables`)."""
        self._load(pad_local_tables(self.system, width))

    @property
    def num_features(self) -> int:
        """The correlation functions, as the reference's processor (a
        cluster-expansion processor) counts them."""
        return self.num_corr

    @property
    def local_width(self) -> int:
        """Local clusters a site of the local tables."""
        return int(self.system["local_orbit"].shape[1])

    def get_sublattices(self):
        """The supercell's sublattices, in the reference's order: built anew
        each call, or a loaded processor's own list (the one the distance
        tables read)."""
        if self._subspace is None:
            return self._sublattices
        return super().get_sublattices()

    def compute_corr(self, occupancies: torch.Tensor) -> torch.Tensor:
        """Intensive correlation vectors [W, num_corr] f64 of [W, N]."""
        return corr_ops.corr_from_occupancy(occupancies, self.packed)

    def _base_features(self, occupancies):
        return self.compute_corr(occupancies) * self.size

    @classmethod
    def from_dict(cls, d, device="cuda"):
        """As the reference's (``distance.py:266-273``), which keeps no target
        weights: they come back as ones."""
        return cls(
            process_decoded(d["cluster_subspace"]),
            np.array(d["supercell_matrix"]),
            target_vector=np.array(d["target_vector"]),
            match_weight=d["match_weight"],
            match_tol=d.get("match_tol", 1e-5),
            device=device,
        )


class ClusterInteractionDistanceProcessor(DistanceProcessor, ClusterDecompositionProcessor):
    """Distance of a supercell occupancy from a target cluster-interaction
    vector (the reference's ``distance.py:285-346``): the base features are
    the decomposition processor's, one an orbit, and the diameter groups
    hold orbit ids.  The reference's chain refuses it
    (``pallas_sqs.py:112-116``), so the SQS search runs it on the per-step
    path.

    Args:
        cluster_subspace: the port's ``ClusterSubspace`` (no external terms).
        supercell_matrix: [3, 3] integer supercell matrix.
        interaction_tensors: one an orbit, the empty orbit's first; by
            default each orbit's correlation tensors summed with their
            multiplicities (an offset of 0).
        use_concentration: see :class:`~smol_tpu_torch.moca.processor.base.Processor`.
        target_vector: the target vector, one an orbit (by default zeros).
        match_weight: w, the weight of the exact-match diameter.
        target_weights: W, one an orbit but the empty one (by default ones).
        match_tol: the tolerance of a feature's exact match.
        device: where the packed tables and evaluations live.
    """

    def __init__(self, cluster_subspace, supercell_matrix, interaction_tensors=None,
                 use_concentration=False, target_vector=None, match_weight=1.0,
                 target_weights=None, match_tol=1e-5, device="cuda"):
        if target_vector is None:
            target_vector = np.zeros(cluster_subspace.num_orbits)
        if target_weights is None:
            target_weights = np.ones(cluster_subspace.num_orbits - 1)
        if interaction_tensors is None:
            interaction_tensors = (np.float64(0.0),) + tuple(
                sum(m * tensor for m, tensor in zip(orbit.bit_combo_multiplicities,
                                                    orbit.correlation_tensors))
                for orbit in cluster_subspace.orbits
            )
        if len(cluster_subspace.external_terms) > 0:
            raise ValueError("The cluster subspace cannot have external terms.")
        if match_weight < 0:
            raise ValueError("The match weight must be a positive number.")
        if len(target_weights) != len(target_vector) - 1:
            raise ValueError("target_weights must have length len(target_vector) - 1.")
        super().__init__(cluster_subspace, supercell_matrix, interaction_tensors,
                         use_concentration=use_concentration, device=device)
        groups = [(diameter, [orbit.id for orbit in orbits])
                  for diameter, orbits in cluster_subspace.orbits_by_diameter.items()]
        self._set_distance(target_vector, np.concatenate([[-match_weight], target_weights]),
                           match_tol, groups)

    def _base_features(self, occupancies):
        return ClusterDecompositionProcessor.compute_features(self, occupancies)

    @classmethod
    def from_dict(cls, d, device="cuda"):
        """As the reference's (``distance.py:328-346``), which keeps no target
        weights: they come back as ones."""
        return cls(
            process_decoded(d["cluster_subspace"]),
            np.array(d["supercell_matrix"]),
            interaction_tensors=tuple(np.array(t) for t in d["interaction_tensors"]),
            target_vector=np.array(d["target_vector"]),
            match_weight=d["match_weight"],
            match_tol=d.get("match_tol", 1e-5),
            device=device,
        )
