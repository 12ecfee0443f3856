"""Distance (target-feature) processors for special-structure generation.

Counterpart of ``smol_tpu/moca/processor/distance.py``: the "energy" of an
occupancy is the SQS score

    d = -w L + sum_f W_f |f_f - T_f|

with f the intensive correlation vector, T the target, L the largest
cluster diameter up to which every feature matches the target within
``match_tol`` (diameter groups in ascending order), w the match weight and
W the target weights; ``coefs = [-w, *W]``
(https://doi.org/10.1016/j.calphad.2013.06.006).  The processor is built
as the reference's is, from ``(subspace, supercell matrix, target vector,
match weight, target weights, match tol)``
(:func:`smol_tpu_torch.system.build_distance_system`), or loaded from a
distance system dict (``from_system``;
:func:`smol_tpu_torch.system.export_distance_system` writes one from the
reference's processor), and evaluates on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from smol_tpu_torch.moca.processor.base import Processor
from smol_tpu_torch.ops import correlations as corr_ops
from smol_tpu_torch.serial import process_decoded
from smol_tpu_torch.system import build_distance_system, pad_local_tables

__all__ = [
    "CorrelationDistanceProcessor",
    "ClusterInteractionDistanceProcessor",
]


class CorrelationDistanceProcessor(Processor):
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
        self.target_vector = np.asarray(system["target_vector"], dtype=np.float64)
        self.coefs = np.asarray(system["distance_coefs"], dtype=np.float64)
        self.match_tol = float(system["match_tol"])
        features = np.asarray(system["diameter_group_features"])
        offsets = np.asarray(system["diameter_group_features_offsets"])
        self.diameter_groups = [
            (float(diameter), features[offsets[g]: offsets[g + 1]].tolist())
            for g, diameter in enumerate(system["diameter_group_diameters"])
        ]
        self._target_dev = torch.as_tensor(self.target_vector, device=self.device)
        self._coefs_dev = torch.as_tensor(self.coefs, device=self.device)

    def repad_local_tables(self, width):
        """Pad the local tables to ``width`` local clusters a site, as the
        reference pads the shapes of one search to their widest
        (:func:`smol_tpu_torch.system.pad_local_tables`)."""
        self._load(pad_local_tables(self.system, width))

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

    def exact_match_max_diameter(self, distance_vector) -> float:
        """Largest diameter up to which every feature matches the target."""
        max_matched = 0.0
        for diameter, indices in self.diameter_groups:
            if np.all(np.asarray(distance_vector)[indices] <= self.match_tol):
                max_matched = diameter
            else:
                break
        return max_matched

    def compute_corr(self, occupancies: torch.Tensor) -> torch.Tensor:
        """Intensive correlation vectors [W, num_corr] f64 of [W, N]."""
        return corr_ops.corr_from_occupancy(occupancies, self.packed)

    def compute_features(self, occupancies: torch.Tensor) -> torch.Tensor:
        """Distance features [W, num_corr] f64 of occupancies [W, N]:
        |f - T| with slot 0 the exact-match diameter L (0 without a match
        term), batched as the reference's device features (``distance.py``
        :38-55)."""
        occupancies = torch.atleast_2d(occupancies).long()
        corr = self.compute_corr(occupancies) * self.size
        dist = (corr / self.size - self._target_dev).abs()
        ell = torch.zeros(len(dist), dtype=torch.float64, device=dist.device)
        if self.coefs[0] != 0:
            running = torch.ones_like(ell)
            for diameter, indices in self.diameter_groups:
                matched = (dist[:, indices] <= self.match_tol).all(dim=1)
                running = running * matched.to(running.dtype)
                ell = torch.maximum(ell, diameter * running)
        dist[:, 0] = ell
        return dist

    def compute_scores(self, occupancies: torch.Tensor) -> torch.Tensor:
        """Scores [W] f64, coefs . features, of occupancies [W, N]."""
        return self.compute_features(occupancies) @ self._coefs_dev

    def compute_feature_vector(self, occupancy) -> np.ndarray:
        """Distance features of one occupancy [N], as a host array (the
        reference's ``compute_feature_vector``, :115-122)."""
        occu = torch.as_tensor(np.asarray(occupancy), device=self.device)
        corr = self.compute_corr(occu[None, :])[0].cpu().numpy() * self.size
        features = np.abs(corr / self.size - self.target_vector)
        features[0] = (
            self.exact_match_max_diameter(features) if self.coefs[0] != 0 else 0.0
        )
        return features

    def _base_feature_vector(self, occupancy) -> np.ndarray:
        """The extensive correlation vector of one occupancy [N], host f64."""
        occu = torch.as_tensor(np.asarray(occupancy, dtype=np.int64), device=self.device)
        return self.compute_corr(occu[None, :])[0].cpu().numpy() * self.size

    def _distances(self, occupancy, flips, vector) -> tuple[np.ndarray, np.ndarray]:
        """(|f_i - vector|, |f_f - vector|): the intensive correlation vector
        before and after a flip list (applied in order on a copy)."""
        occupancy = np.asarray(occupancy, dtype=np.int32)
        occu_f = occupancy.copy()
        for site, code in flips:
            occu_f[site] = code
        vector = np.asarray(vector, dtype=np.float64)
        return tuple(np.abs(self._base_feature_vector(occu) / self.size - vector)
                     for occu in (occupancy, occu_f))

    def compute_feature_vector_distances(self, occupancy, flips) -> np.ndarray:
        """[2, num_corr] |f - T| before and after a flip list, slot 0 zero."""
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


class ClusterInteractionDistanceProcessor:
    """Distance from a target cluster-interaction vector: not ported.

    Its diameter groups hold orbit ids, another index space than the
    correlation functions the distance chain indexes by, and the
    reference's chain refuses it too (``pallas_sqs.py:112-116``).
    """

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the cluster-interaction distance is not ported yet (ROADMAP.md "
            "Queue 1 item 6)"
        )
