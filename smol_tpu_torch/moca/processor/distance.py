"""Distance (target-feature) processors for special-structure generation.

Counterpart of ``smol_tpu/moca/processor/distance.py``: the "energy" of an
occupancy is the SQS score

    d = -w L + sum_f W_f |f_f - T_f|

with f the intensive correlation vector, T the target, L the largest
cluster diameter up to which every feature matches the target within
``match_tol`` (diameter groups in ascending order), w the match weight and
W the target weights; ``coefs = [-w, *W]``
(https://doi.org/10.1016/j.calphad.2013.06.006).  The processor is built
from a distance system dict (:func:`smol_tpu_torch.system.export_distance_system`)
and evaluates on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from smol_tpu_torch.moca.sublattice import sublattices_from_system
from smol_tpu_torch.ops import correlations as corr_ops

__all__ = [
    "CorrelationDistanceProcessor",
    "ClusterInteractionDistanceProcessor",
]


class CorrelationDistanceProcessor:
    """Distance of a supercell occupancy from a target correlation vector.

    Args:
        system: a distance system dict (one supercell shape).
        device: where the packed tables and evaluations live.
    """

    def __init__(self, system: dict, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {self.device} requested but torch sees no CUDA device; "
                "pass device='cpu' to evaluate on the CPU"
            )
        self.system = system
        self.num_sites = int(system["num_sites"])
        self.size = int(system["size"])
        self.num_corr = int(system["num_corr"])
        self.packed = corr_ops.to_device(system, self.device)
        self.target_vector = np.asarray(system["target_vector"], dtype=np.float64)
        self.coefs = np.asarray(system["distance_coefs"], dtype=np.float64)
        self.match_tol = float(system["match_tol"])
        self.supercell_matrix = np.asarray(system["supercell_matrix"])
        features = np.asarray(system["diameter_group_features"])
        offsets = np.asarray(system["diameter_group_features_offsets"])
        self.diameter_groups = [
            (float(diameter), features[offsets[g]: offsets[g + 1]].tolist())
            for g, diameter in enumerate(system["diameter_group_diameters"])
        ]
        self._sublattices = sublattices_from_system(system)
        self._target_dev = torch.as_tensor(self.target_vector, device=self.device)
        self._coefs_dev = torch.as_tensor(self.coefs, device=self.device)

    def get_sublattices(self):
        """The supercell's sublattices, in the reference's order."""
        return self._sublattices

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

    def compute_property(self, occupancy) -> float:
        """Score of one occupancy [N]: coefs . features."""
        return float(self.coefs @ self.compute_feature_vector(occupancy))


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
