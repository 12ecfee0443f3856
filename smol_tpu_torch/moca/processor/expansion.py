"""Cluster-expansion processor.

Counterpart of ``smol_tpu/moca/processor/expansion.py``
(``ClusterExpansionProcessor`` :183, ``_ce_features_fn`` :60): the feature
vector is the extensive correlation vector, ``corr * size``.  The processor
also holds the per-site local-cluster arrays (host numpy) from which the
flip chain builds its tables (:mod:`smol_tpu_torch.ops.chain`).
"""

from __future__ import annotations

import numpy as np
import torch

from smol_tpu_torch.ops import correlations as corr_ops

__all__ = ["ClusterExpansionProcessor"]


class ClusterExpansionProcessor:
    """Features of a supercell occupancy under a cluster expansion.

    Args:
        system: a system dict (:mod:`smol_tpu_torch.system`).
        device: where the packed tables and evaluations live.
    """

    def __init__(self, system: dict, device):
        self.device = torch.device(device)
        self.num_sites = int(system["num_sites"])
        self.size = int(system["size"])
        self.num_corr = int(system["num_corr"])
        self.num_energy_coefs = self.num_corr  # one coefficient per feature
        self.packed = corr_ops.to_device(system, self.device)
        # host arrays of the per-site local clusters (chain-table input)
        self.local_sites = np.asarray(system["local_sites"])
        self.local_strides = np.asarray(system["local_strides"])
        self.local_d2 = np.asarray(system["local_d2"])
        self.local_g = np.asarray(system["local_g"], dtype=np.float64)

    def compute_features(self, occupancies: torch.Tensor) -> torch.Tensor:
        """Feature vectors [W, num_corr] f64 of occupancies [W, N]."""
        return corr_ops.corr_from_occupancy(occupancies, self.packed) * self.size

    def compute_feature_vector(self, occupancy) -> np.ndarray:
        """Feature vector of one occupancy [N], as a host array."""
        occu = torch.as_tensor(np.asarray(occupancy), device=self.device)
        return self.compute_features(occu[None, :])[0].cpu().numpy()
