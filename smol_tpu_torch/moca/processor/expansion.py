"""Cluster-expansion and cluster-decomposition processors.

Counterpart of ``smol_tpu/moca/processor/expansion.py``
(``ClusterExpansionProcessor`` :183, ``_ce_features_fn`` :60;
``ClusterDecompositionProcessor`` :263-372, ``_cd_features_fn`` :76).  The
expansion's feature vector is the extensive correlation vector,
``corr * size``; the decomposition's is the extensive cluster-interaction
vector, ``interactions * size``, one entry per orbit, whose natural
parameters are the decomposition's coefficients (by default the orbit
multiplicities).  Both processors also hold the per-site local-cluster
arrays (host numpy) from which the chains build their tables
(:mod:`smol_tpu_torch.ops.chain`): the coefficient-folded energy tensors
of the system file, as the reference builds them for each processor.
"""

from __future__ import annotations

import numpy as np
import torch

from smol_tpu_torch.ops import correlations as corr_ops

__all__ = ["ClusterExpansionProcessor", "ClusterDecompositionProcessor"]


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


class ClusterDecompositionProcessor(ClusterExpansionProcessor):
    """Features of a supercell occupancy under a cluster decomposition:
    the cluster-interaction vector times the supercell size, one entry per
    orbit (the system's ``inter_flat``, ``offset``, ``orbit_offset``,
    ``cluster_orbit`` and ``orbit_cluster_count``)."""

    def __init__(self, system: dict, device):
        super().__init__(system, device)
        self.interactions = corr_ops.interactions_to_device(system, self.device)
        self.num_orbits = self.interactions.num_orbits
        self.num_energy_coefs = self.num_orbits  # one coefficient per orbit

    def compute_features(self, occupancies: torch.Tensor) -> torch.Tensor:
        """Feature vectors [W, num_orbits] f64 of occupancies [W, N]."""
        return corr_ops.interactions_from_occupancy(
            occupancies, self.packed, self.interactions) * self.size
