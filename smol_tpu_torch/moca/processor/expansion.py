"""Cluster-expansion and cluster-decomposition processors.

Counterpart of ``smol_tpu/moca/processor/expansion.py``
(``ClusterExpansionProcessor`` :183, ``_ce_features_fn`` :60;
``ClusterDecompositionProcessor`` :263-372, ``_cd_features_fn`` :76).  The
expansion's feature vector is the extensive correlation vector,
``corr * size``; the decomposition's is the extensive cluster-interaction
vector, ``interactions * size``, one entry per orbit, whose natural
parameters are the decomposition's coefficients (by default the orbit
multiplicities).  Each processor builds its fields from ``(subspace,
supercell matrix, coefficients)`` (:func:`smol_tpu_torch.system.
expansion_fields`, :func:`~smol_tpu_torch.system.decomposition_fields`),
or loads them from a system dict (``from_system``), and holds the per-site
local-cluster arrays (host numpy) from which the chains build their tables
(:mod:`smol_tpu_torch.ops.chain`): the coefficient-folded energy tensors,
as the reference builds them for each processor.  A flip's feature change
is the reference's local delta, over the (function, cluster) pairs (or
the clusters) that hold the flipped site
(:func:`smol_tpu_torch.ops.correlations.local_delta`).
"""

from __future__ import annotations

import numpy as np
import torch

from smol_tpu_torch.moca.processor.base import Processor
from smol_tpu_torch.ops import correlations as corr_ops
from smol_tpu_torch.serial import process_decoded
from smol_tpu_torch.system import decomposition_fields, expansion_fields

__all__ = ["ClusterExpansionProcessor", "ClusterDecompositionProcessor"]


class ClusterExpansionProcessor(Processor):
    """Features of a supercell occupancy under a cluster expansion.

    Args:
        cluster_subspace: the port's ``ClusterSubspace``.
        supercell_matrix: [3, 3] integer supercell matrix.
        coefficients: one a correlation function.
        use_concentration: see :class:`~smol_tpu_torch.moca.processor.base.Processor`.
        device: where the packed tables and evaluations live.
    """

    def __init__(self, cluster_subspace, supercell_matrix, coefficients,
                 use_concentration=False, device="cuda"):
        super().__init__(cluster_subspace, supercell_matrix, coefficients,
                         use_concentration, device)
        if len(self.coefs) != cluster_subspace.num_corr_functions:
            raise ValueError(
                f"Got {len(self.coefs)} coefficients, need "
                f"{cluster_subspace.num_corr_functions}."
            )
        self._load(expansion_fields(cluster_subspace, self._scmatrix, self.coefs))

    @classmethod
    def from_system(cls, system: dict, device, sublattices=None):
        """The processor of a system dict, its tables on ``device``; its
        coefficients are the system's first natural parameters, and
        ``sublattices`` (by default the system's) its sublattices."""
        processor = cls.__new__(cls)
        processor._init_from_system(
            system, device, np.asarray(system["natural_parameters"])[:processor._width(system)],
            sublattices)
        processor._load(system)
        return processor

    @staticmethod
    def _width(system) -> int:
        """The number of features of the system's processor."""
        return int(system["num_corr"])

    def _load(self, fields):
        """Move the packed fields to the device and keep the local arrays."""
        self.fields = fields  # host arrays: the system keys of this processor
        self._local = self._energy_weights = None
        self.num_corr = int(fields["num_corr"])
        self.packed = corr_ops.to_device(fields, self.device)
        # host arrays of the per-site local clusters (chain-table input)
        self.local_sites = np.asarray(fields["local_sites"])
        self.local_strides = np.asarray(fields["local_strides"])
        self.local_d2 = np.asarray(fields["local_d2"])
        self.local_g = np.asarray(fields["local_g"], dtype=np.float64)

    def compute_features(self, occupancies):
        """Feature vectors [W, num_corr] f64 of occupancies [W, N]."""
        return corr_ops.corr_from_occupancy(occupancies, self.packed) * self.size

    def _local_entries(self):
        """Each site's (function, cluster) pairs, built at first use."""
        return corr_ops.local_entries(self.fields, self.fields["pair_cluster"],
                                      self.fields["pair_offset"], self.fields["pair_fn"],
                                      self.device)

    def _feature_change(self, occupancy, site, code):
        self.prepare_deltas()
        return corr_ops.local_delta(occupancy, site, code, self._local,
                                    *self._delta_tables())

    def _delta_tables(self):
        """(flat value table, cluster count a feature) of the local delta."""
        return self.packed.corr_flat, self.packed.fn_cluster_count

    def _change_scale(self):
        return self.size

    def prepare_deltas(self):
        if self._local is None:
            self._local = self._local_entries()
        if self._energy_weights is None:
            weights = self.coefs * self.size / np.maximum(self._group_count(), 1)
            weights[0] = 0.0
            self._energy_weights = torch.as_tensor(  # the padding's 0 last
                np.append(weights, 0.0), dtype=torch.float64, device=self.device)

    def _group_count(self):
        """Host cluster count of each feature."""
        return np.asarray(self.fields["fn_cluster_count"], dtype=np.float64)

    def delta_energy(self, occupancies, sites, codes):
        """Energy changes [W] f64 of one flip a walker: the local entries'
        changes, each weighted by its feature's coefficient x size / cluster
        count (:func:`~smol_tpu_torch.ops.correlations.local_energy_delta`)."""
        self.prepare_deltas()
        return corr_ops.local_energy_delta(occupancies, sites, codes, self._local,
                                           self._delta_tables()[0], self._energy_weights)

    @classmethod
    def from_dict(cls, d, device="cuda"):
        return cls(
            process_decoded(d["cluster_subspace"]),
            np.array(d["supercell_matrix"]),
            coefficients=np.array(d["coefficients"]),
            device=device,
        )


class ClusterDecompositionProcessor(ClusterExpansionProcessor):
    """Features of a supercell occupancy under a cluster decomposition:
    the cluster-interaction vector times the supercell size, one entry per
    orbit; the default coefficients are the orbit multiplicities.

    Args:
        cluster_subspace: the port's ``ClusterSubspace``.
        supercell_matrix: [3, 3] integer supercell matrix.
        interaction_tensors: the expansion's ``cluster_interaction_tensors``.
        coefficients: one an orbit; by default the orbit multiplicities.
        use_concentration: see :class:`~smol_tpu_torch.moca.processor.base.Processor`.
        device: where the packed tables and evaluations live.
    """

    def __init__(self, cluster_subspace, supercell_matrix, interaction_tensors,
                 coefficients=None, use_concentration=False, device="cuda"):
        if len(interaction_tensors) != cluster_subspace.num_orbits:
            raise ValueError(
                f"Need {cluster_subspace.num_orbits} interaction tensors, got "
                f"{len(interaction_tensors)}."
            )
        coefficients = (
            cluster_subspace.orbit_multiplicities
            if coefficients is None
            else coefficients
        )
        Processor.__init__(self, cluster_subspace, supercell_matrix, coefficients,
                           use_concentration, device)
        self._interaction_tensors = tuple(
            np.asarray(t, dtype=np.float64) for t in interaction_tensors
        )
        self._load(decomposition_fields(cluster_subspace, self._scmatrix,
                                        self._interaction_tensors, self.coefs))

    @staticmethod
    def _width(system) -> int:
        return len(np.asarray(system["orbit_cluster_count"]))

    def _load(self, fields):
        super()._load(fields)
        self.interactions = corr_ops.interactions_to_device(fields, self.device)
        self.num_orbits = self.interactions.num_orbits

    def compute_features(self, occupancies):
        """Feature vectors [W, num_orbits] f64 of occupancies [W, N]."""
        return corr_ops.interactions_from_occupancy(
            occupancies, self.packed, self.interactions) * self.size

    def _local_entries(self):
        """Each site's clusters, built at first use."""
        orbit = np.asarray(self.fields["cluster_orbit"], dtype=np.int64)
        return corr_ops.local_entries(self.fields, np.arange(len(orbit)),
                                      np.asarray(self.fields["orbit_offset"])[orbit],
                                      orbit, self.device)

    def _delta_tables(self):
        return self.interactions.inter_flat, self.interactions.orbit_cluster_count

    def _group_count(self):
        return np.asarray(self.fields["orbit_cluster_count"], dtype=np.float64)

    def as_dict(self) -> dict:
        d = super().as_dict()
        d["interaction_tensors"] = [
            np.asarray(t).tolist() for t in self._interaction_tensors
        ]
        return d

    @classmethod
    def from_dict(cls, d, device="cuda"):
        return cls(
            process_decoded(d["cluster_subspace"]),
            np.array(d["supercell_matrix"]),
            tuple(np.array(t) for t in d["interaction_tensors"]),
            coefficients=np.array(d["coefficients"]),
            device=device,
        )

