"""Correlation and cluster-interaction vectors of a batch of occupancies.

Counterpart of ``smol_tpu/ops/correlations.py`` (``tensor_indices`` :125,
``corr_from_occupancy`` :149, ``interactions_from_occupancy`` :159).  The
reference selects each cluster's tensor value from precomputed planes,
because gathers are slow on a TPU; here the value is one direct gather, and
the functions' (or orbits') sums one reduction over the (function, cluster)
pairs laid out [num_corr, Pmax] (the clusters laid out [num_orbits, Cmax]),
each run padded to the longest with entries of weight zero: a reduction
along a dimension adds in a fixed order on every device, so the same
occupancy gives the same bits in every run (``index_add_`` adds with f64
atomics on CUDA, in no fixed order).
Correlations and interactions are float64, indices int64 (torch's index
type).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "PackedTensors",
    "to_device",
    "tensor_indices",
    "corr_from_occupancy",
    "PackedInteractions",
    "interactions_to_device",
    "interactions_from_occupancy",
]


@dataclass(frozen=True)
class PackedTensors:
    """The packed-supercell arrays the correlation evaluation reads."""

    num_corr: int
    cluster_sites: torch.Tensor  # [C, K] int64
    cluster_strides: torch.Tensor  # [C, K] int64
    corr_flat: torch.Tensor  # [T] f64
    pair_cluster: torch.Tensor  # [num_corr * Pmax] int64, function-major
    pair_offset: torch.Tensor  # [num_corr * Pmax] int64
    pair_weight: torch.Tensor  # [num_corr, Pmax] f64: 1 for a pair, 0 for padding
    fn_cluster_count: torch.Tensor  # [num_corr] f64


@dataclass(frozen=True)
class PackedInteractions:
    """The interaction tensors of a cluster-decomposition processor."""

    num_orbits: int
    offset: float  # the constant (empty-cluster) interaction
    inter_flat: torch.Tensor  # [T] f64 every orbit's interaction tensor
    cluster_index: torch.Tensor  # [num_orbits * Cmax] int64, orbit-major
    cluster_offset: torch.Tensor  # [num_orbits * Cmax] int64 tensor start
    cluster_weight: torch.Tensor  # [num_orbits, Cmax] f64: 1 a cluster, 0 padding
    orbit_cluster_count: torch.Tensor  # [num_orbits] f64


def _grouped(keys, num_groups):
    """(order, slot, width): the entries sorted by key (stably) and each
    one's slot in a [num_groups, width] layout, every group's run padded
    to the longest."""
    keys = np.asarray(keys)
    order = np.argsort(keys, kind="stable")
    counts = np.bincount(keys, minlength=num_groups)
    starts = np.cumsum(counts) - counts
    width = max(int(counts.max()), 1)
    slot = keys[order] * width + np.arange(len(order)) - starts[keys[order]]
    return order, slot, width


def _padded(values, order, slot, size, dtype, device):
    flat = np.zeros(size, dtype=dtype)
    flat[slot] = values[order]
    return torch.as_tensor(flat, device=device)


def to_device(system: dict, device) -> PackedTensors:
    """Move a system's packed-supercell arrays to ``device``."""

    def ints(name):
        return torch.as_tensor(np.asarray(system[name]), device=device).long()

    def floats(name):
        return torch.as_tensor(
            np.asarray(system[name], dtype=np.float64), device=device
        )

    num_corr = int(system["num_corr"])
    # the pairs function by function, each run padded to the longest
    order, slot, width = _grouped(system["pair_fn"], num_corr)

    def padded(values, dtype):
        return _padded(np.asarray(values), order, slot, num_corr * width, dtype, device)

    return PackedTensors(
        num_corr=num_corr,
        cluster_sites=ints("cluster_sites"),
        cluster_strides=ints("cluster_strides"),
        corr_flat=floats("corr_flat"),
        pair_cluster=padded(system["pair_cluster"], np.int64),
        pair_offset=padded(system["pair_offset"], np.int64),
        pair_weight=padded(np.ones(len(order)), np.float64).view(num_corr, -1),
        fn_cluster_count=floats("fn_cluster_count"),
    )


def interactions_to_device(system: dict, device) -> PackedInteractions:
    """Move a decomposition system's interaction arrays to ``device``."""
    num_orbits = len(np.asarray(system["orbit_cluster_count"]))
    cluster_orbit = np.asarray(system["cluster_orbit"])
    # the clusters orbit by orbit, each run padded to the longest
    order, slot, width = _grouped(cluster_orbit, num_orbits)
    size = num_orbits * width
    starts = np.asarray(system["orbit_offset"])[cluster_orbit]
    return PackedInteractions(
        num_orbits=num_orbits,
        offset=float(system["offset"]),
        inter_flat=torch.as_tensor(np.asarray(system["inter_flat"], dtype=np.float64),
                                   device=device),
        cluster_index=_padded(np.arange(len(cluster_orbit)), order, slot, size,
                              np.int64, device),
        cluster_offset=_padded(starts, order, slot, size, np.int64, device),
        cluster_weight=_padded(np.ones(len(order)), order, slot, size, np.float64,
                               device).view(num_orbits, -1),
        orbit_cluster_count=torch.as_tensor(
            np.asarray(system["orbit_cluster_count"], dtype=np.float64), device=device),
    )


def tensor_indices(occu: torch.Tensor, packed: PackedTensors) -> torch.Tensor:
    """Flattened correlation-tensor index of every cluster: [W, C].

    index(cluster) = sum_k strides[c, k] * occu[sites[c, k]] for each of the
    W occupancies in ``occu`` [W, N].
    """
    codes = occu.long()[:, packed.cluster_sites]  # [W, C, K]
    return (codes * packed.cluster_strides).sum(dim=-1)


def corr_from_occupancy(occu: torch.Tensor, packed: PackedTensors) -> torch.Tensor:
    """Correlation vectors [W, num_corr] f64 of occupancies [W, N]."""
    occu = torch.atleast_2d(occu)
    tidx = tensor_indices(occu, packed)  # [W, C]
    vals = packed.corr_flat[packed.pair_offset + tidx[:, packed.pair_cluster]]
    weight = packed.pair_weight
    sums = (vals.view(len(vals), *weight.shape) * weight).sum(dim=-1)
    corr = sums / packed.fn_cluster_count
    corr[:, 0] = 1.0
    return corr


def interactions_from_occupancy(occu: torch.Tensor, packed: PackedTensors,
                                inter: PackedInteractions) -> torch.Tensor:
    """Cluster-interaction vectors [W, num_orbits] f64 of occupancies [W, N].

    Each cluster's value is its orbit's interaction tensor at the cluster's
    tensor index; an orbit's entry is the sum over its clusters divided by
    its cluster count, and entry 0 is the offset.
    """
    occu = torch.atleast_2d(occu)
    tidx = tensor_indices(occu, packed)  # [W, C]
    vals = inter.inter_flat[inter.cluster_offset + tidx[:, inter.cluster_index]]
    weight = inter.cluster_weight
    sums = (vals.view(len(vals), *weight.shape) * weight).sum(dim=-1)
    out = sums / inter.orbit_cluster_count
    out[:, 0] = inter.offset
    return out
