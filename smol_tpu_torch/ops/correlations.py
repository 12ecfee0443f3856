"""Correlation and cluster-interaction vectors of a batch of occupancies.

Counterpart of ``smol_tpu/ops/correlations.py`` (``tensor_indices`` :125,
``corr_from_occupancy`` :149, ``interactions_from_occupancy`` :159; the
local delta of one flip, ``delta_corr_single_flip`` :270 and
``delta_interactions_single_flip`` :247, is :func:`local_delta`).  The
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
    "LocalEntries",
    "local_entries",
    "local_delta",
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


@dataclass(frozen=True)
class LocalEntries:
    """The entries ((function, cluster) pairs, or clusters) whose cluster
    holds each site, [N, L] with every site's row padded to the longest:
    the per-site rows of the reference's local delta (``_site_block``)."""

    sites: torch.Tensor  # [N, L, K] int64 the entry's cluster sites
    strides: torch.Tensor  # [N, L, K] int64 their strides, 0 a padded slot
    offset: torch.Tensor  # [N, L] int64 start of the entry's tensor
    group: torch.Tensor  # [N, L] int64 its function (or orbit), -1 padding


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


def local_entries(system: dict, entry_cluster, entry_offset, entry_group,
                  device) -> LocalEntries:
    """Each site's local entries: the entries (``entry_cluster`` [E], one
    cluster each, with their tensor starts and groups) whose cluster holds
    the site in a real slot (a nonzero stride), each once, in entry order,
    every site's row padded to the longest (the reference's per-site
    ``lp_*`` and ``loc_*`` tables)."""
    cluster_sites = np.asarray(system["cluster_sites"], dtype=np.int64)
    cluster_strides = np.asarray(system["cluster_strides"], dtype=np.int64)
    entry_cluster = np.asarray(entry_cluster, dtype=np.int64)
    num_sites, num_entries = int(system["num_sites"]), len(entry_cluster)
    slots = np.where(cluster_strides[entry_cluster] != 0,
                     cluster_sites[entry_cluster], -1).ravel()
    owner = np.repeat(np.arange(num_entries), cluster_sites.shape[1])
    key = np.unique(slots[slots >= 0] * num_entries + owner[slots >= 0])
    site, entry = key // num_entries, key % num_entries  # by site, then entry
    order, slot, width = _grouped(site, num_sites)
    entry = entry[order]

    def table(values, fill):
        out = np.full((num_sites * width,) + values.shape[1:], fill, dtype=np.int64)
        out[slot] = values
        return torch.as_tensor(out.reshape((num_sites, width) + values.shape[1:]),
                               device=device)

    cluster = entry_cluster[entry]
    return LocalEntries(
        sites=table(cluster_sites[cluster], 0),
        strides=table(cluster_strides[cluster], 0),
        offset=table(np.asarray(entry_offset, dtype=np.int64)[entry], 0),
        group=table(np.asarray(entry_group, dtype=np.int64)[entry], -1),
    )


def local_delta(occu: torch.Tensor, site: torch.Tensor, new_code: torch.Tensor,
                local: LocalEntries, flat: torch.Tensor,
                group_count: torch.Tensor) -> torch.Tensor:
    """Feature changes [W, G] f64 of one flip a walker, from the flipped
    site's local entries alone (the reference's ``_local_delta_vals`` and
    its per-group sums, ``delta_corr_single_flip`` :270,
    ``delta_interactions_single_flip`` :247).

    Each local entry's value after the flip less its value before, a site
    repeated in a cluster (a small supercell) taking the new code in every
    slot; summed by group in entry order, a reduction along one dimension,
    and divided by the group's cluster count.  Entry 0 is 0.
    """
    occu = torch.atleast_2d(occu).long()
    site, new_code = site.long(), new_code.long()
    walkers = torch.arange(len(occu), device=occu.device)[:, None, None]
    sites, strides = local.sites[site], local.strides[site]  # [W, L, K]
    codes = occu[walkers, sites]
    flipped = torch.where(sites == site[:, None, None], new_code[:, None, None], codes)
    offset, group = local.offset[site], local.group[site]  # [W, L]
    dvals = (flat[offset + (flipped * strides).sum(dim=-1)]
             - flat[offset + (codes * strides).sum(dim=-1)])
    groups = torch.arange(len(group_count), device=occu.device)
    in_group = group[:, :, None] == groups  # [W, L, G]; padding (-1) in none
    sums = torch.where(in_group, dvals[:, :, None], 0.0).sum(dim=1)
    out = sums / group_count
    out[:, 0] = 0.0
    return out
