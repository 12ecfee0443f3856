"""Correlation vectors of a batch of occupancies.

Counterpart of ``smol_tpu/ops/correlations.py`` (``tensor_indices`` :125,
``corr_from_occupancy`` :149).  The reference selects each cluster's tensor
value from precomputed planes, because gathers are slow on a TPU; here the
value is one direct gather, and the functions' sums one reduction over the
(function, cluster) pairs laid out [num_corr, Pmax], each function's run
padded to the longest with pairs of weight zero: a reduction along a
dimension adds in a fixed order on every device, so the same occupancy
gives the same bits in every run (``index_add_`` adds with f64 atomics on
CUDA, in no fixed order).
Correlations are float64, indices int64 (torch's index type).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["PackedTensors", "to_device", "tensor_indices", "corr_from_occupancy"]


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
    pair_fn = np.asarray(system["pair_fn"])
    order = np.argsort(pair_fn, kind="stable")
    counts = np.bincount(pair_fn, minlength=num_corr)
    starts = np.cumsum(counts) - counts
    slot = pair_fn[order] * counts.max() + np.arange(len(order)) - starts[pair_fn[order]]

    def padded(name, dtype):
        flat = np.zeros(num_corr * counts.max(), dtype=dtype)
        flat[slot] = 1 if name is None else np.asarray(system[name])[order]
        return torch.as_tensor(flat, device=device)

    return PackedTensors(
        num_corr=num_corr,
        cluster_sites=ints("cluster_sites"),
        cluster_strides=ints("cluster_strides"),
        corr_flat=floats("corr_flat"),
        pair_cluster=padded("pair_cluster", np.int64),
        pair_offset=padded("pair_offset", np.int64),
        pair_weight=padded(None, np.float64).view(num_corr, -1),
        fn_cluster_count=floats("fn_cluster_count"),
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
