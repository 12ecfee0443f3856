"""Correlation vectors of a batch of occupancies.

Counterpart of ``smol_tpu/ops/correlations.py`` (``tensor_indices`` :125,
``corr_from_occupancy`` :149).  The reference selects each cluster's tensor
value from precomputed planes, because gathers are slow on a TPU; here the
value is one direct gather and the per-function sums one ``index_add_``.
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
    pair_fn: torch.Tensor  # [P] int64
    pair_cluster: torch.Tensor  # [P] int64
    pair_offset: torch.Tensor  # [P] int64
    fn_cluster_count: torch.Tensor  # [num_corr] f64


def to_device(system: dict, device) -> PackedTensors:
    """Move a system's packed-supercell arrays to ``device``."""

    def ints(name):
        return torch.as_tensor(np.asarray(system[name]), device=device).long()

    def floats(name):
        return torch.as_tensor(
            np.asarray(system[name], dtype=np.float64), device=device
        )

    return PackedTensors(
        num_corr=int(system["num_corr"]),
        cluster_sites=ints("cluster_sites"),
        cluster_strides=ints("cluster_strides"),
        corr_flat=floats("corr_flat"),
        pair_fn=ints("pair_fn"),
        pair_cluster=ints("pair_cluster"),
        pair_offset=ints("pair_offset"),
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
    sums = torch.zeros(
        (occu.shape[0], packed.num_corr), dtype=torch.float64, device=occu.device
    )
    sums.index_add_(1, packed.pair_fn, vals)
    corr = sums / packed.fn_cluster_count
    corr[:, 0] = 1.0
    return corr
