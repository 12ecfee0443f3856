"""Reductions over buffered sample segments, where the samples live.

Counterpart of ``smol_tpu/ops/reductions.py`` (:65-184).  The sample
container keeps record batches on the device (or, past its cap, on the
host); these helpers reduce each segment where it lives and combine the
partial sums on the first one's device, so only the per-walker (or
pooled) results are copied to the host, once.  Two-pass
mean and variance: the squared deviations are taken against the final
mean.

``segments`` is a list of tensors [k, W, ...] covering the sample axis in
order; ``masks`` holds one boolean host array [k] per segment selecting
rows; ``rows`` is the number of selected rows.  With ``pool_walkers`` the
walker axis is reduced too (flat getters).  Results are host float64
arrays.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "masked_mean_segments",
    "masked_min_segments",
    "masked_sqdev_segments",
    "masked_stats_segments",
]


def _selected(values, mask):
    """The mask-selected rows of one segment as f64, on its device."""
    index = torch.as_tensor(np.flatnonzero(mask), device=values.device)
    return values.index_select(0, index).to(torch.float64)


def _count(segments, rows, pool):
    return rows * segments[0].shape[1] if pool else rows


def _sum(x, pool):
    total = x.sum(dim=0)
    return total.sum(dim=0) if pool else total


def _min(x, pool):
    low = x.min(dim=0).values
    return low.min(dim=0).values if pool else low


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _partials(segments, masks):
    for values, mask in zip(segments, masks):
        if np.any(mask):
            yield _selected(values, mask)


def _add(total, part):
    """total + part, on the device of the first part (segments may lie on
    the card or, once moved, on the host)."""
    if isinstance(total, torch.Tensor):
        part = part.to(total.device)
    return total + part


def _mean(segments, masks, rows, pool):
    total = 0.0
    for x in _partials(segments, masks):
        total = _add(total, _sum(x, pool))
    return total / _count(segments, rows, pool)


def _low(segments, masks, pool):
    low = None
    for x in _partials(segments, masks):
        part = _min(x, pool)
        low = part if low is None else torch.minimum(low, part.to(low.device))
    return low


def _sqdev(segments, masks, rows, mean, pool):
    total = 0.0
    for x in _partials(segments, masks):
        center = torch.as_tensor(mean, dtype=torch.float64, device=x.device)
        total = _add(total, _sum((x - center) ** 2, pool))
    return total / _count(segments, rows, pool)


def masked_mean_segments(segments, masks, rows, pool_walkers=True):
    """Mean over the selected rows of ``segments``."""
    return _host(_mean(segments, masks, rows, pool_walkers))


def masked_min_segments(segments, masks, pool_walkers=True):
    """Minimum over the selected rows of ``segments``."""
    return _host(_low(segments, masks, pool_walkers))


def masked_sqdev_segments(segments, masks, rows, mean, pool_walkers=True):
    """Mean squared deviation from ``mean`` over the selected rows."""
    return _host(_sqdev(segments, masks, rows, mean, pool_walkers))


def masked_stats_segments(segments, masks, rows, pool_walkers=True):
    """(mean, variance, min) over the selected rows, synced once at the end."""
    mean = _mean(segments, masks, rows, pool_walkers)
    sqdev = _sqdev(segments, masks, rows, mean, pool_walkers)
    low = _low(segments, masks, pool_walkers)
    return _host(mean), _host(sqdev), _host(low)
