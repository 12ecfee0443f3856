"""Thinning-window loop of a fused chain, with device records.

Counterpart of ``smol_tpu/ops/mc.py`` ``run_chain_fused`` (:707-739).  The
reference scans the windows inside one jitted program; here a Python loop
runs one chain call per window.  Nothing in the loop waits for the device:
each record is a dict of device tensors, and the records are stacked on
the device at the end.
"""

from __future__ import annotations

import torch

__all__ = ["run_chain_fused"]


def run_chain_fused(state, generator, chain_fn, record_fn, nsamples: int):
    """Run ``nsamples`` chain windows, recording a trace after each.

    ``chain_fn(state, generator) -> state`` runs one thinning window and
    adds its accepted moves to ``state["window_naccept"]``, which is reset
    before every window.  ``record_fn(state) -> dict`` returns tensors that
    no later window modifies.  Returns ``(state, traces)`` with each trace
    entry stacked to [nsamples, W, ...].
    """
    records = []
    for _ in range(int(nsamples)):
        state["window_naccept"] = torch.zeros_like(state["naccept"])
        state = chain_fn(state, generator)
        records.append(record_fn(state))
    state.pop("window_naccept", None)
    if not records:
        return state, {}
    traces = {
        name: torch.stack([rec[name] for rec in records])
        for name in records[0]
    }
    return state, traces
