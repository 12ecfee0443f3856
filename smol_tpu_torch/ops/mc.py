"""Thinning-window loop of a fused chain, with device records.

Counterpart of ``smol_tpu/ops/mc.py`` ``run_chain_fused`` (:707-739).  The
reference scans the windows inside one jitted program; here a Python loop
runs one chain call per window.  Nothing in the loop waits for the device:
each record is copied into the launch's stack, one tensor per traced
quantity allocated at the first record, on the device where it lives.
"""

from __future__ import annotations

import torch

__all__ = ["run_chain_fused"]


def run_chain_fused(state, generator, chain_fn, record_fn, nsamples: int):
    """Run ``nsamples`` chain windows, recording a trace after each.

    ``chain_fn(state, generator) -> state`` runs one thinning window and
    adds its accepted moves to ``state["window_naccept"]``, which is reset
    before every window.  ``record_fn(state) -> dict`` returns the tensors
    of one record; they are copied into the stack before the next window,
    so they may be views of the state.  Returns ``(state, traces)`` with
    each trace entry a stack [nsamples, W, ...].
    """
    traces = {}
    for i in range(int(nsamples)):
        state["window_naccept"] = torch.zeros_like(state["naccept"])
        state = chain_fn(state, generator)
        record = record_fn(state)
        if not traces:
            traces = {
                name: torch.empty((int(nsamples), *value.shape), dtype=value.dtype,
                                  device=value.device)
                for name, value in record.items()
            }
        for name, value in record.items():
            traces[name][i].copy_(value)
    state.pop("window_naccept", None)
    return state, traces
