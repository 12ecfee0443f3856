"""The port's Wang-Landau flip chain against smol_tpu's at the bench's window.

Moved whole from ``tests/test_torch_wanglandau.py``, whose helpers and
fixtures it imports, so that ``--dist loadfile`` runs it on a worker of its
own.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_wanglandau import (  # noqa: E402, F401 (fixtures)
    _chain_parity,
    _wl_params,
    bench,
)


def test_chain_parity_flips_bench_window(bench):
    """Au-Cu 3x3x3 at the bench's ~250 bins, two blocks of 64 walkers."""
    ref, port, window = bench
    params = _wl_params(window, flatness=0.3, check_period=20)
    assert params["num_levels"] >= 250
    occ0 = np.random.default_rng(0).integers(0, 2, (128, 27)).astype(np.int32)
    _chain_parity(ref, port, params, "flip", occ0, 300, 64, seed=1)
