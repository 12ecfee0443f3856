"""The port's Wang-Landau swap chain against smol_tpu's on Au-Cu 4x4x4.

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
    aucu4,
)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from export_torch_systems import half_occupancies  # noqa: E402


def test_chain_parity_swaps(aucu4):
    """Au-Cu 4x4x4 at fixed composition: pair sequences, null swaps."""
    ref, port, window = aucu4
    params = _wl_params(window, flatness=0.3, check_period=20)
    occ0 = half_occupancies(64, 128, seed=2)
    _chain_parity(ref, port, params, "swap", occ0, 300, 64, seed=2)
