"""Export the bench spinel systems for the PyTorch port.

Builds the LiMn2O4-type spinel cluster expansion that ``bench.py`` runs
(``spinel_prim``, ``random_expansion(..., {2: 5.3, 3: 3.7}, seed=11)``,
the bench chemical potentials) with ``smol_tpu``, and writes each
supercell as a system file that ``smol_tpu_torch`` loads
(``smol_tpu_torch.system``).  The files are committed under
``tests/data``; regenerate them with

    python scripts/export_torch_systems.py

``tests/test_torch_system.py`` checks that a fresh export equals them.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BENCH_MUS = {"Li+": 0.1, "vacA0+": 0.0, "Mn3+": 0.05, "Mn4+": 0.0}
SUPERCELLS = {"2x2x2": 2, "3x3x3": 3}


def spinel_ensemble(n: int):
    """The bench spinel on an n x n x n supercell (expansion processor)."""
    from smol_tpu.benchmarks.systems import random_expansion, spinel_prim
    from smol_tpu.moca import Ensemble

    ce = random_expansion(spinel_prim(), {2: 5.3, 3: 3.7}, seed=11)
    return Ensemble.from_cluster_expansion(
        ce, np.diag([n, n, n]), processor_type="expansion",
        chemical_potentials=BENCH_MUS,
    )


def system_path(name: str) -> Path:
    return ROOT / "tests" / "data" / f"torch_spinel_{name}.npz"


def main():
    sys.path.insert(0, str(ROOT))
    from smol_tpu_torch.system import export_system, save_system

    for name, n in SUPERCELLS.items():
        system = export_system(spinel_ensemble(n))
        save_system(system, system_path(name))
        print(name, system_path(name), system_path(name).stat().st_size, "bytes")


if __name__ == "__main__":
    main()
