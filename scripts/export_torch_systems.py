"""Export the bench systems for the PyTorch port.

Builds with ``smol_tpu`` the cluster expansions that ``bench.py`` runs and
writes each supercell as a system file that ``smol_tpu_torch`` loads
(``smol_tpu_torch.system``):

- ``torch_spinel_{2x2x2,3x3x3}.npz``: the LiMn2O4-type spinel
  (``spinel_prim``, ``random_expansion(..., {2: 5.3, 3: 3.7}, seed=11)``)
  with the bench chemical potentials, for semigrand flips;
- ``torch_spinel_ewald_{2x2x2,3x3x3}.npz``: the same spinel with an Ewald
  term (``ewald=True``), no chemical potentials (canonical swaps), and a
  charge-neutral ``initial_occupancy`` drawn as ``bench.py`` draws it;
- ``torch_aucu_4x4x4.npz``: the binary Au-Cu FCC of ``bench.py``'s
  ``canonical`` config (``random_expansion(fcc_binary_prim(), {2: 6.0,
  3: 4.0}, seed=7)``), with a half-Au, half-Cu ``initial_occupancy``.

The files are committed under ``tests/data``; regenerate them with

    python scripts/export_torch_systems.py

``tests/test_torch_system.py`` checks that a fresh export equals them.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BENCH_MUS = {"Li+": 0.1, "vacA0+": 0.0, "Mn3+": 0.05, "Mn4+": 0.0}
SUPERCELLS = {"2x2x2": 2, "3x3x3": 3}  # the semigrand spinel files
CANONICAL = {  # file stem -> (system, supercell edge) of the canonical files
    "spinel_ewald_2x2x2": ("spinel_ewald", 2),
    "spinel_ewald_3x3x3": ("spinel_ewald", 3),
    "aucu_4x4x4": ("aucu", 4),
}


def spinel_ensemble(n: int):
    """The bench spinel on an n x n x n supercell (expansion processor)."""
    from smol_tpu.benchmarks.systems import random_expansion, spinel_prim
    from smol_tpu.moca import Ensemble

    ce = random_expansion(spinel_prim(), {2: 5.3, 3: 3.7}, seed=11)
    return Ensemble.from_cluster_expansion(
        ce, np.diag([n, n, n]), processor_type="expansion",
        chemical_potentials=BENCH_MUS,
    )


def spinel_ewald_ensemble(n: int):
    """The spinel CE + Ewald on an n x n x n supercell, canonical."""
    from smol_tpu.benchmarks.systems import random_expansion, spinel_prim
    from smol_tpu.moca import Ensemble

    ce = random_expansion(spinel_prim(), {2: 5.3, 3: 3.7}, seed=11, ewald=True)
    return Ensemble.from_cluster_expansion(
        ce, np.diag([n, n, n]), processor_type="expansion"
    )


def aucu_ensemble(n: int):
    """The bench binary Au-Cu FCC on an n x n x n supercell, canonical."""
    from smol_tpu.benchmarks.systems import fcc_binary_prim, random_expansion
    from smol_tpu.moca import Ensemble

    ce = random_expansion(fcc_binary_prim(), {2: 6.0, 3: 4.0}, seed=7)
    return Ensemble.from_cluster_expansion(
        ce, np.diag([n, n, n]), processor_type="expansion"
    )


def initial_occupancy(kind: str, ensemble) -> np.ndarray:
    """The starting occupancy of a canonical file, from ``default_rng(0)``.

    The spinel takes a random charge-neutral occupancy (``bench.py``'s
    ``spinel-ewald`` start); Au-Cu puts code 1 on a random half of the
    sites (``bench.py``'s ``canonical`` start).
    """
    rng = np.random.default_rng(0)
    if kind == "spinel_ewald":
        from smol_tpu.capp.generate.random import generate_random_ordered_occupancy

        occ = generate_random_ordered_occupancy(
            ensemble.processor, charge_neutral=True, rng=rng
        )
        return np.asarray(occ, dtype=np.int32)
    n = ensemble.num_sites
    occ = np.zeros(n, dtype=np.int32)
    occ[rng.choice(n, n // 2, replace=False)] = 1
    return occ


def canonical_system(stem: str) -> dict:
    """The system dict of one canonical file, initial occupancy included."""
    from smol_tpu_torch.system import export_system

    kind, n = CANONICAL[stem]
    ensemble = {"spinel_ewald": spinel_ewald_ensemble, "aucu": aucu_ensemble}[kind](n)
    system = export_system(ensemble)
    system["initial_occupancy"] = initial_occupancy(kind, ensemble)
    return system


def data_path(stem: str) -> Path:
    return ROOT / "tests" / "data" / f"torch_{stem}.npz"


def system_path(name: str) -> Path:
    """The semigrand spinel file of supercell ``name`` (``"2x2x2"``)."""
    return data_path(f"spinel_{name}")


def main():
    sys.path.insert(0, str(ROOT))
    from smol_tpu_torch.system import export_system, save_system

    systems = {f"spinel_{name}": (lambda n=n: export_system(spinel_ensemble(n)))
               for name, n in SUPERCELLS.items()}
    systems.update({stem: (lambda s=stem: canonical_system(s)) for stem in CANONICAL})
    for stem, build in systems.items():
        save_system(build(), data_path(stem))
        print(stem, data_path(stem), data_path(stem).stat().st_size, "bytes")


if __name__ == "__main__":
    main()
