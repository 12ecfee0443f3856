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
  3: 4.0}, seed=7)``), with a half-Au, half-Cu ``initial_occupancy`` and a
  Wang-Landau window for swaps at that composition (``wl_min_enthalpy``,
  ``wl_max_enthalpy``, ``wl_bin_size``: ``bench.py``'s scheme on 64 random
  half-and-half occupancies from ``default_rng(1)``);
- ``torch_aucu_wl_3x3x3.npz``: ``bench.py``'s ``wang-landau`` config, the
  same expansion on 3x3x3 (27 sites) without chemical potentials, for
  Wang-Landau flips, with the window the bench derives from its first 64
  starting occupancies (``default_rng(0).integers(0, 2, (2048, 27))``):
  five times their enthalpy span in about 250 bins;
- ``torch_aucu_nn_2x2x2.npz``: the 8-site Au-Cu FCC with only the
  nearest-neighbour pair interaction (0.1 eV) and zero chemical
  potentials, whose density of states is countable, with the
  ``exact_enthalpies`` of its 256 states in the order of
  ``itertools.product((0, 1), repeat=8)``;
- ``torch_spinel_ewald_sgc_{2x2x2,3x3x3}.npz``: ``bench.py``'s
  ``spinel-ewald`` config, the spinel CE + Ewald with the bench chemical
  potentials, for charge-neutral semigrand table flips: the ``TableFlip``
  usher's flip table and dimension ids, the site charges and a
  charge-neutral ``initial_occupancy``;
- ``torch_lmof_2x2x2.npz``: a small Li+/Mn3+/vacancy, O2-/F- rocksalt
  whose charge-neutral flips recolor up to three sites (the table chain's
  multi-slot case), with a charge-neutral ``initial_occupancy``;
- ``torch_limn_tiny_2x1x1.npz``: a {Li+, vacancy} x {Mn3+, Mn4+} cell with
  fixed O2-, small enough to enumerate its charge-neutral states;
- ``torch_sqs_fcc8.npz``: ``bench.py``'s ``sqs`` config, the 20 supercell
  shapes of 8 sites that ``StochasticSQSGenerator.from_structure(
  fcc_binary_prim(), {2: 5.0, 3: 3.5}, supercell_size=8)`` enumerates, in
  its order and after its re-padding of the local tables, one distance
  system each (``smol_tpu_torch.system.save_systems``);
- ``torch_sqs_fcc_4x4x4.npz``: the same subspace and generator defaults on
  the 64-site ``diag(4, 4, 4)`` supercell, the SQS users build for a 50/50
  FCC alloy;
- ``torch_sgc_6x6x6.npz``: ``bench.py``'s ``sgc`` config, the ternary
  Au-Ag-Cu FCC (``fcc_ternary_prim``, ``random_expansion(..., {2: 5.5,
  3: 4.0}, seed=7)``) on 6x6x6 (216 sites) with its chemical potentials
  (Au 0.05, Ag 0, Cu -0.05), built as the bench builds it, with
  ``from_cluster_expansion``'s default cluster-decomposition processor;
  the bench's starts are ``default_rng(0)``'s uniform codes,
  ``smol_tpu_torch.moca.ensemble.random_occupancies(ensemble, 8192, 0)``;
- ``torch_sgc_3x3x3.npz``: the same on 3x3x3, for the CPU tests;
- ``torch_spinel_cd_2x2x2.npz``: the semigrand bench spinel 2x2x2 in the
  decomposition form that ``bench.py`` builds (its features are the
  cluster interactions, its natural parameters the orbit multiplicities);
- ``torch_aucu_pt_3x3x3.npz``: ``bench.py``'s ``tempering`` config, the
  binary Au-Cu FCC expansion of ``canonical`` on 3x3x3 (27 sites) with
  zero chemical potentials (Au 0, Cu 0), built as the bench builds it,
  with the default cluster-decomposition processor; the bench's starts
  are ``default_rng(0).integers(0, 2, (8192, 27))`` on the ladder
  ``make_temperature_ladder(300, 3000, 8192)``.

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
WANG_LANDAU = ("aucu_wl_3x3x3", "aucu_nn_2x2x2")  # the Wang-Landau files
TABLE = {  # file stem -> (system, its argument) of the table-flip files
    "spinel_ewald_sgc_2x2x2": ("spinel_ewald_sgc", 2),
    "spinel_ewald_sgc_3x3x3": ("spinel_ewald_sgc", 3),
    "lmof_2x2x2": ("lmof", (2, 2, 2)),
    "limn_tiny_2x1x1": ("limn_tiny", None),
}
SQS = ("sqs_fcc8", "sqs_fcc_4x4x4")  # the distance (SQS) files
SQS_CUTOFFS = {2: 5.0, 3: 3.5}  # bench.py's sqs config
SGC_MUS = {"Au": 0.05, "Ag": 0.0, "Cu": -0.05}  # bench.py's sgc config
DECOMPOSITION = {  # file stem -> (system, supercell edge), as bench.py builds them
    "sgc_6x6x6": ("sgc", 6),
    "sgc_3x3x3": ("sgc", 3),
    "spinel_cd_2x2x2": ("spinel_cd", 2),
    "aucu_pt_3x3x3": ("aucu_pt", 3),
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


def sgc_ensemble(n: int):
    """``bench.py``'s ``sgc`` on an n x n x n supercell (decomposition
    processor, the default, as the bench builds it)."""
    from smol_tpu.benchmarks.systems import fcc_ternary_prim, random_expansion
    from smol_tpu.moca import Ensemble

    ce = random_expansion(fcc_ternary_prim(), {2: 5.5, 3: 4.0}, seed=7)
    return Ensemble.from_cluster_expansion(
        ce, np.diag([n, n, n]), chemical_potentials=SGC_MUS
    )


def spinel_cd_ensemble(n: int):
    """The bench spinel on an n x n x n supercell as ``bench.py`` builds it
    (decomposition processor)."""
    from smol_tpu.benchmarks.systems import random_expansion, spinel_prim
    from smol_tpu.moca import Ensemble

    ce = random_expansion(spinel_prim(), {2: 5.3, 3: 3.7}, seed=11)
    return Ensemble.from_cluster_expansion(
        ce, np.diag([n, n, n]), chemical_potentials=BENCH_MUS
    )


def aucu_pt_ensemble(n: int):
    """``bench.py``'s ``tempering`` on an n x n x n supercell: the bench Au-Cu
    expansion with zero chemical potentials (decomposition processor, the
    default, as the bench builds it)."""
    from smol_tpu.benchmarks.systems import fcc_binary_prim, random_expansion
    from smol_tpu.moca import Ensemble

    ce = random_expansion(fcc_binary_prim(), {2: 6.0, 3: 4.0}, seed=7)
    return Ensemble.from_cluster_expansion(
        ce, np.diag([n, n, n]), chemical_potentials={"Au": 0.0, "Cu": 0.0}
    )


def decomposition_system(stem: str) -> dict:
    """The system dict of one decomposition-form file."""
    from smol_tpu_torch.system import export_system

    kind, n = DECOMPOSITION[stem]
    build = {"sgc": sgc_ensemble, "spinel_cd": spinel_cd_ensemble,
             "aucu_pt": aucu_pt_ensemble}[kind]
    return export_system(build(n))


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


def aucu_nn_ensemble():
    """8-site Au-Cu FCC, nearest-neighbour pair only, zero chemical potentials."""
    from smol_tpu.benchmarks.systems import fcc_binary_prim
    from smol_tpu.cofe import ClusterSubspace
    from smol_tpu.cofe.expansion import ClusterExpansion
    from smol_tpu.moca import Ensemble

    subspace = ClusterSubspace.from_cutoffs(fcc_binary_prim(), {2: 2.8})
    coefs = np.zeros(subspace.num_corr_functions)
    coefs[-1] = 0.1
    return Ensemble.from_cluster_expansion(
        ClusterExpansion(subspace, coefs), np.diag([2, 2, 2]),
        processor_type="expansion", chemical_potentials={"Au": 0.0, "Cu": 0.0},
    )


def enthalpies(ensemble, occupancies) -> np.ndarray:
    """features . natural parameters of each occupancy, f64."""
    return np.array([
        float(ensemble.compute_feature_vector(occ) @ ensemble.natural_parameters)
        for occ in occupancies
    ])


def wl_window(probe: np.ndarray) -> dict:
    """``bench.py``'s Wang-Landau window around probe enthalpies: five
    times their span (plus 1e-3), in bins of a fiftieth of it."""
    span = probe.max() - probe.min() + 1e-3
    return {
        "wl_min_enthalpy": np.float64(probe.min() - 2 * span),
        "wl_max_enthalpy": np.float64(probe.max() + 2 * span),
        "wl_bin_size": np.float64(span / 50),
    }


def half_occupancies(num_sites: int, count: int, seed: int) -> np.ndarray:
    """``count`` occupancies [count, N] int32 with code 1 on a random half."""
    rng = np.random.default_rng(seed)
    occ = np.zeros((count, num_sites), dtype=np.int32)
    for row in occ:
        row[rng.choice(num_sites, num_sites // 2, replace=False)] = 1
    return occ


def wang_landau_system(stem: str) -> dict:
    """The system dict of one Wang-Landau file."""
    from itertools import product

    from smol_tpu_torch.system import export_system

    if stem == "aucu_wl_3x3x3":
        ensemble = aucu_ensemble(3)
        system = export_system(ensemble)
        starts = np.random.default_rng(0).integers(
            0, 2, (2048, ensemble.num_sites)).astype(np.int32)
        system.update(wl_window(enthalpies(ensemble, starts[:64])))
        return system
    ensemble = aucu_nn_ensemble()
    system = export_system(ensemble)
    states = np.array(list(product((0, 1), repeat=8)), dtype=np.int32)
    system["exact_enthalpies"] = enthalpies(ensemble, states)
    return system


def _small_expansion(prim, cutoffs, seed, scale, constant):
    from smol_tpu.cofe import ClusterSubspace
    from smol_tpu.cofe.expansion import ClusterExpansion

    subspace = ClusterSubspace.from_cutoffs(prim, cutoffs)
    coefs = np.random.default_rng(seed).normal(
        scale=scale, size=subspace.num_corr_functions
    )
    coefs[0] = constant
    return ClusterExpansion(subspace, coefs)


def lmof_ensemble(cell=(2, 2, 2)):
    """Li+/Mn3+/vacancy and O2-/F- on a rocksalt, semigrand: its
    charge-neutral flips take up to three site recolorings."""
    from smol_tpu.crystal import Lattice, Structure
    from smol_tpu.moca import Ensemble

    lat = Lattice(np.array([[0, 0.5, 0.5], [0.5, 0, 0.5], [0.5, 0.5, 0]]) * 4.2)
    prim = Structure(
        lat,
        [{"Li+": 1 / 3, "Mn3+": 1 / 3}, {"O2-": 0.8, "F-": 0.2}],
        [[0, 0, 0], [0.5, 0.5, 0.5]],
    )
    ce = _small_expansion(prim, {2: 3.1}, seed=1, scale=0.02, constant=-0.3)
    mus = {"Li+": 0.1, "Mn3+": -0.2, "vacA0+": 0.0, "O2-": 0.0, "F-": 0.05}
    return Ensemble.from_cluster_expansion(
        ce, np.diag(cell), processor_type="expansion", chemical_potentials=mus
    )


def limn_tiny_ensemble():
    """{Li+, vacancy} x {Mn3+, Mn4+} with fixed O2- on a 2x1x1 cubic cell."""
    from smol_tpu.crystal import Lattice, Structure
    from smol_tpu.moca import Ensemble

    prim = Structure(
        Lattice(np.eye(3) * 4.1),
        [{"Li+": 0.5}, {"Mn3+": 0.5, "Mn4+": 0.5}, {"O2-": 1.0}, {"O2-": 1.0}],
        [[0, 0, 0], [0.5, 0.5, 0.5], [0.25, 0.25, 0.25], [0.75, 0.75, 0.75]],
    )
    ce = _small_expansion(prim, {2: 4.2}, seed=5, scale=0.02, constant=-1.0)
    mus = {"Li+": 0.08, "vacA0+": 0.0, "Mn3+": 0.0, "Mn4+": -0.03}
    return Ensemble.from_cluster_expansion(
        ce, np.diag([2, 1, 1]), processor_type="expansion", chemical_potentials=mus
    )


def spinel_ewald_sgc_ensemble(n: int):
    """``bench.py``'s ``spinel-ewald``: the spinel CE + Ewald, semigrand."""
    from smol_tpu.benchmarks.systems import random_expansion, spinel_prim
    from smol_tpu.moca import Ensemble

    ce = random_expansion(spinel_prim(), {2: 5.3, 3: 3.7}, seed=11, ewald=True)
    return Ensemble.from_cluster_expansion(
        ce, np.diag([n, n, n]), processor_type="expansion",
        chemical_potentials=BENCH_MUS,
    )


def lmof_initial_occupancy(ensemble) -> np.ndarray:
    """Half Li+, half Mn3+ on the cation sites, O2- on the anion sites."""
    cations = np.asarray(ensemble.sublattices[0].sites)
    occ = np.zeros(ensemble.num_sites, dtype=np.int32)
    occ[cations[len(cations) // 2:]] = 1
    return occ


def table_system(stem: str) -> dict:
    """The system dict of one table-flip file: usher data included."""
    from smol_tpu.moca.kernel.tableflip import TableFlip
    from smol_tpu_torch.system import export_system

    kind, arg = TABLE[stem]
    ensemble = {
        "spinel_ewald_sgc": spinel_ewald_sgc_ensemble,
        "lmof": lmof_ensemble,
        "limn_tiny": lambda _: limn_tiny_ensemble(),
    }[kind](arg)
    system = export_system(ensemble, usher=TableFlip(ensemble.sublattices))
    if kind == "spinel_ewald_sgc":
        system["initial_occupancy"] = initial_occupancy("spinel_ewald", ensemble)
    elif kind == "lmof":
        system["initial_occupancy"] = lmof_initial_occupancy(ensemble)
    return system


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
    if kind == "aucu":
        probe = half_occupancies(ensemble.num_sites, 64, seed=1)
        system.update(wl_window(enthalpies(ensemble, probe)))
    return system


def sqs_generator(stem: str):
    """The ``smol_tpu`` SQS generator of one distance file."""
    from smol_tpu.benchmarks.systems import fcc_binary_prim
    from smol_tpu.capp import StochasticSQSGenerator

    if stem == "sqs_fcc8":
        return StochasticSQSGenerator.from_structure(
            fcc_binary_prim(), SQS_CUTOFFS, supercell_size=8)
    return StochasticSQSGenerator.from_structure(
        fcc_binary_prim(), SQS_CUTOFFS, supercell_size=64,
        supercell_matrices=[np.diag([4, 4, 4])])


def sqs_systems(stem: str) -> list[dict]:
    """The distance system of each shape of one SQS file, in order."""
    from smol_tpu_torch.system import export_distance_system

    return [export_distance_system(p) for p in sqs_generator(stem).processors]


def data_path(stem: str) -> Path:
    return ROOT / "tests" / "data" / f"torch_{stem}.npz"


def system_path(name: str) -> Path:
    """The semigrand spinel file of supercell ``name`` (``"2x2x2"``)."""
    return data_path(f"spinel_{name}")


def main():
    sys.path.insert(0, str(ROOT))
    from smol_tpu_torch.system import export_system, save_system, save_systems

    systems = {f"spinel_{name}": (lambda n=n: export_system(spinel_ensemble(n)))
               for name, n in SUPERCELLS.items()}
    systems.update({stem: (lambda s=stem: canonical_system(s)) for stem in CANONICAL})
    systems.update({stem: (lambda s=stem: table_system(s)) for stem in TABLE})
    systems.update({stem: (lambda s=stem: wang_landau_system(s)) for stem in WANG_LANDAU})
    systems.update({stem: (lambda s=stem: decomposition_system(s)) for stem in DECOMPOSITION})
    for stem, build in systems.items():
        save_system(build(), data_path(stem))
        print(stem, data_path(stem), data_path(stem).stat().st_size, "bytes")
    for stem in SQS:
        shapes = sqs_systems(stem)
        if len(shapes) == 1:
            save_system(shapes[0], data_path(stem))
        else:
            save_systems(shapes, data_path(stem))
        print(stem, data_path(stem), data_path(stem).stat().st_size, "bytes")


if __name__ == "__main__":
    main()
