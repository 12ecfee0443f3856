"""The port builds the committed systems itself, without ``smol_tpu``.

``smol_tpu_torch.system.build_system`` (and ``Ensemble.
from_cluster_expansion``) builds a system from the port's own prim,
cluster subspace and expansion.  Each of the 11 Ewald-free system files in
``tests/data`` was exported from ``smol_tpu`` by
``scripts/export_torch_systems.py``; the port's build of the same
expansion on the same supercell must hold every array of the file:
integers exactly, f64 within 1e-12 relative (|diff| <= 1e-12 * max(1,
max |file|)).  The two table-flip files are held here to every key but the
usher's; ``tests/test_torch_build_ewald.py`` builds them with the usher's
keys too, and the Ewald files.  Keys that the export
script adds beside ``export_system`` (a starting occupancy, a Wang-Landau
window, exact enthalpies) are not part of a build.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from smol_tpu_torch.benchmarks.systems import (
    fcc_binary_prim,
    fcc_ternary_prim,
    random_expansion,
    spinel_prim,
)
from smol_tpu_torch.cofe import ClusterExpansion, ClusterSubspace
from smol_tpu_torch.crystal import Lattice, Structure
from smol_tpu_torch.moca.ensemble import Ensemble
from smol_tpu_torch.moca.sampler.sampler import Sampler
from smol_tpu_torch.system import build_system, load_system

DATA = Path(__file__).resolve().parent / "data"
REL_TOL = 1e-12
SCRIPT_KEYS = ("initial_occupancy", "wl_min_enthalpy", "wl_max_enthalpy",
               "wl_bin_size", "exact_enthalpies")
USHER_KEYS = ("flip_table", "usher_dim_ids", "usher_dim_ids_offsets", "site_charges")
BENCH_MUS = {"Li+": 0.1, "vacA0+": 0.0, "Mn3+": 0.05, "Mn4+": 0.0}
SGC_MUS = {"Au": 0.05, "Ag": 0.0, "Cu": -0.05}
Q4_MUS = {"Au": 0.05, "Ag": 0.0, "Cu": -0.05, "Pd": 0.02, "Ni": 0.0, "Pt": 0.03}
ROCKSALT = np.array([[0, 0.5, 0.5], [0.5, 0, 0.5], [0.5, 0.5, 0]])


def _spinel():
    return random_expansion(spinel_prim(), {2: 5.3, 3: 3.7}, seed=11)


def _sgc():
    return random_expansion(fcc_ternary_prim(), {2: 5.5, 3: 4.0}, seed=7)


def _aucu():
    return random_expansion(fcc_binary_prim(), {2: 6.0, 3: 4.0}, seed=7)


def _aucu_nn():
    subspace = ClusterSubspace.from_cutoffs(fcc_binary_prim(), {2: 2.8})
    coefs = np.zeros(subspace.num_corr_functions)
    coefs[-1] = 0.1
    return ClusterExpansion(subspace, coefs)


def _rocksalt_q4():
    prim = Structure(
        Lattice(ROCKSALT * 4.2),
        [{sp: 0.25 for sp in ("Au", "Ag", "Cu", "Pd")}, {"Ni": 0.5, "Pt": 0.5}],
        [[0, 0, 0], [0.5, 0.5, 0.5]],
    )
    return random_expansion(prim, {2: 3.0}, seed=3)


def _small_expansion(prim, cutoffs, seed, scale, constant):
    subspace = ClusterSubspace.from_cutoffs(prim, cutoffs)
    coefs = np.random.default_rng(seed).normal(
        scale=scale, size=subspace.num_corr_functions)
    coefs[0] = constant
    return ClusterExpansion(subspace, coefs)


def _lmof():
    prim = Structure(
        Lattice(ROCKSALT * 4.2),
        [{"Li+": 1 / 3, "Mn3+": 1 / 3}, {"O2-": 0.8, "F-": 0.2}],
        [[0, 0, 0], [0.5, 0.5, 0.5]],
    )
    return _small_expansion(prim, {2: 3.1}, seed=1, scale=0.02, constant=-0.3)


def _limn_tiny():
    prim = Structure(
        Lattice(np.eye(3) * 4.1),
        [{"Li+": 0.5}, {"Mn3+": 0.5, "Mn4+": 0.5}, {"O2-": 1.0}, {"O2-": 1.0}],
        [[0, 0, 0], [0.5, 0.5, 0.5], [0.25, 0.25, 0.25], [0.75, 0.75, 0.75]],
    )
    return _small_expansion(prim, {2: 4.2}, seed=5, scale=0.02, constant=-1.0)


# file stem -> (expansion, supercell diagonal, processor type, chemical potentials),
# as scripts/export_torch_systems.py builds each with smol_tpu
BUILDS = {
    "spinel_2x2x2": (_spinel, 2, "expansion", BENCH_MUS),
    "spinel_3x3x3": (_spinel, 3, "expansion", BENCH_MUS),
    "spinel_cd_2x2x2": (_spinel, 2, "decomposition", BENCH_MUS),
    "sgc_3x3x3": (_sgc, 3, "decomposition", SGC_MUS),
    "sgc_6x6x6": (_sgc, 6, "decomposition", SGC_MUS),
    "sgc_wl_3x3x3": (_sgc, 3, "decomposition", SGC_MUS),
    "aucu_4x4x4": (_aucu, 4, "expansion", None),
    "aucu_wl_3x3x3": (_aucu, 3, "expansion", None),
    "aucu_pt_3x3x3": (_aucu, 3, "decomposition", {"Au": 0.0, "Cu": 0.0}),
    "aucu_nn_2x2x2": (_aucu_nn, 2, "expansion", {"Au": 0.0, "Cu": 0.0}),
    "rocksalt_q4_2x2x2": (_rocksalt_q4, 2, "decomposition", Q4_MUS),
    "lmof_2x2x2": (_lmof, 2, "expansion",
                   {"Li+": 0.1, "Mn3+": -0.2, "vacA0+": 0.0, "O2-": 0.0, "F-": 0.05}),
    "limn_tiny_2x1x1": (_limn_tiny, (2, 1, 1), "expansion",
                        {"Li+": 0.08, "vacA0+": 0.0, "Mn3+": 0.0, "Mn4+": -0.03}),
}
TABLE_FILES = ("lmof_2x2x2", "limn_tiny_2x1x1")


def build(stem):
    make, n, kind, mus = BUILDS[stem]
    return build_system(make(), np.diag(np.broadcast_to(n, 3)), processor_type=kind,
                        chemical_potentials=mus)


def compare(built, stored):
    """``{key: (bit for bit, largest |diff|)}``; raises on a mismatch."""
    skip = SCRIPT_KEYS + (USHER_KEYS if "flip_table" in stored else ())
    expected = sorted(k for k in stored if k not in skip)
    assert sorted(built) == expected
    report = {}
    for key in expected:
        mine, theirs = np.asarray(built[key]), np.asarray(stored[key])
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape, key
        if theirs.dtype.kind == "f":
            diff = float(np.abs(mine - theirs).max(initial=0.0))
            scale = max(1.0, float(np.abs(theirs).max(initial=0.0)))
            assert diff <= REL_TOL * scale, (key, diff)
        else:
            assert np.array_equal(mine, theirs), key
            diff = 0.0
        report[key] = (np.array_equal(mine, theirs), diff)
    return report


@pytest.mark.parametrize("stem", sorted(BUILDS))
def test_build_reproduces_committed_file(stem):
    report = compare(build(stem), load_system(DATA / f"torch_{stem}.npz"))
    assert report


def test_from_cluster_expansion_runs_as_the_file():
    """A short CPU run from the built ensemble equals one from the file."""
    make, n, kind, mus = BUILDS["spinel_2x2x2"]
    built = Ensemble.from_cluster_expansion(
        make(), np.diag([n] * 3), processor_type=kind, chemical_potentials=mus,
        device="cpu")
    stored = Ensemble.from_system(load_system(DATA / "torch_spinel_2x2x2.npz"), "cpu")
    traces = []
    for ensemble in (built, stored):
        sampler = Sampler.from_ensemble(ensemble, temperature=1000.0, nwalkers=16,
                                        seed=3, device="cpu")
        occ = np.random.default_rng(0).integers(0, 2, (16, ensemble.num_sites))
        sampler.run(40, initial_occupancies=occ.astype(np.int32), thin_by=20)
        traces.append((sampler.samples.get_occupancies(flat=False),
                       sampler.samples.get_enthalpies(flat=False)))
    for mine, theirs in zip(*traces):
        np.testing.assert_array_equal(np.asarray(mine), np.asarray(theirs))


def test_from_cluster_expansion_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Ensemble.from_cluster_expansion(_aucu_nn(), np.diag([2, 2, 2]))


def test_unknown_processor_type_raises():
    with pytest.raises(ValueError, match="not supported"):
        build_system(_aucu_nn(), np.diag([2, 2, 2]), processor_type="potts")


def test_missing_chemical_potential_raises():
    with pytest.raises(ValueError, match="missing species"):
        build_system(_aucu_nn(), np.diag([2, 2, 2]), chemical_potentials={"Au": 0.0})


def test_ewald_expansion_raises():
    """``random_expansion(..., ewald=True)`` is ported: its subspace carries
    an Ewald term and its coefficients are the reference's."""
    from smol_tpu.benchmarks.systems import random_expansion as ref_expansion
    from smol_tpu.benchmarks.systems import spinel_prim as ref_spinel_prim
    from smol_tpu_torch.cofe.extern import EwaldTerm

    for coef in (0.1, 0.25):
        mine = random_expansion(spinel_prim(), {2: 5.3, 3: 3.7}, seed=11, ewald=True,
                                ewald_coef=coef)
        theirs = ref_expansion(ref_spinel_prim(), {2: 5.3, 3: 3.7}, seed=11, ewald=True,
                               ewald_coef=coef)
        assert [type(t) for t in mine.cluster_subspace.external_terms] == [EwaldTerm]
        assert len(mine.coefs) == mine.cluster_subspace.num_corr_functions + 1
        np.testing.assert_array_equal(mine.coefs, theirs.coefs)
        assert mine.coefs[-1] == coef
