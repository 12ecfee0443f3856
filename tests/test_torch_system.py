"""The port's system files and its independence from JAX.

- a fresh ``export_system`` of the bench spinel, built with ``smol_tpu``,
  equals the committed ``tests/data/torch_spinel_*.npz`` array for array
  (so the files cannot go stale), and the exporter's local-cluster arrays
  equal ``smol_tpu.ops.fastmc.site_local_arrays`` exactly; so does a
  fresh export of each canonical system (spinel CE + Ewald 2x2x2 and
  3x3x3, Au-Cu 4x4x4), initial occupancy included, and of each table-flip
  system (the semigrand spinel CE + Ewald 2x2x2 and 3x3x3, the multi-slot
  rocksalt and the tiny enumeration cell) with its flip table, dimension
  ids and site charges, and of each Wang-Landau system (Au-Cu 3x3x3 with
  the bench's window, the 8-site nearest-neighbour cell with its exact
  enthalpies), and of each SQS file (the bench's 20 shapes of 8 sites, in
  its generator's order, and the 64-site shape) shape for shape, and of
  each decomposition-form system (bench ``sgc`` 6x6x6 and 3x3x3, the bench
  spinel 2x2x2), which the port loads with its decomposition processor;
- the exporter refuses a processor the port cannot evaluate, alone or as
  the expansion part of a composite;
- with ``jax`` blocked from importing, a subprocess imports the port and
  runs short CPU slices from the system files, semigrand flips,
  canonical swaps with Ewald, table flips, Wang-Landau flips, an SQS
  search and ternary flips on ``sgc`` with the q-ary body;
- neither ``chip_smoke.py`` nor any module of ``smol_tpu_torch`` imports
  ``jax`` or ``smol_tpu``.
"""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from smol_tpu.ops.fastmc import site_local_arrays
from smol_tpu_torch.system import export_system, load_system, load_systems, save_system

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
from export_torch_systems import (  # noqa: E402
    CANONICAL,
    DECOMPOSITION,
    SQS,
    SUPERCELLS,
    TABLE,
    WANG_LANDAU,
    canonical_system,
    data_path,
    decomposition_system,
    spinel_ensemble,
    sqs_systems,
    system_path,
    table_system,
    wang_landau_system,
)


@pytest.fixture(scope="module", params=sorted(SUPERCELLS))
def bench_spinel(request):
    name = request.param
    return name, spinel_ensemble(SUPERCELLS[name])


def test_committed_system_matches_fresh_export(bench_spinel):
    name, ensemble = bench_spinel
    fresh = export_system(ensemble)
    committed = load_system(system_path(name))
    assert sorted(fresh) == sorted(committed)
    for key, value in fresh.items():
        stored = committed[key]
        assert stored.dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(stored, value, err_msg=key)


@pytest.mark.parametrize("stem", sorted(CANONICAL))
def test_committed_canonical_system_matches_fresh_export(stem):
    fresh = canonical_system(stem)
    committed = load_system(data_path(stem))
    assert sorted(fresh) == sorted(committed)
    assert "chemical_potential_table" not in committed
    assert ("ewald_matrix" in committed) == stem.startswith("spinel_ewald")
    for key, value in fresh.items():
        stored = committed[key]
        assert stored.dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(stored, value, err_msg=key)


@pytest.mark.parametrize("stem", sorted(TABLE))
def test_committed_table_system_matches_fresh_export(stem):
    fresh = table_system(stem)
    committed = load_system(data_path(stem))
    assert sorted(fresh) == sorted(committed)
    assert {"flip_table", "usher_dim_ids", "usher_dim_ids_offsets", "site_charges",
            "chemical_potential_table"} <= set(committed)
    assert ("ewald_matrix" in committed) == stem.startswith("spinel_ewald")
    for key, value in fresh.items():
        stored = committed[key]
        assert stored.dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(stored, value, err_msg=key)
    # the flip vectors keep the charge, and a stored start is neutral
    charges = committed["site_charges"]
    dim_charge = np.zeros(committed["flip_table"].shape[1])
    subs = np.split(committed["sublattice_sites"],
                    committed["sublattice_sites_offsets"][1:-1])
    dims = np.split(committed["usher_dim_ids"], committed["usher_dim_ids_offsets"][1:-1])
    for sites, ids in zip(subs, dims):
        dim_charge[ids] = charges[sites[0], : len(ids)]
    assert np.all(committed["flip_table"] @ dim_charge == 0)
    if "initial_occupancy" in committed:
        occ = committed["initial_occupancy"]
        assert charges[np.arange(len(occ)), occ].sum() == 0


@pytest.mark.parametrize("stem", sorted(WANG_LANDAU))
def test_committed_wang_landau_system_matches_fresh_export(stem):
    fresh = wang_landau_system(stem)
    committed = load_system(data_path(stem))
    assert sorted(fresh) == sorted(committed)
    for key, value in fresh.items():
        stored = committed[key]
        assert stored.dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(stored, value, err_msg=key)
    if stem == "aucu_wl_3x3x3":  # the bench's window: about 250 bins
        assert "chemical_potential_table" not in committed
        width = committed["wl_max_enthalpy"] - committed["wl_min_enthalpy"]
        assert 249 < width / committed["wl_bin_size"] <= 250
    else:  # 256 states on six levels, zero chemical potentials
        assert not committed["chemical_potential_table"].any()
        levels, counts = np.unique(np.round(committed["exact_enthalpies"], 9),
                                   return_counts=True)
        assert counts.tolist() == [6, 96, 88, 48, 16, 2]


@pytest.mark.parametrize("stem", SQS)
def test_committed_sqs_systems_match_fresh_export(stem):
    fresh = sqs_systems(stem)
    committed = load_systems(data_path(stem))
    assert len(fresh) == len(committed) == (20 if stem == "sqs_fcc8" else 1)
    for shape, (mine, stored) in enumerate(zip(fresh, committed)):
        assert sorted(mine) == sorted(stored), shape
        for key, value in mine.items():
            assert stored[key].dtype == np.asarray(value).dtype, (shape, key)
            np.testing.assert_array_equal(stored[key], value, err_msg=f"{shape} {key}")
    matrices = {tuple(map(tuple, s["supercell_matrix"])) for s in committed}
    assert len(matrices) == len(committed)  # distinct shapes
    assert all(round(abs(np.linalg.det(s["supercell_matrix"]))) == s["size"] for s in committed)


@pytest.mark.parametrize("stem", sorted(DECOMPOSITION))
def test_committed_decomposition_system_matches_fresh_export(stem):
    from smol_tpu_torch.moca.ensemble import Ensemble as TorchEnsemble
    from smol_tpu_torch.moca.processor.expansion import ClusterDecompositionProcessor

    fresh = decomposition_system(stem)
    committed = load_system(data_path(stem))
    assert sorted(fresh) == sorted(committed)
    for key, value in fresh.items():
        stored = committed[key]
        assert stored.dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(stored, value, err_msg=key)
    assert str(committed["processor_type"]) == "decomposition"
    assert "chemical_potential_table" in committed and "ewald_matrix" not in committed
    num_orbits = len(committed["orbit_cluster_count"])
    assert committed["num_energy_coefs"] == num_orbits
    assert committed["natural_parameters"][-1] == -1.0  # the chemical work
    ensemble = TorchEnsemble.from_system(committed, "cpu")
    assert isinstance(ensemble.processor, ClusterDecompositionProcessor)
    if stem.startswith("sgc"):  # bench.py's sgc: 7 orbits, ternary codes
        n = int(stem[4])
        assert num_orbits == 7 and committed["num_sites"] == n ** 3
        assert committed["local_g"].shape[1:] == (104, 27)


def test_canonical_aucu_carries_its_wang_landau_window():
    committed = load_system(data_path("aucu_4x4x4"))
    width = committed["wl_max_enthalpy"] - committed["wl_min_enthalpy"]
    assert 249 < width / committed["wl_bin_size"] <= 250


def test_local_arrays_equal_reference(bench_spinel):
    _, ensemble = bench_spinel
    ref = site_local_arrays(ensemble.processor)
    system = export_system(ensemble)
    mine = [system[k] for k in ("local_sites", "local_strides", "local_d2", "local_g")]
    for r, m in zip(ref[:4], mine):
        np.testing.assert_array_equal(np.asarray(r), m)
    assert system["local_g"].shape[2] == ref[4]


def test_export_requires_expansion_processor():
    """The exporter takes the two cluster processors (a decomposition is
    written with its ``processor_type``) and refuses any other."""
    from types import SimpleNamespace

    from smol_tpu.benchmarks.systems import random_expansion, spinel_prim
    from smol_tpu.moca import Ensemble

    ce = random_expansion(spinel_prim(), {2: 4.0}, seed=11)
    ens = Ensemble.from_cluster_expansion(ce, np.diag([1, 1, 1]))
    assert type(ens.processor).__name__ == "ClusterDecompositionProcessor"
    assert str(export_system(ens)["processor_type"]) == "decomposition"
    expansion = Ensemble.from_cluster_expansion(ce, np.diag([1, 1, 1]),
                                                processor_type="expansion")
    assert "processor_type" not in export_system(expansion)

    class OtherProcessor:
        pass

    with pytest.raises(ValueError, match="ClusterExpansionProcessor"):
        export_system(SimpleNamespace(processor=OtherProcessor()))


def test_export_refuses_composite_of_decomposition():
    from smol_tpu.benchmarks.systems import random_expansion, spinel_prim
    from smol_tpu.moca import Ensemble

    ce = random_expansion(spinel_prim(), {2: 4.0}, seed=11, ewald=True)
    ens = Ensemble.from_cluster_expansion(ce, np.diag([1, 1, 1]))
    assert type(ens.processor).__name__ == "CompositeProcessor"
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 6"):
        export_system(ens)


def test_save_load_roundtrip(tmp_path):
    system = load_system(system_path("2x2x2"))
    save_system(system, tmp_path / "s.npz")
    again = load_system(tmp_path / "s.npz")
    assert sorted(again) == sorted(system)
    for key in system:
        np.testing.assert_array_equal(again[key], system[key])


def test_port_runs_with_jax_blocked():
    """The port imports and samples on the CPU where ``import jax`` fails."""
    script = textwrap.dedent(
        f"""
        import sys
        sys.modules["jax"] = None
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np
        from smol_tpu_torch.system import load_system
        from smol_tpu_torch.moca.ensemble import Ensemble
        from smol_tpu_torch.moca.sampler.sampler import Sampler
        try:
            import jax  # noqa: F401
        except ImportError:
            pass
        else:
            raise SystemExit("jax was importable")
        ens = Ensemble.from_system(load_system({str(system_path("2x2x2"))!r}), "cpu")
        codes = np.ones(ens.num_sites, dtype=np.int64)
        for sl in ens.sublattices:
            codes[sl.sites] = len(sl.encoding)
        rng = np.random.default_rng(0)
        occ = (rng.random((64, ens.num_sites)) * codes).astype(np.int32)
        sampler = Sampler.from_ensemble(ens, 1000.0, 64, seed=3, device="cpu")
        sampler.run(200, occ, thin_by=50)
        assert sampler.samples.num_samples == 4
        print("ok", sampler.execution_path(50))
        system = load_system({str(data_path("spinel_ewald_2x2x2"))!r})
        ens = Ensemble.from_system(system, "cpu")
        sampler = Sampler.from_ensemble(ens, 1000.0, 16, seed=3, device="cpu")
        sampler.run(100, system["initial_occupancy"], thin_by=50)
        assert sampler.samples.num_samples == 2
        print("ok", sampler.execution_path(50))
        system = load_system({str(data_path("spinel_ewald_sgc_2x2x2"))!r})
        ens = Ensemble.from_system(system, "cpu")
        sampler = Sampler.from_ensemble(ens, 1000.0, 16, seed=3, device="cpu",
                                        step_type="table-flip")
        sampler.run(100, system["initial_occupancy"], thin_by=50)
        assert sampler.samples.num_samples == 2
        print("ok", sampler.execution_path(50))
        system = load_system({str(data_path("aucu_wl_3x3x3"))!r})
        ens = Ensemble.from_system(system, "cpu")
        sampler = Sampler.from_ensemble(
            ens, nwalkers=16, seed=13, device="cpu", kernel_type="wang-landau",
            step_type="flip", min_enthalpy=float(system["wl_min_enthalpy"]),
            max_enthalpy=float(system["wl_max_enthalpy"]),
            bin_size=float(system["wl_bin_size"]))
        sampler.run(100, rng.integers(0, 2, (16, ens.num_sites)), thin_by=50)
        assert sampler.samples.num_samples == 2
        assert sampler.samples.num_aux_records == 1
        print("ok", sampler.execution_path(50))
        from smol_tpu_torch.capp import StochasticSQSGenerator
        from smol_tpu_torch.moca.processor.distance import CorrelationDistanceProcessor
        from smol_tpu_torch.system import load_systems
        shapes = load_systems({str(data_path("sqs_fcc8"))!r})[:2]
        generator = StochasticSQSGenerator.from_processors(
            [CorrelationDistanceProcessor(s, "cpu") for s in shapes], device="cpu")
        generator.generate(mcmc_steps=20, temperatures=[1.0], nwalkers=4, seed=0)
        assert generator.num_structures == 8
        print("ok", generator.execution_path)
        ens = Ensemble.from_system(load_system({str(data_path("sgc_3x3x3"))!r}), "cpu")
        sampler = Sampler.from_ensemble(ens, 800.0, 16, seed=3, device="cpu",
                                        chain_delta="qary")
        sampler.run(100, (rng.random((16, ens.num_sites)) * 3).astype(np.int32),
                    thin_by=50)
        feats = sampler.samples.get_feature_vectors()
        assert abs(feats @ ens.natural_parameters - sampler.samples.get_enthalpies()).max() < 1e-9
        print("ok", sampler.execution_path(50))
        from smol_tpu_torch.parallel import make_temperature_ladder
        ens = Ensemble.from_system(load_system({str(data_path("aucu_pt_3x3x3"))!r}), "cpu")
        sampler = Sampler.from_ensemble(ens, make_temperature_ladder(300.0, 3000.0, 16), 16,
                                        seed=3, device="cpu", chain_delta="ising",
                                        replica_exchange_period=10)
        sampler.run(100, rng.integers(0, 2, (16, ens.num_sites)), thin_by=50)
        assert sampler.samples.get_temperatures().shape == (32,)
        print("ok", sampler.execution_path(50))
        bad = [m for m in sys.modules if m == "smol_tpu" or m.startswith("smol_tpu.")]
        assert not bad, bad
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=120, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ok cpu-twin[flip]" in proc.stdout
    assert "ok cpu-twin[swap]+ewald" in proc.stdout
    assert "ok cpu-twin[table]+ewald" in proc.stdout
    assert "ok cpu-twin[wl-flip]+direct" in proc.stdout
    assert "ok cpu-twin[distance]" in proc.stdout
    assert "ok cpu-twin[flip]+qary3" in proc.stdout
    assert "ok cpu-twin[flip]+ising+shared-proposals+replica-exchange@10" in proc.stdout


def test_port_never_imports_jax_or_reference():
    package = ROOT / "smol_tpu_torch"
    offenders = []
    for path in [*sorted(package.rglob("*.py")), ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "smol_tpu"):
                    offenders.append(f"{path.relative_to(ROOT)}: {name}")
    assert not offenders, offenders
    assert (package / "csrc" / "flip_chain.cu").exists()
    assert (package / "csrc" / "swap_chain.cu").exists()
    assert (package / "csrc" / "table_chain.cu").exists()
    assert (package / "csrc" / "wl_chain.cu").exists()
    assert (package / "csrc" / "distance_chain.cu").exists()
    assert (package / "csrc" / "tempering.cu").exists()
    assert (package / "moca" / "kernel" / "wanglandau.py").exists()
    from smol_tpu_torch.ops import _build

    assert sorted(_build.KERNELS) == [
        "distance_chain", "flip_chain", "swap_chain", "table_chain", "tempering",
        "wl_chain"]
    assert all((_build.CSRC_DIR / f"{name}.cu").exists() for name in _build.KERNELS)
