"""K1-Ising and K3 in the table-move (K5) and Wang-Landau (K6) chains, and K3
with the Ewald term and for q = 4, against smol_tpu's Pallas chain.

The reference picks one site body per system and serves every move of its
one kernel with it (``pallas_chain.py:974-1029``, :1635-1649); these are
the (chain, body) pairs the port took last.

- (b) each new twin's delta equals a full recompute of features . theta:
  table moves with K1-Ising and with K3 (q = 2, with the Ewald term) on the
  semigrand spinel CE + Ewald (to 1e-9 absolute, as the direct body's table
  test holds it), K3 flips and swaps with the Ewald term on the spinel CE +
  Ewald and K3 flips with q = 4 on the mixed quaternary and binary rocksalt
  (to 1e-12 of the energy scale, for every rank);
- (d) trajectories: fed the reference wrapper's own draws and seeds, each
  hash-mode twin reproduces the interpret-mode Pallas chain, which takes
  the same body (asserted in each helper): K5 with K1-Ising on the spinel
  CE + Ewald sgc 2x2x2;
  K5 with K3 (q = 2) and the Ewald term on the spinel CE + Ewald sgc
  2x2x2; K6 with K1-Ising, flips on the 8-site cell and on Au-Cu 3x3x3 in
  the bench's window, swaps on Au-Cu 4x4x4; K6 with K3 (q = 3) on the
  ternary ``sgc`` window; K2 with K3 (q = 2) and the Ewald term on the
  spinel CE + Ewald; K1 with K3 at q = 4.  ``SMOL_TPU_CHAIN_NO_ISING=1``
  (by ``monkeypatch``) makes the reference take q = 2 on the binary
  spinel.  A walker may differ only where the port shows one of its
  decisions (or, in Wang-Landau, a window coordinate) within 4 f32 ulps,
  beyond beta times the reference's f32 Ewald error, as in the files whose
  helpers these are (``tests/test_torch_tableflip.py``,
  ``test_torch_wanglandau.py``, ``test_torch_ising.py``,
  ``test_torch_qary.py``); the table runs keep every walker's net charge
  and parity (e) below 1e-9;
- the 8-site density of states through ``Sampler.run`` with the Ising body
  (8 walkers x 10000 steps): every walker's log-DOS within 0.8 of the
  exact degeneracies, the bound of the direct body's test in
  ``test_torch_wanglandau.py``, and the walkers' mean within 0.5
  (``chip_smoke.py`` holds every walker to 0.5 after 200000 steps);
- ``default_delta`` names the body the card measured fastest for each
  chain, and the refusals that remain raise.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from smol_tpu_torch.moca.ensemble import Ensemble as TorchEnsemble
from smol_tpu_torch.moca.ensemble import random_occupancies
from smol_tpu_torch.moca.sampler.sampler import Sampler as TorchSampler
from smol_tpu_torch.ops import chain
from smol_tpu_torch.system import load_system

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from export_torch_systems import data_path, half_occupancies, sgc_ensemble  # noqa: E402
from test_torch_ising import _parity as _metropolis_parity  # noqa: E402
from test_torch_qary import _parity as _qary_parity  # noqa: E402
from test_torch_tableflip import (  # noqa: E402
    _port_kernel,
    _systems,
    _trajectory_parity,
)
from test_torch_wanglandau import (  # noqa: E402, F401 (fixtures)
    _chain_parity,
    _nn_sampler,
    _wl_params,
    aucu4,
    bench,
    nn,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors, so that parallel test
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(stem):
    return TorchEnsemble.from_system(load_system(data_path(stem)), "cpu")


# ---------------- (b): deltas against a full recompute ----------------

@pytest.mark.parametrize("delta", ["ising", "qary"])
def test_table_delta_equals_full_recompute(delta):
    """One table move per walker with K1-Ising or K3 (q = 2, Ewald)."""
    _, _, port = _systems("spinel_ewald", (1, 1, 1))
    kernel = _port_kernel(port, chain_delta=delta)
    tables, tm = kernel.chain_tables(), kernel.table_move()
    assert tables.delta == delta and tables.has_ewald
    W = 2000
    theta = torch.as_tensor(port.natural_parameters)
    occu = torch.as_tensor(random_occupancies(port, W, seed=8))
    occ = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
    before = occ.clone()
    dirs, ranks = chain.table_sequences(tables, tm, torch.Generator().manual_seed(2), (W,))
    accept, valid, a0, b, dE, _, _ = chain.table_step_reference(
        tables, tm, occ, dirs, ranks, torch.zeros(W, dtype=torch.int64),
        torch.zeros(W, dtype=torch.float32))
    assert torch.equal(occ, before) and torch.equal(accept, valid)
    slot_on = torch.as_tensor(tm.slot_valid)[dirs.long()] > 0
    new = occu.clone()
    walkers = torch.arange(W)
    for j in range(tm.k_max):
        on = valid & slot_on[:, j]
        new[walkers[on], tables.rank_sites[ranks[on, j].long()]] = b[on, j].to(new.dtype)
    exact = (port.compute_features(new) - port.compute_features(occu)) @ theta
    assert int(valid.sum()) > 100
    assert float((dE - exact)[valid].abs().max()) <= 1e-9
    # every valid move keeps the walker's net charge
    sites = np.arange(port.num_sites)
    np.testing.assert_array_equal(port.site_charges[sites, new.numpy()].sum(axis=1),
                                  port.site_charges[sites, occu.numpy()].sum(axis=1))


@pytest.mark.parametrize("stem,move,q", [("spinel_ewald_2x2x2", "flip", 2),
                                         ("spinel_ewald_2x2x2", "swap", 2),
                                         ("rocksalt_q4_2x2x2", "flip", 4)])
def test_qary_delta_equals_full_recompute(stem, move, q):
    """K3 with the Ewald term (flips and swaps) and with q = 4 (flips):
    every rank (flips: two proposals each; swaps: every ordered pair)."""
    port = _port(stem)
    tables = chain.build_chain_tables(
        port.processor, port.sublattices,
        mu_table=None if move == "swap" else port.chemical_potential_table,
        delta="qary")
    assert tables.qary == q and tables.has_ewald == stem.startswith("spinel_ewald")
    theta = torch.as_tensor(port.natural_parameters)
    R = tables.num_ranks
    if move == "swap":
        u, v = (x.reshape(-1) for x in torch.meshgrid(torch.arange(R), torch.arange(R),
                                                       indexing="ij"))
        W = R * R
        occu = torch.as_tensor(random_occupancies(port, W, seed=8))
        occ = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
        _, _, a, b, dE, _, _ = chain.swap_step_reference(
            tables, occ, u, v, torch.zeros(W, dtype=torch.int64),
            torch.full((W,), 10.0, dtype=torch.float32))
        new = occu.clone()
        new[torch.arange(W), tables.rank_sites[u]] = b.to(new.dtype)
        new[torch.arange(W), tables.rank_sites[v]] = a.to(new.dtype)
        worst = float((dE - (port.compute_features(new) - port.compute_features(occu))
                       @ theta).abs().max())
        scale = float((port.compute_features(occu) @ theta).abs().max())
    else:
        W = 12
        occu = torch.as_tensor(random_occupancies(port, W, seed=5))
        occ = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
        e_old = port.compute_features(occu) @ theta
        scale = float(e_old.abs().max())
        worst = 0.0
        for r in range(R):
            for draw in range(2):
                _, b, dE, _, _ = chain.flip_step_reference(
                    tables, occ, torch.full((W,), r), torch.zeros(W, dtype=torch.int64),
                    torch.arange(W, dtype=torch.int64) + draw,
                    torch.full((W,), 10.0, dtype=torch.float32))
                new = occu.clone()
                new[:, tables.rank_sites[r]] = b.to(new.dtype)
                exact = port.compute_features(new) @ theta - e_old
                worst = max(worst, float((dE - exact).abs().max()))
    assert worst <= 1e-12 * max(1.0, scale), worst


# ---------------- (d): trajectories against the reference ----------------

def test_table_ising_parity(monkeypatch):
    """K5 with K1-Ising, the reference's default body on the spinel CE +
    Ewald sgc 2x2x2 (two recolorings, the Ewald term on each)."""
    slack, _, _ = _trajectory_parity("spinel_ewald", (2, 2, 2), 8, 150, 1000.0, 0,
                                     monkeypatch, delta="ising")
    assert slack > 0.0


def test_table_qary_ewald_parity(monkeypatch):
    """K5 with K3 (q = 2) and the Ewald term: the reference takes q = 2
    once its Ising body is switched off."""
    monkeypatch.setenv("SMOL_TPU_CHAIN_NO_ISING", "1")
    slack, _, _ = _trajectory_parity("spinel_ewald", (2, 2, 2), 8, 150, 1000.0, 0,
                                     monkeypatch, delta="qary")
    assert slack > 0.0


@pytest.mark.parametrize("system,move,params,walkers,n_steps,block,seed", [
    ("nn", "flip", dict(flatness=0.7, check_period=50), 64, 400, 32, 0),
    ("bench", "flip", dict(flatness=0.3, check_period=20), 64, 300, 32, 1),
    ("aucu4", "swap", dict(flatness=0.3, check_period=20), 128, 300, 64, 2),
])
def test_wl_ising_parity(request, system, move, params, walkers, n_steps, block, seed):
    """K6 with K1-Ising: flips on the 8-site cell (nothing excused) and in
    the bench's window, swaps on Au-Cu 4x4x4."""
    ref, port, window = request.getfixturevalue(system)
    if move == "swap":
        occ0 = half_occupancies(port.num_sites, walkers, seed=seed)
    else:
        occ0 = np.random.default_rng(seed).integers(
            0, 2, (walkers, port.num_sites)).astype(np.int32)
    _chain_parity(ref, port, _wl_params(window, **params), move, occ0, n_steps, block,
                  seed=seed, excuses=system != "nn", delta="ising")


def test_wl_qary_parity_sgc():
    """K6 with K3 (q = 3): semigrand flips on the ternary ``sgc`` 3x3x3 in
    its file's window, where the reference takes its q-ary body."""
    system = load_system(data_path("sgc_wl_3x3x3"))
    window = dict(min_enthalpy=float(system["wl_min_enthalpy"]),
                  max_enthalpy=float(system["wl_max_enthalpy"]),
                  bin_size=float(system["wl_bin_size"]))
    port = TorchEnsemble.from_system(system, "cpu")
    occ0 = random_occupancies(port, 64, 4)
    _chain_parity(sgc_ensemble(3), port,
                  _wl_params(window, flatness=0.3, check_period=20), "flip", occ0, 200,
                  32, seed=4, delta="qary")


def test_swap_qary_ewald_parity(monkeypatch):
    """K2 with K3 (q = 2) and the Ewald term on the spinel CE + Ewald."""
    monkeypatch.setenv("SMOL_TPU_CHAIN_NO_ISING", "1")
    tables, _ = _metropolis_parity("spinel_ewald", "swap", 200, 64, 1000.0, "qary")
    assert tables.qary == 2 and tables.has_ewald


def test_flip_qary_q4_parity():
    """K1 with K3 at q = 4 on the mixed quaternary and binary rocksalt."""
    tables = _qary_parity("q4", "flip")
    assert tables.qary == 4 and set(tables.ncode.tolist()) == {2, 4}


# ---------------- the sampler, the default body, the refusals ----------------

def test_sampler_density_of_states_ising(nn):
    """The 8-site log-DOS through ``Sampler.run`` with the Ising body: every
    walker within 0.8 of the exact degeneracies, their mean within 0.5."""
    _, port, window = nn
    system = load_system(data_path("aucu_nn_2x2x2"))
    sampler = _nn_sampler(port, window, 8, seed=9, check_period=250, chain_delta="ising")
    assert sampler.execution_path(2500) == "cpu-twin[wl-flip]+ising+shared-proposals"
    occ0 = np.random.default_rng(0).integers(0, 2, (8, 8)).astype(np.int32)
    sampler.run(10000, occ0, thin_by=2500)
    entropy = sampler.samples.get_trace_value("entropy", flat=False)[-1]
    exact_bins = np.floor((system["exact_enthalpies"] - window["min_enthalpy"])
                          / window["bin_size"]).astype(int)
    dos = np.bincount(exact_bins, minlength=entropy.shape[1])
    visited = dos > 0
    exact = np.log(dos[visited]) - np.log(dos[visited][0])
    estimates = entropy[:, visited] - entropy[:, visited][:, :1]
    for estimate in estimates:
        assert np.max(np.abs(estimate - exact)) < 0.8, (estimate, exact)
    assert np.max(np.abs(estimates.mean(axis=0) - exact)) < 0.5
    feats = sampler.samples.get_feature_vectors()
    np.testing.assert_allclose(sampler.samples.get_enthalpies(),
                               feats @ port.natural_parameters, rtol=1e-12)


@pytest.mark.parametrize("stem,chain_name,expect", [
    ("aucu_wl_3x3x3", "wl-flip", "ising"), ("aucu_4x4x4", "wl-swap", "ising"),
    ("spinel_ewald_sgc_2x2x2", "table", "ising"), ("spinel_ewald_sgc_3x3x3", "table", "ising"),
    ("sgc_wl_3x3x3", "wl-flip", "direct"),  # ternary: no Ising rows
    ("lmof_2x2x2", "table", "direct"),
])
def test_default_delta_names_the_measured_body(stem, chain_name, expect):
    """``default_delta`` names, for table moves and Wang-Landau, the body
    that won on every cell of that chain on the card (PERF.md), where the
    system's tables take it; the samplers build what it names."""
    port = _port(stem)
    assert chain.default_delta(port.processor, port.sublattices) == expect
    step = {"wl-flip": "flip", "wl-swap": "swap", "table": "table-flip"}[chain_name]
    if chain_name == "table":
        sampler = TorchSampler.from_ensemble(port, 1000.0, nwalkers=4, seed=1, device="cpu",
                                             step_type=step)
    else:
        system = load_system(data_path(stem))
        sampler = TorchSampler.from_ensemble(
            port, kernel_type="wang-landau", step_type=step, nwalkers=4, seed=1,
            device="cpu", min_enthalpy=float(system["wl_min_enthalpy"]),
            max_enthalpy=float(system["wl_max_enthalpy"]),
            bin_size=float(system["wl_bin_size"]))
    assert f"+{expect}+" in sampler.execution_path(10)


def test_refusals_that_remain():
    """A body the tables cannot take raises; nothing falls back."""
    lmof = _port("lmof_2x2x2")  # ternary x binary: no Ising rows, lcm 6
    for delta, why in (("ising", "sign-symmetric"), ("qary", "lcm 6")):
        sampler = TorchSampler.from_ensemble(lmof, 1000.0, nwalkers=4, seed=1, device="cpu",
                                             step_type="table-flip", chain_delta=delta)
        with pytest.raises(NotImplementedError, match=why):
            sampler.execution_path(10)
    sgc = _port("sgc_wl_3x3x3")
    system = load_system(data_path("sgc_wl_3x3x3"))
    sampler = TorchSampler.from_ensemble(
        sgc, kernel_type="wang-landau", nwalkers=4, seed=1, device="cpu",
        chain_delta="ising", min_enthalpy=float(system["wl_min_enthalpy"]),
        max_enthalpy=float(system["wl_max_enthalpy"]),
        bin_size=float(system["wl_bin_size"]))
    with pytest.raises(NotImplementedError, match="sign-symmetric"):
        sampler.execution_path(10)
    # q = 5 has no fold, and more rows than the limit are refused
    with pytest.raises(chain.QaryRefused, match="lcm"):
        chain.qary_tables(np.arange(2), np.arange(2), np.zeros((2, 1, 2), np.int64),
                          np.array([[[1, 5]], [[1, 5]]]), np.zeros((2, 1, 25)),
                          np.array([5, 5]), 25)
    q4 = _port("rocksalt_q4_2x2x2")
    ce = chain._split_processor(q4.processor)[0]
    _, rank_sites, rank_of_site, n_codes = chain._rank_layout(ce, None, q4.sublattices)
    with pytest.raises(chain.QaryRefused, match="rows"):
        chain.qary_tables(rank_sites, rank_of_site, ce.local_sites, ce.local_strides,
                          ce.local_g, n_codes, ce.local_g.shape[2], max_rows=8)
    # the wrappers on a CPU tensor run the twins with every body; a CUDA
    # device is asked for explicitly and never replaced by the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchSampler.from_ensemble(q4, 1000.0, nwalkers=4, seed=1, chain_delta="qary")
