"""K3, the q-ary character body of the port's flip and swap chains, against
smol_tpu's Pallas chain.

- (c) tables: the port's ``qary_tables`` equals the reference's
  ``_qary_tables`` on bench ``sgc`` 3x3x3 (q = 3, 304 rows per rank) and on
  Au-Cu 2x2x2 (q = 2; clusters there hold one site twice) after
  densifying the port's sparse rows: frequencies and self frequencies
  exactly, amplitudes to 1e-15 relative (the reference's f64 amplitudes
  are read before its double-float split, which the test replaces with
  the identity; the fold is the same on both sides);
- (b) the q-ary twin's flip and swap deltas equal a full recompute of
  features . theta for every rank, to 1e-12 of the energy scale;
- (d) trajectories: fed the reference wrapper's own site sequences and
  seeds, the port's hash-mode twin with the q-ary body reproduces the
  interpret-mode Pallas chain (which takes its own q-ary body) occupancy
  for occupancy: flips with chemical potentials on ``sgc`` 3x3x3, swaps
  without them on the ternary CE 3x3x3, and q = 2 flips on Au-Cu 2x2x2
  with ``SMOL_TPU_CHAIN_NO_ISING=1`` (set by ``monkeypatch``), where the
  reference takes q = 2 instead of its Ising body.  64 walkers, 200
  steps; a walker may differ only where the port shows one of its
  decisions within 4 f32 ulps of log U (the reference sums its deltas in
  double-float, the port in f64); enthalpies of equal walkers agree to
  1e-9;
- the body is named in the execution path, refused where the tables
  cannot take it (an Ewald term, table moves, Wang-Landau), and never
  taken unasked.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smol_tpu.benchmarks.systems import fcc_binary_prim, fcc_ternary_prim, random_expansion
from smol_tpu.moca import Ensemble, Sampler
from smol_tpu.ops import pallas_chain
from smol_tpu.ops.fastmc import site_local_arrays
from smol_tpu_torch.moca.ensemble import Ensemble as TorchEnsemble
from smol_tpu_torch.moca.ensemble import random_occupancies
from smol_tpu_torch.moca.sampler.sampler import Sampler as TorchSampler
from smol_tpu_torch.ops import chain
from smol_tpu_torch.system import export_system, load_system

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from export_torch_systems import data_path, sgc_ensemble  # noqa: E402

ULP_SLACK = 4
W, N_STEPS, BLOCK = 64, 200, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors, so that parallel test
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _aucu(cell, mus=None):
    ce = random_expansion(fcc_binary_prim(), {2: 6.0, 3: 4.0}, seed=7)
    return Ensemble.from_cluster_expansion(ce, np.diag(cell), chemical_potentials=mus)


def _ternary_canonical(cell):
    """bench ``sgc``'s expansion without chemical potentials (canonical)."""
    ce = random_expansion(fcc_ternary_prim(), {2: 5.5, 3: 4.0}, seed=7)
    return Ensemble.from_cluster_expansion(ce, np.diag(cell))


_CACHE = {}


def _system(name):
    """(reference ensemble, port ensemble on the CPU), built once."""
    if name not in _CACHE:
        ref = {
            "sgc": lambda: sgc_ensemble(3),
            "ternary": lambda: _ternary_canonical((3, 3, 3)),
            "aucu": lambda: _aucu((2, 2, 2), {"Au": 0.05, "Cu": -0.05}),
        }[name]()
        _CACHE[name] = ref, TorchEnsemble.from_system(export_system(ref), "cpu")
    return _CACHE[name]


def _tables(port, move="flip", delta="qary"):
    return chain.build_chain_tables(
        port.processor, port.sublattices,
        mu_table=None if move == "swap" else port.chemical_potential_table, delta=delta)


def _reference_qary(ref, tables):
    """The reference's ``_qary_tables`` of the same ranks, with its f64
    amplitudes (its double-float split replaced by the identity)."""
    sites3, strides3, _, g3, tmax = (np.asarray(x) for x in site_local_arrays(ref.processor))
    rank_sites = tables.rank_sites.numpy()
    rank_of_site = -np.ones(sites3.shape[0], dtype=np.int64)
    rank_of_site[rank_sites] = np.arange(len(rank_sites))
    n_codes = np.ones(sites3.shape[0], dtype=np.int64)
    for sl in ref.sublattices:
        n_codes[sl.sites] = len(sl.encoding)
    R = len(rank_sites)
    rpad = max(8, -(-R // 8) * 8)
    return pallas_chain._qary_tables(
        rank_sites, rank_of_site, sites3, strides3, g3, strides3.sum(axis=2) > 0,
        n_codes, sites3.shape[1], rpad, int(tmax)), rpad


@pytest.mark.parametrize("name,q", [("sgc", 3), ("aucu", 2)])
def test_tables_equal_reference(name, q, monkeypatch):
    """(c): rows, frequencies and amplitudes of every rank."""
    ref, port = _system(name)
    tables = _tables(port)
    monkeypatch.setattr(pallas_chain, "_split_f64",
                        lambda x: (np.asarray(x, dtype=np.float64), np.zeros(np.shape(x))))
    (q_ref, gmq, amp_c, _, amp_s, _, msq, Lq), rpad = _reference_qary(ref, tables)
    assert tables.qary == q_ref == q
    assert tables.qms.shape[1] == Lq
    if name == "sgc":
        assert Lq == 304  # 293 rows on every rank, padded to a multiple of 16
    R, _, NB = tables.qnbr.shape
    dense = np.zeros((R, Lq, rpad))
    nbr, freq = tables.qnbr.numpy(), tables.qfreq.numpy()
    for r, j, k in zip(*np.nonzero(nbr >= 0)):
        dense[r, j, nbr[r, j, k]] = freq[r, j, k]
    np.testing.assert_array_equal(dense, gmq)
    np.testing.assert_array_equal(tables.qms.numpy(), msq)
    assert np.all((freq == 0) | (nbr >= 0)) and NB == 2
    rows = tables.qrows.numpy()
    assert np.all((np.arange(Lq) < rows[:, None]) == (msq > 0))
    scale = np.abs(amp_c).max()
    np.testing.assert_allclose(tables.qac.numpy(), amp_c, rtol=1e-15, atol=1e-15 * scale)
    np.testing.assert_allclose(tables.qas.numpy(), amp_s, rtol=1e-15, atol=1e-15 * scale)
    if q == 2:
        assert not tables.qas.numpy().any()  # binary codes have no sin characters


@pytest.mark.parametrize("name", ["sgc", "aucu"])
def test_flip_delta_equals_full_recompute(name):
    """(b) with the q-ary body: every rank, two proposals each."""
    ref, port = _system(name)
    tables = _tables(port)
    theta = torch.as_tensor(port.natural_parameters)
    w = 12
    occu = torch.as_tensor(random_occupancies(ref, w, seed=5))
    occ = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
    e_old = port.compute_features(occu) @ theta
    beta32 = torch.full((w,), 10.0, dtype=torch.float32)
    worst = 0.0
    for r in range(tables.num_ranks):
        for draw in range(2):
            u = torch.full((w,), r, dtype=torch.int64)
            r_j = torch.arange(w, dtype=torch.int64) + draw
            _, b, dE, _, _ = chain.flip_step_reference(
                tables, occ, u, torch.zeros(w, dtype=torch.int64), r_j, beta32)
            new = occu.clone()
            new[:, tables.rank_sites[r]] = b.to(new.dtype)
            exact = port.compute_features(new) @ theta - e_old
            worst = max(worst, float((dE - exact).abs().max()))
    assert worst <= 1e-12 * max(1.0, float(e_old.abs().max())), worst


def test_swap_delta_equals_full_recompute():
    """(b) for swaps with the q-ary body: every ordered rank pair."""
    ref, port = _system("ternary")
    tables = _tables(port, "swap")
    theta = torch.as_tensor(port.natural_parameters)
    R = tables.num_ranks
    u, v = (x.reshape(-1) for x in torch.meshgrid(torch.arange(R), torch.arange(R),
                                                   indexing="ij"))
    occu = torch.as_tensor(random_occupancies(ref, R * R, seed=8))
    occ = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
    before = occ.clone()
    accept, is_move, a, b, dE, _, _ = chain.swap_step_reference(
        tables, occ, u, v, torch.zeros(R * R, dtype=torch.int64),
        torch.full((R * R,), 10.0, dtype=torch.float32))
    assert torch.equal(occ, before)
    walkers = torch.arange(R * R)
    new = occu.clone()
    new[walkers, tables.rank_sites[u]] = b.to(new.dtype)
    new[walkers, tables.rank_sites[v]] = a.to(new.dtype)
    e_old = port.compute_features(occu) @ theta
    exact = port.compute_features(new) @ theta - e_old
    assert float((dE - exact).abs().max()) <= 1e-12 * max(1.0, float(e_old.abs().max()))
    assert bool((dE[~is_move] == 0).all()) and not bool(accept[~is_move].any())


def _reference_run(ref, move, seed):
    """The interpret-mode reference chain from random starts, with the
    wrapper's own draws (pallas_chain :2040-2091)."""
    occ0 = random_occupancies(ref, W, seed)
    sampler = Sampler.from_ensemble(ref, temperature=800.0, nwalkers=W, seed=3)
    state = dict(sampler.setup_sample(occ0))
    state.pop("words", None)
    state["occupancy"] = jnp.asarray(occ0)
    mu = None if move == "swap" else ref.chemical_potential_table
    ref_tables = pallas_chain.build_chain_tables(ref.processor, ref.sublattices, mu_table=mu)
    assert ref_tables.qary in (2, 3)  # the reference takes its q-ary body
    key = jax.random.key(seed)
    k_seed, k_seq = jax.random.split(jax.random.fold_in(key, 13))
    seed0 = jax.random.randint(k_seed, (), 0, np.int32(2**30 - 1), dtype=jnp.int32)
    shape = (1, -(-W // min(BLOCK, -(-W // 128) * 128)), N_STEPS)
    if move == "swap":
        seqs = [np.asarray(s, dtype=np.int32)
                for s in pallas_chain.rank_pair_sequence(ref_tables, k_seq, shape)]
    else:
        seqs = [np.asarray(pallas_chain.rank_sequence(ref_tables, k_seq, shape),
                           dtype=np.int32)]
    fn = pallas_chain.make_shared_proposal_chain(
        ref_tables, N_STEPS, block_size=BLOCK, interpret=True, move=move)
    out = fn(state, key)
    return occ0, state, seqs, int(seed0), {k: np.asarray(out[k]) for k in
                                           ("occupancy", "enthalpy", "naccept")}


@pytest.mark.parametrize("name,move", [("sgc", "flip"), ("ternary", "swap"),
                                       ("aucu", "flip")])
def test_trajectory_parity(name, move, monkeypatch):
    """(d): the hash-mode q-ary twin against the interpret-mode reference."""
    if name == "aucu":  # the reference would take its Ising body otherwise
        monkeypatch.setenv("SMOL_TPU_CHAIN_NO_ISING", "1")
    ref, port = _system(name)
    occ0, state, seqs, seed, out = _reference_run(ref, move, seed=2)
    tables = _tables(port, move)
    occu = torch.as_tensor(occ0)
    occ = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
    enth = torch.tensor(np.array(state["enthalpy"]))
    beta32 = torch.tensor(np.array(state["beta"])).to(torch.float32)
    nacc = torch.zeros(W, dtype=torch.int32)
    margin = torch.full((W,), float("inf"))
    common = dict(seed=torch.tensor([seed]), tables=tables, n_steps=N_STEPS,
                  block_size=BLOCK, rng="hash", margin=margin)
    if move == "swap":
        nmove = torch.zeros(W, dtype=torch.int32)
        chain.swap_chain_reference(occ, enth, nacc, nmove, beta32,
                                   *(torch.as_tensor(s[0]) for s in seqs), **common)
    else:
        chain.flip_chain_reference(occ, enth, nacc, beta32, torch.as_tensor(seqs[0][0]),
                                   **common)
    port_occ = occu.clone()
    port_occ[:, tables.rank_sites] = occ.T.to(port_occ.dtype)
    same = np.all(port_occ.numpy() == out["occupancy"], axis=1)
    for w in np.flatnonzero(~same):
        assert margin[w] <= ULP_SLACK, (w, float(margin[w]))
    assert same.mean() >= 0.9, same.mean()
    np.testing.assert_array_equal(nacc.numpy()[same], out["naccept"][same])
    np.testing.assert_allclose(enth.numpy()[same], out["enthalpy"][same], rtol=0, atol=1e-9)
    assert 0 < out["naccept"].mean() < N_STEPS
    # the recorded enthalpy stays features . theta (parity e)
    theta = torch.as_tensor(port.natural_parameters)
    exact = port.compute_features(port_occ) @ theta
    assert float((exact - enth).abs().max()) < 1e-9
    if move == "swap":
        np.testing.assert_array_equal(np.sort(port_occ.numpy(), axis=1),
                                      np.sort(occ0, axis=1))


def test_sampler_names_the_body_and_refuses_what_it_cannot_take():
    port = TorchEnsemble.from_system(load_system(data_path("sgc_3x3x3")), "cpu")
    direct = TorchSampler.from_ensemble(port, 800.0, 8, seed=3, device="cpu")
    assert direct.execution_path(10) == "cpu-twin[flip]+direct+shared-proposals"
    qary = TorchSampler.from_ensemble(port, 800.0, 8, seed=3, device="cpu",
                                      chain_delta="qary")
    assert qary.execution_path(10) == "cpu-twin[flip]+qary3+shared-proposals"
    occ0 = random_occupancies(port, 8, 0)
    runs = []
    for sampler in (direct, qary):
        sampler.run(200, occ0, thin_by=50)
        runs.append(sampler.samples.get_enthalpies())
    # the two bodies compute one delta to f64 roundoff: one trajectory
    np.testing.assert_allclose(runs[0], runs[1], rtol=0, atol=1e-9)
    with pytest.raises(ValueError, match="chain delta"):
        TorchSampler.from_ensemble(port, 800.0, 8, seed=3, device="cpu",
                                   chain_delta="parity")
    # the Ising body is ported, and a ternary system refuses it
    ising = TorchSampler.from_ensemble(port, 800.0, 8, seed=3, device="cpu",
                                       chain_delta="ising")
    with pytest.raises(NotImplementedError, match="sign-symmetric"):
        ising.execution_path(10)
    with pytest.raises(NotImplementedError, match="Queue 2"):
        TorchSampler.from_ensemble(port, kernel_type="wang-landau", nwalkers=8, seed=3,
                                   device="cpu", min_enthalpy=-10.0, max_enthalpy=0.0,
                                   bin_size=0.1, chain_delta="qary")
    ewald = TorchEnsemble.from_system(load_system(data_path("spinel_ewald_2x2x2")), "cpu")
    with pytest.raises(NotImplementedError, match="Queue 2"):
        chain.build_chain_tables(ewald.processor, ewald.sublattices, delta="qary")
    table = TorchEnsemble.from_system(load_system(data_path("spinel_ewald_sgc_2x2x2")),
                                      "cpu")
    with pytest.raises(NotImplementedError, match="Queue 2"):
        TorchSampler.from_ensemble(table, 1000.0, 8, seed=3, device="cpu",
                                   step_type="table-flip", chain_delta="qary")
    tables = _tables(port)
    with pytest.raises(NotImplementedError, match="Queue 2"):
        chain.make_shared_proposal_chain(tables, 10, wl=chain.WLChain(
            min_enthalpy=0.0, bin_size=1.0, num_levels=4, flatness=0.8,
            check_period=10, update_period=1, mod_divisor=2.0))
    # a rank count with no q in {2, 3}: the table refuses, nothing falls back
    with pytest.raises(chain.QaryRefused, match="lcm"):
        chain.qary_tables(np.arange(2), np.arange(2), np.zeros((2, 1, 2), np.int64),
                          np.array([[[1, 5]], [[1, 5]]]), np.zeros((2, 1, 25)),
                          np.array([5, 5]), 25)
