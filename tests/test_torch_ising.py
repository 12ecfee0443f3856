"""K1-Ising, the parity body of the port's flip and swap chains, against
smol_tpu's Pallas chain.

- (c) tables: the port's ``ising_tables`` equals the reference's
  ``_ising_tables`` exactly on the bench spinel 2x2x2, the spinel CE + Ewald
  2x2x2 and bench ``tempering``'s Au-Cu 3x3x3 (decomposition processor):
  the masks unpacked to the reference's 0/1 membership matrix ``gm01`` and
  the amplitudes, both f64, with the same rows in the same order; the
  chain tables keep each rank's rows of nonzero amplitude, in order;
- both return None where the system does not factor: bench ``sgc`` 3x3x3
  (ternary) and a binary Au-Cu FCC expanded on the indicator basis without
  orthonormalisation (the reference takes its q = 2 body there); the port's
  ``delta="ising"`` then raises, and so does a rank count beyond the
  registers' words, and Wang-Landau and table moves refuse the body;
- (b) the Ising twin's flip and swap deltas equal a full recompute of
  features . theta, and the direct body's deltas, to 1e-12 of the energy
  scale, for every rank (flips) and every ordered rank pair (swaps);
- (d) trajectories: fed the reference wrapper's own sequences and seeds,
  the port's hash-mode twin with the Ising body reproduces the
  interpret-mode Pallas chain, which takes its own Ising body by default,
  occupancy for occupancy: spinel flips, Au-Cu swaps and spinel CE + Ewald
  swaps, 64 walkers, a few hundred steps.  A walker may differ only where
  the port shows one of its decisions within 4 f32 ulps of log U beyond
  beta * slack (the reference's f32 Ewald error on a swap, as in
  ``tests/test_torch_swap.py``; it sums its parity rows in double-float,
  the port in f64); enthalpies of equal walkers agree to 1e-9 + naccept *
  slack; the execution path names the body.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smol_tpu.benchmarks.systems import fcc_binary_prim, random_expansion, spinel_prim
from smol_tpu.cofe import ClusterSubspace
from smol_tpu.cofe.expansion import ClusterExpansion
from smol_tpu.moca import Ensemble, Sampler
from smol_tpu.ops import pallas_chain
from smol_tpu_torch.moca.ensemble import Ensemble as TorchEnsemble
from smol_tpu_torch.moca.ensemble import random_occupancies
from smol_tpu_torch.moca.sampler.sampler import Sampler as TorchSampler
from smol_tpu_torch.ops import chain
from smol_tpu_torch.system import export_system, load_system

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from export_torch_systems import aucu_ensemble, data_path, spinel_ensemble  # noqa: E402

ULP_SLACK = 4
F32_EPS = 2.0**-24  # unit roundoff of f32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors, so that parallel test
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _port(stem):
    """A committed system on the CPU."""
    return TorchEnsemble.from_system(load_system(data_path(stem)), "cpu")


def _indicator_ensemble():
    """A binary Au-Cu FCC on the indicator basis, not orthonormalised: its
    local tensors are not A (-1)^t (the reference takes q = 2 there)."""
    subspace = ClusterSubspace.from_cutoffs(fcc_binary_prim(), {2: 5.0, 3: 4.0},
                                            basis="indicator", orthonormal=False)
    coefs = np.random.default_rng(7).normal(scale=0.05, size=len(subspace))
    coefs[0] = -1.0
    return Ensemble.from_cluster_expansion(
        ClusterExpansion(subspace, coefs), np.diag([2, 2, 2]),
        processor_type="expansion", chemical_potentials={"Au": 0.0, "Cu": 0.0})


def _spinel_ewald_small():
    ce = random_expansion(spinel_prim(), {2: 5.3, 3: 3.7}, seed=11, ewald=True)
    return Ensemble.from_cluster_expansion(ce, np.diag([2, 1, 1]),
                                           processor_type="expansion")


@functools.lru_cache(maxsize=None)
def _system(name):
    """(reference ensemble, port ensemble on the CPU), built once."""
    ref = {"spinel": lambda: spinel_ensemble(2), "aucu": lambda: aucu_ensemble(2),
           "spinel_ewald": _spinel_ewald_small, "indicator": _indicator_ensemble}[name]()
    return ref, TorchEnsemble.from_system(export_system(ref), "cpu")


def _layout(port):
    """(expansion part, rank sites, rank of each site, code counts) of a
    port ensemble, as ``build_chain_tables`` lays the ranks out."""
    ce = chain._split_processor(port.processor)[0]
    n = ce.local_sites.shape[0]
    n_codes = np.ones(n, dtype=np.int64)
    for sl in port.sublattices:
        n_codes[sl.sites] = len(sl.encoding)
    rank_sites = np.concatenate([sl.active_sites for sl in port.sublattices
                                 if sl.is_active]).astype(np.int64)
    rank_of_site = -np.ones(n, dtype=np.int64)
    rank_of_site[rank_sites] = np.arange(len(rank_sites))
    return ce, rank_sites, rank_of_site, n_codes


def _both_tables(port):
    """(the port's ising_tables, the reference's _ising_tables) of the same
    local arrays (the exported ones; tests/test_torch_system.py holds them
    to the reference's)."""
    ce, rank_sites, rank_of_site, n_codes = _layout(port)
    sites3, strides3, g3 = ce.local_sites, ce.local_strides, ce.local_g
    L0, R, tmax = sites3.shape[1], len(rank_sites), g3.shape[2]
    L = 8
    while L < L0:
        L *= 2
    ref = pallas_chain._ising_tables(
        rank_sites, rank_of_site, sites3, strides3, g3, strides3.sum(axis=2) > 0,
        L0, L, max(8, -(-R // 8) * 8), tmax)
    mine = chain.ising_tables(rank_sites, rank_of_site, sites3, strides3, g3,
                              n_codes, tmax)
    return mine, ref


def _tables(port, delta, move="flip"):
    return chain.build_chain_tables(
        port.processor, port.sublattices,
        mu_table=None if move == "swap" else port.chemical_potential_table, delta=delta)


@pytest.mark.parametrize("stem,R,L0", [("spinel_2x2x2", 48, 64),
                                       ("spinel_ewald_2x2x2", 48, 64),
                                       ("aucu_pt_3x3x3", 27, 120)])
def test_tables_equal_reference(stem, R, L0):
    """(c): every rank's rows, masks and amplitudes, exactly."""
    port = _port(stem)
    mine, (gm01, amp) = _both_tables(port)
    assert mine.mask.shape == (R, L0, 1) and mine.words == 1
    bits = (mine.mask[..., 0][..., None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
    np.testing.assert_array_equal(bits[..., :R].astype(np.float64), gm01[:, :L0, :R])
    assert not bits[..., R:].any()
    assert not gm01[:, L0:].any() and not gm01[:, :, R:].any()
    np.testing.assert_array_equal(mine.amp, amp[:, :L0])
    assert not amp[:, L0:].any() and mine.amp.any()
    # the chain tables keep each rank's rows of nonzero amplitude, in order
    tables = _tables(port, "ising")
    assert tables.delta == "ising" and tables.ising == 1
    for r in range(R):
        rows = np.flatnonzero(mine.amp[r])
        n = int(tables.irows[r])
        assert n == len(rows)
        np.testing.assert_array_equal(tables.iamp[r, :n].numpy(), mine.amp[r, rows])
        np.testing.assert_array_equal(tables.imask[r, :n].numpy().view(np.uint64),
                                      mine.mask[r, rows])
        assert not tables.iamp[r, n:].any() and not tables.imask[r, n:].any()


def test_systems_that_do_not_factor_are_refused(monkeypatch):
    """None on a ternary system and on a binary one whose basis is not
    sign-symmetric; ``delta="ising"`` raises there, nothing falls back."""
    indicator = _system("indicator")[1]
    for port in (_port("sgc_3x3x3"), indicator):
        mine, ref = _both_tables(port)
        assert mine is None and ref is None
        with pytest.raises(NotImplementedError, match="sign-symmetric"):
            _tables(port, "ising")
        sampler = TorchSampler.from_ensemble(port, 800.0, 8, seed=3, device="cpu",
                                             chain_delta="ising")
        with pytest.raises(NotImplementedError, match="sign-symmetric"):
            sampler.execution_path(10)
        # the default body is the direct lookup there
        default = TorchSampler.from_ensemble(port, 800.0, 8, seed=3, device="cpu")
        assert default.execution_path(10).endswith("+direct+shared-proposals")
    ref = _system("indicator")[0]
    ref_tables = pallas_chain.build_chain_tables(ref.processor, ref.sublattices,
                                                 mu_table=ref.chemical_potential_table)
    assert not ref_tables.ising and ref_tables.qary == 2
    # more ranks than the registers hold
    monkeypatch.setattr(chain, "ISING_MAX_WORDS", 0)
    with pytest.raises(NotImplementedError, match="registers"):
        _tables(_port("aucu_pt_3x3x3"), "ising")
    monkeypatch.undo()
    # Wang-Landau and table moves take the direct body only
    port = _port("aucu_pt_3x3x3")
    with pytest.raises(NotImplementedError, match="Queue 2"):
        TorchSampler.from_ensemble(port, kernel_type="wang-landau", nwalkers=8, seed=3,
                                   device="cpu", min_enthalpy=-30.0, max_enthalpy=0.0,
                                   bin_size=0.1, chain_delta="ising")
    with pytest.raises(NotImplementedError, match="Queue 2"):
        chain.make_shared_proposal_chain(_tables(port, "ising"), 10, wl=chain.WLChain(
            min_enthalpy=0.0, bin_size=1.0, num_levels=4, flatness=0.8,
            check_period=10, update_period=1, mod_divisor=2.0))
    table = _port("spinel_ewald_sgc_2x2x2")
    with pytest.raises(NotImplementedError, match="Queue 2"):
        TorchSampler.from_ensemble(table, 1000.0, 8, seed=3, device="cpu",
                                   step_type="table-flip", chain_delta="ising")


@pytest.mark.parametrize("stem,chain_name,words,expect", [
    ("spinel_2x2x2", "flip", 4, "ising"), ("spinel_3x3x3", "flip", 4, "ising"),
    ("aucu_4x4x4", "swap", 4, "ising"), ("spinel_ewald_2x2x2", "swap", 4, "ising"),
    ("spinel_3x3x3", "flip", 2, "direct"),  # 162 ranks above two words
    ("sgc_3x3x3", "flip", 4, "direct"),  # ternary: no Ising rows
    ("aucu_pt_3x3x3", "wl-flip", 4, "direct"), ("aucu_4x4x4", "wl-swap", 4, "direct"),
    ("spinel_ewald_sgc_2x2x2", "table", 4, "direct"),
])
def test_default_delta_names_the_samplers_body(monkeypatch, stem, chain_name, words,
                                               expect):
    """``default_delta`` is the one place the default body is chosen: K1-Ising
    on flips and swaps where the tables factor within ``ISING_MAX_WORDS``
    words, the direct lookup elsewhere; the kernels build what it names."""
    monkeypatch.setattr(chain, "ISING_MAX_WORDS", words)
    port = _port(stem)
    assert chain.default_delta(port.processor, port.sublattices, chain_name) == expect
    if chain_name in ("flip", "swap"):
        kernel = TorchSampler.from_ensemble(port, 1000.0, 8, seed=3, device="cpu",
                                            step_type=chain_name).mckernel
        assert kernel.chain_tables().delta == expect


@pytest.mark.parametrize("stem", ["spinel_2x2x2", "aucu_pt_3x3x3"])
def test_flip_delta_equals_full_recompute_and_direct(stem):
    """(b) for flips: every rank, two proposals each."""
    port = _port(stem)
    ising, direct = _tables(port, "ising"), _tables(port, "direct")
    theta = torch.as_tensor(port.natural_parameters)
    w = 12
    occu = torch.as_tensor(random_occupancies(port, w, seed=5))
    occ = occu[:, ising.rank_sites].T.to(torch.int8).contiguous()
    e_old = port.compute_features(occu) @ theta
    scale = max(1.0, float(e_old.abs().max()))
    beta32 = torch.full((w,), 10.0, dtype=torch.float32)
    worst = worst_direct = 0.0
    for r in range(ising.num_ranks):
        for draw in range(2):
            u = torch.full((w,), r, dtype=torch.int64)
            r_j = torch.arange(w, dtype=torch.int64) + draw
            zero = torch.zeros(w, dtype=torch.int64)
            _, b, dE, _, _ = chain.flip_step_reference(ising, occ, u, zero, r_j, beta32)
            _, b_direct, dE_direct, _, _ = chain.flip_step_reference(
                direct, occ, u, zero, r_j, beta32)
            assert torch.equal(b, b_direct)
            new = occu.clone()
            new[:, ising.rank_sites[r]] = b.to(new.dtype)
            exact = port.compute_features(new) @ theta - e_old
            worst = max(worst, float((dE - exact).abs().max()))
            worst_direct = max(worst_direct, float((dE - dE_direct).abs().max()))
    assert worst <= 1e-12 * scale, worst
    assert worst_direct <= 1e-12 * scale, worst_direct


@pytest.mark.parametrize("stem", ["spinel_ewald_2x2x2", "aucu_4x4x4"])
def test_swap_delta_equals_full_recompute_and_direct(stem):
    """(b) for swaps: every ordered rank pair, each on its own walker (the
    spinel's with the Ewald term)."""
    port = _port(stem)
    ising, direct = _tables(port, "ising", "swap"), _tables(port, "direct", "swap")
    theta = torch.as_tensor(port.natural_parameters)
    R = ising.num_ranks
    u, v = (x.reshape(-1) for x in torch.meshgrid(torch.arange(R), torch.arange(R),
                                                   indexing="ij"))
    occu = torch.as_tensor(random_occupancies(port, R * R, seed=8))
    occ = occu[:, ising.rank_sites].T.to(torch.int8).contiguous()
    before = occ.clone()
    args = (occ, u, v, torch.zeros(R * R, dtype=torch.int64),
            torch.full((R * R,), 10.0, dtype=torch.float32))
    accept, is_move, a, b, dE, _, _ = chain.swap_step_reference(ising, *args)
    dE_direct = chain.swap_step_reference(direct, *args)[4]
    assert torch.equal(occ, before)
    walkers = torch.arange(R * R)
    new = occu.clone()
    new[walkers, ising.rank_sites[u]] = b.to(new.dtype)
    new[walkers, ising.rank_sites[v]] = a.to(new.dtype)
    e_old = port.compute_features(occu) @ theta
    exact = port.compute_features(new) @ theta - e_old
    scale = max(1.0, float(e_old.abs().max()))
    assert float((dE - exact).abs().max()) <= 1e-12 * scale
    assert float((dE - dE_direct).abs().max()) <= 1e-12 * scale
    assert bool(is_move.any()) and not bool(accept[~is_move].any())
    assert bool((dE[~is_move] == 0).all())


def _ewald_f32_slack(tables):
    """Bound (eV) of the reference's f32 Ewald error on one swap delta (see
    ``tests/test_torch_swap.py``: two terms, each of R f32 products summed
    in any order and added to C_r in double-float)."""
    if not tables.has_ewald:
        return 0.0
    R = tables.num_ranks
    gamma = R * F32_EPS / (1 - R * F32_EPS)
    row = tables.ew_c.abs() + tables.ew_v.abs().sum(dim=1)
    return 2 * (gamma * (1 + 2 * F32_EPS) + 8 * F32_EPS**2) * float(row.max())


@pytest.mark.parametrize("name,move,n_steps,block,temperature", [
    ("spinel", "flip", 300, 64, 1000.0),
    ("aucu", "swap", 200, 32, 300.0),
    ("spinel_ewald", "swap", 200, 64, 1000.0),
])
def test_trajectory_parity(name, move, n_steps, block, temperature):
    """(d): the hash-mode Ising twin against the interpret-mode reference."""
    W, seed = 64, 2
    ref, port = _system(name)
    occ0 = random_occupancies(ref, W, seed)
    sampler = Sampler.from_ensemble(ref, temperature=temperature, nwalkers=W, seed=3)
    state = dict(sampler.setup_sample(occ0))
    state.pop("words", None)
    state["occupancy"] = jnp.asarray(occ0)
    mu = None if move == "swap" else ref.chemical_potential_table
    ref_tables = pallas_chain.build_chain_tables(ref.processor, ref.sublattices,
                                                 mu_table=mu)
    assert ref_tables.ising  # the reference takes its Ising body
    key = jax.random.key(seed)
    k_seed, k_seq = jax.random.split(jax.random.fold_in(key, 13))
    seed0 = jax.random.randint(k_seed, (), 0, np.int32(2**30 - 1), dtype=jnp.int32)
    shape = (1, -(-W // min(block, -(-W // 128) * 128)), n_steps)
    if move == "swap":
        seqs = [np.asarray(s, dtype=np.int32)
                for s in pallas_chain.rank_pair_sequence(ref_tables, k_seq, shape)]
    else:
        seqs = [np.asarray(pallas_chain.rank_sequence(ref_tables, k_seq, shape),
                           dtype=np.int32)]
    fn = pallas_chain.make_shared_proposal_chain(
        ref_tables, n_steps, block_size=block, interpret=True, move=move)
    out = {k: np.asarray(v) for k, v in fn(state, key).items()
           if k in ("occupancy", "enthalpy", "naccept")}

    tables = _tables(port, "ising", move)
    slack = _ewald_f32_slack(tables)
    occu = torch.as_tensor(occ0)
    occ = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
    enth = torch.tensor(np.array(state["enthalpy"]))
    beta32 = torch.tensor(np.array(state["beta"])).to(torch.float32)
    nacc = torch.zeros(W, dtype=torch.int32)
    margin = torch.full((W,), float("inf"))
    common = dict(seed=torch.tensor([int(seed0)]), tables=tables, n_steps=n_steps,
                  block_size=block, rng="hash", margin=margin)
    if move == "swap":
        chain.swap_chain_reference(occ, enth, nacc, torch.zeros(W, dtype=torch.int32),
                                   beta32, *(torch.as_tensor(s[0]) for s in seqs),
                                   slack=slack, **common)
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
    tol = 1e-9 + nacc.numpy()[same] * slack
    assert np.all(np.abs(enth.numpy()[same] - out["enthalpy"][same]) <= tol)
    assert 0 < out["naccept"].mean() < n_steps
    # the recorded enthalpy stays features . theta (parity e)
    theta = torch.as_tensor(port.natural_parameters)
    exact = port.compute_features(port_occ) @ theta
    assert float((exact - enth).abs().max()) < 1e-9
    if move == "swap":
        np.testing.assert_array_equal(np.sort(port_occ.numpy(), axis=1),
                                      np.sort(occ0, axis=1))
    # a sampler asked for the body names it, and takes it by default
    ewald = "+ewald" if tables.has_ewald else ""
    for delta in ("ising", None):
        port_sampler = TorchSampler.from_ensemble(port, temperature, 8, seed=3,
                                                  device="cpu", chain_delta=delta)
        path = port_sampler.execution_path(10)
        assert path == f"cpu-twin[{move}]{ewald}+ising+shared-proposals", path
    direct = TorchSampler.from_ensemble(port, temperature, 8, seed=3, device="cpu",
                                        chain_delta="direct")
    assert direct.execution_path(10) == f"cpu-twin[{move}]{ewald}+direct+shared-proposals"
