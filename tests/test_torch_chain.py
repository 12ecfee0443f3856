"""The port's flip chain against smol_tpu's Pallas chain and exact results.

- the chain tables hold the reference's rank layout;
- (b) the twin's energy delta equals a full recompute of features . theta
  to 1e-10 absolute, for every rank and proposal;
- (c) trajectories: fed the reference wrapper's own site sequences and
  seeds, the port's hash-mode chain reproduces the interpret-mode Pallas
  chain occupancy for occupancy (bench spinel: 64 walkers, 300 steps,
  block 64; ternary FCC: two blocks).  A walker may differ only if the
  port shows one of its decisions within 4 f32 ulps of log U: the
  reference takes the spinel's Ising delta (<= 1e-11 relative from the
  direct lookup) and XLA's and torch's f32 log may differ in the last bit;
- (d) single-flip averages match brute-force Boltzmann enumeration of an
  8-site cell within 5 standard errors (per-walker means, independent
  walkers), for random and sweep proposals;
- the kernel wrapper checks its operands, runs the twin for CPU tensors
  and counts only kernel launches (the kernel itself is compared with the
  twin in ``tests/test_torch_kernel.py``).
"""

import sys
from itertools import product
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smol_tpu.benchmarks.systems import fcc_ternary_prim, random_expansion
from smol_tpu.moca import Ensemble, Sampler
from smol_tpu.ops import pallas_chain
from smol_tpu_torch.benchmarks.systems import random_expansion as torch_random_expansion
from smol_tpu_torch.benchmarks.systems import spinel_prim as torch_spinel_prim
from smol_tpu_torch.constants import kB
from smol_tpu_torch.moca.ensemble import Ensemble as TorchEnsemble
from smol_tpu_torch.moca.ensemble import random_occupancies
from smol_tpu_torch.moca.sampler.sampler import Sampler as TorchSampler
from smol_tpu_torch.ops import chain
from smol_tpu_torch.system import export_system, load_system

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from export_torch_systems import BENCH_MUS, ROOT, spinel_ensemble  # noqa: E402

ULP_SLACK = 4


def _ternary_ensemble():
    ce = random_expansion(fcc_ternary_prim(), {2: 5.5, 3: 4.0}, seed=7)
    return Ensemble.from_cluster_expansion(
        ce, np.diag([2, 2, 2]), processor_type="expansion",
        chemical_potentials={"Au": 0.05, "Ag": 0.0, "Cu": -0.05},
    )


@pytest.fixture(scope="module")
def spinel():
    ref = spinel_ensemble(2)
    return ref, TorchEnsemble.from_system(export_system(ref), "cpu")


@pytest.fixture(scope="module")
def ternary():
    ref = _ternary_ensemble()
    return ref, TorchEnsemble.from_system(export_system(ref), "cpu")


def _tables(port):
    return chain.build_chain_tables(
        port.processor, port.sublattices,
        mu_table=port.chemical_potential_table,
    )


@pytest.mark.parametrize("system", ["spinel", "ternary"])
def test_tables_follow_reference_rank_layout(system, request):
    ref, port = request.getfixturevalue(system)
    ref_tables = pallas_chain.build_chain_tables(
        ref.processor, ref.sublattices, mu_table=ref.chemical_potential_table
    )
    tables = _tables(port)
    np.testing.assert_array_equal(
        tables.rank_sites.numpy(), np.asarray(ref_tables.rank_sites)
    )
    np.testing.assert_array_equal(tables.ncode.numpy(), np.asarray(ref_tables.ncod)[0])
    np.testing.assert_allclose(tables.cum_probs, ref_tables.cum_probs, rtol=0)
    rank_sites = np.asarray(ref_tables.rank_sites)
    np.testing.assert_array_equal(
        tables.mu.numpy(), ref.chemical_potential_table[rank_sites]
    )
    # the reference splits f64 into two f32 words (~2**-45 relative)
    mu_ref = np.asarray(ref_tables.mu, dtype=np.float64)
    C = ref_tables.mu_cols
    np.testing.assert_allclose(
        tables.mu.numpy(), mu_ref[:, :C] + mu_ref[:, C:], rtol=1e-12, atol=1e-15
    )


@pytest.mark.parametrize("system", ["spinel", "ternary"])
def test_delta_equals_full_recompute(system, request):
    """(b): dE of every (rank, proposal) == features(new) . theta - old."""
    ref, port = request.getfixturevalue(system)
    tables = _tables(port)
    theta = torch.as_tensor(port.natural_parameters)
    W = 12
    occu = torch.as_tensor(random_occupancies(ref, W, seed=5))
    occ = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
    e_old = port.compute_features(occu) @ theta
    beta32 = torch.full((W,), 10.0, dtype=torch.float32)
    worst = 0.0
    for r in range(tables.num_ranks):
        for draw in range(2):
            u = torch.full((W,), r, dtype=torch.int64)
            r_j = torch.arange(W, dtype=torch.int64) + draw
            _, b, dE, _, _ = chain.flip_step_reference(
                tables, occ, u, torch.zeros(W, dtype=torch.int64), r_j, beta32
            )
            new = occu.clone()
            new[:, tables.rank_sites[r]] = b.to(new.dtype)
            exact = port.compute_features(new) @ theta - e_old
            worst = max(worst, float((dE - exact).abs().max()))
            assert torch.all(b != occu[:, tables.rank_sites[r]])
    assert worst <= 1e-10, worst


def _reference_draws(ref_tables, key, n_steps, W, block_size):
    """The reference wrapper's seqs and chunk seeds (pallas_chain :2040-2091)."""
    wb = min(block_size, -(-W // 128) * 128)
    grid = -(-W // wb)
    chunk = min(n_steps, pallas_chain.MAX_CHUNK_STEPS)
    n_chunks = -(-n_steps // chunk)
    k_seed, k_seq = jax.random.split(jax.random.fold_in(key, 13))
    seed0 = jax.random.randint(k_seed, (), 0, np.int32(2**30 - 1), dtype=jnp.int32)
    seqs = pallas_chain.rank_sequence(ref_tables, k_seq, (n_chunks, grid, chunk))
    seeds = seed0 + jnp.arange(n_chunks, dtype=jnp.int32) * jnp.int32(999983)
    return np.asarray(seqs, dtype=np.int32), np.asarray(seeds, dtype=np.int64)


def _port_with_margins(tables, occu, enthalpy, beta, seqs, seeds, n_steps,
                       block_size):
    """Hash-mode twin chunk by chunk, with each walker's closest decision,
    summing at the lanes the flip launch takes (``chain.flip_lanes``).

    Returns (occupancy, enthalpy, naccept, margin) where margin is the
    smallest |expo - log U| over the run, in f32 ulps of log U.
    """
    W = occu.shape[0]
    occ = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
    enthalpy = enthalpy.clone()
    nacc = torch.zeros(W, dtype=torch.int32)
    margin = torch.full((W,), float("inf"))
    chunk = seqs.shape[2]
    for c, seed in enumerate(seeds):
        chain.flip_chain_reference(
            occ, enthalpy, nacc, beta.to(torch.float32), torch.as_tensor(seqs[c]),
            torch.tensor([seed]), tables, min(chunk, n_steps - c * chunk),
            block_size, "hash", margin=margin, lanes=chain.flip_lanes(tables, W),
        )
    out = occu.clone()
    out[:, tables.rank_sites] = occ.T.to(out.dtype)
    return out, enthalpy, nacc, margin


def _trajectory_parity(ref, port, W, n_steps, block_size, temperature, seed):
    sampler = Sampler.from_ensemble(ref, temperature=temperature, nwalkers=W, seed=3)
    occ0 = random_occupancies(ref, W, seed)
    state = dict(sampler.setup_sample(occ0))
    state.pop("words", None)
    state["occupancy"] = jnp.asarray(occ0)
    ref_tables = pallas_chain.build_chain_tables(
        ref.processor, ref.sublattices, mu_table=ref.chemical_potential_table
    )
    key = jax.random.key(seed)
    seqs, seeds = _reference_draws(ref_tables, key, n_steps, W, block_size)
    fn = pallas_chain.make_shared_proposal_chain(
        ref_tables, n_steps, block_size=block_size, interpret=True
    )
    out = fn(state, key)
    ref_occ = np.asarray(out["occupancy"])
    ref_enth = np.asarray(out["enthalpy"])
    ref_nacc = np.asarray(out["naccept"])

    tables = _tables(port)
    enthalpy = torch.tensor(np.array(state["enthalpy"]))
    beta = torch.tensor(np.array(state["beta"]))
    occ, enth, nacc, margin = _port_with_margins(
        tables, torch.as_tensor(occ0), enthalpy, beta, seqs, seeds, n_steps,
        block_size,
    )

    # the chain factory, fed the same draws, is the twin loop exactly
    port_state = {
        "occupancy": torch.as_tensor(occ0).clone(),
        "enthalpy": enthalpy.clone(),
        "beta": beta,
        "naccept": torch.zeros(W, dtype=torch.int32),
        "accepted": torch.ones(W, dtype=torch.bool),
    }
    run = chain.make_shared_proposal_chain(
        tables, n_steps, block_size=block_size, rng="hash", seqs=seqs, seeds=seeds
    )
    port_state = run(port_state, None)
    assert torch.equal(port_state["occupancy"], occ)
    assert torch.equal(port_state["enthalpy"], enth)
    assert torch.equal(port_state["naccept"], nacc)

    same = np.all(occ.numpy() == ref_occ, axis=1)
    for w in np.flatnonzero(~same):
        assert margin[w] <= ULP_SLACK, (w, float(margin[w]))
    assert same.mean() >= 0.9, same.mean()
    np.testing.assert_array_equal(nacc.numpy()[same], ref_nacc[same])
    np.testing.assert_allclose(enth.numpy()[same], ref_enth[same], rtol=0, atol=1e-9)
    assert 0 < ref_nacc.mean() < n_steps
    return same


def test_trajectory_parity_spinel(spinel):
    """(c) on the bench spinel (the reference takes its Ising delta)."""
    ref, port = spinel
    _trajectory_parity(ref, port, W=64, n_steps=300, block_size=64,
                       temperature=1000.0, seed=0)


def test_trajectory_parity_ternary(ternary):
    """(c) on a ternary FCC: hashed code draws, two walker blocks."""
    ref, port = ternary
    _trajectory_parity(ref, port, W=32, n_steps=150, block_size=16,
                       temperature=800.0, seed=1)


def _binary_fcc_8():
    from smol_tpu.cofe import ClusterSubspace
    from smol_tpu.cofe.expansion import ClusterExpansion
    from smol_tpu.crystal import Lattice, Structure

    lat = Lattice(np.array([[0, 0.5, 0.5], [0.5, 0, 0.5], [0.5, 0.5, 0]]) * 3.8)
    prim = Structure(lat, [{"Au": 0.5, "Cu": 0.5}], [[0, 0, 0]])
    cs = ClusterSubspace.from_cutoffs(prim, {2: 3.0})
    coefs = np.random.default_rng(5).normal(scale=0.02, size=cs.num_corr_functions)
    coefs[0] = -0.5
    return Ensemble.from_cluster_expansion(
        ClusterExpansion(cs, coefs), np.diag([2, 2, 2]),
        processor_type="expansion", chemical_potentials={"Au": 0.05, "Cu": -0.05},
    )


@pytest.mark.parametrize("proposal_mode", ["random", "sweep"])
def test_averages_match_enumeration(proposal_mode):
    """(d): 8 active sites, 256 states, T = 2000 K."""
    ref = _binary_fcc_8()
    temperature = 2000.0
    beta = 1.0 / (kB * temperature)
    states = np.array(list(product((0, 1), repeat=ref.num_sites)), dtype=np.int32)
    port = TorchEnsemble.from_system(export_system(ref), "cpu")
    h = (port.compute_features(torch.as_tensor(states)) @ torch.as_tensor(
        port.natural_parameters)).numpy()
    ref_h = np.array([ref.compute_feature_vector(s) @ ref.natural_parameters
                      for s in states[::37]])
    np.testing.assert_allclose(h[::37], ref_h, rtol=0, atol=1e-12)
    weights = np.exp(-beta * (h - h.min()))
    exact = float(h @ weights / weights.sum())

    W = 64
    sampler = TorchSampler.from_ensemble(
        port, temperature, nwalkers=W, seed=23, device="cpu", chain_block_size=1,
        proposal_mode=proposal_mode,
    )
    occ0 = np.random.default_rng(4).integers(0, 2, (W, ref.num_sites))
    sampler.run(3000, occ0, thin_by=20)
    enth = sampler.samples.get_enthalpies(discard=30, flat=False)  # [S, W]
    walker_means = enth.mean(axis=0)
    sem = walker_means.std(ddof=1) / np.sqrt(W)
    mc_mean = float(sampler.samples.mean_enthalpy(discard=30))
    assert abs(mc_mean - walker_means.mean()) < 1e-12
    assert abs(mc_mean - exact) < 5 * sem, (mc_mean, exact, sem)


def _chain_operands(port, W=8, block_size=8):
    tables = _tables(port)
    occu = torch.zeros((W, port.num_sites), dtype=torch.int32)
    return dict(
        occ=occu[:, tables.rank_sites].T.to(torch.int8).contiguous(),
        enthalpy=torch.zeros(W, dtype=torch.float64),
        naccept=torch.zeros(W, dtype=torch.int32),
        beta32=torch.full((W,), 5.0, dtype=torch.float32),
        seq=torch.zeros((-(-W // block_size), 10), dtype=torch.int32),
        seed=torch.zeros(1, dtype=torch.int64),
        tables=tables, n_steps=10, block_size=block_size,
    )


def test_wrapper_runs_twin_on_cpu_and_checks_operands(spinel):
    _, port = spinel
    before = chain.flip_chain.launches
    ops = _chain_operands(port)
    chain.flip_chain(**ops)
    assert chain.flip_chain.launches == before  # the twin is not a launch
    assert int(ops["naccept"].sum()) > 0
    for name, bad in (
        ("occ", ops["occ"].to(torch.int32)),
        ("enthalpy", ops["enthalpy"].float()),
        ("seq", ops["seq"][:, :5]),
        ("seed", torch.zeros(2, dtype=torch.int64)),
    ):
        with pytest.raises(ValueError):
            chain.flip_chain(**{**ops, name: bad})


def test_sampler_device_is_explicit(spinel):
    _, port = spinel
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSampler.from_ensemble(port, 1000.0, nwalkers=4, seed=1)
    # a bias takes the per-step path; a file's sublattices carry no charges
    d = sum(len(s.encoding) for s in port.sublattices)
    biased = TorchSampler.from_ensemble(
        port, 1000.0, nwalkers=4, seed=1, device="cpu", bias_type="square-hyperplane-bias",
        bias_kwargs={"hyperplane_normals": [[1.0] + [0.0] * (d - 1)],
                     "hyperplane_intercepts": [4.0]})
    assert biased.execution_path(10) == "cpu-step[flip]+general+independent-proposals"
    with pytest.raises(ValueError, match="no species"):
        TorchSampler.from_ensemble(port, 1000.0, nwalkers=4, seed=1, device="cpu",
                                   bias_type="square-charge-bias")
    with pytest.raises(ValueError, match="no species"):  # a file: no flip table,
        TorchSampler.from_ensemble(port, 1000.0, nwalkers=4, seed=1, device="cpu",  # no species
                                   step_type="table-flip")
    # built here, the spinel derives the flip table stored with its Ewald form
    built = TorchEnsemble.from_cluster_expansion(
        torch_random_expansion(torch_spinel_prim(), {2: 5.3, 3: 3.7}, seed=11),
        np.diag([2, 2, 2]), processor_type="expansion", chemical_potentials=BENCH_MUS,
        device="cpu")
    usher = TorchSampler.from_ensemble(built, 1000.0, nwalkers=4, seed=1, device="cpu",
                                       step_type="table-flip").mckernel.mcusher
    stored = load_system(ROOT / "tests" / "data" / "torch_spinel_ewald_sgc_2x2x2.npz")
    np.testing.assert_array_equal(usher.flip_table, stored["flip_table"])
    np.testing.assert_array_equal(np.concatenate(usher.dim_ids), stored["usher_dim_ids"])
    uniform = TorchSampler.from_ensemble(port, nwalkers=4, seed=1, device="cpu",
                                         kernel_type="uniformly-random")
    assert uniform.execution_path(10) == "cpu-step[flip]+general+independent-proposals"
    with pytest.raises(TypeError):  # Wang-Landau takes a window, no temperature
        TorchSampler.from_ensemble(port, 1000.0, nwalkers=4, seed=1, device="cpu",
                                   kernel_type="wang-landau")
    # replica exchange is ported: a window the period does not divide takes
    # the per-step path, and a ladder needs one temperature per walker
    tempering = TorchSampler.from_ensemble(port, [900.0, 1000.0], nwalkers=4, seed=1,
                                           device="cpu", replica_exchange_period=10)
    assert tempering.execution_path(15) == (
        "cpu-step[flip]+general+independent-proposals+replica-exchange@10")
    with pytest.raises(ValueError, match="ladder"):
        tempering.setup_sample(np.zeros((4, port.num_sites), dtype=np.int32))
