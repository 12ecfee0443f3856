"""Replica exchange (parallel tempering) in the port, against smol_tpu and
exact results.

- the ladder equals ``make_temperature_ladder``'s exactly;
- ``tempering_exchange`` (the exchange kernel's plain twin) equals the
  reference's on the same betas, enthalpies and uniforms (the reference's
  own ``jax.random.uniform`` draws), in both phases, for even and odd
  walker counts and with exact ties d == 0; ``exchange_betas`` on the CPU
  updates beta and its f32 copy alike;
- the CPU tempering chain equals the reference's ``make_tempering_chain``
  over its interpret-mode Pallas chain, occupancy for occupancy and beta
  for beta: Au-Cu 2x2x2 as ``tests/test_moca/test_tempering.py`` builds it,
  16 walkers, 6 segments of 5 steps, the per-segment sequences, seeds and
  exchange uniforms derived from the reference's keys; with the direct and
  with the Ising body;
- the sampler with a ladder and ``replica_exchange_period=10``: the betas
  of every record are a permutation of the ladder, ``get_temperatures``
  returns the records, the exchange counter counts segments, a ``thin_by``
  the period does not divide takes the per-step path (its counter counting
  steps), and the execution path ends in ``+replica-exchange@10``;
- (d) on the 8-site Au-Cu FCC with flips at zero chemical potential, each
  ladder temperature's mean enthalpy matches exact Boltzmann enumeration
  (256 states) within 4 standard errors (batch means over the records of
  the replicas at that temperature).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smol_tpu.benchmarks.systems import fcc_binary_prim, random_expansion
from smol_tpu.moca import Ensemble, Sampler
from smol_tpu.ops import pallas_chain
from smol_tpu.parallel import make_temperature_ladder as reference_ladder
from smol_tpu.parallel.tempering import make_tempering_chain as reference_tempering_chain
from smol_tpu.parallel.tempering import tempering_exchange as reference_exchange
from smol_tpu_torch.constants import kB
from smol_tpu_torch.moca.ensemble import Ensemble as TorchEnsemble
from smol_tpu_torch.moca.sampler.sampler import Sampler as TorchSampler
from smol_tpu_torch.ops import chain
from smol_tpu_torch.parallel import (
    exchange_attempts,
    exchange_betas,
    make_temperature_ladder,
    make_tempering_chain,
    tempering_exchange,
)
from smol_tpu_torch.system import export_system, load_system

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from export_torch_systems import data_path  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors, so that parallel test
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("geometric", [True, False])
def test_ladder_equals_reference(geometric):
    mine = make_temperature_ladder(300.0, 3000.0, 8192, geometric)
    np.testing.assert_array_equal(mine, reference_ladder(300.0, 3000.0, 8192, geometric))
    assert mine[0] == 300.0 and mine[-1] == 3000.0


@pytest.mark.parametrize("W", [16, 17])
@pytest.mark.parametrize("phase", [0, 1])
def test_exchange_equals_reference(W, phase):
    """The same decisions on the same uniforms, ties (d == 0) included."""
    rng = np.random.default_rng(W + 10 * phase)
    for trial in range(20):
        beta = 1.0 / (kB * rng.permutation(make_temperature_ladder(300.0, 3000.0, W)))
        enthalpy = rng.normal(scale=0.05, size=W)
        if trial % 2:  # exact ties d == 0: equal enthalpies, equal betas
            enthalpy[: W // 2] = enthalpy[0]
            beta[W // 2: W // 2 + 3] = beta[W // 2]
        key = jax.random.key(100 * W + trial)
        u = np.array(jax.random.uniform(key, (W,), dtype=jnp.float64))
        state = {"beta": jnp.asarray(beta), "enthalpy": jnp.asarray(enthalpy)}
        expect = np.asarray(reference_exchange(state, key, phase)["beta"])
        got = tempering_exchange(torch.as_tensor(beta), torch.as_tensor(enthalpy),
                                 torch.as_tensor(u), phase)
        np.testing.assert_array_equal(got.numpy(), expect)
        np.testing.assert_array_equal(np.sort(got.numpy()), np.sort(beta))
        # the wrapper on the CPU: in place, beta and its f32 copy together
        b64 = torch.as_tensor(beta.copy())
        b32 = b64.to(torch.float32)
        counts = torch.zeros(W, dtype=torch.int32)
        exchange_betas(b64, b32, torch.as_tensor(enthalpy), torch.as_tensor(u), phase,
                       counts)
        np.testing.assert_array_equal(b64.numpy(), expect)
        assert torch.equal(b32, b64.to(torch.float32))
        # one count per accepted pair, at its left member
        assert bool((counts <= 1).all()) and int(counts[1 - phase::2].sum()) == 0
        changed = int((b64 != torch.as_tensor(beta)).sum())
        assert changed <= 2 * int(counts.sum())
    # a tie d == 0 exchanges; the unpaired ends never move
    beta = torch.tensor([2.0, 1.0, 3.0])
    same = torch.zeros(3, dtype=torch.float64)
    out = tempering_exchange(beta.double(), same, torch.full((3,), 0.5, dtype=torch.float64), 0)
    assert out.tolist() == [1.0, 2.0, 3.0]
    out = tempering_exchange(beta.double(), same, torch.full((3,), 0.5, dtype=torch.float64), 1)
    assert out.tolist() == [2.0, 3.0, 1.0]


def _pt_reference():
    """Au-Cu 2x2x2 as the reference's tempering test builds it."""
    ce = random_expansion(fcc_binary_prim(), {2: 3.0}, seed=2)
    return Ensemble.from_cluster_expansion(
        ce, np.diag([2, 2, 2]), chemical_potentials={"Au": 0.0, "Cu": 0.0})


@pytest.fixture(scope="module")
def pt_system():
    ref = _pt_reference()
    return ref, TorchEnsemble.from_system(export_system(ref), "cpu")


def _reference_segment_draws(ref_tables, key, n_steps, W, block_size):
    """The reference wrapper's seqs and chunk seeds of one segment
    (pallas_chain :2040-2091)."""
    wb = min(block_size, -(-W // 128) * 128)
    grid = -(-W // wb)
    chunk = min(n_steps, pallas_chain.MAX_CHUNK_STEPS)
    n_chunks = -(-n_steps // chunk)
    k_seed, k_seq = jax.random.split(jax.random.fold_in(key, 13))
    seed0 = jax.random.randint(k_seed, (), 0, np.int32(2**30 - 1), dtype=jnp.int32)
    seqs = pallas_chain.rank_sequence(ref_tables, k_seq, (n_chunks, grid, chunk))
    seeds = seed0 + jnp.arange(n_chunks, dtype=jnp.int32) * jnp.int32(999983)
    return np.asarray(seqs, dtype=np.int32), np.asarray(seeds, dtype=np.int64)


@pytest.mark.parametrize("delta", ["direct", "ising"])
def test_tempering_chain_equals_reference(pt_system, delta):
    """Occupancy for occupancy and beta for beta over 6 segments of 5 steps."""
    ref, port = pt_system
    W, period, n_seg, block = 16, 5, 6, 8
    ladder = make_temperature_ladder(300.0, 3000.0, W)
    sampler = Sampler.from_ensemble(ref, temperature=ladder, nwalkers=W, seed=11,
                                    replica_exchange_period=period)
    occ0 = np.random.default_rng(0).integers(0, 2, (W, ref.num_sites)).astype(np.int32)
    state = dict(sampler.setup_sample(occ0))
    state.pop("words", None)
    state["occupancy"] = jnp.asarray(occ0)
    ref_tables = pallas_chain.build_chain_tables(
        ref.processor, ref.sublattices, mu_table=ref.chemical_potential_table)
    assert ref_tables.ising  # the reference takes its Ising body
    inner = pallas_chain.make_shared_proposal_chain(ref_tables, period,
                                                    block_size=block, interpret=True)
    key = jax.random.key(7)
    out = reference_tempering_chain(inner, n_seg)(dict(state), key)

    # the reference's per-segment keys: its sequences, seeds and uniforms
    seqs, seeds, uniforms = [], [], []
    for k in jax.random.split(key, n_seg):
        k_seg, k_ex = jax.random.split(k)
        seq, seed = _reference_segment_draws(ref_tables, k_seg, period, W, block)
        seqs.append(seq)
        seeds.append(seed)
        uniforms.append(np.asarray(jax.random.uniform(k_ex, (W,), dtype=jnp.float64)))
    tables = chain.build_chain_tables(port.processor, port.sublattices,
                                      mu_table=port.chemical_potential_table, delta=delta)
    period_chain = chain.make_shared_proposal_chain(
        tables, period, block_size=block, rng="hash", seqs=np.stack(seqs),
        seeds=np.stack(seeds))
    run = make_tempering_chain(period_chain, n_seg, uniforms=np.stack(uniforms))
    mine = {
        "occupancy": torch.as_tensor(occ0).clone(),
        "enthalpy": torch.tensor(np.array(state["enthalpy"])),
        "beta": torch.tensor(np.array(state["beta"])),
        "naccept": torch.zeros(W, dtype=torch.int32),
        "accepted": torch.ones(W, dtype=torch.bool),
        "pt_counter": 0,
    }
    mine = run(mine, None)
    assert mine["pt_counter"] == int(out["pt_counter"]) == n_seg
    np.testing.assert_array_equal(mine["beta"].numpy(), np.asarray(out["beta"]))
    np.testing.assert_array_equal(mine["occupancy"].numpy(), np.asarray(out["occupancy"]))
    np.testing.assert_array_equal(mine["naccept"].numpy(), np.asarray(out["naccept"]))
    np.testing.assert_allclose(mine["enthalpy"].numpy(), np.asarray(out["enthalpy"]),
                               rtol=0, atol=1e-9)
    assert not np.array_equal(np.asarray(out["beta"]), np.asarray(state["beta"]))
    assert 0 < int(mine["naccept"].sum()) < W * period * n_seg


def test_sampler_runs_replica_exchange():
    port = TorchEnsemble.from_system(load_system(data_path("aucu_pt_3x3x3")), "cpu")
    W, period = 16, 10
    ladder = make_temperature_ladder(300.0, 3000.0, W)
    sampler = TorchSampler.from_ensemble(port, temperature=ladder, nwalkers=W, seed=3,
                                         device="cpu", replica_exchange_period=period,
                                         chain_delta="ising")
    assert sampler.execution_path(50).endswith("+ising+shared-proposals+replica-exchange@10")
    occ0 = np.random.default_rng(0).integers(0, 2, (W, port.num_sites))
    sampler.run(400, occ0, thin_by=50)
    temps = sampler.samples.get_temperatures(flat=False)  # [S, W]
    assert temps.shape == (8, W)
    records = sampler.samples.get_trace_value("temperature", flat=False)
    np.testing.assert_array_equal(temps, records)
    recorded_ladder = 1.0 / (kB * (1.0 / (kB * ladder)))  # T -> beta -> T, rounded
    for t in temps:  # every record a permutation of the ladder, exactly
        np.testing.assert_array_equal(np.sort(t), recorded_ladder)
    assert not np.array_equal(temps[-1], ladder)  # exchanges happened
    np.testing.assert_array_equal(temps[-1], 1.0 / (kB * sampler._state["beta"].numpy()))
    assert sampler._state["pt_counter"] == 400 // period
    accepted = int(sampler._state["pt_accepted"].sum())
    assert 0 < accepted <= exchange_attempts(W, 400 // period)
    feats = sampler.samples.get_feature_vectors()
    enth = sampler.samples.get_enthalpies()
    assert np.abs(feats @ port.natural_parameters - enth).max() < 1e-9
    # a window the period does not divide takes the per-step path, whose
    # counter goes on counting steps; the exchange still permutes the ladder
    assert sampler.execution_path(15) == (
        "cpu-step[flip]+general+independent-proposals+replica-exchange@10")
    sampler.run(45, thin_by=15)
    assert sampler.samples.num_samples == 8 + 3
    assert sampler._state["pt_counter"] == 400 // period + 45
    for t in sampler.samples.get_temperatures(flat=False):
        np.testing.assert_array_equal(np.sort(t), recorded_ladder)
    feats = sampler.samples.get_feature_vectors()
    enth = sampler.samples.get_enthalpies()
    assert np.abs(feats @ port.natural_parameters - enth).max() < 1e-9
    short = TorchSampler.from_ensemble(port, temperature=ladder, nwalkers=8, seed=3,
                                       device="cpu", replica_exchange_period=period)
    with pytest.raises(ValueError, match="ladder of 16 for 8 walkers"):
        short.setup_sample(occ0[:8])
    with pytest.raises(ValueError, match="temperature"):
        TorchSampler.from_ensemble(port, kernel_type="wang-landau", nwalkers=8, seed=3,
                                   device="cpu", min_enthalpy=-30.0, max_enthalpy=0.0,
                                   bin_size=0.1, replica_exchange_period=10)


def test_ladder_averages_match_enumeration():
    """(d): every ladder temperature's mean enthalpy, 8 active sites."""
    system = load_system(data_path("aucu_nn_2x2x2"))
    port = TorchEnsemble.from_system(system, "cpu")
    h = system["exact_enthalpies"]
    temperatures = make_temperature_ladder(600.0, 4000.0, 6)
    copies = 8
    ladder = np.tile(temperatures, copies)  # every pair is a valid exchange
    W = len(ladder)
    sampler = TorchSampler.from_ensemble(port, temperature=ladder, nwalkers=W, seed=23,
                                         device="cpu", chain_block_size=1,
                                         replica_exchange_period=10)
    occ0 = np.random.default_rng(4).integers(0, 2, (W, port.num_sites))
    sampler.run(4000, occ0, thin_by=20)
    discard = 40
    enth = sampler.samples.get_enthalpies(discard=discard, flat=False)  # [S, W]
    temps = sampler.samples.get_temperatures(discard=discard, flat=False)
    batches = 10
    for t in temperatures:
        at = np.isclose(temps, t, rtol=1e-12, atol=0)
        assert np.all(at.sum(axis=1) == copies)
        series = np.where(at, enth, 0.0).sum(axis=1) / copies  # [S]
        means = np.array([b.mean() for b in np.array_split(series, batches)])
        sem = means.std(ddof=1) / np.sqrt(batches)
        weights = np.exp(-(h - h.min()) / (kB * t))
        exact = float(h @ weights / weights.sum())
        assert abs(series.mean() - exact) < 4 * sem, (t, series.mean(), exact, sem)
