"""The port's Wang-Landau path against smol_tpu's and exact degeneracies.

1. Chain level.  Fed the reference wrapper's own sequences and chunk seeds,
   the port's hash-mode twin (``ops/chain.py:wl_chain_reference``)
   reproduces the interpret-mode Pallas Wang-Landau chain on every walker:
   occupancy, entropy, histogram, occurrences, ``mod_factor``,
   ``wl_counter`` and ``naccept`` exactly (integers and ``mod_factor``
   exact; entropy exact, since with ``mod_divisor = 2`` every entropy is a
   short dyadic sum that f64 and the reference's double-float pair both
   hold), enthalpy to 1e-9.  The reference bins in f32 and XLA's and
   torch's f32 log may differ in the last bit, so a walker may differ only
   if the twin shows one of its window coordinates within ``ULP_SLACK`` f32
   ulps of a bin edge, or one of its decisions within ``ULP_SLACK`` f32 ulps
   of log U; such walkers are counted and must stay below ``EXCUSED_SHARE``.
   On the 8-site system the levels sit mid-bin and nothing is excused.
2. Kernel level.  ``WangLandau.make_chain_fn`` against the reference's:
   the boundary recompute of the enthalpy and the per-bin mean features
   and their counts.
3. Sampler level, on the port alone: the density of states of the 8-site
   system against its exact degeneracies, the aux records' cadence, and a
   resume into a fresh sampler.
4. What the port refuses.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smol_tpu.moca import Sampler
from smol_tpu.ops import pallas_chain
from smol_tpu_torch.moca.ensemble import Ensemble as TorchEnsemble
from smol_tpu_torch.moca.kernel.wanglandau import WangLandau
from smol_tpu_torch.moca.sampler.sampler import Sampler as TorchSampler
from smol_tpu_torch.ops import chain
from smol_tpu_torch.system import load_system

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from export_torch_systems import (  # noqa: E402
    aucu_ensemble,
    aucu_nn_ensemble,
    data_path,
    half_occupancies,
)

ULP_SLACK = 4
EXCUSED_SHARE = 0.05  # most walkers that may differ from the reference's


@pytest.fixture(scope="module")
def nn():
    """The 8-site nearest-neighbour system: (reference, port, window)."""
    ref = aucu_nn_ensemble()
    system = load_system(data_path("aucu_nn_2x2x2"))
    levels = np.unique(np.round(system["exact_enthalpies"], 9))
    bin_size = float(levels[1] - levels[0])
    window = dict(min_enthalpy=float(levels[0] - bin_size / 2),
                  max_enthalpy=float(levels[-1] + bin_size), bin_size=bin_size)
    return ref, TorchEnsemble.from_system(system, "cpu"), window


@pytest.fixture(scope="module")
def bench():
    """The bench's Wang-Landau system, Au-Cu 3x3x3, with its ~250 bins."""
    ref = aucu_ensemble(3)
    system = load_system(data_path("aucu_wl_3x3x3"))
    window = dict(min_enthalpy=float(system["wl_min_enthalpy"]),
                  max_enthalpy=float(system["wl_max_enthalpy"]),
                  bin_size=float(system["wl_bin_size"]))
    return ref, TorchEnsemble.from_system(system, "cpu"), window


@pytest.fixture(scope="module")
def aucu4():
    """Au-Cu 4x4x4 with the window of its half-and-half composition."""
    ref = aucu_ensemble(4)
    system = load_system(data_path("aucu_4x4x4"))
    window = dict(min_enthalpy=float(system["wl_min_enthalpy"]),
                  max_enthalpy=float(system["wl_max_enthalpy"]),
                  bin_size=float(system["wl_bin_size"]))
    return ref, TorchEnsemble.from_system(system, "cpu"), window


def _wl_params(window, **options):
    levels = np.arange(window["min_enthalpy"], window["max_enthalpy"],
                       window["bin_size"])
    params = dict(min_enthalpy=window["min_enthalpy"], bin_size=window["bin_size"],
                  num_levels=len(levels), flatness=0.8, check_period=1000,
                  update_period=1, mod_divisor=2.0)
    params.update(options)
    return params


def _reference_draws(ref_tables, key, n_steps, W, block_size, move):
    """The reference wrapper's seqs and chunk seeds (pallas_chain :2040-2091)."""
    wb = min(block_size, -(-W // 128) * 128)
    shape = (-(-n_steps // min(n_steps, pallas_chain.MAX_CHUNK_STEPS)), -(-W // wb),
             min(n_steps, pallas_chain.MAX_CHUNK_STEPS))
    k_seed, k_seq = jax.random.split(jax.random.fold_in(key, 13))
    seed0 = jax.random.randint(k_seed, (), 0, np.int32(2**30 - 1), dtype=jnp.int32)
    if move == "swap":
        seqs = pallas_chain.rank_pair_sequence(ref_tables, k_seq, shape)
    else:
        seqs = (pallas_chain.rank_sequence(ref_tables, k_seq, shape),)
    seeds = seed0 + jnp.arange(shape[0], dtype=jnp.int32) * jnp.int32(999983)
    return ([np.asarray(s, dtype=np.int32) for s in seqs],
            np.asarray(seeds, dtype=np.int64))


def _chain_parity(ref, port, params, move, occ0, n_steps, block_size, seed,
                  excuses=True):
    """Reference interpret-mode chain against the port's twin; returns the
    share of walkers that differ (each one excused by a margin)."""
    W = len(occ0)
    mu = None if move == "swap" else ref.chemical_potential_table
    ref_tables = pallas_chain.build_chain_tables(ref.processor, ref.sublattices,
                                                 mu_table=mu)
    tables = chain.build_chain_tables(
        port.processor, port.sublattices,
        mu_table=None if move == "swap" else port.chemical_potential_table)
    theta = torch.as_tensor(port.natural_parameters)
    enthalpy = port.compute_features(torch.as_tensor(occ0)) @ theta
    B = params["num_levels"]
    start = 1.0

    state = {
        "occupancy": jnp.asarray(occ0), "enthalpy": jnp.asarray(enthalpy.numpy()),
        "naccept": jnp.zeros(W, jnp.int32), "accepted": jnp.ones(W, bool),
        "entropy": jnp.zeros((W, B)), "histogram": jnp.zeros((W, B), jnp.int32),
        "occurrences": jnp.zeros((W, B), jnp.int32),
        "mod_factor": jnp.full(W, start), "wl_counter": jnp.zeros(W, jnp.int32),
    }
    key = jax.random.key(seed)
    seqs, seeds = _reference_draws(ref_tables, key, n_steps, W, block_size, move)
    fn = pallas_chain.make_shared_proposal_chain(
        ref_tables, n_steps, block_size=block_size, interpret=True, move=move,
        wl=pallas_chain.WLChain(**params))
    out = {k: np.asarray(v) for k, v in fn(state, key).items()}

    # the twin, chunk by chunk, with each walker's margins
    wl = chain.WLChain(**params)
    occ = torch.as_tensor(occ0)[:, tables.rank_sites].T.to(torch.int8).contiguous()
    twin = dict(
        occ=occ, enthalpy=enthalpy.clone(),
        naccept=torch.zeros(W, dtype=torch.int32),
        entropy=torch.zeros((B, W), dtype=torch.float64),
        histogram=torch.zeros((B, W), dtype=torch.int32),
        occurrences=torch.zeros((B, W), dtype=torch.int32),
        mod_factor=torch.full((W,), start, dtype=torch.float64),
        wl_counter=torch.zeros(W, dtype=torch.int32),
    )
    margin = torch.full((W,), float("inf"))
    bin_margin = torch.full((W,), float("inf"), dtype=torch.float64)
    chunk = seqs[0].shape[2]
    for c, chunk_seed in enumerate(seeds):
        chain.wl_chain_reference(
            **twin, seqs=[torch.as_tensor(s[c]) for s in seqs],
            seed=torch.tensor([chunk_seed]), tables=tables, wl=wl,
            n_steps=min(chunk, n_steps - c * chunk), block_size=block_size,
            move=move, rng="hash", margin=margin, bin_margin=bin_margin)

    # the chain factory, fed the same draws, is that loop exactly
    port_state = {
        "occupancy": torch.as_tensor(occ0).clone(), "enthalpy": enthalpy.clone(),
        "naccept": torch.zeros(W, dtype=torch.int32),
        "accepted": torch.ones(W, dtype=torch.bool),
        "entropy": torch.zeros((W, B), dtype=torch.float64),
        "histogram": torch.zeros((W, B), dtype=torch.int32),
        "occurrences": torch.zeros((W, B), dtype=torch.int32),
        "mod_factor": torch.full((W,), start, dtype=torch.float64),
        "wl_counter": torch.zeros(W, dtype=torch.int32),
    }
    run = chain.make_shared_proposal_chain(
        tables, n_steps, block_size=block_size, rng="hash", move=move, wl=wl,
        seqs=seqs if move == "swap" else seqs[0], seeds=seeds)
    port_state = run(port_state, None)
    assert torch.equal(port_state["occupancy"][:, tables.rank_sites].T.to(torch.int8), occ)
    for name in ("entropy", "histogram", "occurrences"):
        assert torch.equal(port_state[name], twin[name].T), name
    for name in ("enthalpy", "naccept", "mod_factor", "wl_counter"):
        assert torch.equal(port_state[name], twin[name]), name

    got = {
        "occupancy": port_state["occupancy"].numpy(),
        **{name: port_state[name].numpy() for name in (
            "entropy", "histogram", "occurrences", "mod_factor", "wl_counter",
            "naccept")},
    }
    same = np.ones(W, dtype=bool)
    for name, value in got.items():
        equal = value == out[name]
        same &= equal.reshape(W, -1).all(axis=1)
    excused = (margin.numpy() <= ULP_SLACK) | (bin_margin.numpy() <= ULP_SLACK)
    if not excuses:
        assert same.all(), np.flatnonzero(~same)
    assert not (~same & ~excused).any(), (
        np.flatnonzero(~same & ~excused), margin[~same], bin_margin[~same])
    assert (~same).mean() <= EXCUSED_SHARE, (~same).mean()
    np.testing.assert_allclose(port_state["enthalpy"].numpy()[same],
                               out["enthalpy"][same], rtol=0, atol=1e-9)
    # the branches ran: accepts, rejects, and at least one flatness reset
    assert 0 < out["naccept"].mean() < n_steps
    assert (out["mod_factor"] < start).any()
    assert np.all(np.frexp(got["mod_factor"])[0] == 0.5)  # powers of two
    return (~same).mean()


def test_chain_parity_flips_mid_bin_levels(nn):
    """8 sites, levels mid-bin: every walker equal, nothing excused."""
    ref, port, window = nn
    occ0 = np.random.default_rng(0).integers(0, 2, (64, 8)).astype(np.int32)
    params = _wl_params(window, flatness=0.7, check_period=50)
    _chain_parity(ref, port, params, "flip", occ0, 400, 32, seed=0, excuses=False)


def test_chain_parity_flips_bench_window(bench):
    """Au-Cu 3x3x3 at the bench's ~250 bins, two blocks of 64 walkers."""
    ref, port, window = bench
    params = _wl_params(window, flatness=0.3, check_period=20)
    assert params["num_levels"] >= 250
    occ0 = np.random.default_rng(0).integers(0, 2, (128, 27)).astype(np.int32)
    _chain_parity(ref, port, params, "flip", occ0, 300, 64, seed=1)


def test_chain_parity_swaps(aucu4):
    """Au-Cu 4x4x4 at fixed composition: pair sequences, null swaps."""
    ref, port, window = aucu4
    params = _wl_params(window, flatness=0.3, check_period=20)
    occ0 = half_occupancies(64, 128, seed=2)
    _chain_parity(ref, port, params, "swap", occ0, 300, 64, seed=2)


def test_chain_parity_across_chunk_boundary(nn):
    """2100 steps: the second chunk restarts the step count of the
    flatness check (period 1500: once in chunk 1, never by count in chunk
    2) and both chunks check at their last step."""
    ref, port, window = nn
    occ0 = np.random.default_rng(3).integers(0, 2, (64, 8)).astype(np.int32)
    params = _wl_params(window, flatness=0.7, check_period=1500)
    _chain_parity(ref, port, params, "flip", occ0, 2100, 32, seed=3, excuses=False)


def test_chain_parity_update_period_and_period_above_chunk(bench):
    """``update_period = 3``, and a ``check_period`` larger than the run:
    only the check at the chunk's last step resets."""
    ref, port, window = bench
    occ0 = np.random.default_rng(4).integers(0, 2, (64, 27)).astype(np.int32)
    params = _wl_params(window, flatness=0.2, check_period=5000, update_period=3)
    _chain_parity(ref, port, params, "flip", occ0, 240, 32, seed=4)
    params = _wl_params(window, flatness=0.3, check_period=7, update_period=3)
    _chain_parity(ref, port, params, "flip", occ0, 240, 32, seed=5)


# ---------------- kernel level ----------------

@pytest.mark.parametrize("move", ["flip", "swap"])
def test_make_chain_fn_matches_reference(move, bench, aucu4, monkeypatch):
    """Two windows of ``make_chain_fn``: the recomputed enthalpy, the mean
    features and their counts equal the reference's on the walkers whose
    chains agree (see the module docstring)."""
    monkeypatch.setenv("SMOL_TPU_CHAIN_INTERPRET", "1")
    ref, port, window = bench if move == "flip" else aucu4
    W, n_steps, block = 64, 60, 32
    options = dict(flatness=0.3, check_period=20)
    if move == "flip":
        occ0 = np.random.default_rng(6).integers(0, 2, (W, 27)).astype(np.int32)
    else:
        occ0 = half_occupancies(64, W, seed=6)
    ref_kernel = Sampler.from_ensemble(
        ref, kernel_type="wang-landau", step_type=move, nwalkers=W, seed=1,
        chain_block_size=block, **window, **options).mckernel
    kernel = WangLandau(port, move, **window, **options, seed=1,
                        chain_block_size=block, rng="hash")
    ref_fn = ref_kernel.make_chain_fn(n_steps)
    assert ref_fn is not None
    built = ref_kernel._get_chain_tables()
    assert built[1] == move
    state = dict(ref_kernel.initial_state(occ0))
    state.pop("words", None)
    state["occupancy"] = jnp.asarray(occ0)
    port_state = kernel.initial_state(occ0)
    np.testing.assert_allclose(port_state["enthalpy"].numpy(),
                               np.asarray(state["enthalpy"]), rtol=1e-12)
    for window_index in range(2):
        key = jax.random.key(10 + window_index)
        seqs, seeds = _reference_draws(built[0], key, n_steps, W, block, move)
        state = ref_fn(state, key)
        port_fn = kernel.make_chain_fn(
            n_steps, seqs=seqs if move == "swap" else seqs[0], seeds=seeds)
        port_state = port_fn(port_state, None)
    out = {k: np.asarray(v) for k, v in state.items()}
    same = (port_state["occupancy"].numpy() == out["occupancy"]).all(axis=1)
    same &= (port_state["entropy"].numpy() == out["entropy"]).all(axis=1)
    assert same.mean() >= 1 - EXCUSED_SHARE
    # the recompute is exact: features . theta of the final occupancies
    theta = torch.as_tensor(port.natural_parameters)
    exact = (port.compute_features(port_state["occupancy"]) @ theta).numpy()
    np.testing.assert_allclose(port_state["enthalpy"].numpy(), exact, rtol=1e-12)
    np.testing.assert_allclose(port_state["chain_enthalpy"].numpy(), exact,
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(port_state["enthalpy"].numpy()[same],
                               out["enthalpy"][same], rtol=1e-12)
    np.testing.assert_array_equal(port_state["wl_mean_counts"].numpy()[same],
                                  out["wl_mean_counts"][same])
    assert port_state["wl_mean_counts"].sum() == 2 * W  # all inside the window
    np.testing.assert_allclose(port_state["mean_features"].numpy()[same],
                               out["mean_features"][same], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(port_state["features"].numpy()[same],
                               out["features"][same], rtol=1e-12, atol=1e-12)


# ---------------- sampler level ----------------

def _nn_sampler(port, window, nwalkers, seed, **options):
    return TorchSampler.from_ensemble(
        port, kernel_type="wang-landau", step_type="flip", nwalkers=nwalkers,
        seed=seed, device="cpu", flatness=0.7, **window, **options)


def test_sampler_density_of_states(nn):
    """log-DOS of every walker against the exact degeneracies, within the
    0.8 of the reference's chain test."""
    _, port, window = nn
    system = load_system(data_path("aucu_nn_2x2x2"))
    sampler = _nn_sampler(port, window, 8, seed=9, check_period=250)
    assert sampler.execution_path(2500) == "cpu-twin[wl-flip]+direct+shared-proposals"
    occ0 = np.random.default_rng(0).integers(0, 2, (8, 8)).astype(np.int32)
    sampler.run(10000, occ0, thin_by=2500)
    samples = sampler.samples
    assert samples.num_samples == 4 and samples.num_aux_records == 1
    np.testing.assert_array_equal(samples.aux_sample_indices, [3])
    assert "temperature" not in samples.traced_values
    entropy = samples.get_trace_value("entropy", flat=False)[-1]  # [W, B]
    mod_factor = samples.get_trace_value("mod_factor", flat=False)[-1]
    assert np.all(mod_factor < 1e-2)
    assert np.all(sampler._state["wl_counter"].numpy() == 10000)
    exact_bins = np.floor((system["exact_enthalpies"] - window["min_enthalpy"])
                          / window["bin_size"]).astype(int)
    dos = np.bincount(exact_bins, minlength=entropy.shape[1])
    visited = dos > 0
    for s in entropy:
        assert np.all(s[visited] > 0) and np.all(s[~visited] == 0)
        estimate = s[visited] - s[visited][0]
        exact = np.log(dos[visited]) - np.log(dos[visited][0])
        assert np.max(np.abs(estimate - exact)) < 0.8, (estimate, exact)
    occurrences = samples.get_trace_value("occurrences", flat=False)[-1]
    histogram = samples.get_trace_value("histogram", flat=False)[-1]
    np.testing.assert_array_equal(occurrences.sum(axis=1), 10000)
    assert np.all(histogram <= occurrences) and histogram.min() >= 0
    # the recorded enthalpies and features are the exact recompute
    feats = samples.get_feature_vectors()
    np.testing.assert_allclose(samples.get_enthalpies(),
                               feats @ port.natural_parameters, rtol=1e-12)


def test_sampler_aux_every_and_resume(nn):
    """``aux_every=1``: one aux record per sample; a fresh sampler on the
    same container resumes on top of the stored record."""
    _, port, window = nn
    sampler = _nn_sampler(port, window, 2, seed=5, check_period=100)
    occ0 = np.random.default_rng(3).integers(0, 2, (2, 8)).astype(np.int32)
    sampler.run(1000, occ0, thin_by=200, aux_every=1)
    samples = sampler.samples
    entropy = samples.get_trace_value("entropy", flat=False)
    assert entropy.shape[0] == 5 and entropy[-1].max() > 0
    assert samples.num_aux_records == 5
    np.testing.assert_array_equal(samples.aux_sample_indices, np.arange(5))
    assert np.all(np.diff(entropy, axis=0) >= 0)  # records are cumulative copies
    mean_features = samples.get_trace_value("cumulative_mean_features", flat=False)
    counts = samples.get_trace_value("cumulative_mean_counts", flat=False)
    assert np.any(mean_features[-1] != 0)
    np.testing.assert_array_equal(counts[-1].sum(axis=1), 5)
    sampler.run(400, thin_by=200, aux_every=2)  # goes on from the state
    np.testing.assert_array_equal(samples.aux_sample_indices, [0, 1, 2, 3, 4, 6])

    last_entropy = samples.get_trace_value("entropy", flat=False)[-1]
    last_mod = samples.get_trace_value("mod_factor", flat=False)[-1]
    fresh = _nn_sampler(port, window, 2, seed=5, check_period=100)
    resumed = TorchSampler(fresh.mckernel, samples, nwalkers=2)
    restored = resumed.mckernel.restore_aux_state(
        resumed.mckernel.initial_state(occ0), samples)
    np.testing.assert_array_equal(restored["entropy"].numpy(), last_entropy)
    np.testing.assert_array_equal(restored["mod_factor"].numpy(), last_mod)
    np.testing.assert_array_equal(restored["wl_mean_counts"].numpy().sum(axis=1), 7)
    resumed.run(200, thin_by=200)
    entropy2 = samples.get_trace_value("entropy", flat=False)[-1]
    assert (entropy2 >= last_entropy).all() and entropy2.sum() > last_entropy.sum()
    gained = entropy2.sum(axis=1) - last_entropy.sum(axis=1)
    assert np.all(gained <= 200 * last_mod + 1e-9)  # from the restored mod_factor
    assert samples.num_samples == 8 and samples.num_aux_records == 7
    with pytest.raises(RuntimeError, match="must be provided"):
        _nn_sampler(port, window, 2, seed=5).run(200, thin_by=200)


# ---------------- refusals ----------------

def test_refusals(nn):
    _, port, window = nn
    tables = chain.build_chain_tables(port.processor, port.sublattices,
                                      mu_table=port.chemical_potential_table)
    wl = chain.WLChain(**_wl_params(window))
    with pytest.raises(ValueError, match="flip/swap moves only"):
        chain.make_shared_proposal_chain(tables, 10, move="table", wl=wl,
                                         table_move=object())
    with pytest.raises(NotImplementedError, match="item 8"):
        WangLandau(port, "flip", **window, bias_type="square-charge")
    with pytest.raises(NotImplementedError, match="item 8"):
        WangLandau(port, "flip", **window, shared_proposals=False)
    kernel = WangLandau(port, "flip", **window, shared_proposals=False,
                        proposal_mode="sweep")  # sweeps are independent anyway
    assert kernel.make_chain_fn(8) is not None
    with pytest.raises(ValueError, match="single bin"):
        WangLandau(port, "flip", 0.0, 1.0, 2.0)
    with pytest.raises(ValueError, match="larger than"):
        WangLandau(port, "flip", 1.0, 0.0, 0.1)
    with pytest.raises(ValueError, match="mod_factor"):
        WangLandau(port, "flip", **window, mod_factor=0.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchSampler.from_ensemble(port, kernel_type="wang-landau", **window)
    with pytest.raises(NotImplementedError, match="item 8"):
        _nn_sampler(port, window, 2, seed=1).run(10, np.zeros((2, 8)), stream_chunk=2)
    state = kernel.initial_state(np.zeros((4, 8), dtype=np.int32))
    with pytest.raises(ValueError, match="wl_chain operand"):
        chain.wl_chain(
            torch.zeros((8, 4), dtype=torch.int8), state["enthalpy"], state["naccept"],
            state["entropy"], state["histogram"].T.contiguous(),  # entropy not [B, W]
            state["occurrences"].T.contiguous(), state["mod_factor"],
            state["wl_counter"], [torch.zeros((1, 4), dtype=torch.int32)],
            torch.zeros(1, dtype=torch.int64), tables, kernel.wl_chain(), 4, 4)
