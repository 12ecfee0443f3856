"""The port's SQS distance annealing against smol_tpu, on the CPU.

- the distance processor's features and score equal the reference's
  ``compute_feature_vector`` / ``compute_property`` to 1e-12 on random
  occupancies of two of the bench's 8-site shapes, of the 64-site shape
  and of a ternary FCC 2x2x2, with and without the match term and with
  weighted targets; the batched features and scores equal them too;
- single forced-accept steps (beta = 0) keep every walker's score equal to
  the exact rescore of its occupancy to 1e-12;
- trajectories: fed the reference wrapper's own pair sequences and seeds,
  the port's hash-mode twin reproduces the interpret-mode Pallas distance
  chain occupancy for occupancy (binary with and without the match term,
  weighted targets, ternary, and 130 steps in chunks of 48).  A walker
  may differ only where the port shows one of its decisions within 4 f32
  ulps of log U beyond beta * slack, where slack = 4e-5 bounds the
  reference's f32 error on d_new - d: twice its own test's bound on the
  f32 score over a window (2e-5, ``tests/test_ops/test_pallas_sqs.py``);
  the number of such walkers is printed.  Equal walkers have equal accept
  counts, scores within the slack, and best occupancies whose exact
  rescores agree within it (ties in score may keep different occupancies);
  the port's scores equal the exact rescore to 1e-9;
- the generator on the CPU draws the reference's starting occupancies from
  the same seed, keeps every composition, never loses ground, stores exact
  scores and finds a matched shell (a negative score) on a small cell;
- what the port refuses raises: the cluster-interaction distance, a
  non-swap step, duplicate removal, structures, shape enumeration, the
  multicell sampler, a restricted sublattice, ``device="cuda"`` without a
  card; and the wrapper runs the twin for CPU tensors, counting no launch.
"""

import functools
import sys
from itertools import combinations
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smol_tpu.benchmarks.systems import fcc_binary_prim, fcc_ternary_prim
from smol_tpu.capp.generate.random import generate_random_ordered_occupancy as ref_occupancy
from smol_tpu.cofe import ClusterSubspace
from smol_tpu.moca.processor.distance import CorrelationDistanceProcessor as RefProcessor
from smol_tpu.ops import pallas_chain, pallas_sqs
from smol_tpu.ops.correlations import corr_from_occupancy
from smol_tpu_torch.capp import StochasticSQSGenerator
from smol_tpu_torch.capp.generate.random import generate_random_ordered_occupancy
from smol_tpu_torch.capp.generate.special.sqs import random_starts
from smol_tpu_torch.moca.processor.distance import (
    ClusterInteractionDistanceProcessor,
    CorrelationDistanceProcessor,
)
from smol_tpu_torch.ops import sqs
from smol_tpu_torch.system import export_distance_system, load_systems

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from export_torch_systems import SQS_CUTOFFS, data_path  # noqa: E402

ULP_SLACK = 4
SCORE_SLACK = 4e-5  # twice the reference's f32 score bound over a window


@functools.lru_cache(maxsize=None)
def _subspace(kind, cutoffs):
    prim = {"binary": fcc_binary_prim, "ternary": fcc_ternary_prim}[kind]()
    return ClusterSubspace.from_cutoffs(prim, dict(cutoffs))


def _pair(kind, cutoffs, scm, **kwargs):
    """(reference processor, port processor on the CPU) of one shape."""
    ref = RefProcessor(_subspace(kind, tuple(cutoffs.items())), np.asarray(scm), **kwargs)
    return ref, CorrelationDistanceProcessor(export_distance_system(ref), "cpu")


def _weighted(kind, cutoffs, seed=3):
    """A random target and weights, as the reference's weighted test."""
    num = _subspace(kind, tuple(cutoffs.items())).num_corr_functions
    rng = np.random.default_rng(seed)
    target = np.zeros(num)
    target[1:] = rng.uniform(-0.3, 0.3, num - 1)
    return {"match_weight": 0.5, "target_vector": target,
            "target_weights": rng.uniform(0.5, 2.0, num - 1)}


def _random_occupancies(proc, count, seed, balanced=True):
    """The reference test's walkers: permutations of a balanced occupancy,
    or uniform codes."""
    rng = np.random.default_rng(seed)
    n = proc.num_sites
    n_codes = np.array([len(sp) for sp in proc.allowed_species])
    if balanced:
        base = np.arange(n) % int(n_codes.max())
        return np.stack([rng.permutation(base).astype(np.int32) for _ in range(count)])
    return (rng.random((count, n)) * n_codes).astype(np.int32)


BENCH_SHAPES = load_systems(data_path("sqs_fcc8"))
FEATURE_CASES = {
    "fcc8-shape0": ("binary", SQS_CUTOFFS, BENCH_SHAPES[0]["supercell_matrix"], {}),
    "fcc8-shape11": ("binary", SQS_CUTOFFS, BENCH_SHAPES[11]["supercell_matrix"], {}),
    "fcc8-shape11-no-match": ("binary", SQS_CUTOFFS,
                              BENCH_SHAPES[11]["supercell_matrix"], {"match_weight": 0.0}),
    "fcc-4x4x4": ("binary", SQS_CUTOFFS, np.diag([4, 4, 4]), {}),
    "fcc-4x4x4-weighted": ("binary", SQS_CUTOFFS, np.diag([4, 4, 4]),
                           _weighted("binary", SQS_CUTOFFS)),
    "ternary-2x2x2": ("ternary", {2: 4.0}, np.diag([2, 2, 2]), {}),
}


@pytest.mark.parametrize("case", sorted(FEATURE_CASES))
def test_features_and_scores_equal_reference(case):
    kind, cutoffs, scm, kwargs = FEATURE_CASES[case]
    ref, port = _pair(kind, cutoffs, scm, **kwargs)
    occus = np.concatenate([_random_occupancies(ref, 6, 1),
                            _random_occupancies(ref, 6, 2, balanced=False)])
    if ref.num_sites == 8:  # every half-and-half state: some match a shell
        halves = np.zeros((70, 8), dtype=np.int32)
        for i, ones in enumerate(combinations(range(8), 4)):
            halves[i, list(ones)] = 1
        occus = np.concatenate([occus, halves])
    batched = port.compute_features(torch.as_tensor(occus)).numpy()
    scores = port.compute_scores(torch.as_tensor(occus)).numpy()
    matched = 0
    for occu, feats, score in zip(occus, batched, scores):
        expect = ref.compute_feature_vector(occu)
        np.testing.assert_allclose(port.compute_feature_vector(occu), expect,
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(feats, expect, rtol=0, atol=1e-12)
        expect_score = ref.compute_property(occu)
        assert abs(port.compute_property(occu) - expect_score) <= 1e-12
        assert abs(score - expect_score) <= 1e-12
        matched += expect[0] > 0
    if case == "fcc8-shape0":  # shape 11 holds no matched half-and-half state
        assert matched > 0, "no occupancy exercised the match term"


def test_forced_accept_steps_are_exact():
    """beta = 0 accepts every non-null swap; each step's score must equal
    the exact rescore of the walker's new occupancy."""
    ref, port = _pair("binary", SQS_CUTOFFS, BENCH_SHAPES[3]["supercell_matrix"])
    tables = sqs.build_distance_tables(port)
    occu = torch.as_tensor(_random_occupancies(ref, 16, 5))
    ops = sqs.distance_launch_operands(
        tables, port.compute_corr, occu, torch.zeros(16, dtype=torch.float64), 1, 16,
        torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    moved = 0
    for it in range(12):
        ops["useq"], ops["vseq"] = sqs.rank_pair_sequence(tables, gen, (1, 1))
        before = ops["naccept"].clone()
        sqs.distance_chain(**ops, seed=torch.tensor([it]), rng="hash")
        occupancy = torch.zeros_like(occu)
        occupancy[:, tables.rank_sites] = ops["occ"].T.to(occupancy.dtype)
        exact = port.compute_scores(occupancy)
        assert float((exact - ops["d"]).abs().max()) <= 1e-12
        moved += int((ops["naccept"] - before).sum())
    assert moved > 0


def _reference_run(ref, occus, beta, n_steps, block_size, seed, chunk_steps=None):
    """The interpret-mode reference chain from exact scores, and its draws
    reconstructed as its wrapper makes them (``pallas_sqs.py:591-605``)."""
    tables = pallas_sqs.build_distance_tables(ref, ref.get_sublattices())
    dp, num_corr = ref._dp, len(ref.target_vector)
    W = len(occus)
    scores = jnp.asarray([float(ref.coefs @ ref.compute_feature_vector(o)) for o in occus])
    state = {
        "occupancy": jnp.asarray(occus), "enthalpy": scores,
        "beta": jnp.full(W, beta), "naccept": jnp.zeros(W, jnp.int32),
        "best_enthalpy": scores, "best_occupancy": jnp.asarray(occus),
    }
    fn = pallas_sqs.make_distance_chain(
        tables, n_steps, lambda o: corr_from_occupancy(o, dp, num_corr),
        block_size=block_size, interpret=True, chunk_steps=chunk_steps)
    key = jax.random.key(seed)
    out = fn(state, key)
    wb = min(block_size, -(-W // 128) * 128)
    chunk = min(n_steps, chunk_steps or pallas_chain.MAX_CHUNK_STEPS)
    n_chunks = -(-n_steps // chunk)
    k_seed, k_seq = jax.random.split(jax.random.fold_in(key, 29))
    seed0 = jax.random.randint(k_seed, (), 0, np.int32(2**30 - 1), dtype=jnp.int32)
    useqs, vseqs = pallas_chain.rank_pair_sequence(tables, k_seq, (n_chunks, -(-W // wb), chunk))
    seeds = seed0 + jnp.arange(n_chunks, dtype=jnp.int32) * jnp.int32(999983)
    draws = (np.asarray(useqs, dtype=np.int32), np.asarray(vseqs, dtype=np.int32),
             np.asarray(seeds, dtype=np.int64))
    return {key: np.array(value) for key, value in out.items()}, draws, wb, chunk


PARITY_CASES = {  # kind, cutoffs, supercell, processor kwargs, run kwargs
    "binary": ("binary", {2: 4.0, 3: 2.8}, {}, {}),
    "binary-no-match": ("binary", {2: 4.0, 3: 2.8}, {"match_weight": 0.0}, {}),
    "weighted": ("binary", {2: 4.0, 3: 2.8}, _weighted("binary", {2: 4.0, 3: 2.8}), {}),
    "ternary": ("ternary", {2: 4.0}, {}, {"n_steps": 150}),
    "multi-chunk": ("binary", {2: 4.0}, {},
                    {"W": 4, "n_steps": 130, "chunk_steps": 48, "seed": 2}),
}


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_twin_matches_interpret_reference(case):
    kind, cutoffs, kwargs, run = PARITY_CASES[case]
    W, n_steps = run.get("W", 8), run.get("n_steps", 200)
    seed, chunk_steps, beta = run.get("seed", 0), run.get("chunk_steps"), 0.5
    ref, port = _pair(kind, cutoffs, np.diag([2, 2, 2]), **kwargs)
    occus = _random_occupancies(ref, W, seed)
    out, (useqs, vseqs, seeds), wb, chunk = _reference_run(
        ref, occus, beta, n_steps, W, seed, chunk_steps)

    tables = sqs.build_distance_tables(port)
    occu = torch.as_tensor(occus)
    ops = sqs.distance_launch_operands(tables, port.compute_corr, occu,
                                       torch.full((W,), beta, dtype=torch.float64),
                                       n_steps, wb, torch.Generator())
    start_best = torch.tensor([float(ref.coefs @ ref.compute_feature_vector(o))
                               for o in occus], dtype=torch.float64)
    ops["best_d"] = start_best.clone()
    margin = torch.full((W,), float("inf"))
    for c in range(len(seeds)):
        sqs.distance_chain_reference(
            **{**ops, "useq": torch.as_tensor(useqs[c]), "vseq": torch.as_tensor(vseqs[c]),
               "n_steps": min(chunk, n_steps - c * chunk)},
            seed=torch.tensor([seeds[c]]), rng="hash", margin=margin, slack=SCORE_SLACK)
    port_occ = occus.copy()
    port_occ[:, tables.rank_sites.numpy()] = ops["occ"].T.numpy()
    port_best = occus.copy()
    port_best[:, tables.rank_sites.numpy()] = ops["best_occ"].T.numpy()

    # the chain factory, fed the same draws, is the twin loop exactly
    state = {
        "occupancy": occu.clone(), "enthalpy": start_best.clone(),
        "beta": torch.full((W,), beta, dtype=torch.float64),
        "naccept": torch.zeros(W, dtype=torch.int32),
        "best_enthalpy": start_best.clone(), "best_occupancy": occu.clone(),
    }
    chain_fn = sqs.make_distance_chain(tables, n_steps, port.compute_corr, block_size=W,
                                       chunk_steps=chunk_steps, rng="hash",
                                       seqs=(useqs, vseqs), seeds=seeds)
    state = chain_fn(state, None)
    assert np.array_equal(state["occupancy"].numpy(), port_occ)
    assert np.array_equal(state["best_occupancy"].numpy(), port_best)
    assert torch.equal(state["enthalpy"], ops["d"])
    assert torch.equal(state["best_enthalpy"], ops["best_d"])
    assert torch.equal(state["naccept"], ops["naccept"])

    same = np.all(port_occ == out["occupancy"], axis=1)
    excused = np.flatnonzero(~same)
    print(f"{case}: {len(excused)} of {W} walkers excused, least margin "
          f"{float(margin.min()):.1f} ulps")
    for w in excused:
        assert margin[w] <= ULP_SLACK, (w, float(margin[w]))
    assert same.mean() >= 0.75, same.mean()
    nacc = ops["naccept"].numpy()
    np.testing.assert_array_equal(nacc[same], out["naccept"][same])
    assert 0 < nacc.mean() < n_steps
    d = ops["d"].numpy()
    assert np.all(np.abs(d[same] - out["enthalpy"][same]) <= SCORE_SLACK)
    exact = port.compute_scores(torch.as_tensor(port_occ)).numpy()
    assert np.abs(exact - d).max() < 1e-9
    exact_best = port.compute_scores(torch.as_tensor(port_best)).numpy()
    assert np.abs(exact_best - ops["best_d"].numpy()).max() < 1e-9
    ref_best = port.compute_scores(torch.as_tensor(out["best_occupancy"])).numpy()
    assert np.all(np.abs(exact_best[same] - ref_best[same]) <= SCORE_SLACK)
    # canonical swaps keep every walker's composition
    np.testing.assert_array_equal(np.sort(port_occ, axis=1), np.sort(occus, axis=1))


@functools.lru_cache(maxsize=None)
def _small_generator_shapes():
    """Reference processors of the 8-site {2: 4.0} binary SQS search, as its
    generator holds them, and their port counterparts on the CPU."""
    from smol_tpu.capp import StochasticSQSGenerator as RefGenerator

    ref = RefGenerator.from_structure(fcc_binary_prim(), {2: 4.0}, supercell_size=8)
    refs = ref.processors[:4]
    return refs, [CorrelationDistanceProcessor(export_distance_system(p), "cpu")
                  for p in refs]


def test_starts_follow_reference():
    """The same numpy generator gives the reference generator's starts: its
    composition-exact occupancy, then a permutation per walker within each
    sublattice (``sqs.py:436-448`` of the reference)."""
    refs, ports = _small_generator_shapes()
    for ref, port in zip(refs, ports):
        compositions = [sl.composition for sl in ref.get_sublattices()]
        rng = np.random.default_rng(7)
        occu0 = ref_occupancy(ref, composition=compositions, rng=rng)
        expect = np.tile(occu0, (5, 1))
        for sl in ref.get_sublattices():
            perms = rng.random((5, len(sl.sites))).argsort(axis=1)
            expect[:, sl.sites] = occu0[sl.sites][perms]
        np.testing.assert_array_equal(
            generate_random_ordered_occupancy(port, rng=np.random.default_rng(7)), occu0)
        np.testing.assert_array_equal(random_starts(port, 5, np.random.default_rng(7)), expect)


def test_generator_on_cpu():
    _, ports = _small_generator_shapes()
    generator = StochasticSQSGenerator.from_processors(ports, device="cpu")
    assert generator.execution_path == "not-run"
    W, temperatures = 16, np.linspace(2.0, 0.02, 4)
    generator.generate(mcmc_steps=150, temperatures=temperatures, nwalkers=W, seed=11)
    assert generator.execution_path == "cpu-twin[distance]"
    assert generator.num_structures == len(ports) * W
    assert len(generator.stage_records) == len(ports) * len(temperatures)
    for rec in generator.stage_records:
        occupancy = rec["occupancy"]
        assert torch.all(occupancy.sum(dim=1) == ports[0].num_sites // 2)
        exact = ports[rec["shape"]].compute_scores(occupancy)
        assert float((exact - rec["enthalpy"]).abs().max()) < 1e-9
    for (shape, occupancies, scores, _), start in zip(generator._best,
                                                      generator.start_scores):
        assert np.all(occupancies.sum(axis=1) == ports[shape].num_sites // 2)
        assert np.all(scores <= start.numpy() + 1e-12)  # never loses ground
    best = generator.get_best_sqs(num_structures=5, remove_duplicates=False)
    assert len(best) == 5 and all(a.score <= b.score for a, b in zip(best, best[1:]))
    for record in best:
        exact = generator.compute_score(record.occupancy, record.supercell_matrix)
        assert abs(exact - record.score) < 1e-9
        np.testing.assert_allclose(
            generator.compute_feature_distance(record.occupancy, record.supercell_matrix),
            record.feature_distance, rtol=0, atol=1e-12)
    assert best[0].score < 0  # a matched shell exists and is found
    generator.generate(mcmc_steps=20, temperatures=[1.0], nwalkers=4, seed=1,
                       clear_previous=False, max_save_num=10)
    assert generator.num_structures == 10
    assert generator.get_best_sqs(1, remove_duplicates=False)[0].score == best[0].score


def test_refusals():
    refs, ports = _small_generator_shapes()
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        ClusterInteractionDistanceProcessor(ports[0].system, "cpu")
    with pytest.raises(NotImplementedError, match="step_type"):
        StochasticSQSGenerator(ports, device="cpu", step_type="flip")
    generator = StochasticSQSGenerator.from_processors(ports[:1], device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        generator.sampler
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        StochasticSQSGenerator.from_structure(fcc_binary_prim(), {2: 4.0}, 8)
    generator.generate(mcmc_steps=5, temperatures=[1.0], nwalkers=2, seed=0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        generator.get_best_sqs(1, remove_duplicates=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        generator.get_best_sqs(1)  # the reference's default removes duplicates
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        generator.get_best_sqs(1, remove_duplicates=False)[0].structure
    restricted = CorrelationDistanceProcessor(ports[0].system, "cpu")
    restricted.get_sublattices()[0].active_sites = restricted.get_sublattices()[0].sites[1:]
    with pytest.raises(NotImplementedError, match="restricted"):
        sqs.build_distance_tables(restricted)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            CorrelationDistanceProcessor(ports[0].system)
        with pytest.raises(RuntimeError, match="CUDA"):
            StochasticSQSGenerator.from_processors(ports)


def test_wrapper_runs_twin_on_cpu_and_checks_operands():
    _, ports = _small_generator_shapes()
    port = ports[0]
    tables = sqs.build_distance_tables(port)
    occu = torch.as_tensor(random_starts(port, 8, np.random.default_rng(0)))
    ops = sqs.distance_launch_operands(tables, port.compute_corr, occu,
                                       torch.full((8,), 2.0, dtype=torch.float64), 10, 8,
                                       torch.Generator().manual_seed(0))
    ops["seed"] = torch.zeros(1, dtype=torch.int64)
    before = sqs.distance_chain.launches
    sqs.distance_chain(**ops)
    assert sqs.distance_chain.launches == before  # the twin is not a launch
    for name, bad in (
        ("feat", ops["feat"][:2].contiguous()),
        ("best_d", ops["best_d"].to(torch.float32)),
        ("vseq", ops["vseq"][:, :5].contiguous()),
    ):
        with pytest.raises(ValueError):
            sqs.distance_chain(**{**ops, name: bad})
