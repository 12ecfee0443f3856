"""Batched SQS launches on the CPU: one launch of several shapes against
each shape's own, through the port's twins.

- the batched twin over four of the bench's 8-site shapes equals each
  shape's own launch at the same lanes, bit for bit;
- batched ``generate`` equals the shape-by-shape search (best
  structures, start scores, stage records), bit for bit.

These tests take about half of the SQS tests' time; they sit in a file of
their own so that ``--dist loadfile`` runs them on a worker of their own,
and the batch whose lanes differ from its shapes' own in another
(``tests/test_torch_sqs_batched_lanes.py``).
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from smol_tpu_torch.capp import StochasticSQSGenerator
from smol_tpu_torch.capp.generate.special.sqs import random_starts
from smol_tpu_torch.moca.processor.distance import CorrelationDistanceProcessor
from smol_tpu_torch.ops import sqs
from smol_tpu_torch.system import load_systems

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from export_torch_systems import data_path  # noqa: E402

BENCH_SHAPES = load_systems(data_path("sqs_fcc8"))
LAUNCH_STATE = ("occ", "best_occ", "feat", "d", "best_d", "naccept")
BATCH_SHAPES = (0, 1, 2, 11)  # 67, 65, 66 and 67 rows a rank: padded to 67


@functools.lru_cache(maxsize=None)
def _batch_processors():
    return tuple(CorrelationDistanceProcessor.from_system(BENCH_SHAPES[s], "cpu") for s in BATCH_SHAPES)


@pytest.mark.parametrize("rng", ["hash", "philox"])
def test_batched_twin_equals_per_shape_twins(rng):
    """Four of the bench's shapes, of 65 to 67 rows a rank, in one batch
    (tables padded to the largest): codes, best codes, features, scores,
    best scores and accept counts equal each shape's own launch at the
    same lanes, bit for bit."""
    procs = _batch_processors()
    tables = [sqs.build_distance_tables(p) for p in procs]
    batch = sqs.stack_distance_tables(tables)
    L = max(t.nbr.shape[1] for t in tables)
    assert batch.nbr.shape == (len(procs), 8, L, 3) and batch.g.shape[2] == L
    short = tables[1]  # 65 rows: its padding is never read
    assert bool((batch.nbr[1, :, short.nbr.shape[1]:] == -1).all())
    assert not bool(batch.g[1, :, short.g.shape[1]:].any())
    W, steps, block = 24, 80, 8
    per_shape = []
    for s, (proc, t) in enumerate(zip(procs, tables)):
        occu = torch.as_tensor(random_starts(proc, W, np.random.default_rng(s)))
        ops = sqs.distance_launch_operands(
            t, proc.compute_corr, occu, torch.full((W,), 4.0, dtype=torch.float64), steps,
            block, torch.Generator().manual_seed(s))
        ops["seed"] = torch.tensor([1000 + s], dtype=torch.int64)
        per_shape.append(ops)
    stacked = {name: torch.stack([ops[name] for ops in per_shape])
               for name in (*LAUNCH_STATE, "beta32", "useq", "vseq")}
    stacked["seed"] = torch.cat([ops["seed"] for ops in per_shape])
    design = sqs._Design(lanes=4)  # the same lanes for the batch and each shape
    sqs.distance_chain_batched(**stacked, batch=batch, n_steps=steps, block_size=block,
                               rng=rng, _design=design)
    for s, ops in enumerate(per_shape):
        sqs.distance_chain(**ops, rng=rng, _design=design)
        for name in LAUNCH_STATE:
            assert torch.equal(stacked[name][s], ops[name]), (s, name)
        assert int(ops["naccept"].sum()) > 0


def _generate_shape_by_shape(procs, mcmc_steps, temperatures, nwalkers, seed):
    """The search as one chain per shape, shape after shape, as the
    reference generator loops (its ``sqs.py:418-482``), on the port's
    one-shape chain: ``(best, start scores, stage records)``."""
    rng = np.random.default_rng(seed)
    best, starts, records = [], [], []
    for shape, proc in enumerate(procs):
        rng.integers(2**31)
        occu = torch.as_tensor(random_starts(proc, nwalkers, rng), dtype=torch.int32)
        generator = torch.Generator().manual_seed(int(rng.integers(2**31)))
        scores = proc.compute_scores(occu)
        starts.append(scores.clone())
        state = {"occupancy": occu, "enthalpy": scores,
                 "naccept": torch.zeros(nwalkers, dtype=torch.int32),
                 "best_enthalpy": scores.clone(), "best_occupancy": occu.clone()}
        chain_fn = sqs.make_distance_chain(sqs.build_distance_tables(proc), mcmc_steps,
                                           proc.compute_corr)
        for temp in temperatures:
            state["beta"] = torch.full((nwalkers,), 1.0 / temp, dtype=torch.float64)
            state["window_naccept"] = torch.zeros_like(state["naccept"])
            state = chain_fn(state, generator)
            records.append({"shape": shape, "temperature": temp,
                            "occupancy": state["occupancy"].clone(),
                            "enthalpy": state["enthalpy"].clone(),
                            "naccept": state["window_naccept"]})
        features = proc.compute_features(state["best_occupancy"])
        best.append((shape, state["best_occupancy"].numpy(),
                     (features @ torch.as_tensor(proc.coefs)).numpy(), features.numpy()))
    return best, starts, records


def test_generate_batched_equals_shape_by_shape():
    """``generate`` runs each temperature as one chain over all shapes; its
    best structures, start scores and stage records (shape-major) equal the
    shape-by-shape search's bit for bit (at these sizes both launches take
    16 lanes)."""
    procs = _batch_processors()
    temperatures = [2.0, 0.5]
    generator = StochasticSQSGenerator.from_processors(procs, device="cpu")
    generator.generate(mcmc_steps=60, temperatures=temperatures, nwalkers=8, seed=4)
    assert [shapes for shapes, _ in generator._chain_fns(60)] == [list(range(len(procs)))]
    best, starts, records = _generate_shape_by_shape(procs, 60, temperatures, 8, 4)
    assert len(generator._best) == len(best)
    for (s1, o1, sc1, f1), (s2, o2, sc2, f2) in zip(generator._best, best):
        assert s1 == s2 and np.array_equal(o1, o2)
        assert np.array_equal(sc1, sc2) and np.array_equal(f1, f2)
    for mine, theirs in zip(generator.start_scores, starts):
        assert torch.equal(mine, theirs)
    assert len(generator.stage_records) == len(records) == len(procs) * len(temperatures)
    for mine, theirs in zip(generator.stage_records, records):
        assert mine["shape"] == theirs["shape"] and mine["temperature"] == theirs["temperature"]
        for key in ("occupancy", "enthalpy", "naccept"):
            assert torch.equal(mine[key], theirs[key]), key
