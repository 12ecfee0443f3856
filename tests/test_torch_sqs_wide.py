"""K7's wide body (F > 32) through its twin, against the interpret-mode reference.

``sqs-fcc8-wide``: Au-Cu FCC with pairs to 9, triplets to 6 and
quadruplets to 5 Angstrom at size 8, 41 features, the reference's chain
within its 8 MB table budget.  Up to 32 features the port's kernel keeps a
walker's features in registers; above, it runs its wide body, whose plain
twin is the same ``distance_chain_reference``.  Here, on the CPU, on two of
its shapes, fed the reference wrapper's own pair sequences and seeds, the
port's hash-mode twin reproduces the interpret-mode Pallas distance chain
occupancy for occupancy, at one lane and at the launch plan's lanes (those
of the wide body's ``launch_lanes``), under the excuse rule of
``tests/test_torch_sqs.py`` (a walker may differ only where the port shows
one of its decisions within 4 f32 ulps of log U beyond beta * slack);
every score equals its exact rescore, compositions are kept.  The
reference's chain takes these shapes (7.99 MB of its 8 MB table budget), so
the port's does too, and its launch plan takes the wide body with its rows
staged as rank rows (a byte a rank) and each feature's values in one
table; rows whose bytes do not fit (more than 16 ranks, a stride sum of
256) are staged as slot rows.
"""

import functools

import numpy as np
import pytest
import torch

from smol_tpu.benchmarks.systems import fcc_binary_prim
from smol_tpu.capp import StochasticSQSGenerator as RefGenerator
from smol_tpu.ops import pallas_sqs
from smol_tpu_torch.moca.processor.distance import CorrelationDistanceProcessor
from smol_tpu_torch.ops import sqs
from smol_tpu_torch.system import export_distance_system

from test_torch_sqs import SCORE_SLACK, ULP_SLACK, _random_occupancies, _reference_run

WIDE_CUTOFFS = {2: 9.0, 3: 6.0, 4: 5.0}
SHAPES = (0, 13)  # of the 20 8-site shapes, least skewed first
W, N_STEPS, BETA = 16, 20, 0.5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _shapes():
    """(reference processor, port processor on the CPU) of SHAPES."""
    from smol_tpu.capp.generate.enumerate import enumerate_supercell_matrices
    from smol_tpu.cofe import ClusterSubspace

    matrices = enumerate_supercell_matrices(
        8, ClusterSubspace.from_cutoffs(fcc_binary_prim(), {2: 4.0}).symops)[::-1]
    ref = RefGenerator.from_structure(fcc_binary_prim(), WIDE_CUTOFFS, supercell_size=8,
                                      supercell_matrices=[matrices[s] for s in SHAPES])
    return [(p, CorrelationDistanceProcessor.from_system(export_distance_system(p), "cpu"))
            for p in ref.processors]


@functools.lru_cache(maxsize=None)
def _tables(shape):
    return sqs.build_distance_tables(_shapes()[shape][1])


@functools.lru_cache(maxsize=None)
def _reference(shape):
    ref, port = _shapes()[shape]
    occus = _random_occupancies(ref, W, 3 + shape)
    return (ref, port, occus, *_reference_run(ref, occus, BETA, N_STEPS, W, seed=shape))


def test_wide_tables_and_plan():
    for shape, (ref, port) in enumerate(_shapes()):
        # the reference's chain takes the shape too: 7.99 MB of its 8 MB
        assert pallas_sqs.build_distance_tables(ref, ref.get_sublattices()) is not None
        tables = _tables(shape)
        rows = int((tables.seg[:, -1] - tables.seg[:, 0]).max())
        assert (sqs.reference_table_bytes(tables.num_ranks, rows, 41, 16)
                <= sqs.REFERENCE_TABLE_BUDGET)
        assert tables.num_feats == 41 > sqs.REGISTER_FEATURES
        assert sqs.wide_launch(tables) and tables.rank_rows is not None
        assert sqs.launch_lanes(20 * 2048, tables=tables) == 4  # the 20 shapes' launch
        assert sqs.launch_lanes(2048, tables=tables) == 16
        assert not sqs._resident(tables, 2048, 512, sqs._Design(lanes=4))
        wb = sqs.distance_block_walkers(2048, 512, sqs._Design(lanes=4), tables)
        plan = sqs.wide_plan(tables, 2048, 512, sqs._Design(lanes=4))
        assert wb == plan.walkers == 64 and plan.rank
        assert plan.shared_bytes == sqs.wide_shared_bytes(8, 41, 16, wb, plan.stage_bytes)
        assert plan.shared_bytes <= sqs.MAX_SHARED_BYTES
        # the rank rows hold every row's integers: byte r' the strides on rank
        # r', the self stride on the own rank
        L = tables.nbr.shape[1]
        words = tables.rank_rows.numpy()[:, :L].view(np.uint32).astype(np.int64)
        rows = ((words[..., None] >> np.array([0, 8, 16, 24])) & 0xFF).reshape(8, L, 8)
        nbr, stride = tables.nbr.numpy(), tables.stride.numpy()
        for r in range(tables.num_ranks):
            expect = np.zeros((L, 8), dtype=np.int64)
            for k in range(nbr.shape[2]):
                on = nbr[r, :, k] >= 0
                np.add.at(expect, (np.flatnonzero(on), nbr[r, on, k]), stride[r, on, k])
            expect[:, r] = tables.d2.numpy()[r]
            np.testing.assert_array_equal(rows[r], expect)
        # each feature's values serve every rank's rows of the feature
        seg, g = tables.seg.numpy(), tables.g.numpy()
        for r in range(tables.num_ranks):
            for f in range(tables.num_feats):
                rows = g[r, seg[r, f]:seg[r, f + 1]]
                assert np.array_equal(rows, np.broadcast_to(tables.gfeat[f].numpy(),
                                                            rows.shape))


@pytest.mark.parametrize("lanes", [1, None])
@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_twin_matches_interpret_reference(shape, lanes):
    ref, port, occus, out, (useqs, vseqs, seeds), wb, chunk = _reference(shape)
    tables = _tables(shape)
    lanes = lanes or sqs.launch_lanes(W, tables=tables)
    ops = sqs.distance_launch_operands(tables, port.compute_corr, torch.as_tensor(occus),
                                       torch.full((W,), BETA, dtype=torch.float64),
                                       N_STEPS, wb, torch.Generator())
    ops["best_d"] = torch.tensor([float(ref.coefs @ ref.compute_feature_vector(o))
                                  for o in occus], dtype=torch.float64)
    margin = torch.full((W,), float("inf"))
    sqs.distance_chain_reference(
        **{**ops, "useq": torch.as_tensor(useqs[0]), "vseq": torch.as_tensor(vseqs[0])},
        seed=torch.tensor([seeds[0]]), rng="hash", margin=margin, slack=SCORE_SLACK,
        lanes=lanes)
    port_occ = occus.copy()
    port_occ[:, tables.rank_sites.numpy()] = ops["occ"].T.numpy()
    same = np.all(port_occ == out["occupancy"], axis=1)
    excused = np.flatnonzero(~same)
    print(f"shape {SHAPES[shape]}, {lanes} lanes: {len(excused)} of {W} walkers excused, "
          f"least margin {float(margin.min()):.1f} ulps")
    for w in excused:
        assert margin[w] <= ULP_SLACK, (w, float(margin[w]))
    assert same.mean() >= 0.75
    nacc = ops["naccept"].numpy()
    np.testing.assert_array_equal(nacc[same], out["naccept"][same])
    assert 0 < nacc.mean() < N_STEPS
    d = ops["d"].numpy()
    assert np.all(np.abs(d[same] - out["enthalpy"][same]) <= SCORE_SLACK)
    exact = port.compute_scores(torch.as_tensor(port_occ)).numpy()
    assert np.abs(exact - d).max() < 1e-9
    np.testing.assert_array_equal(np.sort(port_occ, axis=1), np.sort(occus, axis=1))


def test_wide_rows_pack_where_they_fit():
    """The wide body stages rank rows where their bytes fit (at most 8
    ranks, a stride sum or a self stride below 256); else ``pack_rank_rows``
    returns None and it stages the slot rows, which hold any row: d2, the
    slots' ranks (an empty slot reads rank 0 times stride 0) and strides,
    padded to a multiple of four words, the rows to an even count."""
    rng = np.random.default_rng(0)
    R, L = 6, 5
    for K in (3, 5):
        nbr = rng.integers(-1, R, (R, L, K)).astype(np.int32)
        stride = np.where(nbr >= 0, rng.integers(0, 300, (R, L, K)), 0).astype(np.int32)
        d2 = rng.integers(0, 2**31 - 1, (R, L)).astype(np.int32)
        assert sqs.pack_rank_rows(nbr, stride, d2) is None  # d2 above 255
        rows = sqs.pack_slot_rows(*map(torch.as_tensor, (nbr, stride, d2))).numpy()
        assert rows.shape == (R, L + 1, -(-(1 + 2 * K) // 4) * 4)  # an even count of rows
        assert (rows[:, L] == 0).all()
        rows = rows[:, :L]
        np.testing.assert_array_equal(rows[..., 0], d2)
        np.testing.assert_array_equal(rows[..., 1:1 + K], np.maximum(nbr, 0))
        np.testing.assert_array_equal(rows[..., 1 + K:1 + 2 * K], stride)
        assert (rows[..., 1 + 2 * K:] == 0).all()
    many = np.zeros((9, 1, 1), dtype=np.int32)
    assert sqs.pack_rank_rows(many - 1, many, np.zeros((9, 1), dtype=np.int32)) is None
    few = np.zeros((8, 1, 1), dtype=np.int32)
    assert sqs.pack_rank_rows(few - 1, few, np.zeros((8, 1), dtype=np.int32)).shape == (
        8, 1, 2)
