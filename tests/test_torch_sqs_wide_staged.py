"""The host side of K7's wide body: its staged rows and its launch plan.

The wide body (F > 32, ``smol_tpu_torch/csrc/distance_chain.cu``) copies
each step's rows of u and v into shared memory once a block, by bulk copies
into a ring of two stages, and reads them in one of two layouts built on
the host: rank rows (``sqs.pack_rank_rows``, one byte a rank: a row's
strides summed on each rank and its self stride on its own rank, so that
its table index is a dot product of bytes with the walker's codes) and
slot rows (``sqs.pack_slot_rows``, d2 and the slots' ranks and strides).
Here, on the CPU, on two of ``sqs-fcc8-wide``'s 20 shapes (Au-Cu FCC, pairs
to 9, triplets to 6, quadruplets to 5 Angstrom at size 8, 41 features):
both layouts against the unpacked rows, row for row; the plan's shared
memory against sizes counted by hand; and the ring's chunks, as the kernel
cuts them, against the stages they must fit.
"""

import dataclasses
import functools

import numpy as np
import pytest

from smol_tpu_torch.benchmarks.systems import fcc_binary_prim
from smol_tpu_torch.capp.generate.enumerate import enumerate_supercell_matrices
from smol_tpu_torch.capp.generate.special.sqs import StochasticSQSGenerator
from smol_tpu_torch.cofe import ClusterSubspace
from smol_tpu_torch.ops import sqs

WIDE_CUTOFFS = {2: 9.0, 3: 6.0, 4: 5.0}
SHAPES = (0, 13)  # of the 20 8-site shapes, least skewed first


@functools.lru_cache(maxsize=None)
def _tables():
    symops = ClusterSubspace.from_cutoffs(fcc_binary_prim(), {2: 4.0}).symops
    matrices = enumerate_supercell_matrices(8, symops)[::-1]
    generator = StochasticSQSGenerator.from_structure(
        fcc_binary_prim(), WIDE_CUTOFFS, 8, supercell_matrices=[matrices[s] for s in SHAPES],
        device="cpu")
    return tuple(sqs.build_distance_tables(p) for p in generator.processors)


def _row_index(nbr, stride, d2, r, codes):
    """[L] each row of rank r's index d2 c_r + sum_k stride_k c(nbr_k) at the
    codes ``codes`` [R], from the unpacked rows [R, L, K], [R, L, K], [R, L]."""
    nbr, stride, d2 = (np.asarray(x[r], dtype=np.int64) for x in (nbr, stride, d2))
    return d2 * codes[r] + (stride * np.where(nbr >= 0, codes[np.maximum(nbr, 0)], 0)).sum(1)


def _bytes(words):
    """[..., 4 n] the bytes of int32 words, low byte first."""
    w = words.view(np.uint32).astype(np.int64)
    return ((w[..., None] >> np.array([0, 8, 16, 24])) & 0xFF).reshape(*w.shape[:-1], -1)


def test_rank_rows_hold_the_unpacked_rows():
    rng = np.random.default_rng(0)
    for tables in _tables():
        R, L, _ = tables.nbr.shape
        assert tables.rank_rows is not None and tables.rank_rows.shape == (R, L + L % 2, 2)
        rows = _bytes(tables.rank_rows.numpy())  # [R, Lp, 8]
        assert (rows[:, L:] == 0).all()  # the padding row
        nbr, stride, d2 = tables.nbr.numpy(), tables.stride.numpy(), tables.d2.numpy()
        for r in range(R):
            expect = np.zeros((L, 8), dtype=np.int64)
            for k in range(nbr.shape[2]):
                on = nbr[r, :, k] >= 0
                np.add.at(expect, (np.flatnonzero(on), nbr[r, on, k]), stride[r, on, k])
            assert (expect[:, r] == 0).all()  # no neighbour slot on the own rank
            expect[:, r] = d2[r]
            np.testing.assert_array_equal(rows[r, :L], expect)
            # the kernel's dot products: t at the codes, t + d2 (b - a) after the
            # row's own change from a to b
            for _ in range(4):
                codes = rng.integers(0, 2, R)
                t = rows[r, :L] @ codes
                np.testing.assert_array_equal(t, _row_index(nbr, stride, d2, r, codes))
                changed = codes.copy()
                changed[r] = 1 - codes[r]
                np.testing.assert_array_equal(rows[r, :L] @ changed,
                                              t + d2[r] * (changed[r] - codes[r]))


def test_slot_rows_hold_the_unpacked_rows():
    for tables in _tables():
        R, L, K = tables.nbr.shape
        rows = tables.slot_rows.numpy()
        assert rows.shape == (R, L + L % 2, 12)  # 1 + 2 K = 9 words, padded to 12
        assert (rows[:, L:] == 0).all() and (rows[:, :, 1 + 2 * K:] == 0).all()
        np.testing.assert_array_equal(rows[:, :L, 0], tables.d2.numpy())
        np.testing.assert_array_equal(rows[:, :L, 1:1 + K], tables.nbr.numpy().clip(min=0))
        np.testing.assert_array_equal(rows[:, :L, 1 + K:1 + 2 * K], tables.stride.numpy())


def test_rank_rows_pack_where_they_fit():
    """Rank rows where every byte fits and a row reads no own-rank neighbour;
    two words, up to 8 ranks; else None (the slot rows)."""
    rng = np.random.default_rng(1)
    for R in (6, 8, 9, 16):
        L, K = 5, 3
        nbr = np.stack([rng.choice(np.delete(np.arange(R), r), (L, K)) for r in range(R)])
        nbr[:, 0, 0] = -1
        stride = rng.integers(1, 60, (R, L, K))
        stride[:, 0, 0] = 0
        d2 = rng.integers(1, 256, (R, L))
        packed = sqs.pack_rank_rows(nbr, stride, d2)
        if R > 8:
            assert packed is None
            continue
        assert packed.shape == (R, L, 2)
        rows = _bytes(packed)
        for r in range(R):
            codes = rng.integers(0, 16, R)
            np.testing.assert_array_equal(rows[r, :, :R] @ codes,
                                          _row_index(nbr, stride, d2, r, codes))
        assert (rows[..., R:] == 0).all()
    R, L, K = 4, 2, 2
    nbr = np.array([[[1, 2]] * L, [[0, 2]] * L, [[0, 1]] * L, [[0, 1]] * L])
    stride = np.full((R, L, K), 100)
    d2 = np.ones((R, L), dtype=np.int64)
    assert sqs.pack_rank_rows(nbr, stride, d2) is not None
    assert sqs.pack_rank_rows(nbr, stride, d2 * 256) is None  # a self stride of 256
    same = nbr.copy()
    same[0, 0] = [1, 1]  # two slots on rank 1: 200 + 100 > 255
    stride3 = stride.copy()
    stride3[0, 0] = [200, 100]
    assert sqs.pack_rank_rows(same, stride3, d2) is None
    own = nbr.copy()
    own[0, 0, 0] = 0  # a neighbour slot on the row's own rank
    assert sqs.pack_rank_rows(own, stride, d2) is None
    many = np.zeros((9, 1, 1), dtype=np.int64)
    assert sqs.pack_rank_rows(many - 1, many, np.ones((9, 1), dtype=np.int64)) is None


def _part_bytes(j0, j1, rb):
    """distance_chain.cu part_bytes: rows j0 .. j1 - 1 from 16-byte boundaries."""
    return -(-(j1 * rb) // 16) * 16 - (j0 * rb) // 16 * 16 if j1 > j0 else 0


def _chunks(seg_u, seg_v, F, rb, stage):
    """distance_chain.cu chunk_end, over a step: the chunks' feature ranges."""
    out, f0 = [], 0
    while f0 < F:
        def fits(f1):
            return (_part_bytes(seg_u[f0], seg_u[f1], rb)
                    + _part_bytes(seg_v[f0], seg_v[f1], rb)) <= stage
        f1 = F if fits(F) else f0 + 1
        while f1 < F and fits(f1 + 1):
            f1 += 1
        out.append((f0, f1))
        f0 = f1
    return out


@pytest.mark.parametrize("packed", [True, False])
def test_wide_plan_and_chunks(packed):
    """The plan at the 20-shape launch (2048 walkers a shape, sequence
    blocks of 512), counted by hand for these tables: R = 8, F = 41, TM =
    16, at most 2084 rows a rank and 192 of one feature; two blocks share
    an SM's 228 KB, 1 KB of it reserved a block; and every chunk the kernel
    cuts, for every pair of ranks, fits its stage, the chunks covering the
    features in order: at most two a step for the rank rows at the plan's
    stage, one a feature or more at the least stage the plan allows.  With
    100 features the plan halves the walkers a block until two blocks an
    SM fit, and raises where the design fixes them."""
    batch = sqs.stack_distance_tables(_tables())
    assert (batch.num_ranks, batch.num_feats, batch.g.shape[-1]) == (8, 41, 16)
    assert (batch.rows_max, batch.feature_rows_max) == (2084, 192)
    assert batch.rank_rows.shape == (2, 8, 2084, 2) and batch.slot_rows.shape == (2, 8, 2084, 12)
    # the rest of a block at 64 walkers: gf, the constants, f and fn
    # 41 x (16 + 3 + 2 x 64) x 8 = 48216; group ends and segment starts
    # (41 + 8 x 42) x 4 = 1508 -> 1520; codes and best codes 2 x 8 x 68 = 1088;
    # the two barriers 16
    rest = 48216 + 1520 + 1088 + 16
    assert sqs.wide_shared_bytes(8, 41, 16, 64, 0) == rest == 50840
    share = 228 * 1024 // 2 - 1024  # a block's of two an SM: 115712
    design = sqs._Design(lanes=4, packed=packed)
    plan = sqs.wide_plan(batch, 2048, 512, design)
    assert plan.walkers == 64
    # a whole step is 2 x 2084 rows x 8 B = 33344 (rank rows), 2 x 2084 x 48 B
    # = 200064 (slot rows); two stages of (115712 - 50840) / 2 -> 32432 hold less
    assert plan.stage_bytes == (share - rest) // 2 // 16 * 16 == 32432
    assert (plan.rank, plan.row_bytes) == ((True, 8) if packed else (False, 48))
    assert plan.shared_bytes == rest + 2 * 32432 == 115704 <= share
    assert sqs.distance_chain_shared_bytes(batch, 2048, 512, design) == plan.shared_bytes
    # 16 lanes: 16 walkers a block (256 threads); f and fn 41 x 2 x 16 x 8, codes
    # 2 x 8 x 20: the rest 18584, and a whole step of rank rows fits two an SM
    small = sqs.wide_plan(batch, 2048, 512, sqs._Design(lanes=16, packed=packed))
    assert small.walkers == 16
    assert small.stage_bytes == (33344 if packed else (share - 18584) // 2 // 16 * 16)
    assert small.shared_bytes == 41 * (16 + 3 + 32) * 8 + 1520 + 2 * 8 * 20 + 16 + 2 * (
        small.stage_bytes)
    least = 2 * (-(-192 * plan.row_bytes // 16) * 16 + 16)
    for stage in (plan.stage_bytes, least):
        for tables in batch.shapes:
            seg = tables.seg.numpy()
            for u in range(8):
                for v in range(8):
                    chunks = _chunks(seg[u], seg[v], 41, plan.row_bytes, stage)
                    assert chunks[0][0] == 0 and chunks[-1][1] == 41
                    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
                    for f0, f1 in chunks:
                        assert (_part_bytes(seg[u, f0], seg[u, f1], plan.row_bytes)
                                + _part_bytes(seg[v, f0], seg[v, f1], plan.row_bytes)) <= stage
                    if stage == plan.stage_bytes and packed:
                        assert len(chunks) <= 2
    with pytest.raises(ValueError, match="does not fit"):
        sqs.wide_plan(batch, 2048, 512, sqs._Design(lanes=4, packed=packed,
                                                    stage_bytes=least - 16))
    # 100 features: at 64 walkers the rest, 100 x (16 + 3 + 128) x 8 + (100 +
    # 8 x 101) x 4 + 2 x 8 x 68 + 16 = 122336, leaves two blocks an SM no
    # stage; at 32 walkers, 100 x (16 + 3 + 64) x 8 + 3632 + 2 x 8 x 36 + 16
    # = 70624 leaves two stages of 22544
    wider = dataclasses.replace(batch, seg=np.zeros((1, 8, 101)))
    assert wider.num_feats == 100
    plan = sqs.wide_plan(wider, 2048, 512, design)
    assert (plan.walkers, plan.stage_bytes) == (32, 22544)  # a step's rows exceed it
    assert plan.shared_bytes == 70624 + 2 * 22544 <= share
    with pytest.raises(ValueError, match="does not fit"):
        sqs.wide_plan(wider, 2048, 512, sqs._Design(lanes=4, packed=packed, walkers=64))
