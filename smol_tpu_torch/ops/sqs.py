"""SQS distance annealing: canonical swaps against the correlation distance.

Counterpart of ``smol_tpu/ops/pallas_sqs.py`` (``DistanceTables`` :73,
``build_distance_tables`` :100, ``make_distance_chain`` :355).  Each walker
carries its occupancy and its intensive feature vector f (the correlation
functions without the empty one) and anneals canonical swaps against

    d = -w L + sum_f W_f |f_f - T_f|

(:mod:`smol_tpu_torch.moca.processor.distance`).  A swap's feature change
touches only the local clusters of its two sites, so each step, for a pair
(u, v) of ranks of one sublattice drawn from the exogenous sequences that
the walkers of a block share (as in :mod:`smol_tpu_torch.ops.chain`):

1. adds, for each local row of u (one row per (local cluster, correlation
   function) pair), the change of the row's value from u's code a to v's
   code b into the step's feature change df, then the same for v going
   from b to a with u already holding b;
2. computes d_new from f + df, with L from the diameter groups in the
   processor's order;
3. accepts on the f32 exponent -beta (d_new - d), a null pair (equal codes)
   never, and keeps each walker's best (score, occupancy).

The chain runs in :func:`distance_chain` (one shape) and
:func:`distance_chain_batched` (S shapes of one size in one launch): on a
CUDA tensor they launch the hand-written kernel ``csrc/distance_chain.cu``
(K7); on a CPU tensor they run :func:`distance_chain_reference`, the plain
torch twin that does the same arithmetic in the same order.  Features, df
and d are f64 (the reference's are f32 and double-float pairs).  A walker's
rows are sorted by feature; the kernel gives each walker G threads (lanes),
lane j summing rows j, j + G, ... of each feature, u's then v's, and the
lanes' partials meet in a butterfly, which the twin repeats
(:func:`_lane_sum`; one lane sums every row in order).  A launch takes
the fewest lanes that give it ``LANE_THREADS`` threads (:func:`launch_lanes`).
Up to ``REGISTER_FEATURES`` features the kernel keeps f and df in
registers and the pair's rows in shared memory; above that, and wherever
the rows do not fit in shared memory, it runs its wide body
(:func:`wide_launch`, planned by :func:`wide_plan`): each feature's values
in one table in shared memory (every row of a feature holds the same
values), each step's rows copied into shared memory once a block by bulk
copies a chunk ahead, as rank rows (:func:`pack_rank_rows`: a dot product
of bytes with the walker's codes in registers) where they fit, else as
slot rows (:func:`pack_slot_rows`), a walker's f and fn in shared memory,
feature by feature, with the same sums in the same order.  The score sums the
features in the order of the diameter groups, each term
``W_f * |f_f + df_f - T_f|`` rounded on its own (no fused multiply-add), and
subtracts ``w * L`` last.  Nothing of the TPU layout (bf16 stride planes,
0/1 scatter matrices, extent segments) is kept.

Which shapes take the chain is the reference's choice
(:func:`build_distance_tables` returns None where the reference's
``pallas_sqs.build_distance_tables`` does, its 8 MB table budget
included, :func:`reference_table_bytes`); the SQS search runs the rest
on the per-step path.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from smol_tpu_torch.ops import _build
from smol_tpu_torch.ops.chain import (
    MAX_CHUNK_STEPS,
    RNG_MODES,
    SEED_STRIDE,
    _check_operands,
    _launch_check,
    _lower_margin,
    _metropolis,
    _wrap_int32,
    chain_draws,
    rank_pair_sequence,
)

__all__ = [
    "DistanceBatch",
    "DistanceTables",
    "build_distance_tables",
    "pack_rank_rows",
    "pack_slot_rows",
    "reference_table_bytes",
    "distance_block_walkers",
    "launch_lanes",
    "distance_of",
    "distance_step_reference",
    "pack_rows",
    "distance_chain_reference",
    "distance_chain_batched_reference",
    "distance_chain",
    "distance_chain_batched",
    "distance_chain_shared_bytes",
    "wide_launch",
    "wide_plan",
    "wide_shared_bytes",
    "distance_launch_operands",
    "make_batched_distance_chain",
    "make_distance_chain",
    "stack_distance_tables",
]

MAX_TENSOR = 63  # the reference's bound on a cluster tensor (pallas_chain.py:87)
MAX_CODES = 16  # the reference's bound on a site's codes (fastmc.py:50)
REFERENCE_TABLE_BUDGET = 8 * 2**20  # the reference's table bytes (pallas_sqs.py:70)
REGISTER_FEATURES = 32  # the most features of the kernel's register bodies (FMAX)
MAX_SHARED_BYTES = 232448  # shared memory one block can use on sm_90 (227 KB)
DISTANCE_THREADS = 256  # most threads of a CUDA block (kDistanceThreads)
STATIC_SHARED_BYTES = 1024  # the kernel's per-feature constants (896 bytes at most)
LANE_THREADS = 32768  # a launch takes the fewest lanes that give it this many threads
WIDE_LANE_THREADS = 131072  # the same for the wide body, which holds more warps an SM
MAX_LANES = 16
WIDE_THREADS = 256  # most threads of a block of the wide body (kWideThreads)
WIDE_STAGES = 2  # the wide body's ring of row stages (kStages)
WIDE_BLOCKS = 2  # blocks of the wide body an SM holds (kWideBlocks): its stages' size
SM_SHARED_BYTES = 233472  # an SM's shared memory on sm_90 (228 KB), 1 KB of it a block's


@dataclass(frozen=True)
class DistanceTables:
    """Static operands of the distance chain, on one device.

    R active ranks, L local rows per rank at most (a row is one local
    cluster with one of its orbit's correlation functions), K slots per
    cluster, TM the largest tensor, F features, P the most rows of one
    rank on one feature.  A rank's rows are sorted by feature: rows
    ``seg[r, f] .. seg[r, f + 1] - 1`` feed feature f.  Features are in
    the order of the diameter groups (``feature_ids``); ``group_last[f]``
    is 1 where feature f ends its group and ``group_diameter[f]`` is the
    diameter of its group.  ``padded`` holds the twin's [R, F, P, ...]
    layout of the same rows (zero rows pad each feature to P).
    """

    num_sites: int
    rank_sites: torch.Tensor  # [R] int64
    nbr: torch.Tensor  # [R, L, K] int32 neighbour rank, -1 = contributes 0
    stride: torch.Tensor  # [R, L, K] int32 (0 wherever nbr is -1)
    d2: torch.Tensor  # [R, L] int32 summed stride of the rank's own slots
    g: torch.Tensor  # [R, L, TM] f64 corr_flat / fn_cluster_count of the row
    seg: torch.Tensor  # [R, F + 1] int32 first row of each feature
    feature_ids: np.ndarray  # [F] correlation function of each feature
    target: torch.Tensor  # [F] f64
    weight: torch.Tensor  # [F] f64
    group_last: torch.Tensor  # [F] int32
    group_diameter: torch.Tensor  # [F] f64
    groups: tuple  # ((first feature, end, diameter), ...) ascending diameter
    match_tol: float
    match_weight: float
    cum_probs: torch.Tensor  # [S] f64 sublattice pick cdf (uniform)
    sub_offset: torch.Tensor  # [S] int64 first rank of each sublattice
    n_active: torch.Tensor  # [S] int64 ranks of each sublattice
    padded: dict  # nbr, stride [R, F, P, K]; d2 [R, F, P]; g [R, F, P, TM]
    meta: torch.Tensor | None = None  # [R, L, 2] int32 packed rows (pack_rows)
    gfeat: torch.Tensor | None = None  # [F, TM] f64 each feature's values (every row's)
    rank_rows: torch.Tensor | None = None  # [R, Lp, 2] int32 (pack_rank_rows)
    rows_max: int = 0  # the most rows of a rank
    feature_rows_max: int = 0  # the most rows of a rank on one feature

    @functools.cached_property
    def slot_rows(self) -> torch.Tensor:
        """[R, Lp, 4 n] int32, :func:`pack_slot_rows`, made at first use."""
        return pack_slot_rows(self.nbr, self.stride, self.d2)

    @property
    def num_ranks(self) -> int:
        return int(self.nbr.shape[0])

    @property
    def num_feats(self) -> int:
        return len(self.feature_ids)

    @property
    def device(self) -> torch.device:
        return self.g.device


def _function_offsets(system) -> np.ndarray:
    """Offset in ``corr_flat`` of each correlation function's tensor.

    Orbit tensors are appended combo-major from slot 1 in the order of the
    orbits' first functions (``pallas_sqs.py:189-202``).
    """
    bit_id = np.asarray(system["orbit_bit_id"])
    ncomb = np.asarray(system["orbit_num_combos"])
    tsize = np.asarray(system["orbit_tensor_size"])
    fn_off = np.zeros(int(system["num_corr"]), dtype=np.int64)
    off = 1
    for o in np.argsort(bit_id, kind="stable"):
        if o == 0:
            continue
        for k in range(int(ncomb[o])):
            fn_off[bit_id[o] + k] = off
            off += int(tsize[o])
    return fn_off


def reference_table_bytes(num_ranks, max_rows, num_feats, tensor_max) -> int:
    """The bytes of the reference's distance tables of these shapes
    (``pallas_sqs.py:317``: its bf16 stride planes [R, Ld, RP], its f32
    value and self-stride rows [R, Ld, 2 TM + 1] and its bf16 scatter
    matrices [R, FP, Ld], with Ld the power of two from 8 that holds a
    rank's rows, RP the ranks and FP the features, each rounded up to a
    multiple of 8, at least 8).  Above ``REFERENCE_TABLE_BUDGET`` the
    reference refuses its chain (:318-319), and so does the port: the rule
    decides the path, whatever the port's own layout needs."""
    ld = 8
    while ld < max_rows:
        ld *= 2
    rpad = max(8, -(-num_ranks // 8) * 8)
    fpad = max(8, -(-num_feats // 8) * 8)
    return (2 * num_ranks * ld * rpad + 4 * num_ranks * ld * (2 * tensor_max + 1)
            + 2 * num_ranks * fpad * ld)


def build_distance_tables(processor) -> DistanceTables | None:
    """Distance tables of a :class:`CorrelationDistanceProcessor`, on its
    device, or None where the reference's chain refuses the processor
    (``pallas_sqs.py:100-330``), which then runs on the per-step path.

    The reference's refusals: another processor than the correlation
    distance, a tensor of more than ``MAX_TENSOR`` entries, no active
    sublattice, non-default (arange) encodings or restricted sites, a site
    of more than ``MAX_CODES`` codes, a local cluster without a positive
    self stride or reaching a frozen multi-code site, a row whose strides
    on one neighbour rank sum to 256 or more, no feature or no row, and
    tables of more than ``REFERENCE_TABLE_BUDGET`` bytes as the reference
    lays them out (:func:`reference_table_bytes`).  Any number of features
    is taken: above ``REGISTER_FEATURES`` the kernel runs its wide body.
    """
    if type(processor).__name__ != "CorrelationDistanceProcessor":
        return None
    system = processor.system
    sublattices = processor.get_sublattices()
    n = processor.num_sites
    sites3 = np.asarray(system["local_sites"]).astype(np.int64)
    strides3 = np.asarray(system["local_strides"]).astype(np.int64)
    orbit = np.asarray(system["local_orbit"]).astype(np.int64)
    tsize = np.asarray(system["orbit_tensor_size"]).astype(np.int64)
    tmax = int(tsize.max())
    if tmax > MAX_TENSOR:
        return None

    active = [s for s in sublattices if s.is_active]
    if not active:
        return None
    for s in active:
        if not np.array_equal(s.encoding, np.arange(len(s.encoding))):
            return None  # non-default sublattice encodings
        if len(s.active_sites) != len(s.sites):
            return None  # restricted sites
    n_codes = np.ones(n, dtype=np.int64)
    for s in sublattices:
        n_codes[s.sites] = len(s.encoding)
    if n_codes.max() > MAX_CODES:
        return None

    rank_sites = np.concatenate([np.asarray(s.active_sites) for s in active])
    R = len(rank_sites)
    rank_of_site = -np.ones(n, dtype=np.int64)
    rank_of_site[rank_sites] = np.arange(R)
    valid = orbit >= 0  # [N, L0]
    is_self = (sites3 == np.arange(n)[:, None, None]) & (strides3 > 0)
    d2_all = np.where(is_self, strides3, 0).sum(axis=2)
    if np.any(valid & (d2_all <= 0)) or d2_all.max(initial=0) >= 2**24:
        return None  # a local cluster without a positive self stride
    nbr_rank = rank_of_site[sites3]
    frozen = (strides3 > 0) & ~is_self & (nbr_rank < 0) & valid[:, :, None]
    if np.any(frozen & (n_codes[sites3] != 1)):
        return None  # a local cluster reaches a frozen multi-code site
    contributes = (strides3 > 0) & ~is_self & (nbr_rank >= 0) & valid[:, :, None]
    # a row's strides summed on each neighbour rank (the reference's bf16
    # stride planes hold them below 256)
    on_rank = np.where(contributes, strides3, 0)
    same = nbr_rank[:, :, :, None] == nbr_rank[:, :, None, :]
    if (same * on_rank[:, :, None, :]).sum(axis=3).max(initial=0) >= 256:
        return None

    # features in the order of the diameter groups (the plane rows)
    feature_ids, groups = [], []
    for diameter, indices in processor.diameter_groups:
        g0 = len(feature_ids)
        feature_ids.extend(int(f) for f in indices)
        groups.append((g0, len(feature_ids), float(diameter)))
    F = len(feature_ids)
    if F == 0:
        return None
    row_of_fn = -np.ones(processor.num_corr, dtype=np.int64)
    row_of_fn[feature_ids] = np.arange(F)
    fn_off = _function_offsets(system)
    bit_id = np.asarray(system["orbit_bit_id"])
    ncomb = np.asarray(system["orbit_num_combos"])
    corr_flat = np.asarray(system["corr_flat"], dtype=np.float64)
    ncl = np.asarray(system["fn_cluster_count"], dtype=np.float64)

    # each rank's rows (local cluster l, function) in the reference's order,
    # then sorted by feature (stable: (l, combo) order within a feature)
    rows = []
    for site in rank_sites:
        mine = []
        for l in np.flatnonzero(valid[site]):
            o = int(orbit[site, l])
            for k in range(int(ncomb[o])):
                fn = int(bit_id[o]) + k
                if row_of_fn[fn] >= 0:
                    mine.append((int(row_of_fn[fn]), int(l), fn))
        mine.sort(key=lambda row: row[0])
        rows.append(mine)
    max_rows = max(len(mine) for mine in rows)
    if max_rows == 0 or reference_table_bytes(R, max_rows, F, tmax) > REFERENCE_TABLE_BUDGET:
        return None
    L = max_rows
    K = sites3.shape[2]
    nbr = -np.ones((R, L, K), dtype=np.int64)
    stride = np.zeros((R, L, K), dtype=np.int64)
    d2 = np.zeros((R, L), dtype=np.int64)
    g = np.zeros((R, L, tmax), dtype=np.float64)
    seg = np.zeros((R, F + 1), dtype=np.int64)
    for r, (site, mine) in enumerate(zip(rank_sites, rows)):
        counts = np.bincount([row[0] for row in mine], minlength=F)
        seg[r, 1:] = np.cumsum(counts)
        for j, (_, l, fn) in enumerate(mine):
            on = contributes[site, l]
            nbr[r, j] = np.where(on, nbr_rank[site, l], -1)
            stride[r, j] = np.where(on, strides3[site, l], 0)
            d2[r, j] = d2_all[site, l]
            ts = int(tsize[orbit[site, l]])
            g[r, j, :ts] = corr_flat[fn_off[fn]: fn_off[fn] + ts] / ncl[fn]

    # the twin's layout: each feature's rows padded to P with zero rows
    counts = np.diff(seg, axis=1)  # [R, F]
    P = max(1, int(counts.max()))
    slot = np.full((R, F, P), L, dtype=np.int64)  # L: the zero row
    for r in range(R):
        for f in range(F):
            slot[r, f, : counts[r, f]] = np.arange(seg[r, f], seg[r, f + 1])

    def with_zero_row(x):
        return np.concatenate([x, np.zeros_like(x[:, :1])], axis=1)

    meta = pack_rows(nbr, stride, d2)
    # the wide body's rank rows, an even count a rank (16-byte boundaries)
    rank_rows = pack_rank_rows(nbr, stride, d2)
    if rank_rows is not None:
        rank_rows = np.pad(rank_rows, ((0, 0), (0, L % 2), (0, 0)))
    # a row's values are its feature's (corr_flat / fn_cluster_count of its
    # function), so one [F, TM] table serves every rank's rows of a feature
    gfeat = np.zeros((F, tmax), dtype=np.float64)
    for f in range(F):
        ranks = np.flatnonzero(seg[:, f + 1] > seg[:, f])
        if len(ranks):
            gfeat[f] = g[ranks[0], seg[ranks[0], f]]
    rr = np.arange(R)[:, None, None]
    nbr_p = with_zero_row(nbr)
    nbr_p[:, L] = -1

    group_last = np.zeros(F, dtype=np.int64)
    group_diameter = np.zeros(F, dtype=np.float64)
    for g0, g1, diameter in groups:
        group_last[g1 - 1] = 1
        group_diameter[g0:g1] = diameter
    n_active = np.array([len(s.active_sites) for s in active], dtype=np.int64)
    coefs = processor.coefs
    device = processor.device

    def dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    return DistanceTables(
        num_sites=n,
        rank_sites=dev(rank_sites, torch.int64),
        nbr=dev(nbr, torch.int32),
        stride=dev(stride, torch.int32),
        d2=dev(d2, torch.int32),
        g=dev(g, torch.float64),
        seg=dev(seg, torch.int32),
        feature_ids=np.asarray(feature_ids, dtype=np.int64),
        target=dev(processor.target_vector[feature_ids], torch.float64),
        weight=dev(coefs[feature_ids], torch.float64),
        group_last=dev(group_last, torch.int32),
        group_diameter=dev(group_diameter, torch.float64),
        groups=tuple(groups),
        match_tol=float(processor.match_tol),
        match_weight=float(-coefs[0]),
        cum_probs=dev(np.cumsum(np.full(len(active), 1.0 / len(active))), torch.float64),
        sub_offset=dev(np.concatenate([[0], np.cumsum(n_active)[:-1]]), torch.int64),
        n_active=dev(n_active, torch.int64),
        meta=None if meta is None else dev(meta, torch.int32),
        gfeat=dev(gfeat, torch.float64),
        rank_rows=None if rank_rows is None else dev(rank_rows, torch.int32),
        rows_max=int((seg[:, -1] - seg[:, 0]).max()),
        feature_rows_max=P,
        padded={
            "nbr": dev(nbr_p[rr, slot], torch.int64),
            "stride": dev(with_zero_row(stride)[rr, slot], torch.int64),
            "d2": dev(with_zero_row(d2)[rr, slot], torch.int64),
            "g": dev(with_zero_row(g)[rr, slot], torch.float64),
        },
    )


def pack_rows(nbr, stride, d2):
    """[R, L, 2] int32: each row's self stride and up to three neighbour
    slots in two words, one 8-byte load in the kernel, or None where a
    field does not fit a byte (more than 3 slots, 256 ranks, a stride of
    256).  Word 0 holds d2 in bits 0-7 and the slots' ranks in bits 8-15,
    16-23, 24-31; word 1 their strides in bits 0-7, 8-15, 16-23.  An empty
    slot (rank -1, stride 0) reads rank 0 times stride 0, which adds 0."""
    R, L, K = nbr.shape
    if K > 3 or R > 256 or stride.max(initial=0) > 255 or d2.max(initial=0) > 255:
        return None
    ranks = np.zeros((R, L, 3), dtype=np.int64)
    strides = np.zeros((R, L, 3), dtype=np.int64)
    ranks[..., :K] = np.where(nbr >= 0, nbr, 0)
    strides[..., :K] = stride
    words = np.stack([d2 | ranks[..., 0] << 8 | ranks[..., 1] << 16 | ranks[..., 2] << 24,
                      strides[..., 0] | strides[..., 1] << 8 | strides[..., 2] << 16], axis=-1)
    return words.astype(np.uint32).view(np.int32)


def pack_rank_rows(nbr, stride, d2):
    """[R, L, 2] int32: each row of the wide body as one byte a rank, or
    None where they do not fit (more than 8 ranks, a self stride or a row's
    strides summed on one rank above 255, a neighbour slot on the row's own
    rank).  Byte r holds the row's strides summed over its slots on rank r
    and, on the row's own rank, its self stride d2, so that with a walker's
    codes c (one byte a rank) the row's index d2 a + sum_k stride_k
    c(nbr_k) is sum_r byte_r c_r, the kernel's dot product of bytes; with
    the row's own code changed from a to b it is that index plus d2 (b -
    a).  Padding rows are 0."""
    R, L, K = nbr.shape
    if R > 8 or d2.max(initial=0) > 255:
        return None
    on_rank = np.zeros((R, L, R), dtype=np.int64)
    for k in range(K):
        r, j = np.nonzero(nbr[..., k] >= 0)
        np.add.at(on_rank, (r, j, nbr[r, j, k]), stride[r, j, k])
    own = np.arange(R)
    if on_rank.max(initial=0) > 255 or on_rank[own, :, own].any():
        return None
    on_rank[own, :, own] = d2
    full = np.zeros((R, L, 8), dtype=np.int64)
    full[..., :R] = on_rank
    shifts = np.array([0, 8, 16, 24])
    packed = (full.reshape(R, L, 2, 4) << shifts).sum(axis=-1)
    return packed.astype(np.uint32).view(np.int32)


def pack_slot_rows(nbr, stride, d2):
    """[..., Lp, 4 n] int32 from the rows' tensors [..., L, K] (``nbr``,
    ``stride``) and [..., L] (``d2``): each row of the wide body as d2, its K
    slots' ranks and their K strides, padded with zeros to a multiple of
    four words (16 bytes), and the rows to an even count Lp (a rank's rows
    start on a 16-byte boundary); an empty slot (rank -1, stride 0) reads
    rank 0 times stride 0.  Every row takes this layout; the wide body reads
    it where the rank rows (:func:`pack_rank_rows`) do not fit."""
    L, K = nbr.shape[-2:]
    words = -(-(1 + 2 * K) // 4) * 4
    rows = torch.cat([d2[..., None], nbr.clamp(min=0), stride], dim=-1).to(torch.int32)
    return torch.nn.functional.pad(rows, (0, words - 1 - 2 * K, 0, L % 2))


def distance_of(tables: DistanceTables, plane):
    """Scores [W] f64 of a feature plane [F, W], summed and matched as the
    kernel does."""
    x = (plane - tables.target[:, None]).abs()
    dsum = torch.zeros(plane.shape[1], dtype=torch.float64, device=plane.device)
    for f in range(len(x)):
        dsum = dsum + tables.weight[f] * x[f]
    ell = torch.zeros_like(dsum)
    running = torch.ones_like(dsum, dtype=torch.bool)
    for g0, g1, diameter in tables.groups:
        running = running & (x[g0:g1] <= tables.match_tol).all(dim=0)
        ell = torch.where(running, torch.clamp(ell, min=diameter), ell)
    return dsum - tables.match_weight * ell


def _row_terms(tables: DistanceTables, occ, u, a, b):
    """[F, P, W] f64 change of each of rank u[w]'s rows from code a to b
    (zero on the padding rows)."""
    pad = tables.padded
    walkers = torch.arange(occ.shape[1], device=occ.device)
    nb = pad["nbr"][u]  # [W, F, P, K]
    codes = occ[nb.clamp(min=0), walkers[:, None, None, None]].long()
    d2 = pad["d2"][u]  # [W, F, P]
    t = d2 * a[:, None, None] + (pad["stride"][u] * codes).sum(dim=-1)
    tn = t + d2 * (b - a)[:, None, None]
    g_u = pad["g"][u]  # [W, F, P, TM]
    term = g_u.gather(3, tn[..., None])[..., 0] - g_u.gather(3, t[..., None])[..., 0]
    return term.permute(1, 2, 0)


def _lane_sum(terms_u, terms_v, lanes):
    """[F, W] feature change of a step, summed as the kernel's ``lanes``
    lanes sum it: lane j adds rows j, j + lanes, ... of each feature, u's
    then v's, in order from +0.0; then the lanes' partials meet in a
    butterfly (lane j adds lane j ^ m's partial, m = 1, 2, 4, ...).

    Padding rows add +0.0, which leaves a partial that starts at +0.0
    unchanged, so padding the rows to a multiple of ``lanes`` changes no
    bit."""
    F, P, W = terms_u.shape
    steps = -(-P // lanes)
    partial = terms_u.new_zeros((F, lanes, W))
    for terms in (terms_u, terms_v):
        if steps * lanes != P:
            terms = torch.nn.functional.pad(terms, (0, 0, 0, steps * lanes - P))
        terms = terms.reshape(F, steps, lanes, W)
        for k in range(steps):
            partial = partial + terms[:, k]
    m = 1
    while m < lanes:
        partner = torch.arange(lanes, device=partial.device) ^ m
        partial = partial + partial[:, partner]
        m <<= 1
    return partial[:, 0]


def distance_step_reference(tables: DistanceTables, occ, feat, d, u, v, r_u, beta32,
                            lanes=1):
    """One swap proposal for every walker, without applying it.

    ``occ`` [R, W] int8 codes (left as it was), ``feat`` [F, W] f64, ``d``
    [W] f64 the walkers' scores, ``u``/``v`` [W] ranks, ``r_u`` [W] random
    bits, ``beta32`` [W] f32, ``lanes`` the kernel's threads per walker,
    which set the order of df's sums (:func:`_lane_sum`).  Returns
    ``(accept, is_move, a, b, fn, d_new, expo, log_u)``: u holds a and v
    holds b; ``fn`` [F, W] and ``d_new`` are the features and score after
    the swap.  A null pair (a == b) is never accepted.
    """
    walkers = torch.arange(occ.shape[1], device=occ.device)
    u, v = u.long(), v.long()
    a = occ[u, walkers].long()
    b = occ[v, walkers].long()
    is_move = a != b
    terms_u = _row_terms(tables, occ, u, a, b)
    occ[u, walkers] = b.to(occ.dtype)  # v's rows see u already holding b
    terms_v = _row_terms(tables, occ, v, b, a)
    occ[u, walkers] = a.to(occ.dtype)
    fn = feat + _lane_sum(terms_u, terms_v, lanes)
    d_new = distance_of(tables, fn)
    accept, expo, log_u = _metropolis(d_new - d, r_u, beta32)
    return accept & is_move, is_move, a, b, fn, d_new, expo, log_u


def distance_chain_reference(occ, best_occ, feat, d, best_d, naccept, beta32,
                             useq, vseq, seed, tables, n_steps, block_size,
                             rng="philox", margin=None, slack=0.0, work=None,
                             lanes=None):
    """Plain torch twin of the CUDA distance-chain kernel (same arguments).

    Updates ``occ``, ``best_occ``, ``feat``, ``d``, ``best_d`` and
    ``naccept`` in place.  ``lanes`` is the kernel's threads per walker
    (default: :func:`launch_lanes` of this launch's W walkers): the twin
    sums each step's df in their order (:func:`_lane_sum`).
    ``margin``, an optional [W] f32 tensor, is lowered in place to each
    walker's closest decision beyond beta * ``slack`` (the bound on another
    implementation's error in d_new - d), in f32 ulps of log U
    (``ops/chain.py:_lower_margin``); null pairs never lower it.  ``work``,
    an optional [2, W] int64 tensor, gains each walker's non-null proposals
    (row 0) and the rows of u and v those proposals read (row 1): the work
    its data needs.
    """
    W = occ.shape[1]
    lanes = lanes or launch_lanes(W, tables=tables)
    walkers = torch.arange(W, device=occ.device)
    group = walkers // block_size
    r_u, _ = chain_draws(rng, int(seed[0]), n_steps, W, block_size, occ.device)
    rows = (tables.seg[:, -1] - tables.seg[:, 0]).long()  # [R] rows of each rank
    for i in range(n_steps):
        u, v = useq[group, i].long(), vseq[group, i].long()
        accept, is_move, a, b, fn, d_new, expo, log_u = distance_step_reference(
            tables, occ, feat, d, u, v, r_u[i], beta32, lanes
        )
        if margin is not None:
            _lower_margin(margin, expo, log_u, beta32, slack, ~is_move)
        if work is not None:
            work[0] += is_move
            work[1] += torch.where(is_move, rows[u] + rows[v], 0)
        occ[u, walkers] = torch.where(accept, b, a).to(occ.dtype)
        occ[v, walkers] = torch.where(accept, a, b).to(occ.dtype)
        feat.copy_(torch.where(accept, fn, feat))
        d.copy_(torch.where(accept, d_new, d))
        naccept += accept.to(naccept.dtype)
        better = d < best_d
        best_d.copy_(torch.where(better, d, best_d))
        best_occ.copy_(torch.where(better, occ, best_occ))


@dataclass(frozen=True)
class DistanceBatch:
    """The tables of S shapes of one size, stacked for one launch.

    ``shapes`` holds each shape's :class:`DistanceTables` (the twin's);
    the kernel's operands are stacked shape-major and padded to the
    batch's largest L, K and TM (rows past a rank's ``seg`` end are never
    read): ``nbr``, ``stride`` [S, R, L, K] int32, ``d2`` [S, R, L],
    ``g`` [S, R, L, TM] f64, ``seg`` [S, R, F + 1], ``target``, ``weight``,
    ``group_diameter`` [S, F] f64, ``group_last`` [S, F] int32,
    ``match`` [S, 2] f64 (match_tol, match_weight) and, where every shape
    has them, the packed rows ``meta`` [S, R, L, 2] int32 (:func:`pack_rows`);
    for the wide body each feature's values ``gfeat`` [S, F, TM], where every
    shape has them the rank rows ``rank_rows`` [S, R, Lp, words] int32, Lp
    the rows a rank padded to an even count (a rank's rows start on a
    16-byte boundary), and the slot rows (:attr:`slot_rows`).
    """

    shapes: tuple
    nbr: torch.Tensor
    stride: torch.Tensor
    d2: torch.Tensor
    g: torch.Tensor
    seg: torch.Tensor
    target: torch.Tensor
    weight: torch.Tensor
    group_last: torch.Tensor
    group_diameter: torch.Tensor
    match: torch.Tensor
    meta: torch.Tensor | None = None  # [S, R, L, 2] int32 where every shape packs
    gfeat: torch.Tensor | None = None  # [S, F, TM] f64
    rank_rows: torch.Tensor | None = None  # [S, R, Lp, 2] int32 where every shape packs

    @property
    def num_shapes(self) -> int:
        return len(self.shapes)

    @property
    def num_ranks(self) -> int:
        return int(self.nbr.shape[1])

    @property
    def num_feats(self) -> int:
        return int(self.seg.shape[2]) - 1

    @property
    def device(self) -> torch.device:
        return self.g.device

    @functools.cached_property
    def slot_rows(self) -> torch.Tensor:
        """[S, R, Lp, 4 n] int32, :func:`pack_slot_rows`, made at first use."""
        return pack_slot_rows(self.nbr, self.stride, self.d2)

    @property
    def rows_max(self) -> int:
        return max(t.rows_max for t in self.shapes)

    @property
    def feature_rows_max(self) -> int:
        return max(t.feature_rows_max for t in self.shapes)


@functools.lru_cache(maxsize=None)
def _match_tensor(device, match_tol, match_weight):
    """[2] f64 (match_tol, match_weight) on ``device``, made once per value."""
    return torch.tensor([match_tol, match_weight], dtype=torch.float64, device=device)


def stack_distance_tables(tables_seq) -> DistanceBatch:
    """The :class:`DistanceBatch` of shapes of one size (equal R and F).

    One shape's batch is made of views of its tables, with no copy."""
    tables_seq = tuple(tables_seq)
    first = tables_seq[0]
    R, F = first.num_ranks, first.num_feats
    if any(t.num_ranks != R or t.num_feats != F or t.device != first.device
           for t in tables_seq):
        raise ValueError("a batch of distance tables needs equal ranks, features "
                         "and device")
    match = [_match_tensor(t.device, t.match_tol, t.match_weight) for t in tables_seq]
    names = ("target", "weight", "group_last", "group_diameter")
    packed = all(t.meta is not None for t in tables_seq)
    rank = all(t.rank_rows is not None for t in tables_seq)
    if len(tables_seq) == 1:
        return DistanceBatch(
            shapes=tables_seq, nbr=first.nbr[None], stride=first.stride[None],
            d2=first.d2[None], g=first.g[None], seg=first.seg[None],
            **{name: getattr(first, name)[None] for name in names}, match=match[0][None],
            meta=first.meta[None] if packed else None, gfeat=first.gfeat[None],
            rank_rows=first.rank_rows[None] if rank else None,
        )
    L = max(t.nbr.shape[1] for t in tables_seq)
    K = max(t.nbr.shape[2] for t in tables_seq)
    TM = max(t.g.shape[2] for t in tables_seq)
    pad = torch.nn.functional.pad
    def stacked(name, widths, value=0):
        """The shapes' ``name`` tensors padded to ``widths`` after the rank axis."""
        out = []
        for t in tables_seq:
            x = getattr(t, name)
            spec = []  # torch's pad order: the last axis first
            for width, n in reversed(list(zip(widths, x.shape[1:]))):
                spec += [0, width - n]
            out.append(pad(x, spec, value=value))
        return torch.stack(out)

    return DistanceBatch(
        shapes=tables_seq, nbr=stacked("nbr", (L, K), -1), stride=stacked("stride", (L, K)),
        d2=stacked("d2", (L,)), g=stacked("g", (L, TM)),
        seg=torch.stack([t.seg for t in tables_seq]),
        **{name: torch.stack([getattr(t, name) for t in tables_seq]) for name in names},
        match=torch.stack(match), meta=stacked("meta", (L, 2)) if packed else None,
        gfeat=stacked("gfeat", (TM,)),
        rank_rows=stacked("rank_rows", (L + L % 2, first.rank_rows.shape[-1])) if rank else None,
    )


@dataclass(frozen=True)
class _Design:
    """How the distance kernel is launched: its threads per walker (None:
    :func:`launch_lanes` of the launch's walkers), whether every rank's rows
    stay in shared memory (None: wherever they fit), whether a batch of
    shapes is one launch, and whether the rows are read packed where the
    tables have them (:func:`pack_rows`, F <= 8; in the wide body the rank
    rows, :func:`pack_rank_rows`, else the slot rows).  For the wide body
    also its walkers a block and the bytes of a stage of its ring (None:
    :func:`wide_plan`'s).  Private: the A/B of ``chip_smoke.py`` and the
    tests choose one; users get the default."""

    lanes: int | None = None
    resident: bool | None = None
    batched: bool = True
    packed: bool = True
    walkers: int | None = None
    stage_bytes: int | None = None


_DESIGN = _Design()
_OLD_DESIGN = _Design(lanes=1, resident=False, batched=False, packed=False)


def launch_lanes(walkers, design=_DESIGN, tables=None):
    """Threads per walker of a launch of ``walkers`` walkers (every shape's):
    the design's, else the fewest (1, 2, 4, 8 or 16) that give the launch
    ``LANE_THREADS`` threads.  A launch that fills the card (the 20 8-site
    shapes: 40960 walkers) runs fastest at one lane, since every further
    lane repeats the score, the draws and the decision; one shape of 2048
    walkers runs fastest at 16, spread over more warps (NVIDIA H100,
    ``PERF.md``).  The lanes set the order of df's sums, so a shape's
    features round as the lanes of its launch sum them; its draws do not
    depend on the launch.  Given the launch's ``tables`` (a
    :class:`DistanceTables` or a :class:`DistanceBatch`), a launch of the
    wide body (:func:`wide_launch`) takes the fewest that give it
    ``WIDE_LANE_THREADS``: 4 lanes at the 20-shape launch, faster there
    than 1, 2 or 8 on the H100 (``PERF.md``): its shared memory a walker (f
    and fn) does not grow with the lanes, so more lanes put more warps on an
    SM, until what every lane repeats (the segment starts, the butterfly,
    the score) outweighs them."""
    if design.lanes:
        return design.lanes
    wide = tables is not None and wide_launch(tables)
    target = WIDE_LANE_THREADS if wide else LANE_THREADS
    lanes = 1
    while lanes < MAX_LANES and walkers * lanes < target:
        lanes *= 2
    return lanes


def _resolve(design, walkers, tables):
    """``design`` with its lanes for a launch of ``walkers`` walkers."""
    return dataclasses.replace(design, lanes=launch_lanes(walkers, design, tables))


def distance_block_walkers(W, block_size, design=_DESIGN, tables=None):
    """Walkers of one CUDA block: a block must lie inside one sequence group
    of ``block_size`` walkers, since its threads share the group's pairs.
    Given the launch's ``tables`` (a :class:`DistanceTables` or a
    :class:`DistanceBatch`) of the wide body, :func:`wide_plan`'s."""
    if tables is not None and wide_launch(tables):
        return wide_plan(tables, W, block_size, design).walkers
    lanes = launch_lanes(W, design, tables)
    return _group_walkers(W, block_size, min(64, DISTANCE_THREADS // lanes))


def _group_walkers(W, block_size, wb):
    """``wb`` walkers a block, or fewer where a block would straddle two
    sequence groups."""
    return wb if W <= block_size or block_size % wb == 0 else math.gcd(block_size, wb)


def _packed(tables, design):
    """Whether a launch reads the packed rows (the K = 3 body, F <= 8)."""
    return design.packed and tables.meta is not None and tables.num_feats <= 8


def wide_shared_bytes(R, F, TM, walkers_per_block, stage_bytes) -> int:
    """Dynamic shared memory of a block of the wide body, in bytes
    (``wide_shared_bytes`` of distance_chain.cu): the ring's
    ``WIDE_STAGES`` stages of ``stage_bytes`` and their barriers (16
    bytes), each feature's values [F, TM] and the score's constants (f64),
    each walker's f and fn, the group ends and the segment starts (int32),
    the codes and the best codes."""
    doubles = F * (TM + 3 + 2 * walkers_per_block) * 8
    ints = -(-((F + R * (F + 1)) * 4) // 16) * 16
    pitch = -(-walkers_per_block // 4) * 4 + 4
    return WIDE_STAGES * stage_bytes + 16 + doubles + ints + 2 * R * pitch


@dataclass(frozen=True)
class WidePlan:
    """The launch of the wide body: walkers a block, its staged rows (the
    batch's tensor [S, R, Lp, words] and ``rank``, whether they are rank
    rows), a row's bytes, a stage's bytes, the block's dynamic shared
    memory."""

    walkers: int
    rows: torch.Tensor
    rank: bool
    row_bytes: int
    stage_bytes: int
    shared_bytes: int


def _align16(n):
    return -(-n // 16) * 16


def wide_plan(tables, W, block_size, design=_DESIGN) -> WidePlan:
    """How the wide body launches ``tables`` (a :class:`DistanceTables` or
    a :class:`DistanceBatch`) at W walkers a shape: rank rows where the
    tables have them and the design reads packed rows, else slot rows;
    min(64, ``WIDE_THREADS`` / lanes) walkers a block (the design's where
    it names them), inside one sequence group; the ring's two stages take
    what is left of ``WIDE_BLOCKS`` blocks' share of an SM's shared memory
    (the kernel's registers hold that many blocks an SM, faster than one
    block an SM on the H100, ``PERF.md``), a whole step's rows of u and v
    where they fit, else fed feature-chunk by feature-chunk: a stage holds
    at least any one feature's rows of u and v, each from a 16-byte
    boundary.  Where that does not fit, the walkers a block are halved.
    Raises ``ValueError`` where nothing fits."""
    lanes = launch_lanes(W, design, tables)
    rank = design.packed and tables.rank_rows is not None
    rows = tables.rank_rows if rank else tables.slot_rows
    rows = rows if rows.dim() == 4 else rows[None]
    row_bytes = 4 * rows.shape[-1]
    R, F, TM = tables.nbr.shape[-3], tables.num_feats, tables.g.shape[-1]
    whole = 2 * _align16(tables.rows_max * row_bytes)  # a step's rows of u and v
    least = 2 * (_align16(tables.feature_rows_max * row_bytes) + 16)
    share = SM_SHARED_BYTES // WIDE_BLOCKS - 1024
    wb = _group_walkers(W, block_size, design.walkers or min(64, WIDE_THREADS // lanes))
    while True:
        rest = wide_shared_bytes(R, F, TM, wb, 0)
        stage = design.stage_bytes or min(whole, (share - rest) // WIDE_STAGES // 16 * 16)
        if least <= stage and rest + WIDE_STAGES * stage <= MAX_SHARED_BYTES:
            break
        if wb == 1 or design.walkers or design.stage_bytes:
            raise ValueError(
                f"distance_chain: the wide body's block ({wb} walkers, {F} features, "
                f"stages of at least {least} bytes) does not fit in shared memory")
        wb = wb // 2 if wb % 2 == 0 else 1
    return WidePlan(wb, rows, rank, row_bytes, stage, rest + WIDE_STAGES * stage)


def _register_bytes(tables, W, block_size, design, resident):
    """Dynamic shared memory of a launch of a register body (F <= 32)."""
    R, L, K = tables.nbr.shape[-3:]
    meta = 8 * L if _packed(tables, design) else L * (2 * K + 1) * 4
    row_set = -(-(L * tables.g.shape[-1] * 8 + meta) // 16) * 16
    seg_bytes = -(-(R * (tables.num_feats + 1) * 4) // 16) * 16
    pitch = -(-distance_block_walkers(W, block_size, design) // 4) * 4 + 4
    return (R if resident else 4) * row_set + seg_bytes + 2 * R * pitch


def wide_launch(tables) -> bool:
    """Whether launches of ``tables`` run the kernel's wide body: above
    ``REGISTER_FEATURES`` features, or where the register bodies' four
    streamed row sets do not fit in shared memory beside the codes of the
    largest block."""
    if tables.num_feats > REGISTER_FEATURES:
        return True
    R, L, K = tables.nbr.shape[-3:]
    row_set = -(-(L * tables.g.shape[-1] * 8 + L * (2 * K + 1) * 4) // 16) * 16
    seg_bytes = -(-(R * (tables.num_feats + 1) * 4) // 16) * 16
    return 4 * row_set + seg_bytes + 2 * R * 68 + STATIC_SHARED_BYTES > MAX_SHARED_BYTES


def distance_chain_shared_bytes(tables, W, block_size, design=_DESIGN, resident=False):
    """Dynamic shared memory of one launch of W walkers a shape, in bytes
    (``shared_bytes`` of distance_chain.cu): every rank's rows
    (``resident``) or two buffers of u's and v's rows, every rank's segment
    starts, and the block's codes and best codes; for the wide body
    (:func:`wide_launch`), :func:`wide_plan`'s.  ``tables`` is a
    :class:`DistanceTables` or a :class:`DistanceBatch`."""
    design = _resolve(design, W * getattr(tables, "num_shapes", 1), tables)
    if wide_launch(tables):
        return wide_plan(tables, W, block_size, design).shared_bytes
    return _register_bytes(tables, W, block_size, design, resident)


def _resident(tables, W, block_size, design):
    """Whether a launch keeps every rank's rows in shared memory: where they
    fit beside the codes and the kernel's static shared memory (at most
    ``STATIC_SHARED_BYTES``); never in the wide body."""
    if wide_launch(tables):
        if design.resident:
            raise ValueError("distance_chain: the wide body stages each step's rows; "
                             "it keeps no rank's rows resident")
        return False
    smem = distance_chain_shared_bytes(tables, W, block_size, design, True)
    fits = smem + STATIC_SHARED_BYTES <= MAX_SHARED_BYTES
    if design.resident and not fits:
        raise ValueError("distance_chain: every rank's rows do not fit in shared memory")
    return fits if design.resident is None else design.resident


def _launch(occ, best_occ, feat, d, best_d, naccept, beta32, useq, vseq, seed, batch,
            n_steps, block_size, rng, design):
    """One kernel launch over the [S, ...] operands of ``batch``."""
    S, R, W = occ.shape
    L, K = batch.nbr.shape[2:]
    wide = wide_launch(batch)
    design = _resolve(design, S * W, batch)
    resident = _resident(batch, W, block_size, design)
    if wide:  # each feature's values [S, F, TM] and the staged rows
        plan = wide_plan(batch, W, block_size, design)
        meta, packed, wb, stage = plan.rows, int(plan.rank), plan.walkers, plan.stage_bytes
        L, smem = plan.rows.shape[2], plan.shared_bytes
    else:
        packed, meta, stage = int(_packed(batch, design)), batch.meta, 0
        wb = distance_block_walkers(W, block_size, design, batch)
        smem = distance_chain_shared_bytes(batch, W, block_size, design, resident)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"distance_chain needs {smem} bytes of shared memory per block, "
            f"above the card's {MAX_SHARED_BYTES}"
        )
    lib = _build.load_chain("distance_chain")
    with torch.cuda.device(occ.device):
        stream = torch.cuda.current_stream(occ.device).cuda_stream
        rc = lib.smol_distance_chain(
            occ.data_ptr(), best_occ.data_ptr(), feat.data_ptr(), d.data_ptr(),
            best_d.data_ptr(), naccept.data_ptr(), beta32.data_ptr(),
            useq.data_ptr(), vseq.data_ptr(), useq.stride(1), useq.stride(0),
            seed.data_ptr(), batch.nbr.data_ptr(), batch.stride.data_ptr(),
            batch.d2.data_ptr(), (batch.gfeat if wide else batch.g).data_ptr(),
            batch.seg.data_ptr(), batch.target.data_ptr(), batch.weight.data_ptr(),
            batch.group_last.data_ptr(), batch.group_diameter.data_ptr(),
            batch.match.data_ptr(), meta.data_ptr() if packed or wide else None, S, R, L,
            K, batch.g.shape[3], batch.num_feats, W, block_size, n_steps, RNG_MODES[rng],
            design.lanes, wb, int(resident), packed, int(wide), stage, stream,
        )
    distance_chain.launches += 1
    if wide:
        distance_chain.wide_launches += 1
    _launch_check(lib, "distance_chain", rc)


def _check_device(name, occ, rng):
    if occ.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {occ.device}")
    if rng not in RNG_MODES:
        raise ValueError(f"unknown rng mode: {rng!r}")


def distance_chain(occ, best_occ, feat, d, best_d, naccept, beta32, useq, vseq,
                   seed, tables, n_steps, block_size, rng="philox", _design=_DESIGN):
    """Run ``n_steps`` shared-proposal distance swaps on every walker, in place.

    Args:
        occ: [R, W] int8 codes, rank-major; updated in place.
        best_occ: [R, W] int8, each walker's best codes so far.
        feat: [F, W] f64 features of ``occ`` in the tables' order.
        d: [W] f64 scores of ``feat`` (:func:`distance_of`).
        best_d: [W] f64 scores of ``best_occ``.
        naccept: [W] int32, accepted moves added in place.
        beta32: [W] f32 inverse temperatures (kB = 1; the exponent is f32).
        useq, vseq: [G, >= n_steps] int32 swap pairs, one row per block of
            ``block_size`` walkers (G = ceil(W / block_size)).
        seed: [1] int64 seed of this launch.
        tables: :class:`DistanceTables` on the same device.
        rng: ``"philox"`` (run mode) or ``"hash"`` (reference parity).

    A CUDA tensor launches the kernel (``distance_chain.launches`` counts the
    launches); a CPU tensor runs :func:`distance_chain_reference` with the
    kernel's lanes.
    """
    R, W = occ.shape
    F = tables.num_feats
    _check_operands(
        "distance_chain", occ, d, (naccept,), beta32, (useq, vseq), seed, tables,
        n_steps, block_size,
        extra=((best_occ, torch.int8, (R, W)), (feat, torch.float64, (F, W)),
               (best_d, torch.float64, (W,))),
    )
    if occ.device.type == "cpu":
        distance_chain_reference(occ, best_occ, feat, d, best_d, naccept, beta32,
                                 useq, vseq, seed, tables, n_steps, block_size, rng,
                                 lanes=launch_lanes(W, _design, tables))
        return
    _check_device("distance_chain", occ, rng)
    _launch(occ[None], best_occ[None], feat[None], d[None], best_d[None], naccept[None],
            beta32[None], useq[None], vseq[None], seed, stack_distance_tables((tables,)),
            n_steps, block_size, rng, _design)


distance_chain.launches = 0
distance_chain.wide_launches = 0  # of them, launches of the wide body


def _check_batch(occ, best_occ, feat, d, best_d, naccept, beta32, useq, vseq, seed,
                 batch, n_steps, block_size):
    """Raise ``ValueError`` on a batched operand the chain does not take."""
    S, R, W = occ.shape
    F = batch.num_feats
    expect = ((occ, torch.int8, (batch.num_shapes, batch.num_ranks, W)),
              (best_occ, torch.int8, (S, R, W)), (feat, torch.float64, (S, F, W)),
              (d, torch.float64, (S, W)), (best_d, torch.float64, (S, W)),
              (naccept, torch.int32, (S, W)), (beta32, torch.float32, (S, W)),
              (seed, torch.int64, (S,)))
    for tensor, dtype, shape in expect:
        if tensor.dtype != dtype or tuple(tensor.shape) != shape:
            raise ValueError(f"distance_chain_batched operand: expected {dtype} {shape}, "
                             f"got {tensor.dtype} {tuple(tensor.shape)}")
    groups = -(-W // block_size)
    for seq in (useq, vseq):
        if block_size < 1 or seq.dtype != torch.int32 or seq.dim() != 3 \
                or tuple(seq.shape[:2]) != (S, groups) or seq.shape[2] < n_steps \
                or seq.stride() != useq.stride():
            raise ValueError(
                f"distance_chain_batched sequence: expected int32 [{S}, {groups}, "
                f">={n_steps}], got {seq.dtype} {tuple(seq.shape)}")
    operands = [t for t, _, _ in expect] + [useq, vseq, batch.g]
    if any(t.device != occ.device for t in operands):
        raise ValueError("distance_chain_batched operands lie on different devices")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("distance_chain_batched operands must be contiguous")


def distance_chain_batched_reference(occ, best_occ, feat, d, best_d, naccept, beta32,
                                     useq, vseq, seed, batch, n_steps, block_size,
                                     rng="philox", work=None, lanes=None):
    """Plain torch twin of a batched launch: :func:`distance_chain_reference`
    on each shape's slice of the [S, ...] operands, in place, at ``lanes``
    (default: :func:`launch_lanes` of the launch's S x W walkers; ``work``,
    an optional [S, 2, W] int64 tensor, gains each shape's work counts)."""
    lanes = lanes or launch_lanes(occ.shape[0] * occ.shape[2], tables=batch)
    for s, tables in enumerate(batch.shapes):
        distance_chain_reference(occ[s], best_occ[s], feat[s], d[s], best_d[s],
                                 naccept[s], beta32[s], useq[s], vseq[s], seed[s: s + 1],
                                 tables, n_steps, block_size, rng,
                                 work=None if work is None else work[s], lanes=lanes)


def distance_chain_batched(occ, best_occ, feat, d, best_d, naccept, beta32, useq, vseq,
                           seed, batch, n_steps, block_size, rng="philox",
                           _design=_DESIGN):
    """:func:`distance_chain` on S shapes of one size at once, in place.

    Every operand gains a leading shape axis: ``occ``, ``best_occ`` [S, R,
    W], ``feat`` [S, F, W], ``d``, ``best_d``, ``naccept``, ``beta32`` [S,
    W], ``useq``, ``vseq`` [S, G, >= n_steps], ``seed`` [S]; ``batch`` is a
    :class:`DistanceBatch`.  Each shape's walkers draw as that shape's own
    launch would, so the result equals S launches of one shape each at the
    batch's lanes (:func:`launch_lanes` of all S x W walkers).  A
    CUDA tensor launches the kernel once (``distance_chain.launches``); a
    CPU tensor runs :func:`distance_chain_batched_reference`.
    """
    _check_batch(occ, best_occ, feat, d, best_d, naccept, beta32, useq, vseq, seed,
                 batch, n_steps, block_size)
    S, _, W = occ.shape
    _design = _resolve(_design, S * W if _design.batched else W, batch)
    if occ.device.type == "cpu":
        distance_chain_batched_reference(occ, best_occ, feat, d, best_d, naccept, beta32,
                                         useq, vseq, seed, batch, n_steps, block_size,
                                         rng, lanes=_design.lanes)
        return
    _check_device("distance_chain_batched", occ, rng)
    if _design.batched:
        _launch(occ, best_occ, feat, d, best_d, naccept, beta32, useq, vseq, seed, batch,
                n_steps, block_size, rng, _design)
        return
    for s, tables in enumerate(batch.shapes):  # one shape per launch
        _launch(occ[s: s + 1], best_occ[s: s + 1], feat[s: s + 1], d[s: s + 1],
                best_d[s: s + 1], naccept[s: s + 1], beta32[s: s + 1], useq[s: s + 1],
                vseq[s: s + 1], seed[s: s + 1], stack_distance_tables((tables,)),
                n_steps, block_size, rng, _design)


def _walker_operands(tables: DistanceTables, corr, occu, best_occu):
    """Rank-major codes, best codes and the exact feature plane of walkers
    ``occu`` [W, N] with intensive correlations ``corr`` [W, num_corr]:
    ``(occ, best_occ, feat, d)``."""
    feature_ids = torch.as_tensor(tables.feature_ids, device=corr.device)
    feat = corr[:, feature_ids].T.contiguous()  # [F, W]
    d = distance_of(tables, feat)
    occ = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
    best_occ = best_occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
    return occ, best_occ, feat, d


def distance_launch_operands(tables: DistanceTables, base_corr_fn, occu, beta,
                             n_steps, block_size, generator) -> dict:
    """Keyword operands of :func:`distance_chain` (and of its twin) for
    walkers at ``occu`` [W, N], each its own best so far, at inverse
    temperatures ``beta`` [W], with swap pairs [G, n_steps] drawn from
    ``generator``.  The launch seed is the caller's to add."""
    W = occu.shape[0]
    occ, best_occ, feat, d = _walker_operands(tables, base_corr_fn(occu), occu, occu)
    useq, vseq = rank_pair_sequence(tables, generator, (-(-W // block_size), n_steps))
    return dict(
        occ=occ, best_occ=best_occ, feat=feat, d=d, best_d=d.clone(),
        naccept=torch.zeros(W, dtype=torch.int32, device=occu.device),
        beta32=beta.to(torch.float32), useq=useq, vseq=vseq, tables=tables,
        n_steps=n_steps, block_size=block_size,
    )


def make_distance_chain(tables: DistanceTables, n_steps: int, base_corr_fn,
                        block_size: int = 512, chunk_steps: int | None = None,
                        rng: str = "philox", seqs=None, seeds=None, _design=_DESIGN):
    """Build ``fn(state, generator) -> state`` annealing ``n_steps`` swaps.

    ``base_corr_fn(occu [W, N]) -> [W, num_corr] f64`` returns the exact
    intensive correlation vectors (``CorrelationDistanceProcessor.compute_corr``):
    every call of ``fn`` recomputes each walker's features, and its score
    from them, exactly (``pallas_sqs.py:607-626``), so no drift crosses a
    launch.  ``state`` holds ``occupancy`` [W, N] int32, ``enthalpy`` [W]
    f64 (the score; overwritten, not read), ``beta`` [W] f64 (1 /
    temperature at kB = 1), ``naccept`` [W] int32, ``best_enthalpy`` [W]
    f64 and ``best_occupancy`` [W, N] int32, and optionally
    ``window_naccept``; ``fn`` updates them in place and sets ``accepted``.
    ``generator`` is a ``torch.Generator`` on the state's device.

    Walkers share their swap pairs in blocks of min(``block_size``,
    ceil(W / 128) * 128), as the reference's walker blocks.  The steps run
    in chunks of ``chunk_steps``, by default 2048 with ``rng="hash"`` (the
    reference's chunk) and all in one launch with ``"philox"``: chunk c
    takes seed ``seed0 + c * 999983`` (int32 wrap in hash mode) and counts
    its steps from 0.  ``seqs = (u_seqs, v_seqs)`` [n_chunks, G, chunk] and
    ``seeds`` [n_chunks] replace the draws (the tests pass the reference's
    own).  This is :func:`make_batched_distance_chain` over one shape.
    """
    run = make_batched_distance_chain(
        (tables,), n_steps, (base_corr_fn,), block_size, chunk_steps, rng,
        None if seqs is None else (seqs,), None if seeds is None else (seeds,), _design)

    def fn(state, generator):
        return run((state,), (generator,))[0]

    return fn


def make_batched_distance_chain(tables_seq, n_steps: int, base_corr_fns,
                                block_size: int = 512, chunk_steps: int | None = None,
                                rng: str = "philox", seqs=None, seeds=None,
                                _design=_DESIGN):
    """Build ``fn(states, generators) -> states``: :func:`make_distance_chain`'s
    ``fn`` on S shapes of one size, one launch per chunk for all of them.

    ``states``, ``generators``, ``base_corr_fns`` and (optionally) ``seqs``
    and ``seeds`` hold one entry per shape of ``tables_seq``; every state
    has the same number of walkers.  Each shape draws its pairs, then its
    seed, from its own generator, in shape order, and its features are
    recomputed exactly on entry, as its own ``make_distance_chain`` would:
    the result equals one such chain per shape at the same lanes bit for
    bit.  The lanes (:func:`launch_lanes` of all S x W walkers, where one
    shape's chain takes those of its W) set the order of df's sums, so at
    other lanes a shape's scores can differ in their last bits.
    """
    if rng not in RNG_MODES:
        raise ValueError(f"unknown rng mode: {rng!r}")
    tables_seq = tuple(tables_seq)
    batch = stack_distance_tables(tables_seq)
    default_chunk = MAX_CHUNK_STEPS if rng == "hash" else n_steps
    chunk = max(1, min(n_steps, chunk_steps or default_chunk))
    n_chunks = -(-n_steps // chunk)

    def draws(tables, generator, wb, W, device, shape_seqs, shape_seeds):
        """One shape's pairs [n_chunks, G, chunk] and seeds [n_chunks]."""
        shape = (n_chunks, -(-W // wb), chunk)
        if shape_seqs is not None:
            useq, vseq = (torch.as_tensor(np.asarray(s), dtype=torch.int32, device=device)
                          for s in shape_seqs)
        else:
            useq, vseq = rank_pair_sequence(tables, generator, shape)
        if shape_seeds is not None:
            seed = torch.as_tensor(np.asarray(shape_seeds), dtype=torch.int64, device=device)
        elif rng == "hash":
            seed0 = torch.randint(0, 2**30 - 1, (1,), generator=generator,
                                  device=device, dtype=torch.int64)
            seed = _wrap_int32(seed0 + torch.arange(n_chunks, device=device) * SEED_STRIDE)
        else:
            seed0 = torch.randint(0, 2**62, (1,), generator=generator, device=device,
                                  dtype=torch.int64)
            seed = seed0 + torch.arange(n_chunks, device=device) * SEED_STRIDE
        return useq, vseq, seed

    def fn(states, generators):
        W = states[0]["occupancy"].shape[0]
        if any(state["occupancy"].shape[0] != W for state in states):
            raise ValueError("every shape of a batch needs the same number of walkers")
        device = states[0]["occupancy"].device
        wb = min(block_size, -(-W // 128) * 128)
        drawn = [draws(tables, gen, wb, W, device,
                       None if seqs is None else seqs[s], None if seeds is None else seeds[s])
                 for s, (tables, gen) in enumerate(zip(tables_seq, generators))]
        useq, vseq, seed = (torch.stack(x, dim=1) for x in zip(*drawn))  # chunk-major
        walkers = [_walker_operands(tables, corr_fn(state["occupancy"]),
                                    state["occupancy"], state["best_occupancy"])
                   for tables, corr_fn, state in zip(tables_seq, base_corr_fns, states)]
        occ, best_occ, feat, d = (torch.stack(x) for x in zip(*walkers))
        best_d = torch.stack([state["best_enthalpy"] for state in states])
        nacc = torch.zeros((len(states), W), dtype=torch.int32, device=device)
        beta32 = torch.stack([state["beta"] for state in states]).to(torch.float32)
        for c in range(n_chunks):
            steps = min(chunk, n_steps - c * chunk)
            distance_chain_batched(occ, best_occ, feat, d, best_d, nacc, beta32,
                                   useq[c].contiguous(), vseq[c].contiguous(),
                                   seed[c].contiguous(), batch, steps, wb, rng, _design)
        for s, (tables, state) in enumerate(zip(tables_seq, states)):
            occu = state["occupancy"]
            occu[:, tables.rank_sites] = occ[s].T.to(occu.dtype)
            state["best_occupancy"][:, tables.rank_sites] = best_occ[s].T.to(occu.dtype)
            state["enthalpy"].copy_(d[s])
            torch.minimum(state["best_enthalpy"], best_d[s], out=state["best_enthalpy"])
            state["naccept"] += nacc[s]
            state["accepted"] = nacc[s] > 0  # coarse: any accept in the window
            if "window_naccept" in state:
                state["window_naccept"] += nacc[s]
        return states

    return fn
