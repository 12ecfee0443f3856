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

The chain runs in :func:`distance_chain`: on a CUDA tensor it launches the
hand-written kernel ``csrc/distance_chain.cu`` (K7); on a CPU tensor it runs
:func:`distance_chain_reference`, the plain torch twin that does the same
arithmetic in the same order.  Features, df and d are f64 (the reference's
are f32 and double-float pairs).  A walker's rows are sorted by feature, and
df of a feature sums that feature's rows of u, then of v, in row order; the
score sums the features in the order of the diameter groups, each term
``W_f * |f_f + df_f - T_f|`` rounded on its own (no fused multiply-add), and
subtracts ``w * L`` last.  Nothing of the TPU layout (bf16 stride planes,
0/1 scatter matrices, extent segments) is kept.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from smol_tpu_torch.ops import _build
from smol_tpu_torch.ops.chain import (
    MAX_CHUNK_STEPS,
    RNG_MODES,
    SEED_STRIDE,
    _check_operands,
    _cuda_block_threads,
    _launch_check,
    _lower_margin,
    _metropolis,
    _wrap_int32,
    chain_draws,
    rank_pair_sequence,
)

__all__ = [
    "DistanceTables",
    "build_distance_tables",
    "distance_of",
    "distance_step_reference",
    "distance_chain_reference",
    "distance_chain",
    "distance_chain_shared_bytes",
    "distance_launch_operands",
    "make_distance_chain",
]

MAX_TENSOR = 63  # the reference's bound on a cluster tensor (pallas_chain.py:87)
MAX_FEATURES = 32  # the kernel keeps f and df of a walker in registers
MAX_SHARED_BYTES = 232448  # shared memory one block can use on sm_90 (227 KB)


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


def build_distance_tables(processor) -> DistanceTables:
    """Distance tables of a :class:`CorrelationDistanceProcessor`, on its device.

    Requirements, as the reference's (``pallas_sqs.py:131-168``): active
    sublattices with default (arange) encodings and no restricted sites,
    a positive self stride in every local cluster, every other slot on an
    active or a single-code site, tensors of at most ``MAX_TENSOR``
    entries; and at most ``MAX_FEATURES`` features.  The reference falls
    back to its per-step path where it cannot build the tables; the port
    has none and raises ``NotImplementedError``.
    """

    def refuse(why):
        return NotImplementedError(
            f"the distance chain cannot take this processor ({why}), and the "
            "per-step path is not ported yet (ROADMAP.md Queue 1 item 6)"
        )

    if type(processor).__name__ != "CorrelationDistanceProcessor":
        raise refuse("only the correlation distance has tables")
    system = processor.system
    sublattices = processor.get_sublattices()
    n = processor.num_sites
    sites3 = np.asarray(system["local_sites"]).astype(np.int64)
    strides3 = np.asarray(system["local_strides"]).astype(np.int64)
    orbit = np.asarray(system["local_orbit"]).astype(np.int64)
    tsize = np.asarray(system["orbit_tensor_size"]).astype(np.int64)
    tmax = int(tsize.max())
    if tmax > MAX_TENSOR:
        raise refuse(f"a tensor of {tmax} > {MAX_TENSOR} entries")

    active = [s for s in sublattices if s.is_active]
    if not active:
        raise refuse("no active sublattice")
    for s in active:
        if not np.array_equal(s.encoding, np.arange(len(s.encoding))):
            raise refuse("non-default sublattice encodings")
        if len(s.active_sites) != len(s.sites):
            raise refuse("sublattices with restricted sites")
    n_codes = np.ones(n, dtype=np.int64)
    for s in sublattices:
        n_codes[s.sites] = len(s.encoding)

    rank_sites = np.concatenate([np.asarray(s.active_sites) for s in active])
    R = len(rank_sites)
    rank_of_site = -np.ones(n, dtype=np.int64)
    rank_of_site[rank_sites] = np.arange(R)
    valid = orbit >= 0  # [N, L0]
    is_self = (sites3 == np.arange(n)[:, None, None]) & (strides3 > 0)
    d2_all = np.where(is_self, strides3, 0).sum(axis=2)
    if np.any(valid & (d2_all <= 0)):
        raise refuse("a local cluster without a positive self stride")
    nbr_rank = rank_of_site[sites3]
    frozen = (strides3 > 0) & ~is_self & (nbr_rank < 0) & valid[:, :, None]
    if np.any(frozen & (n_codes[sites3] != 1)):
        raise refuse("a local cluster reaches a frozen multi-code site")
    contributes = (strides3 > 0) & ~is_self & (nbr_rank >= 0) & valid[:, :, None]

    # features in the order of the diameter groups (the plane rows)
    feature_ids, groups = [], []
    for diameter, indices in processor.diameter_groups:
        g0 = len(feature_ids)
        feature_ids.extend(int(f) for f in indices)
        groups.append((g0, len(feature_ids), float(diameter)))
    F = len(feature_ids)
    if F == 0:
        raise refuse("no feature")
    if F > MAX_FEATURES:
        raise refuse(f"{F} > {MAX_FEATURES} features")
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
    L = max(1, max(len(mine) for mine in rows))
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
        padded={
            "nbr": dev(nbr_p[rr, slot], torch.int64),
            "stride": dev(with_zero_row(stride)[rr, slot], torch.int64),
            "d2": dev(with_zero_row(d2)[rr, slot], torch.int64),
            "g": dev(with_zero_row(g)[rr, slot], torch.float64),
        },
    )


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


def distance_step_reference(tables: DistanceTables, occ, feat, d, u, v, r_u, beta32):
    """One swap proposal for every walker, without applying it.

    ``occ`` [R, W] int8 codes (left as it was), ``feat`` [F, W] f64, ``d``
    [W] f64 the walkers' scores, ``u``/``v`` [W] ranks, ``r_u`` [W] random
    bits, ``beta32`` [W] f32.  Returns ``(accept, is_move, a, b, fn, d_new,
    expo, log_u)``: u holds a and v holds b; ``fn`` [F, W] and ``d_new`` are
    the features and score after the swap.  A null pair (a == b) is never
    accepted.
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
    df = torch.zeros_like(feat)
    for terms in (terms_u, terms_v):
        for k in range(terms.shape[1]):
            df = df + terms[:, k]
    fn = feat + df
    d_new = distance_of(tables, fn)
    accept, expo, log_u = _metropolis(d_new - d, r_u, beta32)
    return accept & is_move, is_move, a, b, fn, d_new, expo, log_u


def distance_chain_reference(occ, best_occ, feat, d, best_d, naccept, beta32,
                             useq, vseq, seed, tables, n_steps, block_size,
                             rng="philox", margin=None, slack=0.0, work=None):
    """Plain torch twin of the CUDA distance-chain kernel (same arguments).

    Updates ``occ``, ``best_occ``, ``feat``, ``d``, ``best_d`` and
    ``naccept`` in place.  ``margin``, an optional [W] f32 tensor, is
    lowered in place to each walker's closest decision beyond beta *
    ``slack`` (the bound on another implementation's error in d_new - d), in
    f32 ulps of log U (``ops/chain.py:_lower_margin``); null pairs never
    lower it.  ``work``, an optional [2, W] int64 tensor, gains each
    walker's non-null proposals (row 0) and the rows of u and v those
    proposals read (row 1): the work its data needs.
    """
    W = occ.shape[1]
    walkers = torch.arange(W, device=occ.device)
    group = walkers // block_size
    r_u, _ = chain_draws(rng, int(seed[0]), n_steps, W, block_size, occ.device)
    rows = (tables.seg[:, -1] - tables.seg[:, 0]).long()  # [R] rows of each rank
    for i in range(n_steps):
        u, v = useq[group, i].long(), vseq[group, i].long()
        accept, is_move, a, b, fn, d_new, expo, log_u = distance_step_reference(
            tables, occ, feat, d, u, v, r_u[i], beta32
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


def distance_chain_shared_bytes(tables: DistanceTables, W, block_size):
    """Dynamic shared memory of one launch, in bytes: two buffers of u's
    and v's rows, and the block's codes and best codes."""
    L, K = tables.nbr.shape[1:]
    row_set = L * tables.g.shape[2] * 8 + L * (2 * K + 1) * 4
    row_set = -(-row_set // 16) * 16
    return 4 * row_set + 2 * tables.num_ranks * _cuda_block_threads(W, block_size)


def distance_chain(occ, best_occ, feat, d, best_d, naccept, beta32, useq, vseq,
                   seed, tables, n_steps, block_size, rng="philox"):
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
    launches); a CPU tensor runs :func:`distance_chain_reference`.
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
                                 useq, vseq, seed, tables, n_steps, block_size, rng)
        return
    if occ.device.type != "cuda":
        raise ValueError(f"distance_chain runs on cuda or cpu, not {occ.device}")
    if rng not in RNG_MODES:
        raise ValueError(f"unknown rng mode: {rng!r}")
    L, K = tables.nbr.shape[1:]
    smem = distance_chain_shared_bytes(tables, W, block_size)
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
            useq.data_ptr(), vseq.data_ptr(), useq.stride(0), seed.data_ptr(),
            tables.nbr.data_ptr(), tables.stride.data_ptr(), tables.d2.data_ptr(),
            tables.g.data_ptr(), tables.seg.data_ptr(), tables.target.data_ptr(),
            tables.weight.data_ptr(), tables.group_last.data_ptr(),
            tables.group_diameter.data_ptr(), R, L, K, tables.g.shape[2], F, W,
            block_size, n_steps, RNG_MODES[rng], tables.match_tol,
            tables.match_weight, stream,
        )
    distance_chain.launches += 1
    _launch_check(lib, "distance_chain", rc)


distance_chain.launches = 0


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
                        rng: str = "philox", seqs=None, seeds=None):
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
    own).
    """
    if rng not in RNG_MODES:
        raise ValueError(f"unknown rng mode: {rng!r}")
    default_chunk = MAX_CHUNK_STEPS if rng == "hash" else n_steps
    chunk = max(1, min(n_steps, chunk_steps or default_chunk))
    n_chunks = -(-n_steps // chunk)
    rank_sites = tables.rank_sites

    def fn(state, generator):
        occu = state["occupancy"]
        W = occu.shape[0]
        device = occu.device
        wb = min(block_size, -(-W // 128) * 128)
        shape = (n_chunks, -(-W // wb), chunk)
        if seqs is not None:
            useq, vseq = (torch.as_tensor(np.asarray(s), dtype=torch.int32, device=device)
                          for s in seqs)
        else:
            useq, vseq = rank_pair_sequence(tables, generator, shape)
        if seeds is not None:
            seed = torch.as_tensor(np.asarray(seeds), dtype=torch.int64, device=device)
        elif rng == "hash":
            seed0 = torch.randint(0, 2**30 - 1, (1,), generator=generator,
                                  device=device, dtype=torch.int64)
            seed = _wrap_int32(seed0 + torch.arange(n_chunks, device=device) * SEED_STRIDE)
        else:
            seed0 = torch.randint(0, 2**62, (1,), generator=generator, device=device,
                                  dtype=torch.int64)
            seed = seed0 + torch.arange(n_chunks, device=device) * SEED_STRIDE

        occ, best_occ, feat, d = _walker_operands(
            tables, base_corr_fn(occu), occu, state["best_occupancy"])
        best_d = state["best_enthalpy"].clone()
        nacc = torch.zeros(W, dtype=torch.int32, device=device)
        beta32 = state["beta"].to(torch.float32)
        for c in range(n_chunks):
            steps = min(chunk, n_steps - c * chunk)
            distance_chain(occ, best_occ, feat, d, best_d, nacc, beta32,
                           useq[c].contiguous(), vseq[c].contiguous(),
                           seed[c: c + 1].contiguous(), tables, steps, wb, rng)
        occu[:, rank_sites] = occ.T.to(occu.dtype)
        state["best_occupancy"][:, rank_sites] = best_occ.T.to(occu.dtype)
        state["enthalpy"].copy_(d)
        torch.minimum(state["best_enthalpy"], best_d, out=state["best_enthalpy"])
        state["naccept"] += nacc
        state["accepted"] = nacc > 0  # coarse: any accept in the window
        if "window_naccept" in state:
            state["window_naccept"] += nacc
        return state

    return fn
