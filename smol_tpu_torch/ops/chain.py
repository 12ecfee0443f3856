"""Shared-proposal chains: flips, canonical swaps, table moves, Wang-Landau.

Counterpart of ``smol_tpu/ops/pallas_chain.py`` for ``move="flip"``,
``move="swap"`` and ``move="table"`` and for ``wl=WLChain(...)``
(``build_chain_tables`` :841 with the
Ewald fold :1043-1091, ``rank_sequence`` :1142, ``rank_pair_sequence``
:1161, ``TableMove`` :1186, ``build_table_move`` :1233,
``table_sequences`` :1328, ``WLChain`` :1399,
``make_shared_proposal_chain`` :1439).  The statistical contract is the
reference's: the proposal sites follow an exogenous sequence shared by
the walkers of one block (``block_size``), every other draw is per walker,
and each walker is an exact Metropolis chain.  ``proposal_mode="sweep"``
replaces the random sequence of flips with one fixed permutation of the
active ranks, repeated, so that the walkers are fully independent.

A swap takes an exogenous pair (u, v) of ranks of one sublattice; a pair
whose sites hold the same code (or u == v) is an identity proposal that
is never accepted, and the chain counts the other, non-null proposals
(``nmove``).  The joint delta is exact: dE(u: a -> b) + dE(v: b -> a with
u already holding b).

A table move (constrained composition moves, e.g. charge-neutral
semigrand flips) takes an exogenous direction row of a :class:`TableMove`
and one rank per slot of that row; it recolors the row's valid slots in
order, each against the occupancy as the earlier slots left it, if every
checked slot holds its from-code, and is an identity proposal otherwise.
Every direction's negation is in the table with the same weight and the
slot sites are uniform over fixed sublattices, so the proposal is
symmetric and plain Metropolis acceptance is exact.

With a :class:`WLChain` the flips or swaps are accepted by the
Wang-Landau rule on the entropy difference of the enthalpy bins instead of
the Metropolis rule, and the chain keeps each walker's entropy, histogram,
occurrences, modification factor and in-window step count
(:func:`wl_chain`).

The chains run in :func:`flip_chain`, :func:`swap_chain`,
:func:`table_chain` and :func:`wl_chain`: on a CUDA tensor they launch the
hand-written kernels ``csrc/flip_chain.cu``, ``csrc/swap_chain.cu``,
``csrc/table_chain.cu`` and ``csrc/wl_chain.cu``; on a CPU tensor they run
:func:`flip_chain_reference`, :func:`swap_chain_reference`,
:func:`table_chain_reference` and :func:`wl_chain_reference`, the plain
torch twins that do the same arithmetic in the same order.

Tables hold the rank layout of the reference (rank = position in the
concatenated active sites of the active sublattices) on plain f64
lookups; nothing of the TPU layout (bf16 gather rows, double-float splits,
L segments, Ising or q-ary character tables) is kept.  With an Ewald term
the tables carry the reference's fold in f64 (no hi/lo split): the Ewald
change of rank u going from code a to b is (b - a) * (C_u + V_u . occ).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from smol_tpu_torch.moca.processor.composite import CompositeProcessor
from smol_tpu_torch.moca.processor.ewald import EwaldProcessor
from smol_tpu_torch.moca.processor.expansion import ClusterExpansionProcessor
from smol_tpu_torch.ops import _build
from smol_tpu_torch.ops.rng import hash_bits, philox4x32_10, uniform01_from_bits

__all__ = [
    "ChainTables",
    "build_chain_tables",
    "fold_ewald",
    "rank_sequence",
    "rank_pair_sequence",
    "sweep_schedule",
    "chain_draws",
    "flip_step_reference",
    "flip_chain_reference",
    "flip_chain",
    "swap_step_reference",
    "swap_chain_reference",
    "swap_chain",
    "TableMove",
    "make_table_move",
    "build_table_move",
    "table_sequences",
    "table_step_reference",
    "table_chain_reference",
    "table_chain",
    "WLChain",
    "wl_step_reference",
    "wl_chain_reference",
    "wl_chain",
    "wl_launch_operands",
    "make_shared_proposal_chain",
]

MAX_CHUNK_STEPS = 2048  # the reference's step chunk (hash-mode parity)
SEED_STRIDE = 999983  # hash mode: seed of chunk c = seed0 + c * SEED_STRIDE
BLOCK_SEED_STRIDE = 7919  # hash mode: block seed = chunk seed + block * 7919
SWEEP_SEED = 0x5EED  # seed of the sweep schedule's fixed permutation
RNG_MODES = {"philox": 0, "hash": 1}
MOVES = ("flip", "swap", "table")
MAX_TABLE_SLOTS = 8  # most site recolorings of one table move
MAX_SHARED_BYTES = 232448  # shared memory one block can use on sm_90 (227 KB)


@dataclass(frozen=True)
class ChainTables:
    """Static operands of the chain kernels, on one device.

    R active ranks, L local clusters per site, K slots per cluster, TM the
    largest tensor, C code columns of the chemical-potential table.
    """

    num_sites: int
    rank_sites: torch.Tensor  # [R] int64 supercell site of each rank
    nbr: torch.Tensor  # [R, L, K] int32 neighbour rank, -1 = contributes 0
    stride: torch.Tensor  # [R, L, K] int32 (0 wherever nbr is -1)
    d2: torch.Tensor  # [R, L] int32 summed stride of the rank's own slots
    g: torch.Tensor  # [R, L, TM] f64 coefficient-folded energy tables
    mu: torch.Tensor  # [R, C] f64 chemical potentials (zeros: canonical)
    ncode: torch.Tensor  # [R] int32 codes of each rank
    cum_probs: np.ndarray  # [S] f64 sublattice pick cdf
    sub_offset: np.ndarray  # [S] int64 first rank of each active sublattice
    n_active: np.ndarray  # [S] int64 active sites of each sublattice
    ew_v: torch.Tensor | None = None  # [R, R] f64 Ewald fold, V[u, u] = 0
    ew_c: torch.Tensor | None = None  # [R] f64 Ewald fold constants

    @property
    def num_ranks(self) -> int:
        return int(self.nbr.shape[0])

    @property
    def device(self) -> torch.device:
        return self.g.device

    @property
    def has_ewald(self) -> bool:
        return self.ew_v is not None


def _split_processor(processor):
    """(expansion part, Ewald part or None) of a processor (ref :854-866)."""
    if not isinstance(processor, CompositeProcessor):
        return processor, None
    parts = processor.processors
    ce = [p for p in parts if isinstance(p, ClusterExpansionProcessor)]
    ew = [p for p in parts if isinstance(p, EwaldProcessor)]
    if len(ce) != 1 or len(ew) > 1 or len(ce) + len(ew) != len(parts):
        raise NotImplementedError(
            "the chain takes one cluster expansion and at most one Ewald term"
        )
    return ce[0], (ew[0] if ew else None)


def fold_ewald(ewald_matrix, ewald_inds, coef, rank_sites, n_codes):
    """The reference's Ewald fold over binary ranks, in f64: (V [R, R], C [R]).

    Counterpart of ``pallas_chain.py:1043-1091``.  With code 0 and 1 of
    rank u on Ewald rows r0(u), r1(u) (none for a vacancy) and
    dm_u = M[r1(u)] - M[r0(u)], flipping u from 0 to 1 changes the Ewald
    energy by C_u + sum_t V[u, t] occ_t, where
    V[u, t] = 2 coef (dm_u[r1(t)] - dm_u[r0(t)]) for t != u, V[u, u] = 0,
    and C_u = coef (M[r1, r1] - M[r0, r0] + 2 sum over the fixed
    single-code sites' rows of dm_u + 2 sum_{t != u} dm_u[r0(t)]).
    """
    M = np.asarray(ewald_matrix, dtype=np.float64)
    inds = np.asarray(ewald_inds)
    n_ew = M.shape[0]
    Mp = np.zeros((n_ew + 1, n_ew + 1))  # row and column n_ew: no row, zeros
    Mp[:n_ew, :n_ew] = M

    def rows(sites, code):
        r = inds[sites, code] if code < inds.shape[1] else np.full(len(sites), -1)
        return np.where((r >= 0) & (r < n_ew), r, n_ew)

    fixed = rows(np.flatnonzero(n_codes == 1), 0)
    r0, r1 = rows(rank_sites, 0), rows(rank_sites, 1)
    dm = Mp[r1] - Mp[r0]  # [R, n_ew + 1]
    m0, m1 = dm[:, r0], dm[:, r1]  # [u, t] = dm_u[r(t)]
    off = ~np.eye(len(rank_sites), dtype=bool)
    V = np.where(off, 2.0 * (m1 - m0), 0.0)
    C = (Mp[r1, r1] - Mp[r0, r0]) + 2.0 * dm[:, fixed].sum(axis=1) \
        + 2.0 * np.where(off, m0, 0.0).sum(axis=1)
    return coef * V, coef * C


def build_chain_tables(processor, sublattices, mu_table=None,
                       sublattice_probabilities=None) -> ChainTables:
    """Chain tables of a processor's local clusters, on its device.

    The processor is a cluster expansion, or a composite of one and an
    Ewald term, whose fold the tables then carry.  Requirements, as in the
    reference: active sublattices with default (arange) encodings and no
    restricted sites, every non-self slot of a local cluster on an active
    site or on a single-code (code 0) site, and, with an Ewald term,
    binary active sites.  Raises ``NotImplementedError`` otherwise.
    """
    ce, ewald = _split_processor(processor)
    sites3 = ce.local_sites
    strides3 = ce.local_strides
    d2 = ce.local_d2
    g3 = ce.local_g
    n = sites3.shape[0]

    active = [s for s in sublattices if s.is_active]
    if not active:
        raise NotImplementedError("no active sublattice: nothing to flip")
    for s in active:
        if not np.array_equal(s.encoding, np.arange(len(s.encoding))):
            raise NotImplementedError("non-default sublattice encodings")
        if len(s.active_sites) != len(s.sites):
            raise NotImplementedError("sublattices with restricted sites")
    if ewald is not None and any(len(s.encoding) != 2 for s in active):
        raise NotImplementedError("the Ewald fold needs binary active sites")
    n_codes = np.ones(n, dtype=np.int64)
    for s in sublattices:
        n_codes[s.sites] = len(s.encoding)

    rank_sites = np.concatenate([np.asarray(s.active_sites) for s in active])
    R = len(rank_sites)
    rank_of_site = -np.ones(n, dtype=np.int64)
    rank_of_site[rank_sites] = np.arange(R)

    nb_sites = sites3[rank_sites]  # [R, L, K]
    st = strides3[rank_sites]
    is_self = nb_sites == rank_sites[:, None, None]
    nbr = rank_of_site[nb_sites]
    frozen = (st > 0) & ~is_self & (nbr < 0)
    if np.any(frozen & (n_codes[nb_sites] != 1)):
        raise NotImplementedError("a local cluster reaches a frozen multi-code site")
    contributes = (st > 0) & ~is_self & (nbr >= 0)
    nbr = np.where(contributes, nbr, -1)
    st = np.where(contributes, st, 0)

    mu = np.zeros((R, int(n_codes.max())), dtype=np.float64)
    if mu_table is not None:
        mu = np.asarray(mu_table, dtype=np.float64)[rank_sites]
    n_active = np.array([len(s.active_sites) for s in active], dtype=np.int64)
    ncode = np.concatenate(
        [np.full(k, len(s.encoding)) for k, s in zip(n_active, active)]
    )
    if sublattice_probabilities is None:
        probs = np.full(len(active), 1.0 / len(active))
    else:
        probs = np.asarray(sublattice_probabilities, dtype=np.float64)
        if len(probs) != len(active):
            raise ValueError("one sublattice probability per active sublattice")

    device = ce.device

    def dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    ew_v = ew_c = None
    if ewald is not None:
        V, C = fold_ewald(ewald.ewald_matrix, ewald.ewald_inds, ewald.coef,
                          rank_sites, n_codes)
        ew_v, ew_c = dev(V, torch.float64), dev(C, torch.float64)

    return ChainTables(
        num_sites=n,
        rank_sites=dev(rank_sites, torch.int64),
        nbr=dev(nbr, torch.int32),
        stride=dev(st, torch.int32),
        d2=dev(d2[rank_sites], torch.int32),
        g=dev(g3[rank_sites], torch.float64),
        mu=dev(mu, torch.float64),
        ncode=dev(ncode, torch.int32),
        cum_probs=np.cumsum(probs),
        sub_offset=np.concatenate([[0], np.cumsum(n_active)[:-1]]).astype(np.int64),
        n_active=n_active,
        ew_v=ew_v,
        ew_c=ew_c,
    )


def _sublattice_draw(tables, generator, shape):
    """(first rank, active sites) of a sublattice drawn by its probability.

    ``tables`` holds ``cum_probs``, ``n_active`` and ``sub_offset`` as host
    arrays (:class:`ChainTables`: each call copies them to the device) or as
    tensors on its device (the distance tables: no copy, no wait).
    """
    device = tables.device
    cum = torch.as_tensor(tables.cum_probs, device=device)
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float64)
    sl = (cum <= u[..., None]).sum(dim=-1).clamp(max=len(cum) - 1)
    n_act = torch.as_tensor(tables.n_active, device=device)[sl]
    off = torch.as_tensor(tables.sub_offset, device=device)[sl]
    return off, n_act


def _uniform_rank(off, n_act, generator):
    """A rank uniform within each drawn sublattice, int32."""
    v = torch.rand(off.shape, generator=generator, device=off.device,
                   dtype=torch.float64)
    return (off + torch.minimum((v * n_act).long(), n_act - 1)).to(torch.int32)


def rank_sequence(tables: ChainTables, generator, shape) -> torch.Tensor:
    """A state-independent proposal rank sequence of ``shape``, int32.

    The sublattice follows the sublattice probabilities and the site is
    uniform within it: the reference Flip usher's proposal distribution.
    Drawn on the tables' device from ``generator``.
    """
    off, n_act = _sublattice_draw(tables, generator, shape)
    return _uniform_rank(off, n_act, generator)


def rank_pair_sequence(tables, generator, shape):
    """State-independent swap pairs ``(u, v)`` of ``shape``, int32 each.

    The sublattice follows the sublattice probabilities; u and v are iid
    uniform within it (the reference's ``rank_pair_sequence`` :1161).
    Pairs with u == v, or with equal codes at run time, are identity
    proposals: the proposal is state-independent and symmetric, so each
    walker stays an exact canonical Metropolis chain.  ``tables`` is a
    :class:`ChainTables` or a :class:`~smol_tpu_torch.ops.sqs.DistanceTables`.
    """
    off, n_act = _sublattice_draw(tables, generator, shape)
    return _uniform_rank(off, n_act, generator), _uniform_rank(off, n_act, generator)


def sweep_schedule(num_ranks: int, n_steps: int) -> np.ndarray:
    """The deterministic sweep: one fixed permutation of the ranks, repeated."""
    perm = np.random.default_rng(SWEEP_SEED).permutation(num_ranks)
    return np.resize(perm, n_steps).astype(np.int32)


@dataclass(frozen=True)
class TableMove:
    """Static description of the chain's table (composition) moves.

    Row layout of the per-direction tables, as the reference's: rows
    ``0 .. n_dirs - 1`` are the flip directions (each flip vector, then its
    negation), row ``n_dirs`` is the canonical swap, row ``n_dirs + 1`` is
    the null move (taken when a drawn proposal collides with itself).  A
    direction expands into at most ``k_max`` site recolorings (slots).

    Sentinels: ``from_code == -1`` means no from-code check (an unused
    slot, or the swap), ``to_code == -2`` "take the partner slot's code"
    (the swap), ``slot_sub == -1`` "the sublattice drawn from the
    sublattice probabilities" (the swap).

    The host arrays equal the reference's; ``dev`` holds what the chain
    reads on the tables' device: ``rows`` [3, n_dirs + 2, k_max] int32
    (from_code, to_code, slot_valid), ``slot_sub`` and ``slot_valid``
    [n_dirs + 2, k_max] int64, the direction cdf ``dir_cum`` [n_dirs] f64,
    and the sublattices' pick cdf ``sub_cum`` [S] f64, first ranks
    ``sub_offset`` [S] and sizes ``n_active`` [S] int64.
    """

    n_dirs: int  # 2F flip directions (the rows beyond: swap, null)
    k_max: int
    swap_weight: float
    from_code: np.ndarray  # [n_dirs + 2, k_max] int32
    to_code: np.ndarray  # [n_dirs + 2, k_max] int32
    slot_valid: np.ndarray  # [n_dirs + 2, k_max] int32
    slot_sub: np.ndarray  # [n_dirs + 2, k_max] int32
    dir_cum_probs: np.ndarray  # [n_dirs] f64 cumulative direction weights
    dev: dict  # name -> tensor on the tables' device


def make_table_move(tables, n_dirs, k_max, swap_weight, from_code, to_code,
                    slot_valid, slot_sub, dir_cum_probs) -> TableMove:
    """A :class:`TableMove` of these host arrays, with its device copies."""
    device = tables.device

    def dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    return TableMove(
        n_dirs=n_dirs, k_max=k_max, swap_weight=swap_weight,
        from_code=from_code, to_code=to_code, slot_valid=slot_valid,
        slot_sub=slot_sub, dir_cum_probs=dir_cum_probs,
        dev={
            "rows": dev(np.stack([from_code, to_code, slot_valid]), torch.int32),
            "slot_sub": dev(slot_sub, torch.int64),
            "slot_valid": dev(slot_valid, torch.int64),
            "dir_cum": dev(dir_cum_probs, torch.float64),
            "sub_cum": dev(tables.cum_probs, torch.float64),
            "sub_offset": dev(tables.sub_offset, torch.int64),
            "n_active": dev(tables.n_active, torch.int64),
        },
    )


def build_table_move(tables: ChainTables, usher) -> TableMove:
    """Expand a TableFlip usher's flip table into the chain's TableMove.

    Counterpart of ``pallas_chain.py:1233-1325``, with the same arrays.
    Where the chain cannot honour the usher exactly (direction-asymmetric
    flip weights, which break the proposal's symmetry; a flip vector that
    touches an inactive sublattice or changes a sublattice's site count; a
    direction of more than ``MAX_TABLE_SLOTS`` recolorings) the reference
    falls back to its per-step path; the port has none yet and raises
    ``NotImplementedError``.
    """

    def refuse(why):
        return NotImplementedError(
            f"the table chain cannot take this usher ({why}), and the "
            "per-step path is not ported yet (ROADMAP.md Queue 1 item 8)"
        )

    flip_table = np.asarray(usher.flip_table, dtype=np.int64)  # [F, D]
    if flip_table.size == 0:
        raise refuse("its flip table is empty")
    weights = np.asarray(usher.flip_weights, dtype=np.float64)  # [2F]
    pairs = weights.reshape(-1, 2)
    if not np.allclose(pairs[:, 0], pairs[:, 1]):
        raise refuse("direction-asymmetric flip weights")
    if weights.sum() <= 0:
        raise refuse("its flip weights sum to zero")

    # each dimension -> (active sublattice index, code); the active
    # sublattices in the order of the tables' rank layout
    active_index, n_active = {}, 0
    for si, sl in enumerate(usher.sublattices):
        if sl.is_active:
            active_index[si] = n_active
            n_active += 1
    dim_sub = -np.ones(usher.d, dtype=np.int64)
    dim_code = np.zeros(usher.d, dtype=np.int64)
    for si, dim_ids in enumerate(usher.dim_ids):
        for code, dim in enumerate(dim_ids):
            dim_sub[dim] = active_index.get(si, -1)
            dim_code[dim] = code  # encodings are arange (the tables check)

    directions = np.concatenate([(u, -u) for u in flip_table], axis=0)  # [2F, D]
    slots = []  # per direction: (active sublattice, from code, to code) each
    for u in directions:
        if np.any((u != 0) & (dim_sub < 0)):
            raise refuse("a flip vector touches an inactive sublattice")
        dir_slots = []
        for sub in range(n_active):
            removed, added = [], []
            for dim in np.flatnonzero((u != 0) & (dim_sub == sub)):
                target = removed if u[dim] < 0 else added
                target.extend([int(dim_code[dim])] * int(abs(u[dim])))
            if len(removed) != len(added):
                raise refuse("a flip vector changes a sublattice's site count")
            dir_slots.extend((sub, fc, tc) for fc, tc in zip(removed, added))
        if not dir_slots:
            raise refuse("a flip vector changes nothing")
        slots.append(dir_slots)

    n_dirs = len(directions)
    k_max = max(2, max(len(dir_slots) for dir_slots in slots))
    if k_max > MAX_TABLE_SLOTS:
        raise refuse(f"a direction of {k_max} > {MAX_TABLE_SLOTS} recolorings")

    rows = n_dirs + 2  # + the swap row and the null row
    from_code = -np.ones((rows, k_max), dtype=np.int32)
    to_code = -np.ones((rows, k_max), dtype=np.int32)
    slot_valid = np.zeros((rows, k_max), dtype=np.int32)
    slot_sub = np.zeros((rows, k_max), dtype=np.int32)
    for di, dir_slots in enumerate(slots):
        for j, (sub, fc, tc) in enumerate(dir_slots):
            from_code[di, j] = fc
            to_code[di, j] = tc
            slot_valid[di, j] = 1
            slot_sub[di, j] = sub
    # the swap row: slots 0 and 1 exchange their codes within one sublattice
    to_code[n_dirs, :2] = -2
    slot_valid[n_dirs, :2] = 1
    slot_sub[n_dirs, :2] = -1

    return make_table_move(
        tables, n_dirs, k_max, float(usher.swap_weight), from_code, to_code,
        slot_valid, slot_sub, np.cumsum(weights / weights.sum()),
    )


def table_sequences(tables: ChainTables, tm: TableMove, generator, shape):
    """Exogenous ``(dirs, ranks)`` of table moves, int32, on the device.

    ``dirs`` has ``shape`` and ``ranks`` ``shape + (k_max,)``.  A direction
    follows the (direction-symmetric) flip weights with probability
    ``1 - swap_weight`` and is the swap row otherwise; each slot's rank is
    uniform over its sublattice's active ranks (the swap row's sublattice
    follows the sublattice probabilities).  A proposal whose valid slots
    collide (one rank twice, u == v of a swap included) is redirected to
    the null row (the reference's ``table_sequences`` :1328).
    """
    device = tables.device
    d = tm.dev

    def rand(size):
        return torch.rand(size, generator=generator, device=device,
                          dtype=torch.float64)

    dirs = (d["dir_cum"] <= rand(shape)[..., None]).sum(dim=-1).clamp(max=tm.n_dirs - 1)
    if tm.swap_weight > 0:
        dirs = torch.where(rand(shape) < tm.swap_weight,
                           torch.full_like(dirs, tm.n_dirs), dirs)
    swap_sub = (d["sub_cum"] <= rand(shape)[..., None]).sum(dim=-1)
    swap_sub = swap_sub.clamp(max=len(d["sub_cum"]) - 1)

    sub = d["slot_sub"][dirs]  # [*shape, k_max]
    valid = d["slot_valid"][dirs] > 0
    sub = torch.where(sub < 0, swap_sub[..., None], sub)
    n_act = d["n_active"][sub]
    ranks = d["sub_offset"][sub] + torch.minimum(
        (rand(tuple(shape) + (tm.k_max,)) * n_act).long(), n_act - 1
    )
    collide = torch.zeros(shape, dtype=torch.bool, device=device)
    for j in range(tm.k_max):
        for k in range(j + 1, tm.k_max):
            collide |= valid[..., j] & valid[..., k] & (ranks[..., j] == ranks[..., k])
    dirs = torch.where(collide, torch.full_like(dirs, tm.n_dirs + 1), dirs)
    return dirs.to(torch.int32), ranks.to(torch.int32)


def _wrap_int32(x):
    return ((x + 2**31) % 2**32) - 2**31


def chain_draws(rng: str, seed: int, n_steps: int, num_walkers: int,
                block_size: int, device):
    """Random bits of one chain launch: (r_u, r_j), int64 [n_steps, W].

    ``r_u`` feeds the acceptance uniform and ``r_j`` the proposed code (a
    swap draws only ``r_u``); both are 31-bit.  ``"hash"`` reproduces the
    reference's interpret-mode hash (lane = w % block_size, block seed =
    seed + block * 7919); ``"philox"`` is Philox4x32-10 with key (seed low
    word, walker) and counter (step, seed high word, 0, 0).  The CUDA
    kernels draw the same.
    """
    walkers = torch.arange(num_walkers, device=device, dtype=torch.int64)
    steps = torch.arange(n_steps, device=device, dtype=torch.int64)[:, None]
    if rng == "hash":
        block_seed = _wrap_int32(seed + (walkers // block_size) * BLOCK_SEED_STRIDE)
        lanes = walkers % block_size
        return (
            hash_bits(block_seed, steps, 1, lanes),
            hash_bits(block_seed, steps, 0, lanes),
        )
    if rng != "philox":
        raise ValueError(f"unknown rng mode: {rng!r}")
    shape = (n_steps, num_walkers)
    zero = torch.zeros(shape, device=device, dtype=torch.int64)
    counter = torch.stack(
        [steps.expand(shape), zero + ((seed >> 32) & 0xFFFFFFFF), zero, zero], dim=-1
    )
    key = torch.stack([zero + (seed & 0xFFFFFFFF), walkers.expand(shape)], dim=-1)
    bits = philox4x32_10(counter, key)
    return bits[..., 0] & 0x7FFFFFFF, bits[..., 1] & 0x7FFFFFFF


def _ce_terms(tables: ChainTables, occ, u, a, b):
    """[W, L] f64 energy change of each local cluster of rank u[w], a -> b."""
    walkers = torch.arange(occ.shape[1], device=occ.device)
    nb = tables.nbr[u].long()  # [W, L, K]
    codes = occ[nb.clamp(min=0), walkers[:, None, None]].long()
    d2 = tables.d2[u].long()  # [W, L]
    t = d2 * a[:, None] + (tables.stride[u].long() * codes).sum(dim=-1)
    tn = t + d2 * (b - a)[:, None]
    g_u = tables.g[u]  # [W, L, TM]
    return g_u.gather(2, tn[..., None])[..., 0] - g_u.gather(2, t[..., None])[..., 0]


def _ewald_term(tables: ChainTables, occ, u, sign):
    """[W] f64 Ewald change sign * (C_u + V_u . occ) of rank u[w].

    The dot sums in rank order, t = 0 .. R-1, as the kernels' loop does;
    codes are 0/1, so each product is exact and both give the same sum.
    """
    prod = tables.ew_v[u] * occ.T.to(torch.float64)  # [W, R]
    acc = torch.zeros(occ.shape[1], dtype=torch.float64, device=occ.device)
    for t in range(prod.shape[1]):
        acc = acc + prod[:, t]
    return sign.to(torch.float64) * (tables.ew_c[u] + acc)


def _accumulate(*columns):
    """0.0 plus each [W] column in turn: the kernels' summation order."""
    total = torch.zeros_like(columns[0])
    for col in columns:
        total = total + col
    return total


def _metropolis(dE, r_u, beta32):
    """(accept, expo, log_u): the f32 Metropolis decision on f64 ``dE``."""
    log_u = torch.log(uniform01_from_bits(r_u))
    expo = -beta32 * dE.to(torch.float32)
    return (expo >= 0) | (expo > log_u), expo, log_u


def _lower_margin(margin, expo, log_u, beta32, slack, decided):
    """margin = min(margin, distance of this decision beyond beta * slack).

    The distance is counted in f32 ulps of log U; walkers whose decision
    is ``decided`` regardless (null swaps) keep their margin.
    """
    ulp = (torch.nextafter(log_u, log_u.new_tensor(-float("inf"))) - log_u).abs()
    gap = ((expo - log_u).abs() - beta32 * slack).clamp(min=0) / ulp
    gap = torch.where(decided, torch.full_like(gap, float("inf")), gap)
    torch.minimum(margin, gap, out=margin)


def flip_step_reference(tables: ChainTables, occ, u, r_u, r_j, beta32):
    """One flip proposal for every walker, without applying it.

    ``occ`` [R, W] int8 codes, ``u`` [W] proposal ranks, ``r_u``/``r_j``
    [W] random bits, ``beta32`` [W] f32.  Returns ``(accept, b, dE, expo,
    log_u)``: the decision, the proposed codes, the f64 enthalpy change and
    the f32 exponent and log uniform it was decided on.  dE sums the
    clusters' terms in order l = 0 .. L-1, then the Ewald term, then the
    chemical work, as the kernel does.
    """
    walkers = torch.arange(occ.shape[1], device=occ.device)
    u = u.long()
    a = occ[u, walkers].long()
    nc = torch.clamp(tables.ncode[u].long() - 1, min=1)
    j = r_j % nc
    b = j + (j >= a).long()

    terms = _ce_terms(tables, occ, u, a, b)
    columns = list(terms.unbind(1))
    if tables.has_ewald:
        columns.append(_ewald_term(tables, occ, u, b - a))
    dE = _accumulate(*columns) - (tables.mu[u, b] - tables.mu[u, a])
    accept, expo, log_u = _metropolis(dE, r_u, beta32)
    return accept, b, dE, expo, log_u


def swap_step_reference(tables: ChainTables, occ, u, v, r_u, beta32):
    """One swap proposal for every walker, without applying it.

    ``occ`` [R, W] int8 codes (left as it was), ``u``/``v`` [W] ranks,
    ``r_u`` [W] random bits, ``beta32`` [W] f32.  Returns ``(accept,
    is_move, a, b, dE, expo, log_u)``: u holds a and v holds b; on accept
    u takes b and v takes a.  dE sums u's cluster terms, then v's with u
    already holding b, then u's Ewald term, then v's (against the same
    occupancy), as the kernel does.  A null pair (a == b) is never
    accepted.
    """
    walkers = torch.arange(occ.shape[1], device=occ.device)
    u, v = u.long(), v.long()
    a = occ[u, walkers].long()
    b = occ[v, walkers].long()
    is_move = a != b

    columns = list(_ce_terms(tables, occ, u, a, b).unbind(1))
    if tables.has_ewald:
        ewald_u = _ewald_term(tables, occ, u, b - a)
    occ[u, walkers] = b.to(occ.dtype)  # v's delta sees u already holding b
    columns += list(_ce_terms(tables, occ, v, b, a).unbind(1))
    if tables.has_ewald:
        columns += [ewald_u, _ewald_term(tables, occ, v, a - b)]
    occ[u, walkers] = a.to(occ.dtype)
    dE = _accumulate(*columns)
    accept, expo, log_u = _metropolis(dE, r_u, beta32)
    return accept & is_move, is_move, a, b, dE, expo, log_u


def table_step_reference(tables: ChainTables, tm: TableMove, occ, d, ranks,
                         r_u, beta32):
    """One table-move proposal for every walker, without applying it.

    ``occ`` [R, W] int8 codes (left as it was), ``d`` [W] direction rows,
    ``ranks`` [W, k_max] slot ranks, ``r_u`` [W] random bits, ``beta32``
    [W] f32.  Returns ``(accept, valid, a0, b, dE, expo, log_u)``: ``a0``
    and ``b`` [W, k_max] are the slots' codes before the move and the
    codes they take (``b == a0`` on a slot that is not valid).  The move
    is valid if its row has a valid slot, every checked slot holds its
    from-code and, on the swap row, the two codes differ; all of these
    read the codes from before the move.  dE sums, for each valid slot in
    order and against the occupancy as the earlier slots left it, the
    slot's cluster terms in order l = 0 .. L-1, then its Ewald term, then
    minus its chemical work, as the kernel does (``table_step`` of the
    reference, :1701-1785).  An invalid move is never accepted.
    """
    walkers = torch.arange(occ.shape[1], device=occ.device)
    d, ranks = d.long(), ranks.long()
    from_code, to_code, slot_valid = (t[d].long() for t in tm.dev["rows"])  # [W, k_max]
    a0 = occ[ranks, walkers[:, None]].long()  # codes before the move
    slot_on = slot_valid > 0
    valid = slot_on[:, 0] & (~(slot_on & (from_code >= 0)) | (a0 == from_code)).all(dim=1)
    valid &= (to_code[:, 0] != -2) | (a0[:, 0] != a0[:, 1])

    partner_slot = list(range(tm.k_max))
    partner_slot[:2] = [1, 0]  # only the swap row's two slots take a partner
    partner = a0[:, partner_slot]
    b = torch.where(to_code >= 0, to_code, partner)
    b = torch.where(slot_on, b, a0)
    dE = torch.zeros(occ.shape[1], dtype=torch.float64, device=occ.device)
    for j in range(tm.k_max):
        on = slot_on[:, j]
        if not bool(on.any()):
            continue  # a slot no walker's row uses adds exactly zero
        u, a, bj = ranks[:, j], a0[:, j], b[:, j]
        # where the slot is off, a == bj and every term below is exactly 0
        for col in _ce_terms(tables, occ, u, a, bj).unbind(1):
            dE = dE + col
        if tables.has_ewald:
            dE = dE + _ewald_term(tables, occ, u, bj - a)
        dE = dE - (tables.mu[u, bj] - tables.mu[u, a])
        written = on & valid  # distinct sites are certain only among these
        occ[u[written], walkers[written]] = bj[written].to(occ.dtype)
    for j in range(tm.k_max):
        back = slot_on[:, j] & valid
        occ[ranks[back, j], walkers[back]] = a0[back, j].to(occ.dtype)
    accept, expo, log_u = _metropolis(dE, r_u, beta32)
    return accept & valid, valid, a0, b, dE, expo, log_u


def flip_chain_reference(occ, enthalpy, naccept, beta32, seq, seed, tables,
                         n_steps, block_size, rng="philox", margin=None):
    """Plain torch twin of the CUDA flip-chain kernel (same arguments).

    Updates ``occ``, ``enthalpy`` and ``naccept`` in place.  ``margin``, an
    optional [W] f32 tensor, is lowered in place to each walker's closest
    decision: the smallest |expo - log U| in f32 ulps of log U, which
    bounds where another implementation's last-bit rounding could decide
    otherwise.
    """
    W = occ.shape[1]
    walkers = torch.arange(W, device=occ.device)
    group = walkers // block_size
    r_u, r_j = chain_draws(rng, int(seed[0]), n_steps, W, block_size, occ.device)
    for i in range(n_steps):
        u = seq[group, i].long()
        accept, b, dE, expo, log_u = flip_step_reference(
            tables, occ, u, r_u[i], r_j[i], beta32
        )
        if margin is not None:
            _lower_margin(margin, expo, log_u, beta32, 0.0, torch.zeros_like(accept))
        occ[u, walkers] = torch.where(accept, b, occ[u, walkers].long()).to(occ.dtype)
        enthalpy += torch.where(accept, dE, torch.zeros_like(dE))
        naccept += accept.to(naccept.dtype)


def swap_chain_reference(occ, enthalpy, naccept, nmove, beta32, useq, vseq,
                         seed, tables, n_steps, block_size, rng="philox",
                         margin=None, slack=0.0):
    """Plain torch twin of the CUDA swap-chain kernel (same arguments).

    Updates ``occ``, ``enthalpy``, ``naccept`` and ``nmove`` (non-null
    proposals) in place.  ``margin`` as in :func:`flip_chain_reference`,
    with each distance taken beyond beta * ``slack`` (eV): where another
    implementation's delta may be off by up to ``slack``, its decision
    can differ only on walkers whose margin is a few ulps.  Null pairs
    never lower the margin.
    """
    W = occ.shape[1]
    walkers = torch.arange(W, device=occ.device)
    group = walkers // block_size
    r_u, _ = chain_draws(rng, int(seed[0]), n_steps, W, block_size, occ.device)
    for i in range(n_steps):
        u, v = useq[group, i].long(), vseq[group, i].long()
        accept, is_move, a, b, dE, expo, log_u = swap_step_reference(
            tables, occ, u, v, r_u[i], beta32
        )
        if margin is not None:
            _lower_margin(margin, expo, log_u, beta32, slack, ~is_move)
        occ[u, walkers] = torch.where(accept, b, a).to(occ.dtype)
        occ[v, walkers] = torch.where(accept, a, b).to(occ.dtype)
        enthalpy += torch.where(accept, dE, torch.zeros_like(dE))
        naccept += accept.to(naccept.dtype)
        nmove += is_move.to(nmove.dtype)


def table_chain_reference(occ, enthalpy, naccept, beta32, dirs, ranks, seed,
                          tables, table_move, n_steps, block_size,
                          rng="philox", margin=None, slack=0.0, nslot=None):
    """Plain torch twin of the CUDA table-chain kernel (same arguments).

    Updates ``occ``, ``enthalpy`` and ``naccept`` in place.  ``margin`` and
    ``slack`` as in :func:`swap_chain_reference`; invalid (identity)
    proposals never lower the margin.  ``nslot``, an optional [W] int32
    tensor, gains the site recolorings whose delta a walker had to
    compute: the valid slots of its valid proposals.
    """
    W = occ.shape[1]
    walkers = torch.arange(W, device=occ.device)
    group = walkers // block_size
    r_u, _ = chain_draws(rng, int(seed[0]), n_steps, W, block_size, occ.device)
    for i in range(n_steps):
        slot_ranks = ranks[group, i].long()  # [W, k_max]
        accept, valid, _, b, dE, expo, log_u = table_step_reference(
            tables, table_move, occ, dirs[group, i], slot_ranks, r_u[i], beta32
        )
        if margin is not None:
            _lower_margin(margin, expo, log_u, beta32, slack, ~valid)
        slot_on = table_move.dev["slot_valid"][dirs[group, i].long()] > 0  # [W, k_max]
        for j in range(table_move.k_max):
            # an accepted move recolors its valid slots (elsewhere b == a0,
            # and an unused slot's rank may repeat a valid slot's)
            on = accept & slot_on[:, j]
            occ[slot_ranks[on, j], walkers[on]] = b[on, j].to(occ.dtype)
        if nslot is not None:
            nslot += (slot_on.sum(dim=1) * valid).to(nslot.dtype)
        enthalpy += torch.where(accept, dE, torch.zeros_like(dE))
        naccept += accept.to(naccept.dtype)


def _check_operands(name, occ, enthalpy, counts, beta32, seqs, seed, tables,
                    n_steps, block_size, extra=()):
    """Raise ``ValueError`` on an operand the chain does not take.

    ``beta32`` is None for a chain without a temperature; ``extra`` holds
    further ``(tensor, dtype, shape)`` operands of the same device.
    """
    R, W = occ.shape
    expect = (
        (occ, torch.int8, (tables.num_ranks, W)),
        (enthalpy, torch.float64, (W,)),
        *((c, torch.int32, (W,)) for c in counts),
        *(() if beta32 is None else ((beta32, torch.float32, (W,)),)),
        (seed, torch.int64, (1,)),
        *extra,
    )
    for tensor, dtype, shape in expect:
        if tensor.dtype != dtype or tuple(tensor.shape) != shape:
            raise ValueError(
                f"{name} operand: expected {dtype} {shape}, got "
                f"{tensor.dtype} {tuple(tensor.shape)}"
            )
    groups = -(-W // block_size)
    for seq in seqs:
        if block_size < 1 or seq.dtype != torch.int32 or seq.dim() != 2 \
                or seq.shape[0] != groups or seq.shape[1] < n_steps \
                or seq.stride() != seqs[0].stride():
            raise ValueError(
                f"{name} sequence: expected int32 [{groups}, >={n_steps}] "
                f"(all of one layout), got {seq.dtype} {tuple(seq.shape)}"
            )
    operands = [t for t, _, _ in expect] + [*seqs, tables.g]
    if any(t.device != occ.device for t in operands):
        raise ValueError(f"{name} operands lie on different devices")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError(f"{name} operands must be contiguous")


def _launch_check(lib, name, rc):
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: " + lib.smol_cuda_error_string(rc).decode()
        )


def _ewald_pointers(tables):
    if not tables.has_ewald:
        return None, None
    return tables.ew_v.data_ptr(), tables.ew_c.data_ptr()


def flip_chain(occ, enthalpy, naccept, beta32, seq, seed, tables, n_steps,
               block_size, rng="philox"):
    """Run ``n_steps`` shared-proposal flips on every walker, in place.

    Args:
        occ: [R, W] int8 codes, rank-major; updated in place.
        enthalpy: [W] f64, updated in place.
        naccept: [W] int32, accepted moves added in place.
        beta32: [W] f32 inverse temperatures (the exponent is f32).
        seq: [G, >= n_steps] int32 proposal ranks, one row per block of
            ``block_size`` walkers (G = ceil(W / block_size)).
        seed: [1] int64 seed of this launch.
        tables: :class:`ChainTables` on the same device.
        rng: ``"philox"`` (run mode) or ``"hash"`` (reference parity).

    A CUDA tensor launches the kernel (``flip_chain.launches`` counts the
    launches); a CPU tensor runs :func:`flip_chain_reference`.
    """
    _check_operands("flip_chain", occ, enthalpy, (naccept,), beta32, (seq,),
                    seed, tables, n_steps, block_size)
    if occ.device.type == "cpu":
        flip_chain_reference(occ, enthalpy, naccept, beta32, seq, seed,
                             tables, n_steps, block_size, rng)
        return
    if occ.device.type != "cuda":
        raise ValueError(f"flip_chain runs on cuda or cpu, not {occ.device}")
    if rng not in RNG_MODES:
        raise ValueError(f"unknown rng mode: {rng!r}")
    lib = _build.load_chain("flip_chain")
    R, W = occ.shape
    L, K = tables.nbr.shape[1:]
    with torch.cuda.device(occ.device):
        stream = torch.cuda.current_stream(occ.device).cuda_stream
        rc = lib.smol_flip_chain(
            occ.data_ptr(), enthalpy.data_ptr(), naccept.data_ptr(),
            beta32.data_ptr(), seq.data_ptr(), seq.stride(0), seed.data_ptr(),
            tables.nbr.data_ptr(), tables.stride.data_ptr(),
            tables.d2.data_ptr(), tables.g.data_ptr(), tables.mu.data_ptr(),
            tables.ncode.data_ptr(), *_ewald_pointers(tables), R, L, K,
            tables.g.shape[2], tables.mu.shape[1], W, block_size, n_steps,
            RNG_MODES[rng], stream,
        )
    flip_chain.launches += 1
    _launch_check(lib, "flip_chain", rc)


flip_chain.launches = 0


def swap_chain(occ, enthalpy, naccept, nmove, beta32, useq, vseq, seed,
               tables, n_steps, block_size, rng="philox"):
    """Run ``n_steps`` shared-proposal swaps on every walker, in place.

    Arguments as :func:`flip_chain`, with the pair sequences ``useq`` and
    ``vseq`` ([G, >= n_steps] int32 each, one layout) in place of ``seq``
    and ``nmove`` [W] int32, to which the non-null proposals are added.
    A CUDA tensor launches the kernel (``swap_chain.launches`` counts the
    launches); a CPU tensor runs :func:`swap_chain_reference`.
    """
    _check_operands("swap_chain", occ, enthalpy, (naccept, nmove), beta32,
                    (useq, vseq), seed, tables, n_steps, block_size)
    if occ.device.type == "cpu":
        swap_chain_reference(occ, enthalpy, naccept, nmove, beta32, useq, vseq,
                             seed, tables, n_steps, block_size, rng)
        return
    if occ.device.type != "cuda":
        raise ValueError(f"swap_chain runs on cuda or cpu, not {occ.device}")
    if rng not in RNG_MODES:
        raise ValueError(f"unknown rng mode: {rng!r}")
    lib = _build.load_chain("swap_chain")
    R, W = occ.shape
    L, K = tables.nbr.shape[1:]
    with torch.cuda.device(occ.device):
        stream = torch.cuda.current_stream(occ.device).cuda_stream
        rc = lib.smol_swap_chain(
            occ.data_ptr(), enthalpy.data_ptr(), naccept.data_ptr(),
            nmove.data_ptr(), beta32.data_ptr(), useq.data_ptr(),
            vseq.data_ptr(), useq.stride(0), seed.data_ptr(),
            tables.nbr.data_ptr(), tables.stride.data_ptr(),
            tables.d2.data_ptr(), tables.g.data_ptr(), *_ewald_pointers(tables),
            R, L, K, tables.g.shape[2], W, block_size, n_steps, RNG_MODES[rng],
            stream,
        )
    swap_chain.launches += 1
    _launch_check(lib, "swap_chain", rc)


swap_chain.launches = 0


def _cuda_block_threads(W, block_size):
    """Threads of a CUDA block, as ``block_threads`` of chain_common.cuh."""
    if W <= block_size or block_size % 64 == 0:
        return 64
    return int(np.gcd(block_size, 64))


def _shared_bytes(tables, row_sets, W, block_size):
    """Dynamic shared memory of one launch, in bytes: ``row_sets`` sets of
    one rank's table rows (``rows_bytes`` of chain_common.cuh) and the
    block's codes."""
    L, K = tables.nbr.shape[1:]
    ewald_row = tables.num_ranks if tables.has_ewald else 0
    row_set = L * tables.g.shape[2] * 8 + ewald_row * 8 + L * (2 * K + 1) * 4
    row_set = -(-row_set // 16) * 16
    return row_sets * row_set + tables.num_ranks * _cuda_block_threads(W, block_size)


def table_chain_shared_bytes(tables, k_max, W, block_size):
    """Dynamic shared memory of one table-chain launch, in bytes: two
    buffers of ``k_max`` row sets and the block's codes."""
    return _shared_bytes(tables, 2 * k_max, W, block_size)


def table_chain(occ, enthalpy, naccept, beta32, dirs, ranks, seed, tables,
                table_move, n_steps, block_size, rng="philox"):
    """Run ``n_steps`` shared-proposal table moves on every walker, in place.

    Arguments as :func:`flip_chain`, with the direction rows ``dirs``
    [G, >= n_steps] int32 and the slot ranks ``ranks`` [G, >= n_steps,
    k_max] int32 in place of ``seq``, and the :class:`TableMove` of the
    same tables.  A CUDA tensor launches the kernel
    (``table_chain.launches`` counts the launches); a CPU tensor runs
    :func:`table_chain_reference`.
    """
    _check_operands("table_chain", occ, enthalpy, (naccept,), beta32, (dirs,),
                    seed, tables, n_steps, block_size)
    k_max = table_move.k_max
    if ranks.dtype != torch.int32 or tuple(ranks.shape) != (*dirs.shape, k_max) \
            or not ranks.is_contiguous() or ranks.device != occ.device:
        raise ValueError(
            f"table_chain ranks: expected contiguous int32 {(*dirs.shape, k_max)} "
            f"on {occ.device}, got {ranks.dtype} {tuple(ranks.shape)} on {ranks.device}"
        )
    rows = table_move.dev["rows"]
    if rows.device != occ.device or tuple(rows.shape[1:]) != (table_move.n_dirs + 2, k_max):
        raise ValueError("table_chain: the table move does not match its operands")
    if occ.device.type == "cpu":
        table_chain_reference(occ, enthalpy, naccept, beta32, dirs, ranks, seed,
                              tables, table_move, n_steps, block_size, rng)
        return
    if occ.device.type != "cuda":
        raise ValueError(f"table_chain runs on cuda or cpu, not {occ.device}")
    if rng not in RNG_MODES:
        raise ValueError(f"unknown rng mode: {rng!r}")
    R, W = occ.shape
    L, K = tables.nbr.shape[1:]
    smem = table_chain_shared_bytes(tables, k_max, W, block_size)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"table_chain needs {smem} bytes of shared memory per block (two "
            f"buffers of k_max = {k_max} row sets of L = {L}, K = {K}, TM = "
            f"{tables.g.shape[2]}, Ewald row {R if tables.has_ewald else 0}, and "
            f"{R} ranks of codes), above the card's {MAX_SHARED_BYTES}"
        )
    lib = _build.load_chain("table_chain")
    with torch.cuda.device(occ.device):
        stream = torch.cuda.current_stream(occ.device).cuda_stream
        rc = lib.smol_table_chain(
            occ.data_ptr(), enthalpy.data_ptr(), naccept.data_ptr(),
            beta32.data_ptr(), dirs.data_ptr(), ranks.data_ptr(),
            dirs.stride(0), ranks.stride(0), seed.data_ptr(),
            tables.nbr.data_ptr(), tables.stride.data_ptr(),
            tables.d2.data_ptr(), tables.g.data_ptr(), tables.mu.data_ptr(),
            rows.data_ptr(), *_ewald_pointers(tables), R, L, K,
            tables.g.shape[2], tables.mu.shape[1], W, block_size, n_steps,
            RNG_MODES[rng], k_max, table_move.n_dirs + 2, stream,
        )
    table_chain.launches += 1
    _launch_check(lib, "table_chain", rc)


table_chain.launches = 0


# ---------------- Wang-Landau ----------------

@dataclass(frozen=True)
class WLChain:
    """Static parameters of Wang-Landau sampling inside the chain.

    The reference's ``WLChain`` (``pallas_chain.py:1399``), field for
    field.  The thermal Metropolis acceptance gives way to the rule on the
    entropy difference S(bin of E) - S(bin of E'), and the chain keeps the
    per-walker bookkeeping.  Per step and walker, with E' = E + dE of the
    proposed flip or swap, w' = E' - ``min_enthalpy`` and b' =
    clip(floor(w' / ``bin_size``), 0, ``num_levels`` - 1): the proposal is
    rejected if w' lies outside [0, ``num_levels`` * ``bin_size``), else
    accepted if x = S[b_cur] - S[b'] >= 0 or x > log U (a null swap is
    never accepted).  After the decision, at the walker's current state:
    inside the window its counter gains one, and on every
    ``update_period``-th count S[b_cur] += mod_factor and the histogram and
    the occurrences at b_cur gain one.  Flatness is checked when ``(i + 1)
    % check_period == 0``, with i the step index within the launch, and at
    the launch's last step: over the bins with S > 0, if at least two are
    visited and min(histogram) > ``flatness`` * mean(histogram), the
    walker's histogram is zeroed and its mod_factor divided by
    ``mod_divisor``.

    Enthalpy, window coordinate, bin, entropy and mod_factor are f64; the
    exponent x is compared in f32, as the Metropolis chains' is, and the
    flatness test is taken in f32 on the exact integer sum and minimum, as
    the reference's.  The reference bins in f32 and keeps mod_factor in
    f32 and the entropy as a double-float pair, so its walkers can differ
    from this chain's where an enthalpy lies within a few f32 ulps of a
    bin edge; with ``mod_divisor = 2`` every entropy is a short dyadic sum
    that both representations hold exactly.
    """

    min_enthalpy: float
    bin_size: float
    num_levels: int
    flatness: float
    check_period: int
    update_period: int
    mod_divisor: float

    @property
    def span(self) -> float:
        """Width of the window: the enthalpies in [min, min + span) count."""
        return self.num_levels * self.bin_size


def _true_divide(x, divisor: float):
    """``x / divisor`` rounded as IEEE division, as the kernel divides.

    The divisor goes in as a tensor on ``x``'s device: torch's CUDA
    division by a host scalar multiplies by the reciprocal instead, which
    can differ in the last bit and put an enthalpy that lies on a bin edge
    into the other bin.
    """
    return x / torch.tensor(divisor, dtype=x.dtype, device=x.device)


def _wl_bin(w, wl: WLChain):
    """Clipped bin of window coordinates ``w`` [W] f64, int64."""
    return torch.floor(_true_divide(w, wl.bin_size)).clamp(0, wl.num_levels - 1).long()


def _lower_bin_margin(bin_margin, w, wl: WLChain, counts):
    """bin_margin = min(bin_margin, distance of w from a bin edge).

    The edges are k * bin_size for k = 0 .. num_levels (the window's ends
    included); the distance is counted in f32 ulps of w, so it bounds
    where an implementation that bins in f32 could bin otherwise.  Only
    walkers in ``counts`` lower their margin.
    """
    k = torch.floor(_true_divide(w, wl.bin_size))
    lo = k.clamp(0, wl.num_levels) * wl.bin_size
    hi = (k + 1).clamp(0, wl.num_levels) * wl.bin_size
    dist = torch.minimum((w - lo).abs(), (w - hi).abs())
    w32 = w.to(torch.float32)
    ulp = (torch.nextafter(w32, w32.new_tensor(float("inf"))) - w32).abs()
    gap = (dist / ulp.to(torch.float64)).to(bin_margin.dtype)
    gap = torch.where(counts, gap, torch.full_like(gap, float("inf")))
    torch.minimum(bin_margin, gap, out=bin_margin)


def wl_step_reference(tables: ChainTables, wl: WLChain, occ, ranks, r_u, r_j,
                      enthalpy, entropy, s_cur, move="flip"):
    """One Wang-Landau proposal for every walker, without applying it.

    ``occ`` [R, W] int8 codes (left as it was), ``ranks`` the proposal
    ranks ``(u,)`` of a flip or ``(u, v)`` of a swap, [W] each, ``r_u`` /
    ``r_j`` [W] random bits, ``enthalpy`` [W] f64, ``entropy`` [B, W] f64
    and ``s_cur`` [W] f64 the entropy of each walker's current bin.
    Returns ``(accept, is_move, a, b, dE, w_new, b_new, expo, log_u,
    in_win)``: u holds a and takes b (for a swap v holds b and takes a);
    dE is :func:`flip_step_reference`'s or :func:`swap_step_reference`'s;
    ``expo`` is the f32 exponent S[b_cur] - S[b_new] and ``log_u`` the f32
    log uniform it is compared with.
    """
    W = occ.shape[1]
    walkers = torch.arange(W, device=occ.device)
    no_beta = torch.zeros(W, dtype=torch.float32, device=occ.device)
    if move == "swap":
        _, is_move, a, b, dE, _, log_u = swap_step_reference(
            tables, occ, ranks[0], ranks[1], r_u, no_beta)
    else:
        _, b, dE, _, log_u = flip_step_reference(
            tables, occ, ranks[0], r_u, r_j, no_beta)
        a = occ[ranks[0].long(), walkers].long()
        is_move = torch.ones(W, dtype=torch.bool, device=occ.device)
    w_new = (enthalpy + dE) - wl.min_enthalpy
    b_new = _wl_bin(w_new, wl)
    in_win = (w_new >= 0) & (w_new < wl.span)
    expo = (s_cur - entropy[b_new, walkers]).to(torch.float32)
    accept = ((expo >= 0) | (expo > log_u)) & in_win & is_move
    return accept, is_move, a, b, dE, w_new, b_new, expo, log_u, in_win


def _wl_flatness(entropy, histogram, mod_factor, wl: WLChain):
    """The flatness check of every walker, in place (see :class:`WLChain`)."""
    visited = entropy > 0  # [B, W]
    nvis = visited.sum(dim=0)
    hsum = torch.where(visited, histogram, 0).sum(dim=0, dtype=torch.int64)
    big = torch.iinfo(torch.int32).max
    hmin = torch.where(visited, histogram, big).min(dim=0).values
    hmean = hsum.to(torch.float32) / nvis.clamp(min=1).to(torch.float32)
    flatness = torch.tensor(wl.flatness, dtype=torch.float32, device=entropy.device)
    flat = (nvis >= 2) & (hmin.to(torch.float32) > flatness * hmean)
    histogram[:, flat] = 0
    mod_factor[flat] = _true_divide(mod_factor[flat], wl.mod_divisor)


def wl_chain_reference(occ, enthalpy, naccept, entropy, histogram, occurrences,
                       mod_factor, wl_counter, seqs, seed, tables, wl, n_steps,
                       block_size, move="flip", rng="philox", margin=None,
                       bin_margin=None):
    """Plain torch twin of the CUDA Wang-Landau chain kernel (same arguments).

    Updates ``occ``, ``enthalpy``, ``naccept``, the planes ``entropy``,
    ``histogram``, ``occurrences`` [B, W], ``mod_factor`` and
    ``wl_counter`` in place.  ``margin``, an optional [W] f32 tensor, is
    lowered to each walker's closest decision, |x - log U| in f32 ulps of
    log U (proposals outside the window and null swaps, decided
    regardless, do not count).  ``bin_margin``, an optional [W] tensor, is
    lowered to the least distance from a bin edge, in f32 ulps of the
    window coordinate, of the walker's coordinate at the launch's start
    and of every non-null proposal's.
    """
    W = occ.shape[1]
    walkers = torch.arange(W, device=occ.device)
    group = walkers // block_size
    r_u, r_j = chain_draws(rng, int(seed[0]), n_steps, W, block_size, occ.device)
    w_cur = enthalpy - wl.min_enthalpy
    b_cur = _wl_bin(w_cur, wl)
    s_cur = entropy[b_cur, walkers]
    everyone = torch.ones(W, dtype=torch.bool, device=occ.device)
    if bin_margin is not None:
        _lower_bin_margin(bin_margin, w_cur, wl, everyone)
    no_beta = torch.zeros(W, dtype=torch.float32, device=occ.device)
    for i in range(n_steps):
        ranks = [s[group, i].long() for s in seqs]
        accept, is_move, a, b, dE, w_new, b_new, expo, log_u, in_win = wl_step_reference(
            tables, wl, occ, ranks, r_u[i], r_j[i], enthalpy, entropy, s_cur, move)
        if margin is not None:
            _lower_margin(margin, expo, log_u, no_beta, 0.0, ~(in_win & is_move))
        if bin_margin is not None:
            _lower_bin_margin(bin_margin, w_new, wl, is_move)
        u = ranks[0]
        occ[u, walkers] = torch.where(accept, b, a).to(occ.dtype)
        if move == "swap":
            occ[ranks[1], walkers] = torch.where(accept, a, b).to(occ.dtype)
        enthalpy += torch.where(accept, dE, torch.zeros_like(dE))
        naccept += accept.to(naccept.dtype)
        w_cur = torch.where(accept, w_new, w_cur)
        b_cur = torch.where(accept, b_new, b_cur)
        s_cur = torch.where(accept, entropy[b_new, walkers], s_cur)
        # the bookkeeping at the (possibly new) current state
        valid = (w_cur >= 0) & (w_cur < wl.span)
        wl_counter += valid.to(wl_counter.dtype)
        update = valid & (wl_counter % wl.update_period == 0)
        s_cur = torch.where(update, s_cur + mod_factor, s_cur)
        rows, cols = b_cur[update], walkers[update]
        entropy[rows, cols] = s_cur[update]
        histogram[rows, cols] += 1
        occurrences[rows, cols] += 1
        if (i + 1) % wl.check_period == 0 or i + 1 == n_steps:
            _wl_flatness(entropy, histogram, mod_factor, wl)


def _wl_operands(wl, W, entropy, histogram, occurrences, mod_factor, wl_counter):
    planes = (wl.num_levels, W)
    return (
        (entropy, torch.float64, planes),
        (histogram, torch.int32, planes),
        (occurrences, torch.int32, planes),
        (mod_factor, torch.float64, (W,)),
        (wl_counter, torch.int32, (W,)),
    )


def wl_chain_shared_bytes(tables, W, block_size, move):
    """Dynamic shared memory of one Wang-Landau launch, in bytes: two
    buffers of the step's row sets (two for a swap) and the block's codes."""
    return _shared_bytes(tables, 4 if move == "swap" else 2, W, block_size)


def wl_chain(occ, enthalpy, naccept, entropy, histogram, occurrences,
             mod_factor, wl_counter, seqs, seed, tables, wl, n_steps,
             block_size, move="flip", rng="philox"):
    """Run ``n_steps`` shared-proposal Wang-Landau steps on every walker.

    Args:
        occ, enthalpy, naccept, seed, tables, block_size, rng: as
            :func:`flip_chain`; all updated in place.
        entropy: [B, W] f64, bin-major (B = ``wl.num_levels``).
        histogram, occurrences: [B, W] int32.
        mod_factor: [W] f64.
        wl_counter: [W] int32, the walker's steps inside the window.
        seqs: ``(seq,)`` for ``move="flip"``, ``(useq, vseq)`` for
            ``move="swap"``: [G, >= n_steps] int32 each, one layout.
        wl: the :class:`WLChain`; its flatness check counts the steps of
            this launch (a launch is one chunk).

    A CUDA tensor launches the kernel (``wl_chain.launches`` counts the
    launches); a CPU tensor runs :func:`wl_chain_reference`.
    """
    if move not in ("flip", "swap"):
        raise ValueError("the Wang-Landau chain supports flip/swap moves only")
    seqs = tuple(seqs)
    if len(seqs) != (2 if move == "swap" else 1):
        raise ValueError(f"wl_chain: move={move!r} takes {2 if move == 'swap' else 1} "
                         f"sequence(s), got {len(seqs)}")
    if wl.num_levels < 1 or wl.check_period < 1 or wl.update_period < 1:
        raise ValueError("wl_chain: num_levels, check_period and update_period "
                         "must be positive")
    W = occ.shape[1]
    _check_operands(
        "wl_chain", occ, enthalpy, (naccept,), None, seqs, seed, tables, n_steps,
        block_size,
        extra=_wl_operands(wl, W, entropy, histogram, occurrences, mod_factor,
                           wl_counter),
    )
    if occ.device.type == "cpu":
        wl_chain_reference(occ, enthalpy, naccept, entropy, histogram, occurrences,
                           mod_factor, wl_counter, seqs, seed, tables, wl, n_steps,
                           block_size, move, rng)
        return
    if occ.device.type != "cuda":
        raise ValueError(f"wl_chain runs on cuda or cpu, not {occ.device}")
    if rng not in RNG_MODES:
        raise ValueError(f"unknown rng mode: {rng!r}")
    R = occ.shape[0]
    L, K = tables.nbr.shape[1:]
    smem = wl_chain_shared_bytes(tables, W, block_size, move)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"wl_chain needs {smem} bytes of shared memory per block, above "
            f"the card's {MAX_SHARED_BYTES}"
        )
    lib = _build.load_chain("wl_chain")
    vseq = seqs[1] if move == "swap" else seqs[0]
    with torch.cuda.device(occ.device):
        stream = torch.cuda.current_stream(occ.device).cuda_stream
        rc = lib.smol_wl_chain(
            occ.data_ptr(), enthalpy.data_ptr(), naccept.data_ptr(),
            entropy.data_ptr(), histogram.data_ptr(), occurrences.data_ptr(),
            mod_factor.data_ptr(), wl_counter.data_ptr(), seqs[0].data_ptr(),
            vseq.data_ptr(), seqs[0].stride(0), seed.data_ptr(),
            tables.nbr.data_ptr(), tables.stride.data_ptr(),
            tables.d2.data_ptr(), tables.g.data_ptr(), tables.mu.data_ptr(),
            tables.ncode.data_ptr(), *_ewald_pointers(tables), R, L, K,
            tables.g.shape[2], tables.mu.shape[1], W, block_size, n_steps,
            RNG_MODES[rng], MOVES.index(move), wl.num_levels, wl.check_period,
            wl.update_period, wl.min_enthalpy, wl.bin_size, wl.span,
            wl.mod_divisor, wl.flatness, stream,
        )
    wl_chain.launches += 1
    _launch_check(lib, "wl_chain", rc)


wl_chain.launches = 0


def wl_launch_operands(tables: ChainTables, wl: WLChain, move, occu, enthalpy,
                       n_steps, block_size, generator, n_chunks=None) -> dict:
    """Keyword operands of :func:`wl_chain` (and of its twin) for walkers
    that have not sampled yet: ``occu`` [W, N] and their ``enthalpy`` [W]
    f64, planes of zeros, ``mod_factor`` 1, and proposal sequences drawn
    from ``generator`` ([G, n_steps], or [n_chunks, G, n_steps] for a run
    in chunks).  The launch seed is the caller's to add.
    """
    W, device = occu.shape[0], occu.device
    shape = (-(-W // block_size), n_steps)
    if n_chunks is not None:
        shape = (n_chunks, *shape)
    if move == "swap":
        seqs = list(rank_pair_sequence(tables, generator, shape))
    else:
        seqs = [rank_sequence(tables, generator, shape)]

    def plane(dtype):
        return torch.zeros((wl.num_levels, W), dtype=dtype, device=device)

    return dict(
        occ=occu[:, tables.rank_sites].T.to(torch.int8).contiguous(),
        enthalpy=enthalpy,
        naccept=torch.zeros(W, dtype=torch.int32, device=device),
        entropy=plane(torch.float64), histogram=plane(torch.int32),
        occurrences=plane(torch.int32),
        mod_factor=torch.ones(W, dtype=torch.float64, device=device),
        wl_counter=torch.zeros(W, dtype=torch.int32, device=device),
        seqs=seqs, tables=tables, wl=wl, n_steps=n_steps, block_size=block_size,
        move=move,
    )


def make_shared_proposal_chain(tables: ChainTables, n_steps: int,
                               block_size: int = 1024,
                               proposal_mode: str = "random",
                               rng: str = "philox", seqs=None, seeds=None,
                               move: str = "flip", table_move=None,
                               wl: WLChain | None = None):
    """Build ``fn(state, generator) -> state`` running ``n_steps`` moves.

    ``move`` is ``"flip"`` (single-site, semigrand), ``"swap"`` (two
    sites of one sublattice exchange codes, canonical) or ``"table"``
    (constrained composition moves of ``table_move``, a
    :class:`TableMove`).  ``state`` holds
    ``occupancy`` [W, N] int32, ``enthalpy`` [W] f64, ``beta`` [W] f64,
    ``naccept`` [W] int32 and ``accepted`` [W] bool, and optionally
    ``window_naccept`` [W] int32 and, for swaps, ``nmove`` [W] int32 (the
    non-null proposals); ``fn`` updates these tensors in place and returns
    the state.  ``generator`` is a ``torch.Generator`` on the state's
    device for the site sequence and the launch seeds.

    ``rng="hash"`` reproduces the reference interpret-mode chain: the
    steps run in chunks of at most 2048 (``2048 // k_max`` for table
    moves) with the step counted within the chunk and chunk seeds
    ``seed0 + c * 999983``.  ``seqs`` [n_chunks, G, chunk] (for swaps a
    pair ``(u_seqs, v_seqs)`` of them, for table moves ``(dirs, ranks)``
    with ranks [n_chunks, G, chunk, k_max]) and ``seeds`` [n_chunks]
    replace the draws (the tests pass the reference's own draws); in
    ``"philox"`` mode a window is one chunk.  ``proposal_mode="sweep"`` is
    defined for flips only.

    ``wl`` switches flips or swaps to Wang-Landau sampling
    (:class:`WLChain`).  The state then carries ``entropy`` [W, B] f64,
    ``histogram`` and ``occurrences`` [W, B] int32, ``mod_factor`` [W] f64
    and ``wl_counter`` [W] int32, all updated in place, and needs no
    ``beta``.  The chain works on bin-major [B, W] copies of the planes,
    transposed once per call of ``fn``, not per step; the flatness check
    counts its steps within each chunk.
    """
    if move not in MOVES:
        raise ValueError(f"unknown move type: {move!r}")
    if (move == "table") != (table_move is not None):
        raise ValueError('move="table" goes with a table_move, and no other move')
    if proposal_mode not in ("random", "sweep"):
        raise ValueError(f"unknown proposal mode: {proposal_mode!r}")
    if proposal_mode == "sweep" and move != "flip":
        raise ValueError('proposal_mode="sweep" supports move="flip" only')
    if rng not in RNG_MODES:
        raise ValueError(f"unknown rng mode: {rng!r}")
    if wl is not None and move == "table":
        raise ValueError("the Wang-Landau chain supports flip/swap moves only")
    swap, table = move == "swap", move == "table"
    max_chunk = MAX_CHUNK_STEPS // table_move.k_max if table else MAX_CHUNK_STEPS
    chunk = min(n_steps, max_chunk) if rng == "hash" else n_steps
    n_chunks = -(-n_steps // chunk)
    rank_sites = tables.rank_sites

    def as_seq(x, device):
        return torch.as_tensor(np.asarray(x), dtype=torch.int32, device=device)

    def fn(state, generator):
        occu = state["occupancy"]
        W = occu.shape[0]
        device = occu.device
        groups = -(-W // block_size)
        shape = (n_chunks, groups, chunk)
        if seqs is not None:
            pair = swap or table
            seq = [as_seq(s, device) for s in seqs] if pair else [as_seq(seqs, device)]
        elif table:
            seq = list(table_sequences(tables, table_move, generator, shape))
        elif swap:
            seq = list(rank_pair_sequence(tables, generator, shape))
        elif proposal_mode == "sweep":
            sched = sweep_schedule(tables.num_ranks, n_chunks * chunk)
            sched = torch.as_tensor(sched, device=device).reshape(n_chunks, 1, chunk)
            seq = [sched.expand(shape)]
        else:
            seq = [rank_sequence(tables, generator, shape)]
        if seeds is not None:
            seed = torch.as_tensor(np.asarray(seeds), dtype=torch.int64, device=device)
        elif rng == "hash":
            seed0 = torch.randint(0, 2**30 - 1, (1,), generator=generator,
                                  device=device, dtype=torch.int64)
            seed = _wrap_int32(
                seed0 + torch.arange(n_chunks, device=device) * SEED_STRIDE
            )
        else:
            seed = torch.randint(0, 2**63 - 1, (n_chunks,), generator=generator,
                                 device=device, dtype=torch.int64)

        occ = occu[:, rank_sites].T.to(torch.int8).contiguous()  # [R, W]
        nacc = torch.zeros(W, dtype=torch.int32, device=device)
        nmv = torch.zeros(W, dtype=torch.int32, device=device)
        if wl is not None:
            plane_names = ("entropy", "histogram", "occurrences")
            planes = [state[name].T.contiguous() for name in plane_names]  # [B, W]
        else:
            beta32 = state["beta"].to(torch.float32)
        for c in range(n_chunks):
            steps = min(chunk, n_steps - c * chunk)
            seed_c = seed[c: c + 1].contiguous()
            seq_c = [s[c].contiguous() for s in seq]
            if wl is not None:
                wl_chain(occ, state["enthalpy"], nacc, *planes,
                         state["mod_factor"], state["wl_counter"], seq_c, seed_c,
                         tables, wl, steps, block_size, move, rng)
            elif table:
                table_chain(occ, state["enthalpy"], nacc, beta32, *seq_c,
                            seed_c, tables, table_move, steps, block_size, rng)
            elif swap:
                swap_chain(occ, state["enthalpy"], nacc, nmv, beta32, *seq_c,
                           seed_c, tables, steps, block_size, rng)
            else:
                flip_chain(occ, state["enthalpy"], nacc, beta32, *seq_c,
                           seed_c, tables, steps, block_size, rng)
        occu[:, rank_sites] = occ.T.to(occu.dtype)
        if wl is not None:
            for name, plane in zip(plane_names, planes):
                state[name].copy_(plane.T)
        state["naccept"] += nacc
        state["accepted"] = nacc > 0  # coarse: any accept in the window
        if "window_naccept" in state:
            state["window_naccept"] += nacc
        if swap and wl is None and "nmove" in state:
            state["nmove"] += nmv
        return state

    return fn
