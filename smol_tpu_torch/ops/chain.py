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
L segments, dense membership matrices for the MXU) is kept.  With an Ewald term the tables carry
the reference's fold in f64 (no hi/lo split): the Ewald change of rank u
going from code a to b is (b - a) * (C_u + V_u . occ).

Every chain (flips, swaps, table moves, Wang-Landau) takes one of three
bodies for the cluster-expansion delta of a site, as the reference's one
kernel serves all its moves with the body it picks (:1635-1649).  ``direct`` looks up each local cluster's
coefficient-folded tensor: g[l, t_new] - g[l, t_old].  ``ising`` (the
samplers' default where the system's tables take it: :func:`default_delta`)
is K1-Ising, the reference's parity delta (``make_site_delta_ising`` :374,
``make_swap_pair_delta_ising`` :410, tables ``_ising_tables`` :781): on
binary sites with a sign-symmetric basis every local tensor is A (-1)^t,
t the number of members holding code 1, so recoloring the self site
a -> b changes the cluster by -2 (b - a) A (-1)^{t_nbr}; its rows
(:func:`ising_tables`) are each a neighbour mask of rank bits and one
amplitude, and the kernels hold the walker's codes as rank bits in
registers.  ``qary`` is K3, the
reference's Z_q character delta (``make_site_delta_qary`` :519,
``make_swap_pair_delta_qary`` :570, tables ``_qary_tables`` :651): every
local cluster's tensor is a real Fourier series over Z_q characters, and
recoloring the self site a -> b moves each character's phase
u + m_self a to u + m_self b, where u = sum_j f_j code(nbr_j) is the
neighbour phase; its rows (:func:`qary_tables`) are stored sparse, the
neighbour ranks and their scaled frequencies, not as the reference's dense
frequency matrix for the MXU.  Each body carries the Ewald fold beside it.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from math import gcd, lcm

import numpy as np
import torch

from smol_tpu_torch.moca.processor.composite import CompositeProcessor
from smol_tpu_torch.moca.processor.distance import DistanceProcessor
from smol_tpu_torch.moca.processor.ewald import EwaldProcessor
from smol_tpu_torch.moca.processor.expansion import ClusterExpansionProcessor
from smol_tpu_torch.ops import _build
from smol_tpu_torch.ops.rng import hash_bits, philox4x32_10, uniform01_from_bits

__all__ = [
    "ChainTables",
    "QaryTables",
    "qary_tables",
    "IsingTables",
    "ising_tables",
    "build_chain_tables",
    "chain_refusal",
    "table_move_refusal",
    "fold_ewald",
    "rank_sequence",
    "rank_pair_sequence",
    "sweep_schedule",
    "chain_draws",
    "flip_step_reference",
    "flip_chain_reference",
    "flip_chain",
    "LanePlan",
    "launch_lanes",
    "twin_order",
    "flip_lanes",
    "chain_shared_bytes",
    "launch_plan",
    "flip_launch_plan",
    "swap_step_reference",
    "swap_chain_reference",
    "swap_chain",
    "TableMove",
    "make_table_move",
    "build_table_move",
    "table_sequences",
    "table_step_reference",
    "table_chain_reference",
    "body_rows",
    "table_chain",
    "WLChain",
    "wl_step_reference",
    "wl_chain_reference",
    "WLPlan",
    "wl_lanes",
    "wl_block_walkers",
    "wl_chain_shared_bytes",
    "wl_launch_plan",
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
DELTAS = ("direct", "qary", "ising")  # the chains' site bodies
ISING_MAX_WORDS = 4  # 64-bit words of rank bits the Ising body holds (256 ranks)
ISING_TOLERANCE = 1e-11  # the reference's relative check of the sign pattern
QARY_MAX_ROWS = 2048  # the reference's limit on character rows per rank
# q -> the amplitude folds (fold_c, fold_s) of the reference's _qary_fold
# (:453): every difference of cos(2 pi w / q) is fold_c times an integer in
# {0, +-1, +-2}, likewise for sin, and the folded selectors below (its
# _phase_sel :476, cos and sin over the fold, for w = 0 .. q - 1) take
# those integers.
QARY_FOLD = {2: (1.0, 0.0), 3: (1.5, np.sqrt(3.0) / 2.0), 4: (1.0, 1.0)}
QARY_SIGMA = {2: ((1, -1), (0, 0)), 3: ((1, 0, 0), (0, 1, -1)),
              4: ((1, 0, -1, 0), (0, 1, 0, -1))}


class QaryRefused(NotImplementedError):
    """The system's tables have no Z_q character form the chain takes."""


@dataclass(frozen=True)
class QaryTables:
    """K3's character rows, R ranks of at most Lq rows of NB neighbours.

    Row j of rank r is the character sum_k qfreq[r, j, k] code(qnbr[r, j,
    k]) + qms[r, j] code(r) (mod q) with folded amplitudes qac, qas; rows
    at and beyond qrows[r], and neighbour slots qnbr = -1, are padding
    (amplitudes and frequencies 0).
    """

    q: int
    qnbr: np.ndarray  # [R, Lq, NB] int32 neighbour rank, -1 = none
    qfreq: np.ndarray  # [R, Lq, NB] int32 scaled frequency in [0, q)
    qms: np.ndarray  # [R, Lq] int32 scaled self frequency in [1, q)
    qac: np.ndarray  # [R, Lq] f64 folded cos amplitude
    qas: np.ndarray  # [R, Lq] f64 folded sin amplitude (0 for q = 2)
    qrows: np.ndarray  # [R] int32 character rows of each rank


def _characters(row, strides, shape, q, tmax):
    """The delta-relevant characters of one local tensor.

    ``row`` is the cluster's energy table, ``strides`` its members' summed
    strides and ``shape`` their code counts.  The reference's arithmetic
    (:700-756): the tensor over the members' code grid, its real DFT,
    conjugate pairs folded into cos and sin amplitudes, characters below
    1e-13 of the scale dropped, the reconstruction checked to 1e-11 of the
    scale.  Returns ``[(scaled frequencies, a_c, a_s)]`` of the characters
    with a nonzero self frequency, or raises :class:`QaryRefused`.
    """
    members_scale = np.array([q // qk for qk in shape])
    grid = np.stack(np.meshgrid(*(np.arange(qk) for qk in shape), indexing="ij"))
    t_grid = np.tensordot(np.array(strides), grid, axes=(0, 0))
    if t_grid.max() >= tmax:
        raise QaryRefused("a local tensor index beyond the table")
    v = row[t_grid]
    scale = max(float(np.abs(v).max()), 1e-300)
    F = np.fft.fftn(v) / v.size
    tiny = 1e-13 * scale
    consumed = np.zeros(shape, dtype=bool)
    recon = np.zeros(shape, dtype=np.float64)
    kept = []
    for m in np.ndindex(shape):
        if consumed[m]:
            continue
        consumed[m] = True
        mc = tuple((-mi) % qk for mi, qk in zip(m, shape))
        if mc == m:  # self-conjugate: a purely real character
            a_c, a_s = float(F[m].real), 0.0
        else:
            consumed[mc] = True
            a_c = 2.0 * float(F[m].real)
            a_s = -2.0 * float(F[m].imag)
        if max(abs(a_c), abs(a_s)) < tiny:
            continue
        sm = np.array(m) * members_scale  # scaled frequencies
        w = np.mod(np.tensordot(sm, grid, axes=(0, 0)), q)
        theta = 2.0 * np.pi * w / q
        recon += a_c * np.cos(theta) + a_s * np.sin(theta)
        if sm[0] % q:  # delta-relevant: nonzero self frequency
            kept.append((sm, a_c, a_s))
    if np.abs(recon - v).max() > 1e-11 * scale:
        raise QaryRefused("a local tensor's character sum misses it by more than "
                          "1e-11 of its scale")
    return kept


def qary_tables(rank_sites, rank_of_site, sites3, strides3, g3, n_codes, tmax,
                max_rows=QARY_MAX_ROWS) -> QaryTables:
    """K3's Z_q character rows of every rank (the reference's ``_qary_tables``
    :651-780, with its arithmetic, row order and refusals).

    For each valid local cluster of a rank's site: its slots grouped by
    member site (a site may fill several slots in a small cell), the
    self site first and then the neighbours that are ranks (a frozen
    single-code site holds code 0 and drops out); the tensor over the
    members' code grid; its characters (:func:`_characters`), each
    member's frequency scaled by q / (its code count), q the lcm of the
    ranks' code counts (so mixed binary and quaternary sites ride one
    q = 4 body, as the reference's do).  Characters of the same (neighbour frequencies,
    self frequency) merge across the rank's clusters, their amplitudes
    summed in insertion order, and the fold is applied after the merge.
    Raises :class:`QaryRefused` where the reference returns None: q not
    in {2, 3, 4}, a tensor index at or beyond ``tmax``, a row without a
    self slot, a reconstruction error above 1e-11 of the scale, more than
    ``max_rows`` rows on a rank, or no row at all.
    """
    R, (_, L0, K) = len(rank_sites), sites3.shape
    valid_cluster = strides3.sum(axis=2) > 0
    q = 1
    for site in rank_sites:
        q = lcm(q, int(n_codes[site]))
    if q not in QARY_FOLD:
        raise QaryRefused(f"the active code counts have lcm {q}, not 2, 3 or 4")
    fold_c, fold_s = QARY_FOLD[q]
    cache = {}  # (code counts, strides, energy table) -> characters
    rows = [{} for _ in range(R)]  # (neighbours, ms) -> [neighbours, A_c, A_s]
    for ri, site in enumerate(rank_sites):
        site = int(site)
        for l in range(L0):
            if not valid_cluster[site, l]:
                continue
            groups = {}  # member site -> summed stride
            for k in range(K):
                st = int(strides3[site, l, k])
                if st > 0:
                    member = int(sites3[site, l, k])
                    groups[member] = groups.get(member, 0) + st
            if site not in groups:
                raise QaryRefused("a local cluster without a self slot")
            members = [site] + [m for m in groups if m != site and rank_of_site[m] >= 0]
            shape = tuple(int(n_codes[m]) for m in members)
            strides = tuple(groups[m] for m in members)
            key = (shape, strides, g3[site, l].tobytes())
            if key not in cache:
                cache[key] = _characters(g3[site, l], strides, shape, q, tmax)
            for sm, a_c, a_s in cache[key]:
                nbrs = tuple((int(rank_of_site[m]), int(f))
                             for m, f in zip(members[1:], sm[1:]) if f)
                entry = rows[ri].setdefault((tuple(sorted(nbrs)), int(sm[0] % q)),
                                            [nbrs, 0.0, 0.0])
                entry[1] += a_c
                entry[2] += a_s
        if len(rows[ri]) > max_rows:
            raise QaryRefused(f"a rank with {len(rows[ri])} character rows, above "
                              f"{max_rows}")
    n_max = max((len(r) for r in rows), default=0)
    if n_max == 0:
        raise QaryRefused("no character changes with a site's code")
    Lq = max(16, -(-n_max // 16) * 16)  # the reference's row padding
    NB = max(1, K - 1)  # a row's distinct neighbour sites
    out = QaryTables(
        q=q,
        qnbr=np.full((R, Lq, NB), -1, dtype=np.int32),
        qfreq=np.zeros((R, Lq, NB), dtype=np.int32),
        qms=np.zeros((R, Lq), dtype=np.int32),
        qac=np.zeros((R, Lq), dtype=np.float64),
        qas=np.zeros((R, Lq), dtype=np.float64),
        qrows=np.array([len(r) for r in rows], dtype=np.int32),
    )
    for ri in range(R):
        for j, ((_, ms), (nbrs, a_c, a_s)) in enumerate(rows[ri].items()):
            for k, (rank, f) in enumerate(nbrs):
                out.qnbr[ri, j, k], out.qfreq[ri, j, k] = rank, f
            out.qms[ri, j] = ms
            # fold after the merge, as the reference does
            out.qac[ri, j], out.qas[ri, j] = fold_c * a_c, fold_s * a_s
    # the phases are sums of non-negative integers: mod q needs no sign care
    assert out.qfreq.min() >= 0 and out.qfreq.max() < q
    assert np.all((out.qms > 0) == (np.arange(Lq) < out.qrows[:, None]))
    assert out.qms.max() < q
    return out


@dataclass(frozen=True)
class IsingTables:
    """K1-Ising's parity rows, one per local cluster of each rank's site.

    Row l of rank r (the reference's ``_ising_tables`` :781, the same rows
    in the same order) changes by -2 (b - a) amp[r, l] (-1)^t when rank r
    recolors a -> b, t the number of ranks of ``mask[r, l]`` holding code
    1: the members that fill an odd number of the cluster's slots (frozen
    single-code members dropped), as bit r' % 64 of word r' // 64.  A row
    whose self site fills an even number of slots, and a padding row, has
    amplitude 0.
    """

    words: int  # NW 64-bit words of rank bits per row
    mask: np.ndarray  # [R, L, NW] uint64
    amp: np.ndarray  # [R, L] f64


def ising_tables(rank_sites, rank_of_site, sites3, strides3, g3, n_codes,
                 tmax) -> IsingTables | None:
    """K1-Ising's rows of every rank, or None where the system does not
    factor (the reference's ``_ising_tables`` :781-838 and its binary test
    :974-978).

    For each valid local cluster of a rank's site: its slots grouped by
    member site (a site may fill several slots in a small cell), frozen
    members dropped (their code 0 adds nothing); every code pattern the
    members and the self site can reach is enumerated jointly per site,
    and the tensor must equal A (-1)^p on each, A = g[l, 0] and p the
    number of slots holding code 1, to ``ISING_TOLERANCE`` of |A|.  Returns
    None on a rank that is not binary, on a tensor index at or beyond
    ``tmax`` and on the first row that misses the pattern.
    """
    R, (_, L0, K) = len(rank_sites), sites3.shape
    if np.any(np.asarray(n_codes)[np.asarray(rank_sites)] != 2):
        return None
    valid_cluster = strides3.sum(axis=2) > 0
    words = max(1, -(-R // 64))
    mask = np.zeros((R, L0, words), dtype=np.uint64)
    amp = np.zeros((R, L0), dtype=np.float64)
    for ri, site in enumerate(rank_sites):
        site = int(site)
        for l in range(L0):
            if not valid_cluster[site, l]:
                continue
            row = g3[site, l]
            a0 = row[0]
            groups = {}  # member site -> [summed stride, slot count]
            for k in range(K):
                st = int(strides3[site, l, k])
                if st > 0:
                    entry = groups.setdefault(int(sites3[site, l, k]), [0, 0])
                    entry[0] += st
                    entry[1] += 1
            self_sum, self_count = groups.pop(site, [0, 0])
            members = [(ssum, cnt) for member, (ssum, cnt) in groups.items()
                       if rank_of_site[member] >= 0]
            if self_count:
                members.append((self_sum, self_count))
            combos = [(0, 0)]  # (tensor index, slots holding code 1)
            for ssum, cnt in members:
                combos = [(t + c * ssum, p + c * cnt) for t, p in combos for c in (0, 1)]
            tol = ISING_TOLERANCE * max(abs(a0), 1e-300)
            for t, p in combos:
                if t >= tmax or abs(row[t] - a0 * (-1.0) ** p) > tol:
                    return None
            amp[ri, l] = a0 if self_count % 2 else 0.0
            for member, (_, cnt) in groups.items():
                nr = int(rank_of_site[member])
                if nr >= 0 and cnt % 2:
                    mask[ri, l, nr // 64] |= np.uint64(1) << np.uint64(nr % 64)
    return IsingTables(words=words, mask=mask, amp=amp)


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
    cum_probs: torch.Tensor  # [S] f64 sublattice pick cdf
    sub_offset: torch.Tensor  # [S] int64 first rank of each active sublattice
    n_active: torch.Tensor  # [S] int64 active sites of each sublattice
    ew_v: torch.Tensor | None = None  # [R, R] f64 Ewald fold, V[u, u] = 0
    ew_c: torch.Tensor | None = None  # [R] f64 Ewald fold constants
    # K3, the q-ary body (qary = q), as :class:`QaryTables`; 0: direct
    qary: int = 0
    qnbr: torch.Tensor | None = None  # [R, Lq, NB] int32
    qfreq: torch.Tensor | None = None  # [R, Lq, NB] int32
    qms: torch.Tensor | None = None  # [R, Lq] int32
    qac: torch.Tensor | None = None  # [R, Lq] f64
    qas: torch.Tensor | None = None  # [R, Lq] f64
    qrows: torch.Tensor | None = None  # [R] int32
    # K1-Ising, the parity body (ising = NW words of rank bits); 0: another
    # body.  The rows of nonzero amplitude of :class:`IsingTables`, in order,
    # padded to Li with zero rows
    ising: int = 0
    imask: torch.Tensor | None = None  # [R, Li, NW] int64 (the uint64 words)
    iamp: torch.Tensor | None = None  # [R, Li] f64
    irows: torch.Tensor | None = None  # [R] int32 rows of each rank

    @property
    def num_ranks(self) -> int:
        return int(self.nbr.shape[0])

    @property
    def device(self) -> torch.device:
        return self.g.device

    @property
    def has_ewald(self) -> bool:
        return self.ew_v is not None

    @property
    def delta(self) -> str:
        """The site body of the flip and swap chains: ``direct``, ``qary`` or
        ``ising``."""
        if self.ising:
            return "ising"
        return "qary" if self.qary else "direct"


def _split_processor(processor):
    """(expansion part, Ewald part or None) of a processor (ref :854-866).

    A distance processor's score is no sum over local clusters: the chains
    refuse it, as the reference's do (``fastmc.py:136``)."""
    if isinstance(processor, DistanceProcessor):
        raise NotImplementedError("a distance processor has no local energy tables")
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


def _rank_layout(ce, ewald, sublattices):
    """The rank layout of :func:`build_chain_tables`, after its requirement
    checks: (active sublattices, rank_sites [R], rank_of_site [N] (-1 off
    the active sites), n_codes [N])."""
    n = ce.local_sites.shape[0]
    active = [s for s in sublattices if s.is_active]
    if not active:
        raise NotImplementedError("no active sublattice: nothing to flip")
    # every sublattice's, frozen ones too: the tables read a frozen site's
    # single code as code 0, so the part of a split sublattice that keeps
    # only code c > 0 would sum the wrong clusters (the reference checks
    # the active sublattices only, pallas_chain.py:879-883)
    for s in sublattices:
        if not np.array_equal(s.encoding, np.arange(len(s.encoding))):
            raise NotImplementedError("non-default sublattice encodings")
    for s in active:
        if len(s.active_sites) != len(s.sites):
            raise NotImplementedError("sublattices with restricted sites")
    if ewald is not None and any(len(s.encoding) != 2 for s in active):
        raise NotImplementedError("the Ewald fold needs binary active sites")
    n_codes = np.ones(n, dtype=np.int64)
    for s in sublattices:
        n_codes[s.sites] = len(s.encoding)
    rank_sites = np.concatenate([np.asarray(s.active_sites) for s in active])
    rank_of_site = -np.ones(n, dtype=np.int64)
    rank_of_site[rank_sites] = np.arange(len(rank_sites))
    nb_sites = ce.local_sites[rank_sites]  # [R, L, K]
    frozen = ((ce.local_strides[rank_sites] > 0) & (nb_sites != rank_sites[:, None, None])
              & (rank_of_site[nb_sites] < 0))
    if np.any(frozen & (n_codes[nb_sites] != 1)):
        raise NotImplementedError("a local cluster reaches a frozen multi-code site")
    return active, rank_sites, rank_of_site, n_codes


def chain_refusal(processor, sublattices):
    """Why the chains cannot take a system, or None where they can: the
    requirement checks of :func:`build_chain_tables`, without its tables
    (the reference's ``build_chain_tables`` returns None on the same
    systems, ``pallas_chain.py:840-890``).  A kernel whose system they
    refuse takes the per-step path (:mod:`smol_tpu_torch.ops.mc`)."""
    try:
        ce, ewald = _split_processor(processor)
        _rank_layout(ce, ewald, sublattices)
    except NotImplementedError as refusal:
        return str(refusal)
    return None


def default_delta(processor, sublattices) -> str:
    """The site body the samplers take without a ``chain_delta``, in every
    chain (flips, swaps, table moves, Wang-Landau).

    ``"ising"`` (K1-Ising) where the system's tables factor
    (:func:`ising_tables`) within ``ISING_MAX_WORDS`` words of rank bits,
    and ``"direct"`` elsewhere, as the reference's ``build_chain_tables``
    picks its body by the system (:974-1029).  K1-Ising beat the direct
    body on every cell of every chain, and K3 lost to it on its own cells,
    each timed on the card in turns (PERF.md), so K3 is never the default.
    """
    ce, ewald = _split_processor(processor)
    _, rank_sites, rank_of_site, n_codes = _rank_layout(ce, ewald, sublattices)
    it = ising_tables(rank_sites, rank_of_site, ce.local_sites, ce.local_strides,
                      ce.local_g, n_codes, ce.local_g.shape[2])
    return "ising" if it is not None and it.words <= ISING_MAX_WORDS else "direct"


def build_chain_tables(processor, sublattices, mu_table=None,
                       sublattice_probabilities=None, delta="direct") -> ChainTables:
    """Chain tables of a processor's local clusters, on its device.

    The processor is a cluster expansion (of correlations or of cluster
    interactions), or a composite of one and an Ewald term, whose fold the
    tables then carry.  Requirements, as in the reference: active
    sublattices with default (arange) encodings and no restricted sites,
    every non-self slot of a local cluster on an active site or on a
    single-code (code 0) site, and, with an Ewald term, binary active
    sites.  Raises ``NotImplementedError`` otherwise.

    ``delta`` picks every chain's site body: ``"direct"``, ``"qary"``,
    K3's character rows (:func:`qary_tables`), which raises where those
    refuse the system, or ``"ising"``, K1-Ising's parity rows
    (:func:`ising_tables`), which raises where the system does not factor
    (a rank that is not binary, a basis that is not sign-symmetric) and
    above ``ISING_MAX_WORDS`` * 64 ranks.  Each carries the Ewald fold.
    Nothing falls back; :func:`default_delta` names the body the samplers
    take.
    """
    if delta not in DELTAS:
        raise ValueError(f"unknown chain delta {delta!r}: one of {DELTAS}")
    ce, ewald = _split_processor(processor)
    sites3 = ce.local_sites
    strides3 = ce.local_strides
    d2 = ce.local_d2
    g3 = ce.local_g
    n = sites3.shape[0]
    active, rank_sites, rank_of_site, n_codes = _rank_layout(ce, ewald, sublattices)
    R = len(rank_sites)

    nb_sites = sites3[rank_sites]  # [R, L, K]
    st = strides3[rank_sites]
    is_self = nb_sites == rank_sites[:, None, None]
    nbr = rank_of_site[nb_sites]
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
    body = {}  # the fields of the q-ary or the Ising body
    if delta == "qary":
        qt = qary_tables(rank_sites, rank_of_site, sites3, strides3, g3, n_codes,
                         g3.shape[2])
        body = {"qary": qt.q, "qnbr": dev(qt.qnbr, torch.int32),
                "qfreq": dev(qt.qfreq, torch.int32), "qms": dev(qt.qms, torch.int32),
                "qac": dev(qt.qac, torch.float64), "qas": dev(qt.qas, torch.float64),
                "qrows": dev(qt.qrows, torch.int32)}
    if delta == "ising":
        it = ising_tables(rank_sites, rank_of_site, sites3, strides3, g3, n_codes,
                          g3.shape[2])
        if it is None:
            raise NotImplementedError(
                "the Ising body needs binary sites and a sign-symmetric basis, "
                "and this system's local tensors do not factor as A (-1)^t; "
                "its delta takes the direct or the q-ary body")
        elif it.words > ISING_MAX_WORDS:
            raise NotImplementedError(
                f"the Ising body holds at most {64 * ISING_MAX_WORDS} ranks in "
                f"registers, not {R}")
        body = {"ising": it.words, **_compact_ising(it, dev)}

    return ChainTables(
        num_sites=n,
        rank_sites=dev(rank_sites, torch.int64),
        nbr=dev(nbr, torch.int32),
        stride=dev(st, torch.int32),
        d2=dev(d2[rank_sites], torch.int32),
        g=dev(g3[rank_sites], torch.float64),
        mu=dev(mu, torch.float64),
        ncode=dev(ncode, torch.int32),
        cum_probs=dev(np.cumsum(probs), torch.float64),
        sub_offset=dev(np.concatenate([[0], np.cumsum(n_active)[:-1]]), torch.int64),
        n_active=dev(n_active, torch.int64),
        ew_v=ew_v,
        ew_c=ew_c,
        **body,
    )


def _compact_ising(it: IsingTables, dev) -> dict:
    """The :class:`ChainTables` fields of K1-Ising: each rank's rows of
    nonzero amplitude, in local-cluster order (a zero row adds nothing),
    padded with zero rows to the most of any rank (at least 1)."""
    keep = it.amp != 0.0
    counts = keep.sum(axis=1)
    Li = max(1, int(counts.max()))
    R = it.amp.shape[0]
    mask = np.zeros((R, Li, it.words), dtype=np.uint64)
    amp = np.zeros((R, Li), dtype=np.float64)
    for r in range(R):
        rows = np.flatnonzero(keep[r])
        mask[r, :len(rows)] = it.mask[r, rows]
        amp[r, :len(rows)] = it.amp[r, rows]
    return {"imask": dev(mask.view(np.int64), torch.int64),
            "iamp": dev(amp, torch.float64), "irows": dev(counts, torch.int32)}


def _sublattice_draw(tables, generator, shape):
    """(first rank, active sites) of a sublattice drawn by its probability.

    ``tables`` (:class:`ChainTables` or the distance tables) holds
    ``cum_probs``, ``n_active`` and ``sub_offset`` on its device: the draw
    copies nothing and never waits for the device.
    """
    device = tables.device
    cum = tables.cum_probs
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float64)
    sl = (cum <= u[..., None]).sum(dim=-1).clamp(max=len(cum) - 1)
    return tables.sub_offset[sl], tables.n_active[sl]


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
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=dtype).contiguous()
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


class _TableRefusal(Exception):
    """Why the table chain cannot take an usher."""


def _table_slots(usher):
    """(flip weights [2F], per direction its (active sublattice, from code,
    to code) slots, k_max) of a TableFlip usher, or :class:`_TableRefusal`
    where the chain cannot honour it (``pallas_chain.py:1233-1290``)."""
    flip_table = np.asarray(usher.flip_table, dtype=np.int64)  # [F, D]
    if flip_table.size == 0:
        raise _TableRefusal("its flip table is empty")
    weights = np.asarray(usher.flip_weights, dtype=np.float64)  # [2F]
    pairs = weights.reshape(-1, 2)
    if not np.allclose(pairs[:, 0], pairs[:, 1]):
        raise _TableRefusal("direction-asymmetric flip weights")
    if weights.sum() <= 0:
        raise _TableRefusal("its flip weights sum to zero")

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
            raise _TableRefusal("a flip vector touches an inactive sublattice")
        dir_slots = []
        for sub in range(n_active):
            removed, added = [], []
            for dim in np.flatnonzero((u != 0) & (dim_sub == sub)):
                target = removed if u[dim] < 0 else added
                target.extend([int(dim_code[dim])] * int(abs(u[dim])))
            if len(removed) != len(added):
                raise _TableRefusal("a flip vector changes a sublattice's site count")
            dir_slots.extend((sub, fc, tc) for fc, tc in zip(removed, added))
        if not dir_slots:
            raise _TableRefusal("a flip vector changes nothing")
        slots.append(dir_slots)

    k_max = max(2, max(len(dir_slots) for dir_slots in slots))
    if k_max > MAX_TABLE_SLOTS:
        raise _TableRefusal(f"a direction of {k_max} > {MAX_TABLE_SLOTS} recolorings")
    return weights, slots, k_max


def table_move_refusal(usher):
    """Why the table chain cannot take a TableFlip usher, or None where it
    can (the reference's ``build_table_move`` returns None on the same
    ushers); a kernel with such an usher takes the per-step TableFlip."""
    try:
        _table_slots(usher)
    except _TableRefusal as why:
        return f"the table chain cannot take this usher ({why})"
    return None


def build_table_move(tables: ChainTables, usher) -> TableMove:
    """Expand a TableFlip usher's flip table into the chain's TableMove.

    Counterpart of ``pallas_chain.py:1233-1325``, with the same arrays.
    Where the chain cannot honour the usher exactly (direction-asymmetric
    flip weights, which break the proposal's symmetry; a flip vector that
    touches an inactive sublattice or changes a sublattice's site count; a
    direction of more than ``MAX_TABLE_SLOTS`` recolorings;
    :func:`table_move_refusal`) the reference returns None and its kernel
    takes its per-step TableFlip; here the kernel decides that from its
    configuration before it builds a chain, and this raises
    ``NotImplementedError``.
    """
    try:
        weights, slots, k_max = _table_slots(usher)
    except _TableRefusal as why:
        raise NotImplementedError(
            f"the table chain cannot take this usher ({why}); a kernel with it "
            "takes the per-step TableFlip") from None
    n_dirs = len(slots)
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


def _qary_terms(tables: ChainTables, occ, u, a, b):
    """[W, Lq] f64 change of each character row of rank u[w], a -> b (K3).

    u = sum_k f_k code(nbr_k) is the row's neighbour phase, an integer
    >= 0; the phases before and after are (u + ms a) mod q and
    (u + ms b) mod q, and the row's change is qac dc + qas ds with the
    integer differences dc, ds in {0, +-1, +-2} of the folded selectors.
    Each product is exact, so the one rounding of the sum is the kernel's.
    Rows beyond the rank's count have zero amplitudes and add 0.
    """
    q = tables.qary
    walkers = torch.arange(occ.shape[1], device=occ.device)
    nb = tables.qnbr[u].long()  # [W, Lq, NB]
    codes = occ[nb.clamp(min=0), walkers[:, None, None]].long()
    phase = (tables.qfreq[u].long() * codes).sum(dim=-1)  # padding has f = 0
    ms = tables.qms[u].long()
    wo = (phase + ms * a[:, None]) % q
    wn = (phase + ms * b[:, None]) % q
    sigma_c, sigma_s = (torch.tensor(x, device=occ.device) for x in QARY_SIGMA[q])
    terms = tables.qac[u] * (sigma_c[wn] - sigma_c[wo]).to(torch.float64)
    if q != 2:  # q = 2 has no sin characters
        terms = terms + tables.qas[u] * (sigma_s[wn] - sigma_s[wo]).to(torch.float64)
    return terms


def _walker_words(occ, words):
    """[W, words] int64: each walker's 0/1 codes ``occ`` [R, W] as rank bits,
    rank r at bit r % 64 of word r // 64 (bit 63 is the int64 sign bit)."""
    R, W = occ.shape
    bits = torch.zeros((words * 64, W), dtype=torch.int64, device=occ.device)
    bits[:R] = occ.to(torch.int64)
    shifts = torch.arange(64, dtype=torch.int64, device=occ.device)[None, :, None]
    return (bits.view(words, 64, W) << shifts).sum(dim=1).T  # distinct bits: no carry


def _parity(x):
    """The parity (0 or 1) of the set bits of each int64 of ``x``: the
    halves folded by xor (an arithmetic shift brings sign bits only into
    the bits that later folds drop)."""
    for shift in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> shift)
    return x & 1


def _ising_rows(tables: ChainTables, occ, u):
    """[W, Li] f64 signed amplitudes A_l (-1)^{t_l} of rank u[w]'s parity
    rows against the walker's codes ``occ`` (padding rows: +0.0)."""
    words = _walker_words(occ, tables.ising)  # [W, NW]
    hits = tables.imask[u.long()] & words[:, None, :]  # [W, Li, NW]
    odd = _parity(hits).sum(dim=-1) % 2 == 1
    amp = tables.iamp[u.long()]
    return torch.where(odd, -amp, amp)


def _lane_partials(terms, lanes, partial=None):
    """[W, lanes] partial sums of the [W, P] f64 ``terms`` as the kernel's
    lanes take them: lane j adds terms j, j + lanes, ... in order to its
    partial (from +0.0, or from ``partial``).  Padding terms are +0.0,
    which leaves a partial (never -0.0) unchanged.  At one lane, the terms
    in order from +0.0."""
    W, P = terms.shape
    steps = -(-P // lanes)
    if steps * lanes != P:
        terms = torch.nn.functional.pad(terms, (0, steps * lanes - P))
    terms = terms.reshape(W, steps, lanes)
    if partial is None:
        partial = terms.new_zeros((W, lanes))
    for k in range(steps):
        partial = partial + terms[:, k]
    return partial


def _lanes_meet(partial):
    """[W] sum of the [W, lanes] partials in the Wang-Landau kernel's
    butterfly: lane j adds lane j ^ m's partial, m = 1, 2, 4, ...; every
    lane ends with the same bits."""
    lanes = partial.shape[1]
    m = 1
    while m < lanes:
        partner = torch.arange(lanes, device=partial.device) ^ m
        partial = partial + partial[:, partner]
        m <<= 1
    return partial[:, 0]


def _ising_sum(tables: ChainTables, occ, u, lanes=1):
    """[W] f64 parity sum S of rank u[w]'s rows (K1-Ising): S = sum over
    rows l of A_l (-1)^{t_l}, t_l the parity of the walker's codes under
    the row's mask, as ``lanes`` lanes take it (:func:`_lane_partials`,
    :func:`_lanes_meet`), as ``Lanes<Ising>::sum`` of chain_common.cuh
    sums; at one lane in row order l = 0 .. Li-1 from 0.0.  Padding rows (zero
    amplitude, zero mask) add +0.0."""
    return _lanes_meet(_lane_partials(_ising_rows(tables, occ, u), lanes))


def _row_terms(tables: ChainTables, occ, u, a, b):
    """[W, *] f64 row terms of the direct or the q-ary body, in row order."""
    return _qary_terms(tables, occ, u, a, b) if tables.qary else _ce_terms(tables, occ, u, a, b)


def _body_delta(tables: ChainTables, occ, u, a, b, lanes=1, v=None):
    """[W] f64 change of the site body for u: a -> b and, for a swap, then
    v: b -> a with u already holding b, summed as ``lanes`` lanes of the
    kernels sum it.  The direct and q-ary bodies' row terms, u's then v's,
    go into one partial a lane, and the partials meet after v's; K1-Ising's
    parity sums of u and of v meet apart and are scaled by -2 (b - a) and
    -2 (a - b) in turn from 0.0.  At one lane, the rows in row order from
    +0.0.  Leaves b in u's cell when ``v`` is given, as
    ``lane_swap_delta`` does."""
    walkers = torch.arange(occ.shape[1], device=occ.device)
    if tables.ising:
        scale = (-2 * (b - a)).to(torch.float64)
        dE = torch.zeros_like(scale) + scale * _ising_sum(tables, occ, u, lanes)
        if v is not None:
            occ[u, walkers] = b.to(occ.dtype)  # v's parities see u holding b
            dE = dE + (-scale) * _ising_sum(tables, occ, v, lanes)
        return dE
    partial = _lane_partials(_row_terms(tables, occ, u, a, b), lanes)
    if v is not None:
        occ[u, walkers] = b.to(occ.dtype)  # v's rows see u already holding b
        partial = _lane_partials(_row_terms(tables, occ, v, b, a), lanes, partial)
    return _lanes_meet(partial)


def _flip_proposal(tables: ChainTables, occ, u, r_j, lanes=1):
    """``(a, b, dE)`` of a flip of rank u[w] (long): u holds a and is
    proposed b, the r_j-th of the other codes, and dE sums the body's
    change (:func:`_body_delta`), then the Ewald term, then minus the
    chemical work."""
    walkers = torch.arange(occ.shape[1], device=occ.device)
    a = occ[u, walkers].long()
    nc = torch.clamp(tables.ncode[u].long() - 1, min=1)
    j = r_j % nc
    b = j + (j >= a).long()
    columns = [_body_delta(tables, occ, u, a, b, lanes)]
    if tables.has_ewald:
        columns.append(_ewald_term(tables, occ, u, b - a))
    return a, b, _accumulate(*columns) - (tables.mu[u, b] - tables.mu[u, a])


def _swap_proposal(tables: ChainTables, occ, u, v, lanes=1, ewald_lanes=1):
    """``(a, b, dE)`` of a swap of ranks u[w] and v[w] (long): u holds a and
    v holds b; dE sums the body's change (:func:`_body_delta`), then u's
    Ewald term (taken before u is recolored), then v's with u holding b,
    each dot over ``ewald_lanes`` lanes (:func:`_ewald_term`).  ``occ`` is
    left as it was."""
    walkers = torch.arange(occ.shape[1], device=occ.device)
    a = occ[u, walkers].long()
    b = occ[v, walkers].long()
    if tables.has_ewald:
        ewald_u = _ewald_term(tables, occ, u, b - a, ewald_lanes)
    # with the q-ary body, v's phases (with the Ising body, v's parities)
    # take u's new code, which stands for the reference's rank-1 correction
    columns = [_body_delta(tables, occ, u, a, b, lanes, v)]
    if tables.has_ewald:
        columns += [ewald_u, _ewald_term(tables, occ, v, a - b, ewald_lanes)]
    occ[u, walkers] = a.to(occ.dtype)
    return a, b, _accumulate(*columns)


def _ewald_term(tables: ChainTables, occ, u, sign, lanes=1):
    """[W] f64 Ewald change sign * (C_u + V_u . occ) of rank u[w].

    The dot sums as ``lanes`` lanes of the kernels take it: lane j the
    ranks j, j + lanes, ... in order (:func:`_lane_partials`), the
    partials meeting in the butterfly (:func:`_lanes_meet`); at one lane in
    rank order, t = 0 .. R-1, as every lane's loop does where the dot is
    not split.  Codes are 0/1, so each product is exact and kernel and twin
    give the same sum.
    """
    prod = tables.ew_v[u] * occ.T.to(torch.float64)  # [W, R]
    acc = _lanes_meet(_lane_partials(prod, lanes))
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


def flip_step_reference(tables: ChainTables, occ, u, r_u, r_j, beta32, lanes=1):
    """One flip proposal for every walker, without applying it.

    ``occ`` [R, W] int8 codes, ``u`` [W] proposal ranks, ``r_u``/``r_j``
    [W] random bits, ``beta32`` [W] f32.  Returns ``(accept, b, dE, expo,
    log_u)``: the decision, the proposed codes, the f64 enthalpy change and
    the f32 exponent and log uniform it was decided on.  dE sums the body's
    rows as the kernel's ``lanes`` lanes sum them (:func:`_body_delta`; at
    one lane the clusters' terms in order l = 0 .. L-1, with the q-ary body
    the character rows' terms in row order, with the Ising body -2 (b - a)
    times the parity rows' sum), then the Ewald term, then the chemical
    work, as the kernel does.
    """
    _, b, dE = _flip_proposal(tables, occ, u.long(), r_j, lanes)
    accept, expo, log_u = _metropolis(dE, r_u, beta32)
    return accept, b, dE, expo, log_u


def swap_step_reference(tables: ChainTables, occ, u, v, r_u, beta32, lanes=1):
    """One swap proposal for every walker, without applying it.

    ``occ`` [R, W] int8 codes (left as it was), ``u``/``v`` [W] ranks,
    ``r_u`` [W] random bits, ``beta32`` [W] f32.  Returns ``(accept,
    is_move, a, b, dE, expo, log_u)``: u holds a and v holds b; on accept
    u takes b and v takes a.  dE sums u's cluster terms, then v's with u
    already holding b, then u's Ewald term, then v's (against the same
    occupancy), as the kernel's ``lanes`` lanes sum them
    (:func:`_body_delta`; each Ewald dot split over the lanes too; at one
    lane, the one-thread order).  A null pair (a == b) is never accepted.
    """
    a, b, dE = _swap_proposal(tables, occ, u.long(), v.long(), lanes, lanes)
    is_move = a != b
    accept, expo, log_u = _metropolis(dE, r_u, beta32)
    return accept & is_move, is_move, a, b, dE, expo, log_u


def table_step_reference(tables: ChainTables, tm: TableMove, occ, d, ranks,
                         r_u, beta32, lanes=1):
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
    slot's site-body terms (the cluster terms in order l = 0 .. L-1, or
    the q-ary or Ising rows in row order), then its Ewald term, then
    minus its chemical work, as the kernel does (``table_step`` of the
    reference, :1701-1785).  The body's terms sum as the kernel's ``lanes``
    lanes take them: lane 0 adds its rows onto the running dE and the
    others from +0.0, the partials meeting in the butterfly (the Ising
    body's parity sum meets first and is then scaled and added); the Ewald
    dot split over the lanes too; at one lane, the one-thread order.  An
    invalid move is never accepted.
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
        if tables.ising:
            scale = (-2 * (bj - a)).to(torch.float64)
            dE = dE + scale * _ising_sum(tables, occ, u, lanes)
        else:
            partial = torch.zeros((occ.shape[1], lanes), dtype=torch.float64,
                                  device=occ.device)
            partial[:, 0] = dE  # lane 0 carries the running dE
            dE = _lanes_meet(_lane_partials(_row_terms(tables, occ, u, a, bj), lanes,
                                            partial))
        if tables.has_ewald:
            dE = dE + _ewald_term(tables, occ, u, bj - a, lanes)
        dE = dE - (tables.mu[u, bj] - tables.mu[u, a])
        written = on & valid  # distinct sites are certain only among these
        occ[u[written], walkers[written]] = bj[written].to(occ.dtype)
    for j in range(tm.k_max):
        back = slot_on[:, j] & valid
        occ[ranks[back, j], walkers[back]] = a0[back, j].to(occ.dtype)
    accept, expo, log_u = _metropolis(dE, r_u, beta32)
    return accept & valid, valid, a0, b, dE, expo, log_u


def flip_chain_reference(occ, enthalpy, naccept, beta32, seq, seed, tables,
                         n_steps, block_size, rng="philox", margin=None, lanes=1):
    """Plain torch twin of the CUDA flip-chain kernel (same arguments).

    Updates ``occ``, ``enthalpy`` and ``naccept`` in place.  Each delta
    sums as the kernel's ``lanes`` lanes sum it (:func:`flip_chain` takes
    the launch's, :func:`flip_lanes`; at one lane, the one-thread order).
    ``margin``, an optional [W] f32 tensor, is lowered in place to each
    walker's closest decision: the smallest |expo - log U| in f32 ulps of
    log U, which bounds where another implementation's last-bit rounding
    could decide otherwise.
    """
    W = occ.shape[1]
    walkers = torch.arange(W, device=occ.device)
    group = walkers // block_size
    r_u, r_j = chain_draws(rng, int(seed[0]), n_steps, W, block_size, occ.device)
    for i in range(n_steps):
        u = seq[group, i].long()
        accept, b, dE, expo, log_u = flip_step_reference(
            tables, occ, u, r_u[i], r_j[i], beta32, lanes
        )
        if margin is not None:
            _lower_margin(margin, expo, log_u, beta32, 0.0, torch.zeros_like(accept))
        occ[u, walkers] = torch.where(accept, b, occ[u, walkers].long()).to(occ.dtype)
        enthalpy += torch.where(accept, dE, torch.zeros_like(dE))
        naccept += accept.to(naccept.dtype)


def swap_chain_reference(occ, enthalpy, naccept, nmove, beta32, useq, vseq,
                         seed, tables, n_steps, block_size, rng="philox",
                         margin=None, slack=0.0, lanes=1):
    """Plain torch twin of the CUDA swap-chain kernel (same arguments).

    Updates ``occ``, ``enthalpy``, ``naccept`` and ``nmove`` (non-null
    proposals) in place.  Each delta sums as the kernel's ``lanes`` lanes
    sum it, the Ewald dots too (:func:`swap_chain` takes the launch's,
    :func:`twin_order`; at one lane, the one-thread order).  ``margin`` as
    in :func:`flip_chain_reference`, with each distance taken beyond beta
    * ``slack`` (eV): where another
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
            tables, occ, u, v, r_u[i], beta32, lanes
        )
        if margin is not None:
            _lower_margin(margin, expo, log_u, beta32, slack, ~is_move)
        occ[u, walkers] = torch.where(accept, b, a).to(occ.dtype)
        occ[v, walkers] = torch.where(accept, a, b).to(occ.dtype)
        enthalpy += torch.where(accept, dE, torch.zeros_like(dE))
        naccept += accept.to(naccept.dtype)
        nmove += is_move.to(nmove.dtype)


def body_rows(tables: ChainTables) -> torch.Tensor:
    """[R] int64: the rows the site body reads for a recoloring of each
    rank (the direct body's L local clusters, or the rank's q-ary or Ising
    rows)."""
    if tables.ising:
        return tables.irows.long()
    if tables.qary:
        return tables.qrows.long()
    return torch.full((tables.num_ranks,), tables.nbr.shape[1], dtype=torch.int64,
                      device=tables.device)


def table_chain_reference(occ, enthalpy, naccept, beta32, dirs, ranks, seed,
                          tables, table_move, n_steps, block_size,
                          rng="philox", margin=None, slack=0.0, nslot=None,
                          nrow=None, lanes=1):
    """Plain torch twin of the CUDA table-chain kernel (same arguments).

    Updates ``occ``, ``enthalpy`` and ``naccept`` in place.  Each delta
    sums as the kernel's ``lanes`` lanes sum it, the Ewald dots too
    (:func:`table_chain` takes the launch's, :func:`twin_order`; at one
    lane, the one-thread order).
    ``margin`` and
    ``slack`` as in :func:`swap_chain_reference`; invalid (identity)
    proposals never lower the margin.  ``nslot``, an optional [W] int32
    tensor, gains the site recolorings whose delta a walker had to
    compute: the valid slots of its valid proposals; ``nrow``, an optional
    [W] int64 tensor, the site body's rows of those recolorings
    (:func:`body_rows`).
    """
    W = occ.shape[1]
    walkers = torch.arange(W, device=occ.device)
    group = walkers // block_size
    r_u, _ = chain_draws(rng, int(seed[0]), n_steps, W, block_size, occ.device)
    for i in range(n_steps):
        slot_ranks = ranks[group, i].long()  # [W, k_max]
        accept, valid, _, b, dE, expo, log_u = table_step_reference(
            tables, table_move, occ, dirs[group, i], slot_ranks, r_u[i], beta32, lanes
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
        if nrow is not None:
            rows = body_rows(tables)[slot_ranks] * slot_on
            nrow += rows.sum(dim=1) * valid
        enthalpy += torch.where(accept, dE, torch.zeros_like(dE))
        naccept += accept.to(naccept.dtype)


# the tables' Ewald fold and site-body tensors, whose addresses the kernels take
BODY_TENSORS = ("ew_v", "ew_c", "qnbr", "qfreq", "qms", "qac", "qas", "qrows",
                "imask", "iamp", "irows")


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
    body = [getattr(tables, name) for name in BODY_TENSORS
            if getattr(tables, name, None) is not None]  # distance tables have none
    operands = [t for t, _, _ in expect] + [*seqs, tables.g, *body]
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


def _body_operands(tables):
    """The site body's table pointers (K3's qnbr .. qrows, then K1-Ising's
    imask, iamp, irows) and its (q, Lq, NB, Li, NW), in the kernels'
    argument order: None and zeros for the fields of a body the tables do
    not take."""
    qary = ("qnbr", "qfreq", "qms", "qac", "qas", "qrows")
    ising = ("imask", "iamp", "irows")
    ptrs = [getattr(tables, name).data_ptr() if on else None
            for names, on in ((qary, tables.qary), (ising, tables.ising))
            for name in names]
    q_shape = (tables.qary, *tables.qnbr.shape[1:]) if tables.qary else (0, 0, 0)
    i_shape = (tables.imask.shape[1], tables.ising) if tables.ising else (0, 0)
    return ptrs, (*q_shape, *i_shape)


def _count_launch(kernel, tables):
    """One launch of ``kernel`` on ``tables``: ``launches``, and
    ``qary_launches`` or ``ising_launches`` by the tables' body."""
    kernel.launches += 1
    kernel.qary_launches += bool(tables.qary)
    kernel.ising_launches += bool(tables.ising)


def flip_chain(occ, enthalpy, naccept, beta32, seq, seed, tables, n_steps,
               block_size, rng="philox", _design=None):
    """Run ``n_steps`` shared-proposal flips on every walker, in place.

    Args:
        occ: [R, W] int8 codes, rank-major; updated in place.
        enthalpy: [W] f64, updated in place.
        naccept: [W] int32, accepted moves added in place.
        beta32: [W] f32 inverse temperatures (the exponent is f32).
        seq: [G, >= n_steps] int32 proposal ranks, one row per block of
            ``block_size`` walkers (G = ceil(W / block_size)).
        seed: [1] int64 seed of this launch.
        tables: :class:`ChainTables` on the same device; their site body
            (``tables.delta``: direct, K3's q-ary rows or K1-Ising's parity
            rows) is the kernel's.
        rng: ``"philox"`` (run mode) or ``"hash"`` (reference parity).

    A CUDA tensor launches the kernel (``flip_chain.launches`` counts the
    launches, ``flip_chain.qary_launches`` and ``flip_chain.ising_launches``
    those with the q-ary and the Ising body) as :func:`launch_plan`
    shapes it; a CPU tensor runs :func:`flip_chain_reference` at the lanes
    the kernel would take (:func:`twin_order`).  ``_design`` (private;
    None: ``_FLIP_DESIGN``) picks another launch for the A/B of
    ``chip_smoke.py`` and the tests.
    """
    if occ.device.type == "cpu":
        _check_operands("flip_chain", occ, enthalpy, (naccept,), beta32, (seq,),
                        seed, tables, n_steps, block_size)
        flip_chain_reference(occ, enthalpy, naccept, beta32, seq, seed, tables,
                             n_steps, block_size, rng,
                             **twin_order("flip", tables, occ.shape[1], _design))
        return
    ChainLaunches("flip", occ, enthalpy, (naccept,), beta32, (seq[None],),
                  seed, tables, block_size, rng, _design).launch(0, n_steps)


flip_chain.launches = 0
flip_chain.qary_launches = 0  # of the launches, those with K3's q-ary body
flip_chain.ising_launches = 0  # of the launches, those with K1-Ising's body


def swap_chain(occ, enthalpy, naccept, nmove, beta32, useq, vseq, seed,
               tables, n_steps, block_size, rng="philox", _design=None):
    """Run ``n_steps`` shared-proposal swaps on every walker, in place.

    Arguments as :func:`flip_chain`, with the pair sequences ``useq`` and
    ``vseq`` ([G, >= n_steps] int32 each, one layout) in place of ``seq``
    and ``nmove`` [W] int32, to which the non-null proposals are added.
    A CUDA tensor launches the kernel (``swap_chain.launches`` counts the
    launches, ``swap_chain.qary_launches`` and ``swap_chain.ising_launches``
    those with the q-ary and the Ising body) as :func:`launch_plan` shapes
    it; a CPU tensor runs :func:`swap_chain_reference` in the order the
    kernel would sum (:func:`twin_order`).  ``_design`` (private; None:
    ``_SWAP_DESIGN``) as for :func:`flip_chain`.
    """
    if occ.device.type == "cpu":
        _check_operands("swap_chain", occ, enthalpy, (naccept, nmove), beta32,
                        (useq, vseq), seed, tables, n_steps, block_size)
        swap_chain_reference(occ, enthalpy, naccept, nmove, beta32, useq, vseq,
                             seed, tables, n_steps, block_size, rng,
                             **twin_order("swap", tables, occ.shape[1], _design))
        return
    ChainLaunches("swap", occ, enthalpy, (naccept, nmove), beta32,
                  (useq[None], vseq[None]), seed, tables, block_size, rng,
                  _design).launch(0, n_steps)


swap_chain.launches = 0
swap_chain.qary_launches = 0  # of the launches, those with K3's q-ary body
swap_chain.ising_launches = 0  # of the launches, those with K1-Ising's body


class ChainLaunches:
    """Launches of the flip or swap kernel on the operands of one window.

    The operands are checked (as :func:`flip_chain` and :func:`swap_chain`
    check them) and turned into the kernel's argument list once; launch k
    then points the list at row k of the sequences ``seqs`` (each [n, G,
    >= n_steps] int32, contiguous) and of the seeds ``seed`` ([n] int64)
    and makes one foreign call.  A window of replica-exchange segments
    launches the kernel once per segment on the same operands, and the
    checks and the list cost the host several times the call itself.  CUDA
    tensors only; the object holds every operand whose address the list
    carries, so none returns to the allocator while a launch may read it.
    Every launch counts on the wrapper (``launches``, and
    ``qary_launches`` or ``ising_launches`` by the tables' body).  The
    launch is planned once here (:func:`launch_plan` for the sequences'
    steps, under ``design``), not per launch.
    """

    def __init__(self, move, occ, enthalpy, counts, beta32, seqs, seed, tables,
                 block_size, rng, design=None):
        self.kernel = flip_chain if move == "flip" else swap_chain
        name = self.kernel.__name__
        rows = tuple(s[0] for s in seqs)
        _check_operands(name, occ, enthalpy, counts, beta32, rows, seed[:1], tables,
                        seqs[0].shape[-1], block_size)
        if occ.device.type != "cuda":
            raise ValueError(f"{name} runs on cuda or cpu, not {occ.device}")
        if rng not in RNG_MODES:
            raise ValueError(f"unknown rng mode: {rng!r}")
        if not all(s.is_contiguous() for s in seqs) or not seed.is_contiguous() \
                or len(seed) != seqs[0].shape[0]:
            raise ValueError(f"{name}: one contiguous seed per contiguous sequence row")
        self.lib = _build.load_chain(name)
        self.entry = getattr(self.lib, f"smol_{name}")
        self.operands = (occ, enthalpy, counts, beta32, seqs, seed, tables)
        R, W = occ.shape
        L, K = tables.nbr.shape[1:]
        with torch.cuda.device(occ.device):
            stream = torch.cuda.current_stream(occ.device).cuda_stream
        args = [t.data_ptr() for t in (occ, enthalpy, *counts, beta32)]
        self.seq_slots = range(len(args), len(args) + len(seqs))
        self.seq_rows = [(s.data_ptr(), s.stride(0) * s.element_size()) for s in seqs]
        args += [s.data_ptr() for s in rows] + [rows[0].stride(0)]
        self.seed_slot, self.seed_ptr = len(args), seed.data_ptr()
        args += [seed.data_ptr(), tables.nbr.data_ptr(), tables.stride.data_ptr(),
                 tables.d2.data_ptr(), tables.g.data_ptr()]
        if move == "flip":
            args += [tables.mu.data_ptr(), tables.ncode.data_ptr()]
        body_ptrs, body_shape = _body_operands(tables)
        args += [*_ewald_pointers(tables), *body_ptrs, R, L, K, tables.g.shape[2]]
        if move == "flip":
            args.append(tables.mu.shape[1])
        args += [W, block_size]
        self.steps_slot = len(args)
        args += [0, RNG_MODES[rng], *body_shape]
        plan = launch_plan(move, tables, W, block_size, seqs[0].shape[-1], design=design)
        args += [plan.lanes, plan.walkers_per_block, int(plan.resident)]
        self.args = args + [stream]
        self.tables = tables
        self.rows, self.max_steps = len(seed), seqs[0].shape[-1]
        self.snap = None  # the window's snapshots where the caller gives none

    def launch(self, k, n_steps):
        """Launch ``n_steps`` steps on sequence row ``k`` and seed ``k``."""
        if not (0 <= k < self.rows and 0 <= n_steps <= self.max_steps):
            raise ValueError(
                f"{self.kernel.__name__}: launch {k} of {self.rows}, {n_steps} steps "
                f"of sequences of {self.max_steps}")
        args = self.args
        for slot, (base, row_bytes) in zip(self.seq_slots, self.seq_rows):
            args[slot] = base + k * row_bytes
        args[self.seed_slot] = self.seed_ptr + 8 * k
        args[self.steps_slot] = n_steps
        rc = self.entry(*args)
        _count_launch(self.kernel, self.tables)
        _launch_check(self.lib, self.kernel.__name__, rc)

    def window(self, n_steps, beta, uniforms, phase0, accepted, snap=None):
        """One cooperative launch of the flip kernel's window
        (``smol_flip_window``): every sequence row and seed a segment of
        ``n_steps`` steps, each followed by an exchange sweep of phase
        (``phase0`` + s) % 2 on row s of ``uniforms`` [n, W] f64, which
        exchanges ``beta`` [W] f64 with the f32 copy the chain reads and
        adds to ``accepted`` ([W] int32 or None).  ``snap``, a [2, 2, W]
        f64 buffer, holds the segments' snapshots (None: one the object
        allocates at its first window).  Counts on :func:`flip_window`; a
        launch that fails raises."""
        W = beta.shape[0]
        if self.kernel is not flip_chain:
            raise ValueError("the window runs flips only")
        for tensor, dtype, shape in ((beta, torch.float64, (W,)),
                                     (uniforms, torch.float64, (self.rows, W)),
                                     *(() if accepted is None else
                                       ((accepted, torch.int32, (W,)),))):
            if tensor.dtype != dtype or tuple(tensor.shape) != shape \
                    or not tensor.is_contiguous() or tensor.device != beta.device:
                raise ValueError(f"flip_window operand: expected contiguous {dtype} {shape} "
                                 f"on {beta.device}, got {tensor.dtype} "
                                 f"{tuple(tensor.shape)} on {tensor.device}")
        if not 0 <= n_steps <= self.max_steps:
            raise ValueError(f"flip_window: {n_steps} steps of sequences of {self.max_steps}")
        if snap is None:  # [2][2][W]: by segment parity, enthalpies then betas
            if self.snap is None:
                self.snap = _window_snapshot(W, beta.device)
            snap = self.snap
        if snap.dtype != torch.float64 or tuple(snap.shape) != (2, 2, W) \
                or not snap.is_contiguous() or snap.device != beta.device:
            raise ValueError(f"flip_window: a contiguous float64 (2, 2, {W}) snapshot on "
                             f"{beta.device}")
        self.window_operands = (beta, uniforms, accepted, snap)
        args = list(self.args)
        args[self.steps_slot] = n_steps
        seq_segment = self.seq_rows[0][1] // 4  # int32 elements a segment
        rc = self.lib.smol_flip_window(
            *args[:-1], beta.data_ptr(), snap.data_ptr(), uniforms.data_ptr(),
            None if accepted is None else accepted.data_ptr(), seq_segment, self.rows,
            int(phase0) % 2, args[-1])
        _count_launch(flip_window, self.tables)
        _launch_check(self.lib, "flip_window", rc)


def _align16(nbytes):
    return -(-nbytes // 16) * 16


def _row_set_bytes(tables):
    """Bytes of one rank's rows in shared memory: ``rows_bytes`` of
    chain_common.cuh, ``qrows_bytes`` for K3's character rows,
    ``irows_bytes`` for K1-Ising's parity rows."""
    ewald_row = tables.num_ranks if tables.has_ewald else 0
    if tables.ising:
        row_set = (tables.iamp.shape[1] * (tables.ising + 1) + ewald_row) * 8
    elif tables.qary:
        Lq, NB = tables.qnbr.shape[1:]
        row_set = Lq * 16 + ewald_row * 8 + Lq * (2 * NB + 1) * 4
    else:
        L, K = tables.nbr.shape[1:]
        row_set = L * tables.g.shape[2] * 8 + ewald_row * 8 + L * (2 * K + 1) * 4
    return _align16(row_set)


# ---- the flip, swap and table kernels' launch: lanes and resident rows ----

LANE_BLOCK_THREADS = 256  # most threads of a lane kernel's block: walkers x lanes
# a launch takes the fewest lanes that give it this many threads (at 8192
# walkers: 8 lanes), but a flip with the direct body half as many (4
# lanes): the fastest of 1-16 lanes on the cells of chip_smoke.py's sweeps
# on an H100 (flip_ab, lane_ab; PERF.md).  A swap or table move's direct
# body reads two or more ranks' rows a step, a flip's one.
LANE_THREADS = 65536
FLIP_DIRECT_LANE_THREADS = 32768
MAX_LANES = 16
# the card's limits on the blocks one SM holds at once (an H100 SXM: 132
# SMs, 2048 threads, 32 blocks and 228 KB of shared memory an SM, 1 KB of
# which each block reserves); registers are not counted
SM_COUNT = 132
SM_THREADS = 2048
SM_BLOCKS = 32
SM_SHARED_BYTES = 233472


@dataclass(frozen=True)
class _LaneDesign:
    """How the flip, swap or table kernel is launched: its threads per
    walker (None: :func:`launch_lanes` of the launch) and whether every
    rank's rows stay in shared memory (None: as :func:`launch_plan`
    decides).  Private: the A/B of ``chip_smoke.py`` and the tests choose
    one; users get the default."""

    lanes: int | None = None
    resident: bool | None = None


_FlipDesign = _LaneDesign  # the name K1's callers use
_FLIP_DESIGN = _LaneDesign()
_SWAP_DESIGN = _LaneDesign()
_TABLE_DESIGN = _LaneDesign()


def _design_of(move, design):
    """``design``, or the move's default (read at call time, so that a test
    may replace it)."""
    return design or {"flip": _FLIP_DESIGN, "swap": _SWAP_DESIGN, "table": _TABLE_DESIGN}[move]


@dataclass(frozen=True)
class LanePlan:
    """One flip, swap or table launch's shape: threads per walker, walkers
    per CUDA block, whether every rank's rows are resident in shared
    memory, and its dynamic shared memory in bytes."""

    lanes: int
    walkers_per_block: int
    resident: bool
    shared_bytes: int

    def blocks(self, W: int) -> int:
        return -(-W // self.walkers_per_block)


def launch_lanes(move, tables, W, design=None):
    """Threads per walker of a ``move`` launch of ``W`` walkers on
    ``tables``: the design's (None: the move's default), else the fewest
    (1, 2, 4, 8 or 16) that give the launch ``LANE_THREADS`` threads
    (``FLIP_DIRECT_LANE_THREADS`` for a flip with the direct body).  The
    lanes set the order of the delta's sums, and the twin takes the same
    lanes for the same launch."""
    design = _design_of(move, design)
    if design.lanes:
        return design.lanes
    threads = (FLIP_DIRECT_LANE_THREADS if (move, tables.delta) == ("flip", "direct")
               else LANE_THREADS)
    lanes = 1
    while lanes < MAX_LANES and W * lanes < threads:
        lanes *= 2
    return lanes


def twin_order(move, tables, W, design=None) -> dict:
    """The keyword arguments with which the ``move`` twin sums in the order
    of the kernel's launch of ``W`` walkers: its lanes."""
    return {"lanes": launch_lanes(move, tables, W, design)}


def flip_lanes(tables, W, design=None):
    """:func:`launch_lanes` of a flip launch."""
    return launch_lanes("flip", tables, W, design)


def _block_walkers(W, block_size, lanes):
    """Walkers of one CUDA block of a lane kernel: at most 64 and
    ``LANE_BLOCK_THREADS`` threads, and a block must lie inside one
    sequence group of ``block_size`` walkers, since its threads share the
    group's proposals."""
    wb = min(64, LANE_BLOCK_THREADS // lanes)
    return wb if W <= block_size or block_size % wb == 0 else gcd(block_size, wb)


def chain_shared_bytes(move, tables, walkers_per_block, resident, k_max=2):
    """Dynamic shared memory of one flip, swap or table launch, in bytes
    (``shared_bytes`` of its .cu file): every rank's rows (``resident``)
    or two buffers of a step's row sets (one rank's for a flip, u's and
    v's for a swap, ``k_max`` slots' for a table move), and the block's
    codes, one byte a walker at a padded pitch."""
    step_sets = {"flip": 1, "swap": 2, "table": k_max}[move]
    row_sets = tables.num_ranks if resident else 2 * step_sets
    pitch = -(-walkers_per_block // 4) * 4 + 4
    return row_sets * _row_set_bytes(tables) + _align16(tables.num_ranks * pitch)


def _waves(blocks, threads, smem):
    """Waves of ``blocks`` CUDA blocks of ``threads`` threads and ``smem``
    bytes of shared memory each over the card's SMs (inf: it does not fit)."""
    if smem > MAX_SHARED_BYTES:
        return float("inf")
    per_sm = min(SM_THREADS // threads, SM_BLOCKS, SM_SHARED_BYTES // (smem + 1024))
    return -(-blocks // (SM_COUNT * per_sm))


def launch_plan(move, tables, W, block_size, n_steps, k_max=2, design=None) -> LanePlan:
    """The ``move`` launch ("flip", "swap" or "table", whose moves
    recolor up to ``k_max`` sites) of ``W`` walkers for ``n_steps`` steps,
    from shapes only: the lanes of :func:`launch_lanes`, the walkers a
    block of :func:`_block_walkers`, every rank's rows resident where they
    fit beside the codes, the launch runs at least one step a rank (so
    that it copies no more rows than streaming them would: a 100-step
    window resident, bench tempering's 10-step segments on Au-Cu 3x3x3's
    27 ranks streamed, each the faster on an H100, PERF.md) and the rows'
    shared memory adds no wave of blocks over the SMs (Au-Cu 4x4x4's 115 KB
    of K1-Ising rows hold one block of 32 walkers an SM, 256 blocks in two
    waves, and ran 1.40x slower than streamed, PERF.md).  Raises where
    even the streamed rows do not fit, or where the design (None: the
    move's default) asks for what does not."""
    design = _design_of(move, design)
    lanes = launch_lanes(move, tables, W, design)
    wpb = _block_walkers(W, block_size, lanes)

    def nbytes(resident):
        return chain_shared_bytes(move, tables, wpb, resident, k_max)

    if design.resident is None:
        blocks, threads = -(-W // wpb), wpb * lanes
        resident = (n_steps >= tables.num_ranks
                    and _waves(blocks, threads, nbytes(True))
                    <= _waves(blocks, threads, nbytes(False)))
    else:
        resident = design.resident
    smem = nbytes(resident)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"{move}_chain needs {smem} bytes of shared memory per block ("
            f"{'every rank' if resident else 'two buffers of a step'} of {tables.delta} "
            f"rows of {_row_set_bytes(tables)} B and {tables.num_ranks} ranks of codes for "
            f"{wpb} walkers), above the card's {MAX_SHARED_BYTES}")
    return LanePlan(lanes, wpb, resident, smem)


def flip_launch_plan(tables, W, block_size, n_steps, design=None) -> LanePlan:
    """:func:`launch_plan` of a flip launch."""
    return launch_plan("flip", tables, W, block_size, n_steps, design=design)


# ---- K1's tempering window: a window's segments and exchanges in one launch ----

@dataclass(frozen=True)
class WindowPlan:
    """How a tempering window runs on the card: ``windowed``, all its
    segments and exchange sweeps in one cooperative launch of K1 of shape
    ``launch`` (``blocks`` blocks, of which the card holds
    ``resident_blocks`` at once), or segment by segment, a chain launch
    and an exchange launch a segment; ``reason`` says why."""

    windowed: bool
    reason: str
    launch: LanePlan | None = None
    blocks: int = 0
    resident_blocks: int = 0


@functools.lru_cache(maxsize=None)
def _window_blocks_per_sm(q, nw, ewald, K, NB, threads, smem, device_index):
    """Blocks of the window kernel one SM holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    lib = _build.load_chain("flip_chain")
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = lib.smol_flip_window_blocks_per_sm(q, nw, ewald, K, NB, threads, smem,
                                                ctypes.addressof(out))
    _launch_check(lib, "flip_window occupancy", rc)
    return out.value


def tempering_window_plan(tables, W, block_size, n_steps, segments, move="flip",
                          rng="philox", device=None, blocks_per_sm=None) -> WindowPlan:
    """How a tempering window of ``segments`` segments of ``n_steps``
    ``move`` steps of ``W`` walkers runs, decided once a window from shapes:
    in one cooperative launch of K1 (:func:`flip_window`) where the moves
    are flips, a segment is one chunk (any philox segment; a hash-mode
    segment of at most ``MAX_CHUNK_STEPS``) and every block of the launch
    (:func:`launch_plan` for the window's steps) is resident at once on the
    card (``blocks_per_sm``, else asked of the card on ``device``, the
    tables' by default); else segment by segment: swaps, table moves, a
    longer hash-mode segment, a grid that does not fit, and on the CPU,
    where the twins run."""
    if move != "flip":
        return WindowPlan(False, f"{move} moves run segment by segment")
    if rng == "hash" and n_steps > MAX_CHUNK_STEPS:
        return WindowPlan(False, f"a hash-mode segment of {n_steps} steps is "
                                 f"{-(-n_steps // MAX_CHUNK_STEPS)} chunks")
    device = torch.device(device) if device is not None else tables.device
    if blocks_per_sm is None and device.type != "cuda":
        return WindowPlan(False, f"the twins run on the {device.type} segment by segment")
    launch = launch_plan("flip", tables, W, block_size, segments * n_steps)
    blocks = launch.blocks(W)
    sms = SM_COUNT
    if blocks_per_sm is None:
        q, _, NB, _, NW = _body_operands(tables)[1]
        index = device.index if device.index is not None else torch.cuda.current_device()
        blocks_per_sm = _window_blocks_per_sm(
            q, NW, int(tables.has_ewald), tables.nbr.shape[2], NB,
            launch.walkers_per_block * launch.lanes, launch.shared_bytes, index)
        sms = torch.cuda.get_device_properties(index).multi_processor_count
    resident = blocks_per_sm * sms
    if blocks > resident:
        return WindowPlan(False, f"{blocks} blocks, of which the card holds {resident} "
                                 "at once", launch, blocks, resident)
    return WindowPlan(True, "one cooperative launch a window", launch, blocks, resident)


def _window_snapshot(W, device):
    """The [2, 2, W] f64 snapshots of a window of ``W`` walkers: by segment
    parity, the walkers' enthalpies, then their betas."""
    return torch.empty((2, 2, W), dtype=torch.float64, device=device)


def _window_launches(plan, occ, enthalpy, naccept, beta32, seqs, seeds, tables, block_size,
                     rng):
    """The window's launch object on ``plan``'s shape; raises where the
    plan runs the window segment by segment."""
    if not plan.windowed:
        raise ValueError(f"flip_window: the plan runs this window segment by segment "
                         f"({plan.reason})")
    return ChainLaunches("flip", occ, enthalpy, (naccept,), beta32, (seqs,), seeds, tables,
                         block_size, rng, _LaneDesign(plan.launch.lanes, plan.launch.resident))


def flip_window(occ, enthalpy, naccept, beta, beta32, seqs, seeds, tables, n_steps,
                block_size, uniforms, phase0, accepted=None, rng="philox"):
    """A tempering window of flips, in place: segment s runs ``n_steps``
    flips (:func:`flip_chain`) on sequence row ``seqs[s]`` ([n, G, >=
    n_steps] int32) and seed ``seeds[s]`` ([n] int64), then an exchange
    sweep of phase (``phase0`` + s) % 2 on ``uniforms[s]`` ([n, W] f64),
    which exchanges ``beta`` [W] f64 and its f32 copy ``beta32`` (what the
    flips read) and adds the accepted exchanges to ``accepted`` ([W]
    int32, at each pair's left member) where given.

    CUDA tensors only: one cooperative launch of K1's window
    (``flip_window.launches`` counts the launches, ``qary_launches`` and
    ``ising_launches`` those of the q-ary and Ising bodies) as
    :func:`tempering_window_plan` shapes it; raises where the plan does
    not take the window.  The window's plain twin is the tempering chain
    segment by segment (:func:`flip_chain_reference`, then
    :func:`~smol_tpu_torch.parallel.tempering.exchange_betas_reference`),
    which is how a CPU tensor runs it
    (:func:`~smol_tpu_torch.parallel.tempering.make_tempering_chain`).
    """
    if occ.device.type != "cuda":
        raise ValueError(f"flip_window runs on cuda, not {occ.device}: elsewhere a "
                         "tempering window runs segment by segment")
    plan = tempering_window_plan(tables, occ.shape[1], block_size, n_steps, len(seeds),
                                 rng=rng, device=occ.device)
    _window_launches(plan, occ, enthalpy, naccept, beta32, seqs, seeds, tables, block_size,
                     rng).window(n_steps, beta, uniforms, phase0, accepted)


flip_window.launches = 0
flip_window.qary_launches = 0  # of the launches, those with K3's q-ary body
flip_window.ising_launches = 0  # of the launches, those with K1-Ising's body


def table_chain(occ, enthalpy, naccept, beta32, dirs, ranks, seed, tables,
                table_move, n_steps, block_size, rng="philox", _design=None):
    """Run ``n_steps`` shared-proposal table moves on every walker, in place.

    Arguments as :func:`flip_chain`, with the direction rows ``dirs``
    [G, >= n_steps] int32 and the slot ranks ``ranks`` [G, >= n_steps,
    k_max] int32 in place of ``seq``, and the :class:`TableMove` of the
    same tables; the tables' site body is the kernel's.  A CUDA tensor
    launches the kernel (``table_chain.launches`` counts the launches,
    ``table_chain.qary_launches`` and ``table_chain.ising_launches`` those
    with the q-ary and the Ising body) as :func:`launch_plan` shapes it,
    planned once per call; a CPU tensor runs :func:`table_chain_reference`
    in the order the kernel would sum (:func:`twin_order`).  ``_design``
    (private; None: ``_TABLE_DESIGN``) as for :func:`flip_chain`.
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
    R, W = occ.shape
    if occ.device.type == "cpu":
        table_chain_reference(occ, enthalpy, naccept, beta32, dirs, ranks, seed,
                              tables, table_move, n_steps, block_size, rng,
                              **twin_order("table", tables, W, _design))
        return
    if occ.device.type != "cuda":
        raise ValueError(f"table_chain runs on cuda or cpu, not {occ.device}")
    if rng not in RNG_MODES:
        raise ValueError(f"unknown rng mode: {rng!r}")
    L, K = tables.nbr.shape[1:]
    plan = launch_plan("table", tables, W, block_size, n_steps, k_max, _design)
    lib = _build.load_chain("table_chain")
    body_ptrs, body_shape = _body_operands(tables)
    with torch.cuda.device(occ.device):
        stream = torch.cuda.current_stream(occ.device).cuda_stream
        rc = lib.smol_table_chain(
            occ.data_ptr(), enthalpy.data_ptr(), naccept.data_ptr(),
            beta32.data_ptr(), dirs.data_ptr(), ranks.data_ptr(),
            dirs.stride(0), ranks.stride(0), seed.data_ptr(),
            tables.nbr.data_ptr(), tables.stride.data_ptr(),
            tables.d2.data_ptr(), tables.g.data_ptr(), tables.mu.data_ptr(),
            rows.data_ptr(), *_ewald_pointers(tables), *body_ptrs, R, L, K,
            tables.g.shape[2], tables.mu.shape[1], W, block_size, n_steps,
            RNG_MODES[rng], k_max, table_move.n_dirs + 2, *body_shape, plan.lanes,
            plan.walkers_per_block, int(plan.resident), stream,
        )
    _count_launch(table_chain, tables)
    _launch_check(lib, "table_chain", rc)


table_chain.launches = 0
table_chain.qary_launches = 0  # of the launches, those with K3's q-ary body
table_chain.ising_launches = 0  # of the launches, those with K1-Ising's body


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


# ---- the kernel's launch: lanes, resident rows and planes ----

WL_THREADS = LANE_BLOCK_THREADS  # most threads of a Wang-Landau block (kWLThreads)
WL_LANE_THREADS = 32768  # a launch takes the fewest lanes that give it this many threads
WL_MAX_LANES = 16
WL_PLANES = ("global", "entropy")  # what the block keeps in shared memory


@dataclass(frozen=True)
class _WLDesign:
    """How the Wang-Landau kernel is launched: its threads per walker (None:
    :func:`wl_lanes` of the launch's walkers), whether every rank's rows
    stay in shared memory (None: wherever they fit), and whether the block
    keeps the entropy in shared memory (an index into ``WL_PLANES``; None:
    wherever it fits).  Private: the A/B of
    ``chip_smoke.py`` and the tests choose one; users get the default."""

    lanes: int | None = None
    resident: bool | None = None
    planes: int | None = None


_WL_DESIGN = _WLDesign()
_WL_OLD_DESIGN = _WLDesign(lanes=1, resident=False, planes=0)


@dataclass(frozen=True)
class WLPlan:
    """One Wang-Landau launch's shape: threads per walker, walkers per
    CUDA block, whether every rank's rows are resident, whether the block
    keeps the entropy in shared memory (``WL_PLANES``), and its dynamic shared
    memory in bytes."""

    lanes: int
    walkers_per_block: int
    resident: bool
    planes: int
    shared_bytes: int

    def blocks(self, W: int) -> int:
        return -(-W // self.walkers_per_block)


def wl_lanes(W, design=None):
    """Threads per walker of a launch of ``W`` walkers: the design's (None:
    ``_WL_DESIGN``), else the fewest (1, 2, 4, 8 or 16) that give the
    launch ``WL_LANE_THREADS`` threads (bench ``wang-landau``'s 2048
    walkers: 16, which beat 2, 4 and 8 on both cells and bodies on an
    H100, ``PERF.md``).  The lanes set the order of the delta's sums, and
    the twin takes the same lanes for the same walkers."""
    design = design or _WL_DESIGN
    if design.lanes:
        return design.lanes
    lanes = 1
    while lanes < WL_MAX_LANES and W * lanes < WL_LANE_THREADS:
        lanes *= 2
    return lanes


def wl_block_walkers(W, block_size, design=None):
    """Walkers of one CUDA block: a block must lie inside one sequence group
    of ``block_size`` walkers, since its threads share the group's proposals."""
    return _block_walkers(W, block_size, wl_lanes(W, design))


def wl_chain_shared_bytes(tables, move, num_levels, walkers_per_block, resident, planes):
    """Dynamic shared memory of one Wang-Landau launch, in bytes
    (``shared_bytes`` of wl_chain.cu): every rank's rows (``resident``) or
    two buffers of the step's row sets (two for a swap), the entropy where
    the block keeps it (``[walker][B | 1]``, 8 bytes a cell) and the block's
    codes."""
    row_sets = tables.num_ranks if resident else (4 if move == "swap" else 2)
    plane_bytes = _align16(8 * (num_levels | 1) * walkers_per_block) if planes else 0
    pitch = -(-walkers_per_block // 4) * 4 + 4
    return (row_sets * _row_set_bytes(tables) + plane_bytes
            + _align16(tables.num_ranks * pitch))


def wl_launch_plan(tables, W, block_size, move, num_levels, design=None) -> WLPlan:
    """The launch of ``W`` walkers: the design's lanes and walkers per
    block; every rank's rows resident where they fit beside the codes; then
    the entropy in shared memory where it fits beside both (on an H100,
    ``PERF.md``, ``chip_smoke.py``'s ``wl_ab``, it was faster on three of
    the four cells and bodies and level on the fourth).  Raises where even
    the streamed rows and global planes do not fit, or where the design
    (None: ``_WL_DESIGN``) asks for what does not."""
    design = design or _WL_DESIGN
    lanes = wl_lanes(W, design)
    wpb = wl_block_walkers(W, block_size, design)

    def fits(resident, planes):
        smem = wl_chain_shared_bytes(tables, move, num_levels, wpb, resident, planes)
        return smem <= MAX_SHARED_BYTES

    resident = fits(True, 0) if design.resident is None else design.resident
    if design.planes is None:
        planes = int(fits(resident, 1))
    else:
        planes = design.planes
    if not fits(resident, planes):
        smem = wl_chain_shared_bytes(tables, move, num_levels, wpb, resident, planes)
        raise ValueError(
            f"wl_chain needs {smem} bytes of shared memory per block, above the "
            f"card's {MAX_SHARED_BYTES}")
    return WLPlan(lanes, wpb, resident, planes,
                  wl_chain_shared_bytes(tables, move, num_levels, wpb, resident, planes))


# ---- the twin ----

def wl_step_reference(tables: ChainTables, wl: WLChain, occ, ranks, r_u, r_j,
                      enthalpy, entropy, s_cur, move="flip", lanes=1):
    """One Wang-Landau proposal for every walker, without applying it.

    ``occ`` [R, W] int8 codes (left as it was), ``ranks`` the proposal
    ranks ``(u,)`` of a flip or ``(u, v)`` of a swap, [W] each, ``r_u`` /
    ``r_j`` [W] random bits, ``enthalpy`` [W] f64, ``entropy`` [B, W] f64
    and ``s_cur`` [W] f64 the entropy of each walker's current bin.
    Returns ``(accept, is_move, a, b, dE, w_new, b_new, expo, log_u,
    in_win)``: u holds a and takes b (for a swap v holds b and takes a);
    the proposal and dE are :func:`flip_step_reference`'s and
    :func:`swap_step_reference`'s (:func:`_flip_proposal`,
    :func:`_swap_proposal`), dE summed as the kernel's ``lanes`` lanes sum
    it (at one lane, in their order); ``expo`` is the f32 exponent
    S[b_cur] - S[b_new] and ``log_u`` the f32 log uniform it is compared
    with.
    """
    W = occ.shape[1]
    walkers = torch.arange(W, device=occ.device)
    ranks = [r.long() for r in ranks]
    if move == "swap":
        a, b, dE = _swap_proposal(tables, occ, *ranks, lanes)
        is_move = a != b
    else:
        a, b, dE = _flip_proposal(tables, occ, ranks[0], r_j, lanes)
        is_move = torch.ones(W, dtype=torch.bool, device=occ.device)
    log_u = torch.log(uniform01_from_bits(r_u))
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
                       bin_margin=None, lanes=None):
    """Plain torch twin of the CUDA Wang-Landau chain kernel (same arguments).

    Updates ``occ``, ``enthalpy``, ``naccept``, the planes ``entropy``,
    ``histogram``, ``occurrences`` [B, W], ``mod_factor`` and
    ``wl_counter`` in place.  Each delta sums as the kernel's ``lanes``
    lanes sum it (None: :func:`wl_lanes` of the walkers, the kernel's
    default).  ``margin``, an optional [W] f32 tensor, is
    lowered to each walker's closest decision, |x - log U| in f32 ulps of
    log U (proposals outside the window and null swaps, decided
    regardless, do not count).  ``bin_margin``, an optional [W] tensor, is
    lowered to the least distance from a bin edge, in f32 ulps of the
    window coordinate, of the walker's coordinate at the launch's start
    and of every non-null proposal's.
    """
    W = occ.shape[1]
    lanes = lanes or wl_lanes(W)
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
            tables, wl, occ, ranks, r_u[i], r_j[i], enthalpy, entropy, s_cur, move, lanes)
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


def wl_chain(occ, enthalpy, naccept, entropy, histogram, occurrences,
             mod_factor, wl_counter, seqs, seed, tables, wl, n_steps,
             block_size, move="flip", rng="philox", _design=None):
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

    The tables' site body is the kernel's.  A CUDA tensor launches the
    kernel (``wl_chain.launches`` counts the launches,
    ``wl_chain.qary_launches`` and ``wl_chain.ising_launches`` those with
    the q-ary and the Ising body) as :func:`wl_launch_plan` shapes it; a
    CPU tensor runs :func:`wl_chain_reference` at the lanes the kernel
    would take.  ``_design`` (private; None: ``_WL_DESIGN``) picks another
    launch for the A/B of ``chip_smoke.py`` and the tests.
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
                           block_size, move, rng, lanes=wl_lanes(W, _design))
        return
    if occ.device.type != "cuda":
        raise ValueError(f"wl_chain runs on cuda or cpu, not {occ.device}")
    if rng not in RNG_MODES:
        raise ValueError(f"unknown rng mode: {rng!r}")
    R = occ.shape[0]
    L, K = tables.nbr.shape[1:]
    plan = wl_launch_plan(tables, W, block_size, move, wl.num_levels, _design)
    lib = _build.load_chain("wl_chain")
    vseq = seqs[1] if move == "swap" else seqs[0]
    body_ptrs, body_shape = _body_operands(tables)
    with torch.cuda.device(occ.device):
        stream = torch.cuda.current_stream(occ.device).cuda_stream
        rc = lib.smol_wl_chain(
            occ.data_ptr(), enthalpy.data_ptr(), naccept.data_ptr(),
            entropy.data_ptr(), histogram.data_ptr(), occurrences.data_ptr(),
            mod_factor.data_ptr(), wl_counter.data_ptr(), seqs[0].data_ptr(),
            vseq.data_ptr(), seqs[0].stride(0), seed.data_ptr(),
            tables.nbr.data_ptr(), tables.stride.data_ptr(),
            tables.d2.data_ptr(), tables.g.data_ptr(), tables.mu.data_ptr(),
            tables.ncode.data_ptr(), *_ewald_pointers(tables), *body_ptrs, R, L, K,
            tables.g.shape[2], tables.mu.shape[1], W, block_size, n_steps,
            RNG_MODES[rng], MOVES.index(move), wl.num_levels, wl.check_period,
            wl.update_period, *body_shape, plan.lanes, plan.walkers_per_block,
            int(plan.resident), plan.planes, wl.min_enthalpy, wl.bin_size, wl.span,
            wl.mod_divisor, wl.flatness, stream,
        )
    _count_launch(wl_chain, tables)
    _launch_check(lib, "wl_chain", rc)


wl_chain.launches = 0
wl_chain.qary_launches = 0  # of the launches, those with K3's q-ary body
wl_chain.ising_launches = 0  # of the launches, those with K1-Ising's body


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

    ``fn(state, generator, segments=k, between=cb)`` (the Metropolis
    chains) runs k segments of ``n_steps`` in one call, as k calls of
    ``fn`` would, and calls ``cb(s, beta32)`` after segment s: the
    sequences and seeds of all k segments are drawn at once (in hash mode
    with injected ``seqs`` [k * n_chunks, G, chunk] and ``seeds`` [k *
    n_chunks], or with a leading segment axis), the occupancy is gathered
    once, and between segments only the kernels are launched, with no host
    wait.  ``beta32`` [W] f32 is what the chain reads, which ``cb`` may
    change in place together with ``state["beta"]`` (replica exchange,
    :func:`smol_tpu_torch.parallel.tempering.make_tempering_chain`).
    ``exchange=(uniforms, phase0, accepted)`` gives the exchange sweeps
    that ``cb`` runs: uniforms [k, W] f64, the first sweep's phase and the
    [W] int32 count of accepted exchanges (or None).  Where
    :func:`tempering_window_plan` takes the window (flips on the card, one
    chunk a segment, a co-resident grid; planned at the first window of a
    walker count and kept), the k segments and sweeps run in one launch of
    K1 (:func:`flip_window`) and ``cb`` is not called.  Without
    ``exchange`` the segments run one launch each with ``cb`` between.
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

    windows = {}  # (W, segments, device) -> the window's plan and snapshots

    def window_of(W, segments, device):
        """The plan of a tempering window, decided at its first use, and its
        snapshots where the plan takes the window in one launch."""
        key = (W, segments, device)
        if key not in windows:
            plan = tempering_window_plan(tables, W, block_size, n_steps, segments, move,
                                         rng, device)
            windows[key] = plan, (_window_snapshot(W, device) if plan.windowed else None)
        return windows[key]

    def fn(state, generator, segments=1, between=None, exchange=None):
        if segments != 1 and wl is not None:
            raise ValueError("segments are defined for the Metropolis chains")
        occu = state["occupancy"]
        W = occu.shape[0]
        device = occu.device
        groups = -(-W // block_size)
        launches = segments * n_chunks
        shape = (launches, groups, chunk)
        if seqs is not None:
            pair = swap or table
            seq = [as_seq(s, device) for s in seqs] if pair else [as_seq(seqs, device)]
            # a leading segment axis, or none (a table move's ranks have one
            # axis more than its directions)
            seq = [x.flatten(0, 1) if x.dim() == 4 + (table and i == 1) else x
                   for i, x in enumerate(seq)]
        elif table:
            seq = list(table_sequences(tables, table_move, generator, shape))
        elif swap:
            seq = list(rank_pair_sequence(tables, generator, shape))
        elif proposal_mode == "sweep":
            sched = sweep_schedule(tables.num_ranks, n_chunks * chunk)
            sched = torch.as_tensor(sched, device=device).reshape(n_chunks, 1, chunk)
            seq = [sched.repeat(segments, 1, 1).expand(shape)]
        else:
            seq = [rank_sequence(tables, generator, shape)]
        seq = [s.contiguous() for s in seq]  # kept until the last launch
        if seeds is not None:
            seed = torch.as_tensor(np.asarray(seeds), dtype=torch.int64,
                                   device=device).reshape(launches)
        elif rng == "hash":
            seed0 = torch.randint(0, 2**30 - 1, (segments, 1), generator=generator,
                                  device=device, dtype=torch.int64)
            seed = _wrap_int32(
                seed0 + torch.arange(n_chunks, device=device) * SEED_STRIDE
            ).reshape(launches)
        else:
            seed = torch.randint(0, 2**63 - 1, (launches,), generator=generator,
                                 device=device, dtype=torch.int64)

        occ = occu[:, rank_sites].T.to(torch.int8).contiguous()  # [R, W]
        nacc = torch.zeros(W, dtype=torch.int32, device=device)
        nmv = torch.zeros(W, dtype=torch.int32, device=device)
        launcher = None
        if wl is not None:
            plane_names = ("entropy", "histogram", "occurrences")
            planes = [state[name].T.contiguous() for name in plane_names]  # [B, W]
        else:
            beta32 = state["beta"].to(torch.float32)
            plan, snap = (window_of(W, segments, device)
                          if exchange is not None and device.type == "cuda" else (None, None))
            if plan is not None and plan.windowed:
                _window_launches(plan, occ, state["enthalpy"], nacc, beta32, seq[0], seed,
                                 tables, block_size, rng).window(n_steps, state["beta"],
                                                                 *exchange, snap)
                launches = 0  # the window ran in one launch
            elif device.type == "cuda" and not table:  # checked once per window
                launcher = ChainLaunches(
                    move, occ, state["enthalpy"], (nacc, nmv) if swap else (nacc,),
                    beta32, seq, seed, tables, block_size, rng)
        for k in range(launches):
            c = k % n_chunks
            steps = min(chunk, n_steps - c * chunk)
            seed_c = seed[k: k + 1]
            seq_c = [s[k] for s in seq] if launcher is None else None
            if launcher is not None:
                launcher.launch(k, steps)
            elif wl is not None:
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
            if between is not None and c == n_chunks - 1:
                between(k // n_chunks, beta32)
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
