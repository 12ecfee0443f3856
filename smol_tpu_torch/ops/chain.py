"""Shared-proposal single-flip Metropolis chain.

Counterpart of ``smol_tpu/ops/pallas_chain.py`` for ``move="flip"``
(``build_chain_tables`` :841, ``rank_sequence`` :1142,
``make_shared_proposal_chain`` :1439).  The statistical contract is the
reference's: the proposal sites follow an exogenous sequence shared by
the walkers of one block (``block_size``), every other draw is per walker,
and each walker is an exact Metropolis chain.  ``proposal_mode="sweep"``
replaces the random sequence with one fixed permutation of the active
ranks, repeated, so that the walkers are fully independent.

The chain runs in :func:`flip_chain`: on a CUDA tensor it launches the
hand-written kernel ``csrc/flip_chain.cu``; on a CPU tensor it runs
:func:`flip_chain_reference`, the plain torch twin that does the same
arithmetic in the same order.

Tables hold the rank layout of the reference (rank = position in the
concatenated active sites of the active sublattices) on plain f64
lookups; nothing of the TPU layout (bf16 gather rows, double-float splits,
L segments, Ising or q-ary character tables) is kept.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from smol_tpu_torch.ops import _build
from smol_tpu_torch.ops.rng import hash_bits, philox4x32_10, uniform01_from_bits

__all__ = [
    "ChainTables",
    "build_chain_tables",
    "rank_sequence",
    "sweep_schedule",
    "chain_draws",
    "flip_step_reference",
    "flip_chain_reference",
    "flip_chain",
    "make_shared_proposal_chain",
]

MAX_CHUNK_STEPS = 2048  # the reference's step chunk (hash-mode parity)
SEED_STRIDE = 999983  # hash mode: seed of chunk c = seed0 + c * SEED_STRIDE
BLOCK_SEED_STRIDE = 7919  # hash mode: block seed = chunk seed + block * 7919
SWEEP_SEED = 0x5EED  # seed of the sweep schedule's fixed permutation
RNG_MODES = {"philox": 0, "hash": 1}


@dataclass(frozen=True)
class ChainTables:
    """Static operands of the flip chain, on one device.

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

    @property
    def num_ranks(self) -> int:
        return int(self.nbr.shape[0])

    @property
    def device(self) -> torch.device:
        return self.g.device


def build_chain_tables(processor, sublattices, mu_table=None,
                       sublattice_probabilities=None) -> ChainTables:
    """Chain tables of a processor's local clusters, on its device.

    Requirements, as in the reference: active sublattices with default
    (arange) encodings and no restricted sites, and every non-self slot of
    a local cluster on an active site or on a single-code (code 0) site.
    Raises ``NotImplementedError`` otherwise.
    """
    sites3 = processor.local_sites
    strides3 = processor.local_strides
    d2 = processor.local_d2
    g3 = processor.local_g
    n = sites3.shape[0]

    active = [s for s in sublattices if s.is_active]
    if not active:
        raise NotImplementedError("no active sublattice: nothing to flip")
    for s in active:
        if not np.array_equal(s.encoding, np.arange(len(s.encoding))):
            raise NotImplementedError("non-default sublattice encodings")
        if len(s.active_sites) != len(s.sites):
            raise NotImplementedError("sublattices with restricted sites")
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

    device = processor.device

    def dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

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
    )


def rank_sequence(tables: ChainTables, generator, shape) -> torch.Tensor:
    """A state-independent proposal rank sequence of ``shape``, int32.

    The sublattice follows the sublattice probabilities and the site is
    uniform within it: the reference Flip usher's proposal distribution.
    Drawn on the tables' device from ``generator``.
    """
    device = tables.device
    cum = torch.as_tensor(tables.cum_probs, device=device)
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float64)
    sl = (cum <= u[..., None]).sum(dim=-1).clamp(max=len(cum) - 1)
    n_act = torch.as_tensor(tables.n_active, device=device)[sl]
    off = torch.as_tensor(tables.sub_offset, device=device)[sl]
    v = torch.rand(shape, generator=generator, device=device, dtype=torch.float64)
    site = torch.minimum((v * n_act).long(), n_act - 1)
    return (off + site).to(torch.int32)


def sweep_schedule(num_ranks: int, n_steps: int) -> np.ndarray:
    """The deterministic sweep: one fixed permutation of the ranks, repeated."""
    perm = np.random.default_rng(SWEEP_SEED).permutation(num_ranks)
    return np.resize(perm, n_steps).astype(np.int32)


def _wrap_int32(x):
    return ((x + 2**31) % 2**32) - 2**31


def chain_draws(rng: str, seed: int, n_steps: int, num_walkers: int,
                block_size: int, device):
    """Random bits of one chain launch: (r_u, r_j), int64 [n_steps, W].

    ``r_u`` feeds the acceptance uniform and ``r_j`` the proposed code;
    both are 31-bit.  ``"hash"`` reproduces the reference's interpret-mode
    hash (lane = w % block_size, block seed = seed + block * 7919);
    ``"philox"`` is Philox4x32-10 with key (seed low word, walker) and
    counter (step, seed high word, 0, 0).  The CUDA kernel draws the same.
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


def flip_step_reference(tables: ChainTables, occ, u, r_u, r_j, beta32):
    """One flip proposal for every walker, without applying it.

    ``occ`` [R, W] int8 codes, ``u`` [W] proposal ranks, ``r_u``/``r_j``
    [W] random bits, ``beta32`` [W] f32.  Returns ``(accept, b, dE, expo,
    log_u)``: the decision, the proposed codes, the f64 enthalpy change and
    the f32 exponent and log uniform it was decided on.
    """
    walkers = torch.arange(occ.shape[1], device=occ.device)
    u = u.long()
    a = occ[u, walkers].long()
    nc = torch.clamp(tables.ncode[u].long() - 1, min=1)
    j = r_j % nc
    b = j + (j >= a).long()

    nb = tables.nbr[u].long()  # [W, L, K]
    codes = occ[nb.clamp(min=0), walkers[:, None, None]].long()
    d2 = tables.d2[u].long()  # [W, L]
    t = d2 * a[:, None] + (tables.stride[u].long() * codes).sum(dim=-1)
    tn = t + d2 * (b - a)[:, None]
    g_u = tables.g[u]  # [W, L, TM]
    terms = g_u.gather(2, tn[..., None])[..., 0] - g_u.gather(2, t[..., None])[..., 0]
    dE = torch.zeros(occ.shape[1], dtype=torch.float64, device=occ.device)
    for l in range(terms.shape[1]):  # the kernel's summation order
        dE = dE + terms[:, l]
    dE = dE - (tables.mu[u, b] - tables.mu[u, a])

    log_u = torch.log(uniform01_from_bits(r_u))
    expo = -beta32 * dE.to(torch.float32)
    accept = (expo >= 0) | (expo > log_u)
    return accept, b, dE, expo, log_u


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
            ulp = (torch.nextafter(log_u, log_u.new_tensor(-float("inf"))) - log_u).abs()
            torch.minimum(margin, (expo - log_u).abs() / ulp, out=margin)
        occ[u, walkers] = torch.where(accept, b, occ[u, walkers].long()).to(occ.dtype)
        enthalpy += torch.where(accept, dE, torch.zeros_like(dE))
        naccept += accept.to(naccept.dtype)


def _check_operands(occ, enthalpy, naccept, beta32, seq, seed, tables,
                    n_steps, block_size):
    R, W = occ.shape
    expect = (
        (occ, torch.int8, (tables.num_ranks, W)),
        (enthalpy, torch.float64, (W,)),
        (naccept, torch.int32, (W,)),
        (beta32, torch.float32, (W,)),
        (seed, torch.int64, (1,)),
    )
    for tensor, dtype, shape in expect:
        if tensor.dtype != dtype or tuple(tensor.shape) != shape:
            raise ValueError(
                f"flip_chain operand: expected {dtype} {shape}, got "
                f"{tensor.dtype} {tuple(tensor.shape)}"
            )
    groups = -(-W // block_size)
    if block_size < 1 or seq.dtype != torch.int32 or seq.dim() != 2 \
            or seq.shape[0] != groups or seq.shape[1] < n_steps:
        raise ValueError(
            f"flip_chain sequence: expected int32 [{groups}, >={n_steps}], got "
            f"{seq.dtype} {tuple(seq.shape)}"
        )
    operands = (occ, enthalpy, naccept, beta32, seq, seed, tables.g)
    if any(t.device != occ.device for t in operands):
        raise ValueError("flip_chain operands lie on different devices")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("flip_chain operands must be contiguous")


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
    _check_operands(occ, enthalpy, naccept, beta32, seq, seed, tables,
                    n_steps, block_size)
    if occ.device.type == "cpu":
        flip_chain_reference(occ, enthalpy, naccept, beta32, seq, seed,
                             tables, n_steps, block_size, rng)
        return
    if occ.device.type != "cuda":
        raise ValueError(f"flip_chain runs on cuda or cpu, not {occ.device}")
    if rng not in RNG_MODES:
        raise ValueError(f"unknown rng mode: {rng!r}")
    lib = _build.load_flip_chain()
    R, W = occ.shape
    L, K = tables.nbr.shape[1:]
    with torch.cuda.device(occ.device):
        stream = torch.cuda.current_stream(occ.device).cuda_stream
        rc = lib.smol_flip_chain(
            occ.data_ptr(), enthalpy.data_ptr(), naccept.data_ptr(),
            beta32.data_ptr(), seq.data_ptr(), seq.stride(0), seed.data_ptr(),
            tables.nbr.data_ptr(), tables.stride.data_ptr(),
            tables.d2.data_ptr(), tables.g.data_ptr(), tables.mu.data_ptr(),
            tables.ncode.data_ptr(), R, L, K, tables.g.shape[2],
            tables.mu.shape[1], W, block_size, n_steps, RNG_MODES[rng],
            stream,
        )
    flip_chain.launches += 1
    if rc != 0:
        raise RuntimeError(
            "flip_chain kernel launch failed: "
            + lib.smol_cuda_error_string(rc).decode()
        )


flip_chain.launches = 0


def make_shared_proposal_chain(tables: ChainTables, n_steps: int,
                               block_size: int = 1024,
                               proposal_mode: str = "random",
                               rng: str = "philox", seqs=None, seeds=None):
    """Build ``fn(state, generator) -> state`` running ``n_steps`` flips.

    ``state`` holds ``occupancy`` [W, N] int32, ``enthalpy`` [W] f64,
    ``beta`` [W] f64, ``naccept`` [W] int32 and ``accepted`` [W] bool, and
    optionally ``window_naccept`` [W] int32; ``fn`` updates these tensors
    in place and returns the state.  ``generator`` is a
    ``torch.Generator`` on the state's device for the site sequence and
    the launch seeds.

    ``rng="hash"`` reproduces the reference interpret-mode chain: the
    steps run in chunks of at most 2048 with the step counted within the
    chunk and chunk seeds ``seed0 + c * 999983``.  ``seqs``
    [n_chunks, G, chunk] and ``seeds`` [n_chunks] replace the draws (the
    tests pass the reference's own draws); in ``"philox"`` mode a window
    is one chunk.
    """
    if proposal_mode not in ("random", "sweep"):
        raise ValueError(f"unknown proposal mode: {proposal_mode!r}")
    if rng not in RNG_MODES:
        raise ValueError(f"unknown rng mode: {rng!r}")
    chunk = min(n_steps, MAX_CHUNK_STEPS) if rng == "hash" else n_steps
    n_chunks = -(-n_steps // chunk)
    rank_sites = tables.rank_sites

    def fn(state, generator):
        occu = state["occupancy"]
        W = occu.shape[0]
        device = occu.device
        groups = -(-W // block_size)
        if seqs is not None:
            seq = torch.as_tensor(np.asarray(seqs), dtype=torch.int32, device=device)
        elif proposal_mode == "sweep":
            sched = sweep_schedule(tables.num_ranks, n_chunks * chunk)
            seq = torch.as_tensor(sched, device=device).reshape(n_chunks, 1, chunk)
            seq = seq.expand(n_chunks, groups, chunk)
        else:
            seq = rank_sequence(tables, generator, (n_chunks, groups, chunk))
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
        beta32 = state["beta"].to(torch.float32)
        nacc = torch.zeros(W, dtype=torch.int32, device=device)
        for c in range(n_chunks):
            flip_chain(
                occ, state["enthalpy"], nacc, beta32, seq[c].contiguous(),
                seed[c: c + 1].contiguous(), tables,
                min(chunk, n_steps - c * chunk), block_size, rng,
            )
        occu[:, rank_sites] = occ.T.to(occu.dtype)
        state["naccept"] += nacc
        state["accepted"] = nacc > 0  # coarse: any accept in the window
        if "window_naccept" in state:
            state["window_naccept"] += nacc
        return state

    return fn
