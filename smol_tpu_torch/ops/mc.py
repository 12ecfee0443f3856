"""The per-step Monte Carlo path, and the thinning-window loops.

Counterpart of ``smol_tpu/ops/mc.py``.  The reference scans its steps
inside one jitted program (``lax.scan`` over ``jax.vmap``-ed walkers);
here each step is plain torch ops on tensors of all walkers [W, ...], on
the device the occupancies live on, drawing from one ``torch.Generator``.
The step loop is a Python loop that never waits for the device: no
``.item()``, no host copy and no branch on a device value inside a
thinning window.

- :func:`sublattice_tables`: the active sublattices as padded tensors.
- proposals, ``propose(occu [W, N], generator) -> (sites [W, S],
  codes [W, S], valid [W, S], log_priori)``: :func:`flip_proposal`,
  :func:`swap_proposal`, :func:`multistep_proposal`,
  :func:`composite_proposal` and :func:`table_flip_proposal` (bind their
  tables with ``functools.partial``), and the table flip's a-priori factor
  :func:`table_flip_log_priori`.
- :func:`make_step_applier`: the S flips applied in sequence against the
  evolving occupancy, with the enthalpy change (and the feature change).
- :func:`make_metropolis_step`, :func:`make_uniform_step`,
  :func:`make_wang_landau_step`: the kernels' steps over the walker state.
- :func:`run_chain` (the per-step path, windows of :func:`step_window`)
  and :func:`run_chain_fused` (the hand-written chains, one call a
  window): windows and their records.

The reference's TPU gather workarounds (``sel_row``, ``sel_vec``,
``set_vec``, the compare-sum ``searchsorted_right``) have no counterpart:
the port indexes directly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "SublatticeTables",
    "sublattice_tables",
    "flip_proposal",
    "swap_proposal",
    "multistep_proposal",
    "composite_proposal",
    "TableFlipTables",
    "table_flip_proposal",
    "table_flip_log_priori",
    "apply_flips",
    "make_step_applier",
    "make_metropolis_step",
    "make_uniform_step",
    "make_wang_landau_step",
    "step_window",
    "run_chain",
    "run_chain_fused",
]


# ---------------------------------------------------------------------------
# sublattice tables
# ---------------------------------------------------------------------------


class SublatticeTables(NamedTuple):
    """The active sublattices as padded tensors."""

    active_sites: torch.Tensor  # [S, A] int64, padded 0
    n_active: torch.Tensor  # [S] int64
    encodings: torch.Tensor  # [S, C] int64, padded 0
    n_codes: torch.Tensor  # [S] int64
    cum_probs: torch.Tensor  # [S] f64 cumulative selection probabilities

    def to(self, device) -> "SublatticeTables":
        return SublatticeTables(*(t.to(device) for t in self))


def sublattice_tables(sublattices, sublattice_probabilities=None,
                      device="cpu") -> SublatticeTables:
    """Pack the ACTIVE sublattices into padded tensors on ``device``."""
    active = [s for s in sublattices if s.is_active]
    if not active:
        raise ValueError("No active sublattices.")
    if sublattice_probabilities is None:
        probs = np.full(len(active), 1.0 / len(active))
    else:
        probs = np.asarray(sublattice_probabilities, dtype=np.float64)
        if len(probs) != len(active):
            raise AttributeError(
                "Sublattice probabilities must match the number of active "
                "sublattices."
            )
        if abs(probs.sum() - 1) > 1e-12:
            raise ValueError("Sublattice probabilities must sum to one.")
    amax = max(len(s.active_sites) for s in active)
    cmax = max(len(s.encoding) for s in active)
    act = np.zeros((len(active), amax), dtype=np.int64)
    enc = np.zeros((len(active), cmax), dtype=np.int64)
    for i, s in enumerate(active):
        act[i, : len(s.active_sites)] = s.active_sites
        enc[i, : len(s.encoding)] = s.encoding

    def dev(x, dtype=torch.int64):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return SublatticeTables(
        active_sites=dev(act),
        n_active=dev([len(s.active_sites) for s in active]),
        encodings=dev(enc),
        n_codes=dev([len(s.encoding) for s in active]),
        cum_probs=dev(np.cumsum(probs), torch.float64),
    )


# ---------------------------------------------------------------------------
# proposals
# ---------------------------------------------------------------------------


def _uniforms(occu, generator, k):
    """[W, k] f64 uniforms in [0, 1), one row a walker."""
    return torch.rand((occu.shape[0], k), generator=generator, dtype=torch.float64,
                      device=occu.device)


def _below(u, n):
    """floor(u n) for uniforms u [W] and counts n [W] >= 1: a uniform
    integer in [0, n)."""
    return torch.minimum((u * n).long(), n - 1)


def _pick(cum_probs, u):
    """The index a uniform u [W] selects from cumulative probabilities."""
    return torch.searchsorted(cum_probs, u.contiguous(), right=True).clamp(
        max=len(cum_probs) - 1)


def _column(values, index):
    """values[w, index[w]] of a [W, K] tensor."""
    return values.gather(1, index[:, None])[:, 0]


def flip_proposal(tables: SublatticeTables, occu, generator):
    """Single-site flip to another random allowed code (the Flip usher):
    a sublattice by its probability, a uniform active site of it, a uniform
    code of the site's other codes."""
    u = _uniforms(occu, generator, 3)
    sl = _pick(tables.cum_probs, u[:, 0])
    site = _column(tables.active_sites[sl], _below(u[:, 1], tables.n_active[sl]))
    codes = tables.encodings[sl]  # [W, C]
    pos = (codes == _column(occu, site).long()[:, None]).to(torch.uint8).argmax(dim=1)
    j = _below(u[:, 2], tables.n_codes[sl] - 1)
    j = j + (j >= pos).long()
    valid = torch.ones((len(site), 1), dtype=torch.bool, device=occu.device)
    return site[:, None], _column(codes, j)[:, None], valid, 0.0


def swap_proposal(tables: SublatticeTables, occu, generator):
    """Canonical two-site swap within one sublattice (the Swap usher).

    Site 2 is uniform among the sublattice's active sites whose code
    differs from site 1's (``smol_tpu/ops/mc.py:195-225``); the step is
    empty (no valid flip) where no such site exists.
    """
    u = _uniforms(occu, generator, 3)
    sl = _pick(tables.cum_probs, u[:, 0])
    n_act = tables.n_active[sl]
    act = tables.active_sites[sl]  # [W, A]
    occ_act = occu.gather(1, act).long()
    i = _below(u[:, 1], n_act)
    sp1 = _column(occ_act, i)
    slots = torch.arange(act.shape[1], device=occu.device)
    mask = (slots < n_act[:, None]) & (occ_act != sp1[:, None])
    count = mask.sum(dim=1)
    m = _below(u[:, 2], count.clamp(min=1))
    j2 = (mask & (mask.cumsum(dim=1) == (m + 1)[:, None])).to(torch.uint8).argmax(dim=1)
    sites = torch.stack([_column(act, i), _column(act, j2)], dim=1)
    codes = torch.stack([_column(occ_act, j2), sp1], dim=1)
    valid = (count > 0)[:, None].expand(-1, 2)
    return sites, codes, valid, 0.0


def apply_flips(occu, sites, codes, valid):
    """``occu`` [W, N] with the valid flips applied in order (a new tensor)."""
    for i in range(sites.shape[1]):
        site = sites[:, i : i + 1]
        code = torch.where(valid[:, i : i + 1], codes[:, i : i + 1].to(occu.dtype),
                           occu.gather(1, site))
        occu = occu.scatter(1, site, code)
    return occu


def multistep_proposal(base, max_length, lengths, cum_probs, occu, generator):
    """Several base proposals chained into one step (the MultiStep usher).

    ``base`` is a proposal, ``lengths`` [P] int64 the step lengths (the
    longest ``max_length``, a host int) and ``cum_probs`` [P] f64 their
    cumulative probabilities, both on the occupancies' device.  Each walker
    draws its length; sub-step k proposes against the occupancy the earlier
    kept sub-steps leave, and is dropped where it is past the walker's
    length or touches a site an earlier kept sub-step used
    (``smol_tpu/ops/mc.py:229-279``).
    """
    u = _uniforms(occu, generator, 1)[:, 0]
    length = lengths[_pick(cum_probs, u)]
    sites, codes, valid = [], [], []
    work = occu
    for k in range(int(max_length)):
        s_sites, s_codes, s_valid, _ = base(work, generator)
        keep = k < length
        if sites:
            used, used_valid = torch.cat(sites, dim=1), torch.cat(valid, dim=1)
            touched = (used_valid[:, None, :]
                       & (used[:, None, :] == s_sites[:, :, None])).any(dim=2).any(dim=1)
            keep = keep & ~touched
        s_valid = s_valid & keep[:, None]
        sites.append(s_sites)
        codes.append(s_codes)
        valid.append(s_valid)
        work = apply_flips(work, s_sites, s_codes, s_valid)
    return torch.cat(sites, dim=1), torch.cat(codes, dim=1), torch.cat(valid, dim=1), 0.0


def composite_proposal(proposals, width, cum_probs, occu, generator):
    """One of several proposals a walker, by probability (the Composite
    usher).  ``proposals`` are (proposal, width) pairs; every proposal
    draws for every walker and each walker keeps its own, padded to
    ``width`` with invalid slots."""
    u = _uniforms(occu, generator, 1)[:, 0]
    which = _pick(cum_probs, u)
    W = occu.shape[0]
    sites = torch.zeros((W, width), dtype=torch.int64, device=occu.device)
    codes = torch.zeros_like(sites)
    valid = torch.zeros((W, width), dtype=torch.bool, device=occu.device)
    log_priori = 0.0
    for k, (propose, w) in enumerate(proposals):
        s, c, v, lp = propose(occu, generator)
        pick = which == k
        sites[:, :w] = torch.where(pick[:, None], s, sites[:, :w])
        codes[:, :w] = torch.where(pick[:, None], c, codes[:, :w])
        valid[:, :w] = torch.where(pick[:, None], v, valid[:, :w])
        if torch.is_tensor(lp):
            log_priori = log_priori + torch.where(pick, lp, 0.0)
    return sites, codes, valid, log_priori


class TableFlipTables(NamedTuple):
    """A TableFlip usher's tables for the per-step proposal and its a-priori
    factor (:func:`table_flip_proposal`, :func:`table_flip_log_priori`)."""

    directions: torch.Tensor  # [2F, D] int64 signed flip vectors: u, -u per row
    weights: torch.Tensor  # [2F] f64 weight of each signed direction
    max_n: torch.Tensor  # [D] int64 active sites of each dimension's sublattice
    dims_table: torch.Tensor  # [N, C] int64 dimension of (site, code), -1 off the active sites
    act_sites: torch.Tensor  # [A] int64 active sites of the active sublattices, in order
    act_dims: torch.Tensor  # [A, C] int64 dims_table's rows of the active sites
    dim_block: torch.Tensor  # [D] int64 sublattice of each dimension (-1 inactive)
    code_of_dim: torch.Tensor  # [D] int64 the code each dimension counts
    width: int  # slots of a proposal: the most sites a direction removes (at least 2)
    swap_weight: float  # probability of a canonical swap instead

    def to(self, device) -> "TableFlipTables":
        return TableFlipTables(*(t.to(device) if torch.is_tensor(t) else t for t in self))


def _sorted_by(keys, ties):
    """Per row, the indices ordering ``keys`` [W, K] ascending, equal keys by
    ``ties`` [W, K], equal ties by index (two stable sorts)."""
    by_ties = torch.argsort(ties, dim=1, stable=True)
    return by_ties.gather(1, torch.argsort(keys.gather(1, by_ties), dim=1, stable=True))


def _dim_counts(dims, n_dims):
    """[W, n_dims] int64 count of each dimension in ``dims`` [W, K] (-1 is
    counted nowhere)."""
    counts = torch.zeros((dims.shape[0], n_dims + 1), dtype=torch.int64, device=dims.device)
    return counts.scatter_add_(1, dims + 1, torch.ones_like(dims))[:, 1:]


def _feasible_weights(tables: TableFlipTables, counts):
    """[W, 2F] the direction weights, zero where a direction would take a
    count below 0 or above its sublattice's active sites."""
    after = counts[:, None, :] + tables.directions[None]
    feasible = ~((after < 0).any(dim=2) | (after > tables.max_n).any(dim=2))
    return tables.weights * feasible


def table_flip_proposal(tables: TableFlipTables, swap, occu, generator):
    """A charge-neutral table flip (the TableFlip usher's per-step move,
    ``smol_tpu/moca/kernel/tableflip.py:241-408``).

    A signed direction by its weight among those the walker's species
    counts allow; the sites it removes, uniform without replacement in each
    dimension (each active site ranked within its dimension by a uniform
    key, ties by position); the removed sites shuffled within their
    sublattice (ranked by a second uniform key) and dealt to the
    dimensions that gain, in dimension order.  With probability
    ``swap_weight``, or where no direction is allowed, the walker takes
    the canonical swap ``swap(occu, generator)`` instead.  Slots past the
    removals are invalid; the step is ``tables.width`` slots wide.
    """
    W, device = occu.shape[0], occu.device
    n_dirs, D = tables.directions.shape
    A, width = tables.act_sites.shape[0], tables.width
    u = _uniforms(occu, generator, 2)  # the swap draw, the direction draw
    r1 = _uniforms(occu, generator, A)
    r2 = _uniforms(occu, generator, width)
    s_sites, s_codes, s_valid, _ = swap(occu, generator)

    occ_act = occu[:, tables.act_sites].long()
    d_act = tables.act_dims[torch.arange(A, device=device)[None, :], occ_act]  # [W, A]
    counts = _dim_counts(d_act, D)
    w = _feasible_weights(tables, counts)
    total = w.sum(dim=1)
    any_flip = total > 0
    cdf = w.cumsum(dim=1) / torch.where(any_flip, total, 1.0)[:, None]
    idx = torch.searchsorted(cdf, u[:, 1:2].contiguous(), right=True)[:, 0]
    u_vec = tables.directions[idx.clamp(max=n_dirs - 1)]  # [W, D]

    # removal: the first kneg[d] sites of dimension d by the key r1
    kneg = (-u_vec).clamp(min=0)
    kneg_c = kneg.cumsum(dim=1)
    order = _sorted_by(d_act, r1)  # by dimension, then r1, then position
    d_sorted = d_act.gather(1, order)
    d_index = d_sorted.clamp(min=0)
    first = (d_act < 0).sum(dim=1, keepdim=True) + counts.cumsum(dim=1) - counts
    rank = torch.arange(A, device=device)[None, :] - first.gather(1, d_index)
    pick = (d_sorted >= 0) & (rank < kneg.gather(1, d_index))
    slot = torch.where(pick, (kneg_c - kneg).gather(1, d_index) + rank, width)
    removed = torch.zeros((W, width + 1), dtype=torch.int64, device=device)
    removed = removed.scatter(1, slot, tables.act_sites[order])[:, :width]
    n_removed = kneg_c[:, -1:]

    # assignment: shuffle the removed sites within their sublattice, deal
    iota_w = torch.arange(width, device=device)
    filled = iota_w[None, :] < n_removed
    slot_dim = (iota_w[None, :, None] >= kneg_c[:, None, :]).sum(dim=2).clamp(max=D - 1)
    block = torch.where(filled, tables.dim_block[slot_dim], D)  # the unfilled last
    sites = torch.where(filled, removed.gather(1, _sorted_by(block, r2)), 0)
    kpos_c = u_vec.clamp(min=0).cumsum(dim=1)
    dest_dim = (iota_w[None, :, None] >= kpos_c[:, None, :]).sum(dim=2).clamp(max=D - 1)
    codes = tables.code_of_dim[dest_dim]
    valid = filled & any_flip[:, None]

    use_swap = ((u[:, 0] < tables.swap_weight) | ~any_flip)[:, None]

    def padded(x):
        return torch.cat([x, x.new_zeros((W, width - x.shape[1]))], dim=1)

    sites = torch.where(use_swap, padded(s_sites), sites)
    codes = torch.where(use_swap, padded(s_codes), codes)
    valid = torch.where(use_swap, padded(s_valid), valid)
    return sites, codes, valid, 0.0


def table_flip_log_priori(tables: TableFlipTables, occu, sites, codes, valid):
    """[W] f64 log a-priori factor of table-flip steps (the TableFlip usher's
    ``device_log_priori``, ``smol_tpu/moca/kernel/tableflip.py:410-508``):
    log of the reverse direction's probability after the step over the
    forward one's before it, plus sum over the changed dimensions of
    lgamma(n + 1) - lgamma(n' + 1); 0 for a step that changes no count (a
    swap)."""
    dt = tables.dims_table
    N, C = dt.shape
    D = tables.directions.shape[1]
    device = occu.device
    iota_d = torch.arange(D, device=device)

    def dims_of(s, c):
        return dt[s, c.long().clamp(max=C - 1)]

    def onehot(dims):
        return (dims[..., None] == iota_d).to(torch.float64)

    old = dims_of(sites, occu.gather(1, sites))
    new = dims_of(sites, codes)
    dn = torch.where(valid[..., None], onehot(new) - onehot(old), 0.0).sum(dim=1)  # [W, D]
    is_swap = (dn == 0).all(dim=1)
    match = (tables.directions.to(torch.float64)[None] == dn[:, None, :]).all(dim=2)
    forward = match.to(torch.uint8).argmax(dim=1)
    reverse = forward ^ 1  # the other sign of the same flip vector

    occ = occu.long()
    dims = torch.where(occ < C, dt[torch.arange(N, device=device)[None, :],
                                   occ.clamp(max=C - 1)], -1)
    counts = _dim_counts(dims, D)
    n_next = counts + dn.long()
    n_now_f, n_next_f = counts.to(torch.float64), n_next.to(torch.float64)
    w_now = _feasible_weights(tables, counts)
    w_next = _feasible_weights(tables, n_next)
    p_now = _column(w_now, forward) / w_now.sum(dim=1)
    p_next = _column(w_next, reverse) / w_next.sum(dim=1)
    log_factor = torch.log(p_next / p_now)
    log_factor = log_factor + torch.where(
        dn != 0, torch.lgamma(n_now_f + 1.0) - torch.lgamma(n_next_f + 1.0), 0.0).sum(dim=1)
    return torch.where(is_swap, 0.0, log_factor)


# ---------------------------------------------------------------------------
# step application: sequential flips + enthalpy / feature deltas
# ---------------------------------------------------------------------------


def make_step_applier(delta_energy_fn, mu_table=None, delta_features_fn=None):
    """``apply(occu, sites, codes, valid) -> (occu', dH [W], dfeat)``.

    ``delta_energy_fn(occu [W, N], site [W], code [W]) -> [W]`` is the
    processor's batched single-flip energy change.  The flips apply in
    order against the evolving occupancy (the reference's multi-flip
    semantics); dH is the energy change less the chemical work of the
    ``mu_table`` [N, C] tensor where one is given (natural parameter -1).
    With ``delta_features_fn(occu, site, code) -> [W, F]`` the feature
    change is summed too, the chemical work appended; otherwise dfeat is
    None.  ``occu`` itself is not changed.
    """

    def apply(occu, sites, codes, valid):
        W = occu.shape[0]
        dh = torch.zeros(W, dtype=torch.float64, device=occu.device)
        dfeat = None
        for i in range(sites.shape[1]):
            site, code, v = sites[:, i], codes[:, i], valid[:, i]
            cur = _column(occu, site).long()
            d = delta_energy_fn(occu, site, code)
            if mu_table is not None:
                dwork = mu_table[site, code] - mu_table[site, cur]
                d = d - dwork
            dh = dh + torch.where(v, d, 0.0)
            if delta_features_fn is not None:
                df = delta_features_fn(occu, site, code)
                if mu_table is not None:
                    df = torch.cat([df, dwork[:, None]], dim=1)
                if dfeat is None:
                    dfeat = torch.zeros_like(df)
                dfeat = dfeat + torch.where(v[:, None], df, 0.0)
            occu = occu.scatter(1, site[:, None],
                                torch.where(v, code, cur).to(occu.dtype)[:, None])
        return occu, dh, dfeat

    return apply


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _update(state, accept, occu_new, dh, dfeat):
    """The state's entries after a step of decisions ``accept`` [W]."""
    state["occupancy"] = torch.where(accept[:, None], occu_new, state["occupancy"])
    state["enthalpy"] = state["enthalpy"] + torch.where(accept, dh, 0.0)
    state["accepted"] = accept
    state["naccept"] = state["naccept"] + accept.to(torch.int32)
    if "features" in state:
        state["features"] = state["features"] + torch.where(accept[:, None], dfeat, 0.0)
    return state


def _accept_metropolis(generator, exponent):
    """[W] bool: exponent >= 0, or exponent > log u for a uniform u in [0, 1)
    f64 of each walker (``smol_tpu/ops/mc.py:426-428``)."""
    u = torch.rand(exponent.shape[0], generator=generator, dtype=torch.float64,
                   device=exponent.device)
    return (exponent >= 0) | (exponent > torch.log(u))


def make_metropolis_step(propose_fn, apply_fn, log_priori_fn=None):
    """Metropolis-Hastings step ``step(state, generator) -> state``.

    State entries: ``occupancy`` [W, N] int32, ``enthalpy`` [W] f64,
    ``beta`` [W] f64, ``accepted`` [W] bool, ``naccept`` [W] int32, and
    optionally ``nmove`` [W] int32 (steps with a valid flip) and
    ``features`` [W, F] f64.  A step is accepted where
    -beta dH + log_priori >= 0 or > log u, u uniform in [0, 1) f64.
    """

    def step(state, generator):
        occu = state["occupancy"]
        sites, codes, valid, log_priori = propose_fn(occu, generator)
        if log_priori_fn is not None:
            log_priori = log_priori + log_priori_fn(occu, sites, codes, valid)
        occu_new, dh, dfeat = apply_fn(occu, sites, codes, valid)
        exponent = -state["beta"] * dh + log_priori
        accept = _accept_metropolis(generator, exponent)
        if "nmove" in state:
            state["nmove"] = state["nmove"] + valid.any(dim=1).to(torch.int32)
        return _update(state, accept, occu_new, dh, dfeat)

    return step


def make_uniform_step(propose_fn, apply_fn):
    """Uniformly-random (infinite temperature) step: every proposal is
    accepted."""

    def step(state, generator):
        occu = state["occupancy"]
        sites, codes, valid, _ = propose_fn(occu, generator)
        occu_new, dh, dfeat = apply_fn(occu, sites, codes, valid)
        accept = torch.ones(occu.shape[0], dtype=torch.bool, device=occu.device)
        return _update(state, accept, occu_new, dh, dfeat)

    return step


def make_wang_landau_step(propose_fn, apply_fn, min_enthalpy: float, bin_size: float,
                          flatness: float = 0.8, check_period: int = 1000,
                          update_period: int = 1, mod_divisor: float = 2.0,
                          log_priori_fn=None):
    """Wang-Landau step ``step(state, generator) -> state`` (the reference's
    ``_wl_step``, ``smol_tpu/ops/mc.py:528-655``).

    State entries besides the Metropolis step's (no ``beta``): ``features``
    [W, F] f64, ``entropy`` [W, L] f64, ``histogram`` and ``occurrences``
    [W, L] int32, ``mean_features`` [W, L, F] f64, ``mod_factor`` [W] f64
    and ``wl_counter`` [W] int32, the walker's steps in the window.  A move
    that leaves the window [min, min + L bin) is rejected; inside, it is
    accepted as Metropolis with the exponent S(now) - S(next) plus the
    proposal's log a-priori factor (and ``log_priori_fn``'s, the usher's,
    where given).  Then, at the walker's bin where it is in the window: the
    counter counts the step, the bin's mean features take in the features
    with ``occurrences`` as their count, every ``update_period`` counted
    steps the entropy gains ``mod_factor`` and the histogram and
    occurrences one, and every ``check_period`` counted steps a histogram
    whose visited bins all exceed ``flatness`` times their mean is reset and
    ``mod_factor`` divided by ``mod_divisor``.  The planes are updated in
    place, by gathers and scatters at each walker's bin.
    """

    def bin_of(e):
        return torch.floor((e - min_enthalpy) / e.new_tensor(bin_size)).long()

    def step(state, generator):
        occu, enthalpy, features = state["occupancy"], state["enthalpy"], state["features"]
        entropy, histogram = state["entropy"], state["histogram"]
        occurrences, mean = state["occurrences"], state["mean_features"]
        mod_factor = state["mod_factor"]
        num_levels = entropy.shape[1]
        max_enthalpy = min_enthalpy + num_levels * bin_size

        sites, codes, valid, log_priori = propose_fn(occu, generator)
        if log_priori_fn is not None:
            log_priori = log_priori + log_priori_fn(occu, sites, codes, valid)
        occu_new, dh, dfeat = apply_fn(occu, sites, codes, valid)
        new_enthalpy = enthalpy + dh
        bin_id = bin_of(enthalpy).clamp(0, num_levels - 1)
        new_bin = bin_of(new_enthalpy).clamp(0, num_levels - 1)
        in_window = (new_enthalpy >= min_enthalpy) & (new_enthalpy < max_enthalpy)
        exponent = _column(entropy, bin_id) - _column(entropy, new_bin) + log_priori
        accept = in_window & _accept_metropolis(generator, exponent)

        occu = torch.where(accept[:, None], occu_new, occu)
        enthalpy = torch.where(accept, new_enthalpy, enthalpy)
        features = torch.where(accept[:, None], features + dfeat, features)

        # at the walker's bin after the step, where it is in the window
        cur_bin = bin_of(enthalpy).clamp(0, num_levels - 1)
        cur_valid = (enthalpy >= min_enthalpy) & (enthalpy < max_enthalpy)
        counter = state["wl_counter"] + cur_valid.to(torch.int32)
        cell = cur_bin[:, None]
        total = occurrences.gather(1, cell).to(torch.float64)  # [W, 1]
        cur_mean = mean.gather(1, cell[:, :, None].expand(-1, 1, mean.shape[2]))[:, 0]
        new_mean = (features + total * cur_mean) / (total + 1)
        mean[torch.arange(len(cur_bin), device=cur_bin.device), cur_bin] = torch.where(
            cur_valid[:, None], new_mean, cur_mean)
        update = cur_valid & (counter % update_period == 0)
        entropy.scatter_add_(1, cell, torch.where(update, mod_factor, 0.0)[:, None])
        histogram.scatter_add_(1, cell, update.to(histogram.dtype)[:, None])
        occurrences.scatter_add_(1, cell, update.to(occurrences.dtype)[:, None])

        # the flatness check, every check_period counted steps
        check = cur_valid & (counter % check_period == 0)
        visited = entropy > 0
        nvisited = visited.sum(dim=1)
        hmean = (torch.where(visited, histogram, 0).sum(dim=1).to(torch.float64)
                 / nvisited.clamp(min=1))
        flat = (nvisited >= 2) & torch.where(
            visited, histogram > flatness * hmean[:, None], True).all(dim=1)
        reset = check & flat
        histogram.masked_fill_(reset[:, None], 0)

        state["occupancy"], state["enthalpy"], state["features"] = occu, enthalpy, features
        state["mod_factor"] = torch.where(reset, mod_factor / mod_divisor, mod_factor)
        state["wl_counter"] = counter
        state["accepted"] = accept
        state["naccept"] = state["naccept"] + accept.to(torch.int32)
        return state

    return step


# ---------------------------------------------------------------------------
# chain drivers
# ---------------------------------------------------------------------------


def step_window(step_fn, thin_by: int):
    """``window(state, generator) -> state``: ``thin_by`` steps of
    ``step_fn(state, generator) -> state`` (one step of every walker), each
    adding its accepted steps to ``state["window_naccept"]``; the per-step
    path's thinning window, as :func:`run_chain_fused` runs it."""

    def window(state, generator):
        for _ in range(int(thin_by)):
            state = step_fn(state, generator)
            state["window_naccept"] += state["accepted"].to(torch.int32)
        return state

    return window


def run_chain(state, generator, step_fn, record_fn, nsamples: int, thin_by: int):
    """Run ``nsamples`` windows of ``thin_by`` steps of ``step_fn``, recording
    a trace after each (the per-step path; ``smol_tpu/ops/mc.py:656-705``).
    Returns ``(state, traces)`` as :func:`run_chain_fused` does."""
    return run_chain_fused(state, generator, step_window(step_fn, thin_by), record_fn,
                           nsamples)


def run_chain_fused(state, generator, chain_fn, record_fn, nsamples: int):
    """Run ``nsamples`` chain windows, recording a trace after each.

    Counterpart of the reference's ``run_chain_fused`` (:707-739), which
    scans the windows inside one jitted program; here a Python loop runs
    one chain call per window.  ``chain_fn(state, generator) -> state``
    runs one thinning window and adds its accepted moves to
    ``state["window_naccept"]``, which is reset before every window.
    ``record_fn(state) -> dict`` returns the tensors of one record; they are
    copied into the launch's stack (one tensor per traced quantity,
    allocated at the first record, on the device where it lives) before
    the next window, so they may be views of the state.  Returns
    ``(state, traces)`` with each trace entry a stack [nsamples, W, ...].
    """
    traces = {}
    for i in range(int(nsamples)):
        state["window_naccept"] = torch.zeros_like(state["naccept"])
        state = chain_fn(state, generator)
        record = record_fn(state)
        if not traces:
            traces = {
                name: torch.empty((int(nsamples), *value.shape), dtype=value.dtype,
                                  device=value.device)
                for name, value in record.items()
            }
        for name, value in record.items():
            traces[name][i].copy_(value)
    state.pop("window_naccept", None)
    return state, traces
