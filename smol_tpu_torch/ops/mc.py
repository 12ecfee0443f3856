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
  :func:`swap_proposal`, :func:`multistep_proposal` and
  :func:`composite_proposal` (bind their tables with ``functools.partial``).
- :func:`make_step_applier`: the S flips applied in sequence against the
  evolving occupancy, with the enthalpy change (and the feature change).
- :func:`make_metropolis_step`, :func:`make_uniform_step`: the kernels'
  steps over the walker state.
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
    "apply_flips",
    "make_step_applier",
    "make_metropolis_step",
    "make_uniform_step",
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
        u = torch.rand(occu.shape[0], generator=generator, dtype=torch.float64,
                       device=occu.device)
        accept = (exponent >= 0) | (exponent > torch.log(u))
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
