"""Parallel tempering (replica exchange) over the walker axis.

Counterpart of ``smol_tpu/parallel/tempering.py``
(``make_temperature_ladder`` :33, ``tempering_exchange`` :42,
``make_tempering_chain`` :82, ``make_tempering_step`` :110).  Walkers carry a temperature ladder in
``state["beta"]`` [W] f64; after every segment of ``period`` chain steps,
adjacent walkers (l, l + 1) exchange their temperatures with probability
min(1, exp[(beta_l - beta_r)(H_l - H_r)]), which preserves the detailed
balance of the extended ensemble.  The pairs alternate between (0, 1),
(2, 3), ... (phase 0) and (1, 2), (3, 4), ... (phase 1); there is no
wrapping pair.  Exchanging temperatures rather than configurations moves
two scalars per pair, whatever the system size.

On a CUDA tensor :func:`exchange_betas` launches the hand-written kernel
``csrc/tempering.cu`` (one launch per sweep, where the plain torch
exchange is about eight); on a CPU tensor it runs
:func:`exchange_betas_reference`, the plain torch twin that makes the
same decisions (:func:`tempering_exchange`).  :func:`make_tempering_chain` runs a thinning window as
segments of a chain of :func:`smol_tpu_torch.ops.chain.make_shared_proposal_chain`
in one call: the window's sequences, seeds and exchange uniforms are drawn
at once.  A window of flips on the card is one cooperative launch of the
flip kernel that runs every segment and exchange
(``ops.chain.flip_window``); elsewhere a segment costs the host two
launches and no wait.
:func:`make_tempering_step` wraps a step of the per-step path
(:mod:`smol_tpu_torch.ops.mc`) with the same exchange every ``period``
steps, through the same kernel on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from smol_tpu_torch.ops import _build

__all__ = [
    "make_temperature_ladder",
    "tempering_exchange",
    "exchange_betas",
    "exchange_betas_reference",
    "exchange_attempts",
    "ExchangeLaunches",
    "make_tempering_chain",
    "make_tempering_step",
]


def make_temperature_ladder(t_min: float, t_max: float, nwalkers: int,
                            geometric: bool = True) -> np.ndarray:
    """A temperature ladder over walkers (geometric spacing by default)."""
    if geometric:
        return np.geomspace(t_min, t_max, nwalkers)
    return np.linspace(t_min, t_max, nwalkers)


def _exchange(beta, enthalpy, uniforms, phase):
    """(new betas, the accepted pairs' left members [W] bool) of one sweep."""
    w = beta.shape[0]
    idx = torch.arange(w, device=beta.device)
    is_left = (idx % 2) == (int(phase) % 2)
    partner = torch.where(is_left, idx + 1, idx - 1)
    valid = (partner >= 0) & (partner < w)
    beta_right = torch.roll(beta, -1)
    beta_left = torch.roll(beta, 1)
    h_right = torch.roll(enthalpy, -1)
    beta_p = torch.where(is_left, beta_right, beta_left)
    delta_left = (beta - beta_right) * (enthalpy - h_right)
    accept_left = (delta_left >= 0) | (delta_left > torch.log(uniforms))
    accept = torch.where(is_left, accept_left, torch.roll(accept_left, 1)) & valid
    return torch.where(accept, beta_p, beta), accept & is_left


def tempering_exchange(beta, enthalpy, uniforms, phase) -> torch.Tensor:
    """The betas after one replica-exchange sweep over adjacent pairs.

    Args:
        beta: [W] f64 inverse temperatures.
        enthalpy: [W] f64 enthalpies.
        uniforms: [W] f64 uniforms in [0, 1); the left member's decides
            its pair.
        phase: 0 pairs (0, 1), (2, 3), ...; 1 pairs (1, 2), (3, 4), ...

    The decision is made at the left member l with d = (beta_l - beta_r)
    (H_l - H_r) in f64, accepted if d >= 0 or d > log u_l, and shared with
    its partner, as the reference decides it.  Returns a new tensor.
    """
    return _exchange(beta, enthalpy, uniforms, phase)[0]


def exchange_attempts(num_walkers: int, sweeps: int) -> int:
    """Pairs tried in the first ``sweeps`` sweeps of a tempering run (phase
    1 first: (W - 1) // 2 pairs, then W // 2, alternating)."""
    odd, even = (sweeps + 1) // 2, sweeps // 2
    return odd * ((num_walkers - 1) // 2) + even * (num_walkers // 2)


def _check_exchange(beta, beta32, enthalpy, uniforms, accepted):
    """Raise ``ValueError`` on an operand the exchange does not take."""
    W = beta.shape[0]
    operands = [(beta, torch.float64), (beta32, torch.float32),
                (enthalpy, torch.float64), (uniforms, torch.float64)]
    if accepted is not None:
        operands.append((accepted, torch.int32))
    for tensor, dtype in operands:
        if tensor.dtype != dtype or tuple(tensor.shape) != (W,) \
                or not tensor.is_contiguous() or tensor.device != beta.device:
            raise ValueError(
                f"exchange_betas operand: expected contiguous {dtype} ({W},) on "
                f"{beta.device}, got {tensor.dtype} {tuple(tensor.shape)} on "
                f"{tensor.device}")


class ExchangeLaunches:
    """Exchange-kernel launches on one window's operands (CUDA tensors):
    checked as :func:`exchange_betas` checks them and turned into the
    kernel's arguments once; sweep s reads row s of ``uniforms`` [n, W], one
    foreign call per sweep (as ``ops.chain.ChainLaunches`` for the chain),
    and counts on ``exchange_betas.launches``.  The object holds the
    operands whose addresses it passes."""

    def __init__(self, beta, beta32, enthalpy, uniforms, accepted):
        _check_exchange(beta, beta32, enthalpy, uniforms[0], accepted)
        if not uniforms.is_contiguous():
            raise ValueError("exchange_betas: the uniforms must be contiguous")
        self.lib = _build.load_chain("tempering")
        self.operands = (beta, beta32, enthalpy, uniforms, accepted)
        with torch.cuda.device(beta.device):
            stream = torch.cuda.current_stream(beta.device).cuda_stream
        W = beta.shape[0]
        self.u0, self.row_bytes = uniforms.data_ptr(), 8 * W
        self.args = [beta.data_ptr(), beta32.data_ptr(), enthalpy.data_ptr(), self.u0,
                     None if accepted is None else accepted.data_ptr(), W, 0, stream]

    def __call__(self, s, phase):
        if self.args[5] < 2:  # no pair to exchange
            return
        self.args[3] = self.u0 + s * self.row_bytes
        self.args[6] = int(phase) % 2
        rc = self.lib.smol_tempering(*self.args)
        exchange_betas.launches += 1
        if rc != 0:
            raise RuntimeError("tempering kernel launch failed: "
                               + self.lib.smol_cuda_error_string(rc).decode())


def exchange_betas(beta, beta32, enthalpy, uniforms, phase, accepted=None):
    """One replica-exchange sweep, in place.

    ``beta`` [W] f64 and its f32 copy ``beta32`` (what the chains read)
    are exchanged together; ``enthalpy`` and ``uniforms`` are [W] f64, all
    contiguous on one device.  ``accepted``, an optional [W] int32 count,
    gains one at the left member of each accepted pair.  A CUDA tensor
    launches the kernel (``exchange_betas.launches`` counts the launches);
    a CPU tensor runs :func:`exchange_betas_reference`.
    """
    _check_exchange(beta, beta32, enthalpy, uniforms, accepted)
    if beta.device.type == "cpu":
        exchange_betas_reference(beta, beta32, enthalpy, uniforms, phase, accepted)
        return
    if beta.device.type != "cuda":
        raise ValueError(f"exchange_betas runs on cuda or cpu, not {beta.device}")
    ExchangeLaunches(beta, beta32, enthalpy, uniforms[None], accepted)(0, phase)


exchange_betas.launches = 0


def exchange_betas_reference(beta, beta32, enthalpy, uniforms, phase, accepted=None):
    """Plain torch twin of :func:`exchange_betas` (same arguments, in place,
    on any device): :func:`tempering_exchange`'s betas, their f32 rounding
    into ``beta32``, one count at each accepted pair's left member."""
    new, left = _exchange(beta, enthalpy, uniforms, phase)
    beta.copy_(new)
    beta32.copy_(new.to(torch.float32))
    if accepted is not None:
        accepted += left.to(torch.int32)


def make_tempering_chain(chain_fn, n_segments: int, uniforms=None):
    """Parallel tempering: ``n_segments`` segments of ``chain_fn`` with an
    exchange sweep after each.

    ``chain_fn`` runs one exchange period of steps, as
    :func:`~smol_tpu_torch.ops.chain.make_shared_proposal_chain` builds it:
    it takes ``segments``, ``between`` and ``exchange`` and runs all
    segments in one call.  ``fn(state, generator) -> state`` draws the
    window's exchange uniforms [n_segments, W] f64 from ``generator`` in
    one call (or takes ``uniforms`` of that shape: the tests pass the
    reference's), runs the segments and, after segment s, exchanges with
    phase ``(pt_counter + s + 1) % 2``, ``pt_counter`` being
    ``state["pt_counter"]`` (a host int counting segments, as the
    reference's does) at the window's start: the first sweep of a run
    pairs (1, 2), (3, 4), ...  The counter gains ``n_segments``.  A
    ``state["pt_accepted"]`` [W] int32 gains the accepted exchanges (at
    each pair's left member; :func:`exchange_attempts` counts the tries).
    Where the chain takes the window in one launch (flips on the card,
    ``ops.chain.tempering_window_plan``), the exchanges run inside it;
    elsewhere one exchange launch (:class:`ExchangeLaunches`) follows each
    segment's launch, or on the CPU :func:`exchange_betas`.
    """

    def fn(state, generator):
        beta, enthalpy = state["beta"], state["enthalpy"]
        if uniforms is not None:
            u = torch.as_tensor(np.asarray(uniforms), dtype=torch.float64,
                                device=beta.device)
        else:
            u = torch.rand((n_segments, beta.shape[0]), generator=generator,
                           dtype=torch.float64, device=beta.device)
        start, accepted = state["pt_counter"], state.get("pt_accepted")
        exchanges = None  # on the card: the window's launches, checked once

        def between(s, beta32):
            nonlocal exchanges
            phase = (start + s + 1) % 2
            if beta.device.type != "cuda":
                exchange_betas(beta, beta32, enthalpy, u[s], phase, accepted)
                return
            if exchanges is None:
                exchanges = ExchangeLaunches(beta, beta32, enthalpy, u, accepted)
            exchanges(s, phase)

        state = chain_fn(state, generator, segments=n_segments, between=between,
                         exchange=(u, (start + 1) % 2, accepted))
        state["pt_counter"] = start + n_segments
        return state

    return fn


def make_tempering_step(step_fn, exchange_period: int = 10):
    """A per-step path's step with a replica-exchange sweep every
    ``exchange_period`` steps (``smol_tpu/parallel/tempering.py:110-133``).

    ``state["pt_counter"]``, a host int, counts the steps here: after step
    c, with c a multiple of the period, the walkers exchange with phase
    (c // period) % 2, on uniforms [W] f64 drawn from the generator, in
    place (:func:`exchange_betas`: the kernel on the card; it gains one to
    ``state["pt_accepted"]`` at the left member of each accepted pair).
    The decision to exchange is the host counter's, so a window never
    waits for the device.
    """
    period = int(exchange_period)

    def step(state, generator):
        state = step_fn(state, generator)
        state["pt_counter"] += 1
        counter = state["pt_counter"]
        if counter % period == 0:
            beta = state["beta"]
            uniforms = torch.rand(beta.shape[0], generator=generator, dtype=torch.float64,
                                  device=beta.device)
            exchange_betas(beta, beta.to(torch.float32), state["enthalpy"], uniforms,
                           (counter // period) % 2, state.get("pt_accepted"))
        return state

    return step
