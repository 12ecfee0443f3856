"""The Metropolis and UniformlyRandom kernels.

Counterpart of ``smol_tpu/moca/kernel/metropolis.py``.  A Metropolis
kernel of ``Flip`` moves (semigrand), ``Swap`` moves (canonical) or
``TableFlip`` moves (constrained-composition semigrand, e.g.
charge-neutral), with shared random proposals or, for flips, the
deterministic sweep, no bias, and a system the chain tables take runs on
the hand-written chains (:meth:`Metropolis.make_chain_fn`), at one
temperature or on a per-walker ladder (replica exchange).  Every other
configuration, as in the reference, runs on the per-step path
(:meth:`Metropolis.make_step_fn`, :mod:`smol_tpu_torch.ops.mc`):
independent proposals, a bias, the ``MultiStep`` and ``Composite``
ushers, a ``TableFlip`` usher the table chain cannot honour, and systems
the chain tables refuse (restricted sites, split sublattices).
``UniformlyRandom``, the infinite-temperature kernel, always runs on the
per-step path.
The factory also builds the Wang-Landau kernel
(:mod:`smol_tpu_torch.moca.kernel.wanglandau`).
"""

from __future__ import annotations

import torch

from smol_tpu_torch.moca.kernel.base import (
    ALL_BIAS,
    ALL_MCUSHERS,
    ChainKernel,
    MCKernel,
    ThermalKernelMixin,
)
from smol_tpu_torch.moca.kernel.mcusher import Swap
from smol_tpu_torch.moca.kernel.wanglandau import WangLandau
from smol_tpu_torch.ops import chain
from smol_tpu_torch.ops import mc as devmc

__all__ = ["Metropolis", "UniformlyRandom", "mckernel_factory"]


def _zero_beta_step(metro_step, state, generator):
    """A Metropolis step at beta 0 (the reference's ``_zero_beta_step``)."""
    state["beta"] = torch.zeros_like(state["enthalpy"])
    state = metro_step(state, generator)
    state.pop("beta")
    return state


class Metropolis(ThermalKernelMixin, ChainKernel):
    """Metropolis-Hastings kernel.

    Args:
        ensemble: the :class:`~smol_tpu_torch.moca.ensemble.Ensemble`.
        step_type: ``"flip"``, ``"swap"``, ``"table-flip"``,
            ``"multi-step"`` or ``"composite"``; ``args`` and ``kwargs`` go
            to its usher (``sublattice_probabilities``; ``flip_weights``,
            ``swap_weight`` for table flips, see
            :class:`~smol_tpu_torch.moca.kernel.tableflip.TableFlip`).
        temperature: in K.
        seed: seed of the run's generator.
        bias_type, bias_kwargs: a bias (the per-step path).
        shared_proposals, chain_block_size, proposal_mode, rng, chain_delta:
            see :class:`~smol_tpu_torch.moca.kernel.base.ChainKernel`.
    """

    valid_mcushers = ALL_MCUSHERS
    valid_bias = ALL_BIAS

    def __init__(self, ensemble, step_type, temperature, *args, **kwargs):
        super().__init__(temperature, ensemble, step_type, *args, **kwargs)
        self._table_move = None

    def initial_state(self, occupancies) -> dict:
        state = super().initial_state(occupancies)
        if type(self.mcusher) is Swap:
            # non-null proposals: pairs of equal codes are identity moves,
            # so this count gives the rate of moves that change something
            state["nmove"] = torch.zeros_like(state["naccept"])
        return state

    def table_move(self):
        """The :class:`~smol_tpu_torch.ops.chain.TableMove` of a TableFlip
        usher (built once, on the tables' device), else None."""
        if self.move == "table" and self._table_move is None:
            self._table_move = chain.build_table_move(self.chain_tables(), self.mcusher)
        return self._table_move

    def make_step_fn(self):
        """One Metropolis step of every walker on the per-step path, each
        walker with its own proposal (``smol_tpu/moca/kernel/metropolis.py:
        187-190``)."""
        propose_fn, _ = self.mcusher.device_proposal(self.device)
        return devmc.make_metropolis_step(propose_fn, self._device_applier(),
                                          self._device_log_priori())

    def make_chain_fn(self, n_steps: int):
        """The chain of ``n_steps`` per call: one thinning window, or, with
        replica exchange, one exchange period, which the sampler runs as
        segments of a window (``fn(state, generator, segments=,
        between=)``, :func:`~smol_tpu_torch.parallel.tempering.make_tempering_chain`)."""
        if not self.runs_chain:
            raise ValueError(
                f"this kernel runs on the per-step path ({self._chain_refusal()})")
        return chain.make_shared_proposal_chain(
            self.chain_tables(),
            n_steps,
            block_size=self.chain_block_size,
            proposal_mode=self.proposal_mode,
            rng=self.rng,
            move=self.move,
            table_move=self.table_move(),
        )


class UniformlyRandom(MCKernel):
    """Infinite-temperature kernel: every proposed step is accepted (with a
    bias or an a-priori factor, a Metropolis test at beta 0).  It runs on
    the per-step path."""

    valid_mcushers = ALL_MCUSHERS
    valid_bias = ALL_BIAS

    def make_step_fn(self):
        propose_fn, _ = self.mcusher.device_proposal(self.device)
        log_priori = self._device_log_priori()
        if log_priori is None:
            return devmc.make_uniform_step(propose_fn, self._device_applier())
        metro_step = devmc.make_metropolis_step(propose_fn, self._device_applier(),
                                                log_priori)
        return lambda state, generator: _zero_beta_step(metro_step, state, generator)


def mckernel_factory(kernel_type, ensemble, step_type, *args, **kwargs):
    """The kernel for ``kernel_type``: ``"Metropolis"`` (with a temperature),
    ``"uniformly-random"`` or ``"wang-landau"`` (with a window), in any
    spelling of the words."""
    name = kernel_type.replace("-", "").replace("_", "").lower()
    kernels = {"metropolis": Metropolis, "uniformlyrandom": UniformlyRandom,
               "wanglandau": WangLandau}
    if name not in kernels:
        raise NotImplementedError(
            f"kernel type {kernel_type!r} is not ported yet (ROADMAP.md "
            "Queue 1 item 6)"
        )
    return kernels[name](ensemble, step_type, *args, **kwargs)
