"""The Metropolis kernel on the shared-proposal chains.

Counterpart of ``smol_tpu/moca/kernel/metropolis.py`` (:83-95 and
:197-301: ``initial_state``, ``_build_chain_tables`` and
``make_chain_fn``).  The port covers single-site ``Flip`` moves
(semigrand), two-site ``Swap`` moves (canonical) and ``TableFlip`` moves
(constrained-composition semigrand, e.g. charge-neutral), with no bias and
no tracked features, with shared random proposals or, for flips, the
deterministic sweep.  Anything else raises ``NotImplementedError`` naming
the ROADMAP.md item that ports it; nothing silently takes another path.
The factory also builds the Wang-Landau kernel
(:mod:`smol_tpu_torch.moca.kernel.wanglandau`).
"""

from __future__ import annotations

import torch

from smol_tpu_torch.moca.kernel.base import ChainKernel, ThermalKernelMixin
from smol_tpu_torch.moca.kernel.wanglandau import WangLandau
from smol_tpu_torch.ops import chain

__all__ = ["Metropolis", "mckernel_factory"]


class Metropolis(ThermalKernelMixin, ChainKernel):
    """Metropolis-Hastings kernel of flips, canonical swaps or table flips.

    Args:
        ensemble: the :class:`~smol_tpu_torch.moca.ensemble.Ensemble`.
        step_type: ``"flip"``, ``"swap"`` or ``"table-flip"``.
        temperature: in K.
        seed: seed of the run's generator.
        shared_proposals, chain_block_size, proposal_mode, rng: see
            :class:`~smol_tpu_torch.moca.kernel.base.ChainKernel`.
        flip_weights, swap_weight: for ``"table-flip"``, see
            :class:`~smol_tpu_torch.moca.kernel.tableflip.TableFlip`.
    """

    def __init__(self, ensemble, step_type, temperature, *, seed=None,
                 sublattice_probabilities=None, flip_weights=None,
                 swap_weight=None, **chain_options):
        super().__init__(
            temperature, ensemble, step_type, seed=seed,
            sublattice_probabilities=sublattice_probabilities,
            flip_weights=flip_weights, swap_weight=swap_weight, **chain_options,
        )
        self._table_move = None

    def initial_state(self, occupancies) -> dict:
        state = super().initial_state(occupancies)
        if self.move == "swap":
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

    def make_chain_fn(self, n_steps: int):
        return chain.make_shared_proposal_chain(
            self.chain_tables(),
            n_steps,
            block_size=self.chain_block_size,
            proposal_mode=self.proposal_mode,
            rng=self.rng,
            move=self.move,
            table_move=self.table_move(),
        )


def mckernel_factory(kernel_type, ensemble, step_type, *args, **kwargs):
    """The kernel for ``kernel_type``: ``"Metropolis"`` (with a temperature)
    or ``"wang-landau"`` (any spelling of the two words; with a window)."""
    name = kernel_type.replace("-", "").replace("_", "").lower()
    kernels = {"metropolis": Metropolis, "wanglandau": WangLandau}
    if name not in kernels:
        raise NotImplementedError(
            f"kernel type {kernel_type!r} is not ported yet (ROADMAP.md "
            "Queue 1 item 8)"
        )
    return kernels[name](ensemble, step_type, *args, **kwargs)
