"""The Metropolis kernel on the shared-proposal chains.

Counterpart of ``smol_tpu/moca/kernel/metropolis.py`` (:83-95 and
:197-301: ``initial_state``, ``_build_chain_tables`` and
``make_chain_fn``).  The port covers single-site ``Flip`` moves
(semigrand), two-site ``Swap`` moves (canonical) and ``TableFlip`` moves
(constrained-composition semigrand, e.g. charge-neutral), with no bias and
no tracked features, with shared random proposals or, for flips, the
deterministic sweep.  Anything else raises ``NotImplementedError`` naming
the ROADMAP.md item that ports it; nothing silently takes another path.
"""

from __future__ import annotations

import torch

from smol_tpu_torch.moca.kernel.base import MCKernel, ThermalKernelMixin
from smol_tpu_torch.moca.kernel.mcusher import Swap
from smol_tpu_torch.moca.kernel.tableflip import TableFlip
from smol_tpu_torch.ops import chain

__all__ = ["Metropolis", "mckernel_factory"]


class Metropolis(ThermalKernelMixin, MCKernel):
    """Metropolis-Hastings kernel of flips, canonical swaps or table flips.

    Args:
        ensemble: the :class:`~smol_tpu_torch.moca.ensemble.Ensemble`.
        step_type: ``"flip"``, ``"swap"`` or ``"table-flip"``.
        temperature: in K.
        seed: seed of the run's generator.
        shared_proposals: must be True: walkers of one block share the
            proposal site sequence (see :mod:`smol_tpu_torch.ops.chain`).
        chain_block_size: walkers per block (the sharing granularity).
        proposal_mode: ``"random"`` or ``"sweep"`` (flips only).
        rng: ``"philox"`` (run mode) or ``"hash"`` (the reference's
            interpret-mode random numbers, for parity checks).
        flip_weights, swap_weight: for ``"table-flip"``, see
            :class:`~smol_tpu_torch.moca.kernel.tableflip.TableFlip`.
    """

    def __init__(self, ensemble, step_type, temperature, *, seed=None,
                 bias_type=None, shared_proposals=True, chain_block_size=1024,
                 proposal_mode="random", rng="philox",
                 sublattice_probabilities=None, flip_weights=None,
                 swap_weight=None):
        if bias_type is not None:
            raise NotImplementedError(
                "MC biases are not ported yet (ROADMAP.md Queue 1 item 8)"
            )
        if proposal_mode not in ("random", "sweep"):
            raise ValueError(f"unknown proposal mode: {proposal_mode!r}")
        if not shared_proposals and proposal_mode != "sweep":
            raise NotImplementedError(
                "independent per-walker proposals are not ported yet "
                "(ROADMAP.md Queue 1 item 8)"
            )
        if rng not in chain.RNG_MODES:
            raise ValueError(f"unknown rng mode: {rng!r}")
        self.chain_block_size = int(chain_block_size)
        self.proposal_mode = str(proposal_mode)
        self.rng = rng
        super().__init__(
            temperature, ensemble, step_type, seed=seed,
            sublattice_probabilities=sublattice_probabilities,
            flip_weights=flip_weights, swap_weight=swap_weight,
        )
        self._chain_tables = None
        self._table_move = None

    @property
    def move(self) -> str:
        """The chain's move: ``"flip"``, ``"swap"`` or ``"table"``, by usher."""
        if isinstance(self.mcusher, TableFlip):
            return "table"
        return "swap" if isinstance(self.mcusher, Swap) else "flip"

    def initial_state(self, occupancies) -> dict:
        state = super().initial_state(occupancies)
        if self.move == "swap":
            # non-null proposals: pairs of equal codes are identity moves,
            # so this count gives the rate of moves that change something
            state["nmove"] = torch.zeros_like(state["naccept"])
        return state

    def chain_tables(self) -> chain.ChainTables:
        """The chain tables of this kernel's ensemble (built once)."""
        if self._chain_tables is None:
            ens = self._ensemble
            # a table move's embedded swaps follow its swapper's sublattice
            # probabilities; its flip directions carry their own sublattices
            usher = self.mcusher._swapper if self.move == "table" else self.mcusher
            self._chain_tables = chain.build_chain_tables(
                ens.processor,
                ens.sublattices,
                # swaps conserve composition: no chemical work, no mu table
                mu_table=(
                    None if self.move == "swap" else ens.chemical_potential_table
                ),
                sublattice_probabilities=usher.sublattice_probabilities,
            )
        return self._chain_tables

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
    """The kernel for ``kernel_type``; the port has ``"Metropolis"`` only."""
    if kernel_type.replace("-", "").replace("_", "").lower() != "metropolis":
        raise NotImplementedError(
            f"kernel type {kernel_type!r} is not ported yet (ROADMAP.md "
            "Queue 1: Wang-Landau is item 7, the others item 8)"
        )
    return Metropolis(ensemble, step_type, *args, **kwargs)
