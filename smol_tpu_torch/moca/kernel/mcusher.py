"""MC step proposers (ushers): the single-site Flip and the two-site Swap.

A minimal counterpart of ``smol_tpu/moca/kernel/mcusher.py`` (:40-55,
``Flip`` and ``Swap``): the usher carries the active sublattices and the
probability of proposing on each.  The proposals themselves are drawn on
the device by the chain (:func:`smol_tpu_torch.ops.chain.rank_sequence`,
:func:`~smol_tpu_torch.ops.chain.rank_pair_sequence`).  The factory also
builds the :class:`~smol_tpu_torch.moca.kernel.tableflip.TableFlip` usher.
"""

from __future__ import annotations

import numpy as np

__all__ = ["MCUsher", "Flip", "Swap", "mcusher_factory"]


class MCUsher:
    """Proposer over the active sublattices of an ensemble."""

    def __init__(self, sublattices, sublattice_probabilities=None):
        self.sublattices = sublattices
        self.active_sublattices = [s for s in sublattices if s.is_active]
        n = len(self.active_sublattices)
        if sublattice_probabilities is None:
            probs = np.full(n, 1.0 / n)
        else:
            probs = np.asarray(sublattice_probabilities, dtype=np.float64)
            if len(probs) != n:
                raise ValueError(
                    "Sublattice probabilities must match the number of "
                    "active sublattices."
                )
            if abs(probs.sum() - 1) > 1e-12:
                raise ValueError("Sublattice probabilities must sum to one.")
        self.sublattice_probabilities = probs


class Flip(MCUsher):
    """Recolor one site to another allowed code (semigrand moves)."""


class Swap(MCUsher):
    """Exchange the codes of two sites of one sublattice (canonical moves)."""


USHERS = {"flip": Flip, "swap": Swap}


def mcusher_factory(step_type: str, sublattices, table_data=None,
                    **kwargs) -> MCUsher:
    """The usher for ``step_type``: ``"flip"``, ``"swap"`` or ``"table-flip"``.

    ``table_data`` holds the ensemble's ``flip_table`` and ``dim_ids`` (or
    None for a system without them); only the table-flip usher reads it.
    ``kwargs`` go to the usher; None values are left to its defaults.
    """
    name = step_type.replace("-", "").replace("_", "").lower()
    kwargs = {key: value for key, value in kwargs.items() if value is not None}
    if name == "tableflip":
        from smol_tpu_torch.moca.kernel.tableflip import TableFlip

        return TableFlip(sublattices, **(table_data or {}), **kwargs)
    usher = USHERS.get(name)
    if usher is None:
        raise NotImplementedError(
            f"step type {step_type!r} is not ported yet (ROADMAP.md Queue 1 "
            "item 8)"
        )
    return usher(sublattices, **kwargs)
