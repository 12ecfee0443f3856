"""TableFlip usher: constrained (e.g. charge-neutral) composition moves.

Counterpart of ``smol_tpu/moca/kernel/tableflip.py`` (:38-112): the usher
holds the flip table of a composition space, one flip vector per row over
the D (sublattice, species) dimensions, the weight of each of its 2F signed
directions, the probability of attempting a canonical swap instead, and a
:class:`~smol_tpu_torch.moca.kernel.mcusher.Swap` usher whose sublattice
probabilities the embedded swaps follow.  The proposals themselves are
drawn on the device by the chain
(:func:`smol_tpu_torch.ops.chain.table_sequences`), exogenously and
symmetrically, so no a-priori factor enters the acceptance.

The flip table comes with the system (``flip_table`` and ``usher_dim_ids``
of a system dict, see :mod:`smol_tpu_torch.system`): the composition space
that derives it from the sublattices' species is part of the host layer,
which is not ported yet.
"""

from __future__ import annotations

import numpy as np

from smol_tpu_torch.moca.kernel.mcusher import MCUsher, Swap

__all__ = ["TableFlip"]


class TableFlip(MCUsher):
    """Composition flips from a (charge-neutral) flip table.

    Args:
        sublattices: all sublattices, active and inactive.
        flip_table: [F, D] flip vectors in "counts" format.
        dim_ids: per sublattice, the dimension id of each of its codes.
        flip_weights: per-direction weights, of length F or 2F (default
            ones).
        swap_weight: probability of attempting a canonical swap instead.
    """

    def __init__(self, sublattices, flip_table=None, dim_ids=None,
                 flip_weights=None, swap_weight=0.1):
        super().__init__(sublattices)
        if flip_table is None or dim_ids is None:
            raise NotImplementedError(
                "the system carries no flip table, and deriving one from the "
                "sublattices' species (CompositionSpace) is not ported yet "
                "(ROADMAP.md Queue 1 item 5(c))"
            )
        self.flip_table = np.array(flip_table, dtype=np.int64).reshape(
            len(flip_table), -1
        )
        self.dim_ids = [np.asarray(ids, dtype=np.int64) for ids in dim_ids]
        if len(self.dim_ids) != len(sublattices) or any(
            len(ids) != len(s.encoding) for ids, s in zip(self.dim_ids, sublattices)
        ):
            raise ValueError("one dimension id per code of every sublattice")
        self.d = sum(len(ids) for ids in self.dim_ids)
        if self.flip_table.shape[1] != self.d:
            raise ValueError(
                f"flip vectors have {self.flip_table.shape[1]} dimensions, "
                f"the sublattices {self.d}"
            )
        self.swap_weight = float(swap_weight)

        n_flips = len(self.flip_table)
        if flip_weights is None:
            self.flip_weights = np.ones(2 * n_flips)
        elif len(flip_weights) == n_flips:
            self.flip_weights = np.repeat(np.asarray(flip_weights, dtype=np.float64), 2)
        elif len(flip_weights) == 2 * n_flips:
            self.flip_weights = np.array(flip_weights, dtype=np.float64)
        else:
            raise ValueError(
                f"{len(flip_weights)} weights provided; need 1x or 2x of "
                f"{n_flips} flip vectors!"
            )
        self._swapper = Swap(sublattices)
