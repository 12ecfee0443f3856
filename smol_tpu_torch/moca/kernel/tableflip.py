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

The flip table is derived as the reference derives it (:41-104): the
dimension ids of each sublattice's species (``get_dim_ids_by_sublattice``)
and the basis of the constrained composition space
(:class:`~smol_tpu_torch.moca.composition.CompositionSpace`, charge-neutral
by default) over the sublattices' species and sizes; a stored flip table
(``flip_table`` and ``usher_dim_ids`` of a system dict, see
:mod:`smol_tpu_torch.system`) takes precedence, and a system file's
sublattices, which carry no species, need one.
"""

from __future__ import annotations

import numpy as np

from smol_tpu_torch.moca.composition.space import CompositionSpace
from smol_tpu_torch.moca.kernel.mcusher import MCUsher, Swap
from smol_tpu_torch.moca.occu_utils import get_dim_ids_by_sublattice

__all__ = ["TableFlip"]


class TableFlip(MCUsher):
    """Composition flips from a (charge-neutral) flip table.

    Args:
        sublattices: all sublattices, active and inactive.
        flip_table: [F, D] flip vectors in "counts" format; derived from
            the composition space of the sublattices' species when absent.
        dim_ids: per sublattice, the dimension id of each of its codes;
            derived from the sublattices' species when absent.
        charge_balanced: add the charge-neutrality constraint.
        other_constraints: extra constraints of the composition space.
        optimize_basis, table_ergodic: see
            :class:`~smol_tpu_torch.moca.composition.CompositionSpace`.
        flip_weights: per-direction weights, of length F or 2F (default
            ones).
        swap_weight: probability of attempting a canonical swap instead.
    """

    def __init__(self, sublattices, flip_table=None, dim_ids=None,
                 charge_balanced=True, other_constraints=None,
                 optimize_basis=False, table_ergodic=False,
                 flip_weights=None, swap_weight=0.1):
        super().__init__(sublattices)
        if flip_table is None or dim_ids is None:
            bits = [list(sl.species) for sl in sublattices]
            sizes = np.array([len(sl.sites) for sl in sublattices], dtype=int)
            supercell_size = int(np.gcd.reduce(sizes))
            self._comp_space = CompositionSpace(
                bits,
                (sizes // supercell_size).tolist(),
                charge_neutral=charge_balanced,
                other_constraints=other_constraints,
                optimize_basis=optimize_basis,
                table_ergodic=table_ergodic,
            )
            if dim_ids is None:
                dim_ids = get_dim_ids_by_sublattice(bits)
            if flip_table is None:
                flip_table = self._comp_space.flip_table
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
