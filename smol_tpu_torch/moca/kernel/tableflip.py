"""TableFlip usher: constrained (e.g. charge-neutral) composition moves.

Counterpart of ``smol_tpu/moca/kernel/tableflip.py`` (:38-112): the usher
holds the flip table of a composition space, one flip vector per row over
the D (sublattice, species) dimensions, the weight of each of its 2F signed
directions, the probability of attempting a canonical swap instead, and a
:class:`~smol_tpu_torch.moca.kernel.mcusher.Swap` usher whose sublattice
probabilities the embedded swaps follow.  The proposals themselves are
drawn on the device by the chain
(:func:`smol_tpu_torch.ops.chain.table_sequences`), exogenously and
symmetrically, so no a-priori factor enters the acceptance.  Where the
reference's kernels leave the chain (a bias, independent proposals,
restricted sites, Wang-Landau, or an usher the table chain cannot honour)
they take the per-step proposal and its a-priori factor
(``tableflip.py:241-508``): :meth:`TableFlip.device_proposal` and
:meth:`TableFlip.device_log_priori`, plain torch over all walkers
(:func:`smol_tpu_torch.ops.mc.table_flip_proposal`,
:func:`~smol_tpu_torch.ops.mc.table_flip_log_priori`).

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

from functools import partial

import numpy as np
import torch

from smol_tpu_torch.moca.composition.space import CompositionSpace
from smol_tpu_torch.moca.kernel.mcusher import MCUsher, Swap
from smol_tpu_torch.moca.occu_utils import get_dim_ids_by_sublattice, get_dim_ids_table
from smol_tpu_torch.ops import mc

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
        # the species counts' bounds and the (site, code) -> dimension
        # tables of the reference's usher (tableflip.py:71-104)
        self.max_n = [len(sl.active_sites) for sl in sublattices for _ in sl.encoding]
        self._dim_ids_table = get_dim_ids_table(sublattices, active_only=True)
        self._dim_ids_full = get_dim_ids_table(sublattices, active_only=False)
        self._flip_tables = None

    @property
    def flip_tables(self) -> mc.TableFlipTables:
        """The per-step proposal's tables, as host tensors (built once)."""
        if self._flip_tables is None:
            directions = np.concatenate([(u, -u) for u in self.flip_table], axis=0)
            dim_block = -np.ones(self.d, dtype=np.int64)
            code_of_dim = np.zeros(self.d, dtype=np.int64)
            active = []
            for bi, (sublatt, dim_ids) in enumerate(zip(self.sublattices, self.dim_ids)):
                if not sublatt.is_active:
                    continue
                active.append(sublatt.active_sites.astype(np.int64))
                for j, d in enumerate(dim_ids):
                    dim_block[d] = bi
                    code_of_dim[d] = sublatt.encoding[j]
            act_sites = np.concatenate(active)
            # the largest total removal count of any direction
            width = max(2, int(max(-dvec[dvec < 0].sum() for dvec in directions)))

            def host(x, dtype=torch.int64):
                return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype)

            self._flip_tables = mc.TableFlipTables(
                directions=host(directions),
                weights=host(self.flip_weights, torch.float64),
                max_n=host(self.max_n),
                dims_table=host(self._dim_ids_table),
                act_sites=host(act_sites),
                act_dims=host(self._dim_ids_table[act_sites]),
                dim_block=host(dim_block),
                code_of_dim=host(code_of_dim),
                width=width,
                swap_weight=self.swap_weight,
            )
        return self._flip_tables

    def device_proposal(self, device="cpu"):
        """(proposal, step width) of the per-step table flip
        (:func:`~smol_tpu_torch.ops.mc.table_flip_proposal`), its embedded
        swaps the swapper's."""
        tables = self.flip_tables.to(device)
        swap, _ = self._swapper.device_proposal(device)
        return partial(mc.table_flip_proposal, tables, swap), tables.width

    def device_log_priori(self, device="cpu"):
        """``(occu, sites, codes, valid) -> [W]`` log a-priori factor of a
        table flip (:func:`~smol_tpu_torch.ops.mc.table_flip_log_priori`)."""
        return partial(mc.table_flip_log_priori, self.flip_tables.to(device))
