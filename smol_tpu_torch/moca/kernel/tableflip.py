"""TableFlip usher: constrained (e.g. charge-neutral) composition moves.

Counterpart of ``smol_tpu/moca/kernel/tableflip.py`` (:38-112): the usher
holds the flip table of a composition space, one flip vector per row over
the D (sublattice, species) dimensions, the weight of each of its 2F signed
directions, the probability of attempting a canonical swap instead, and a
:class:`~smol_tpu_torch.moca.kernel.mcusher.Swap` usher whose sublattice
probabilities the embedded swaps follow.  The proposals themselves are
drawn on the device by the chain
(:func:`smol_tpu_torch.ops.chain.table_sequences`), exogenously and
symmetrically, so no a-priori factor enters the acceptance.  The host
single-walker API is the reference's (``tableflip.py:116-240``):
:meth:`TableFlip.propose_step` draws a direction among the feasible ones,
donor sites without replacement and their deal to the acceptor species
from the usher's numpy generator, and
:meth:`TableFlip.compute_log_priori_factor` is its detailed-balance factor.  Where the
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

import warnings
from functools import partial

import numpy as np
import torch
from scipy.special import gammaln

from smol_tpu_torch.moca.composition.space import CompositionSpace
from smol_tpu_torch.moca.kernel.mcusher import MCUsher, Swap
from smol_tpu_torch.moca.occu_utils import (
    delta_counts_from_step,
    get_dim_ids_by_sublattice,
    get_dim_ids_table,
    occu_to_counts,
    occu_to_species_list,
)
from smol_tpu_torch.ops import mc
from smol_tpu_torch.utils.math import NUM_TOL, choose_section_from_partition, flip_weights_mask

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
        rng: seed or numpy generator of the host proposals (a kernel passes
            its own); the embedded swapper takes the same argument.
    """

    def __init__(self, sublattices, flip_table=None, dim_ids=None,
                 charge_balanced=True, other_constraints=None,
                 optimize_basis=False, table_ergodic=False,
                 flip_weights=None, swap_weight=0.1, rng=None):
        super().__init__(sublattices, rng=rng)
        self._comp_space = None
        sizes = np.array([len(sl.sites) for sl in sublattices], dtype=int)
        self.supercell_size = int(np.gcd.reduce(sizes))
        if flip_table is None or dim_ids is None:
            bits = [list(sl.species) for sl in sublattices]
            self._comp_space = CompositionSpace(
                bits,
                (sizes // self.supercell_size).tolist(),
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
        # as the reference's: a kernel's generator is shared, a seed seeds
        # the swapper's own generator alike
        self._swapper = Swap(sublattices, rng=rng)
        # the species counts' bounds and the (site, code) -> dimension
        # tables of the reference's usher (tableflip.py:71-104)
        self.max_n = [len(sl.active_sites) for sl in sublattices for _ in sl.encoding]
        self._dim_ids_table = get_dim_ids_table(sublattices, active_only=True)
        self._dim_ids_full = get_dim_ids_table(sublattices, active_only=False)
        self._flip_tables = None

    # ---------------- host path ----------------

    def _direction_weights(self, counts):
        """Weights of the 2F signed directions, zero where a direction would
        take a species count out of [0, max_n]."""
        feasible = flip_weights_mask(self.flip_table, counts, self.max_n)
        return self.flip_weights * feasible.astype(float)

    def _on_manifold(self, occupancy) -> bool:
        """Whether the occupancy's counts satisfy the composition space's
        constraints; an usher given its flip table (a system file's, whose
        sublattices carry no species) has no constraints to check."""
        if self._comp_space is None:
            return True
        full_counts = [len(p) for p in
                       occu_to_species_list(occupancy, self.d, self._dim_ids_full)]
        return np.allclose(self._comp_space._A @ np.array(full_counts),
                           self._comp_space._b * self.supercell_size)

    def propose_step(self, occupancy):
        """A table flip on one occupancy [N] (the reference's :116-180): with
        probability ``swap_weight`` the swapper's swap; else a direction
        drawn among the feasible ones by weight, its donor sites drawn
        without replacement from each donor species, pooled per sublattice,
        shuffled and dealt to the acceptor species in order."""
        rng = self._rng
        if rng.random() < self.swap_weight:
            return self._swapper.propose_step(occupancy)

        pools = occu_to_species_list(occupancy, self.d, self._dim_ids_table)
        if self._on_manifold(occupancy):
            sector_weights = self._direction_weights([len(p) for p in pools])
        else:
            warnings.warn(
                "Current occupancy violates CompositionSpace constraints! "
                "Are you initializing trace?"
            )
            sector_weights = np.zeros(2 * len(self.flip_table))
        if np.any(sector_weights <= -NUM_TOL):
            raise ValueError(f"Masked weights {sector_weights} negative!")
        if np.allclose(sector_weights, 0):
            if not np.allclose(occupancy, 0):
                warnings.warn(
                    "Current occupancy is not ergodic! Will do canonical swap only!"
                )
            return self._swapper.propose_step(occupancy)

        pick = choose_section_from_partition(sector_weights, rng=rng)
        u = (1 - 2 * (pick % 2)) * self.flip_table[pick // 2]

        step = []
        for sublatt, dim_ids in zip(self.sublattices, self.dim_ids):
            if not sublatt.is_active:
                continue
            u_sl = u[dim_ids]
            donors = [
                site
                for d in dim_ids[u_sl < 0]
                for site in rng.choice(pools[d], size=-u[d], replace=False)
            ]
            if not donors:
                continue
            dealt = rng.permutation(np.asarray(donors, dtype=int))
            offset = 0
            for d, code in zip(dim_ids[u_sl > 0], sublatt.encoding[u_sl > 0]):
                step.extend((int(site), int(code)) for site in dealt[offset: offset + u[d]])
                offset += u[d]
        return step

    def _match_direction(self, occupancy, step):
        """Signed-direction index (into 2F) of a step, -1 for a null move;
        raises where the step's count change is not a flip-table row or its
        negative."""
        dn = delta_counts_from_step(occupancy, step, self.d, self._dim_ids_table)
        if not np.any(dn):
            return -1
        hits = np.flatnonzero(np.all(self.flip_table == dn[None, :], axis=1))
        if hits.size:
            return 2 * int(hits[0])
        hits = np.flatnonzero(np.all(self.flip_table == -dn[None, :], axis=1))
        if hits.size:
            return 2 * int(hits[0]) + 1
        raise ValueError(f"Step {step} is not in flip table.")

    def compute_log_priori_factor(self, occupancy, step) -> float:
        """log p(reverse) / p(forward) of a step (the reference's :205-240):
        the directions' choice probabilities and the gammaln terms of the
        site choices; 0 for a swap."""
        pick = self._match_direction(occupancy, step)
        if pick < 0:
            return 0.0
        reverse = pick + 1 - 2 * (pick % 2)
        u = (1 - 2 * (pick % 2)) * self.flip_table[pick // 2]
        n_now = occu_to_counts(occupancy, self.d, self._dim_ids_table)
        n_next = n_now + u
        w_now = self._direction_weights(n_now)
        w_next = self._direction_weights(n_next)
        log_factor = np.log((w_next[reverse] / w_next.sum()) / (w_now[pick] / w_now.sum()))
        changed = np.flatnonzero(u)
        log_factor += np.sum(gammaln(n_now[changed] + 1) - gammaln(n_next[changed] + 1))
        return float(log_factor)

    # ---------------- device path ----------------

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

    def device_proposal(self, device="cuda"):
        """(proposal, step width) of the per-step table flip
        (:func:`~smol_tpu_torch.ops.mc.table_flip_proposal`), its embedded
        swaps the swapper's."""
        tables = self.flip_tables.to(device)
        swap, _ = self._swapper.device_proposal(device)
        return partial(mc.table_flip_proposal, tables, swap), tables.width

    def device_log_priori(self, device="cuda"):
        """``(occu, sites, codes, valid) -> [W]`` log a-priori factor of a
        table flip (:func:`~smol_tpu_torch.ops.mc.table_flip_log_priori`)."""
        return partial(mc.table_flip_log_priori, self.flip_tables.to(device))
