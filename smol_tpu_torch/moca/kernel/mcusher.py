"""MC step proposers (ushers).

Counterpart of ``smol_tpu/moca/kernel/mcusher.py`` (:37-261): the usher
carries the active sublattices, the probability of proposing on each and
its ``spec``, and has two faces.  The host single-walker API
(:meth:`MCUsher.propose_step`, ``compute_log_priori_factor``,
``update_aux_state``, ``set_aux_state``), numpy over one occupancy, draws
from the usher's ``np.random.default_rng(rng)`` in the reference's order:
a kernel passes its own generator, so that usher and kernel share one
stream, as the reference's do.  The per-step path takes the usher's
device proposal (:meth:`MCUsher.device_proposal`, a function of
:mod:`smol_tpu_torch.ops.mc` bound to the usher's tables on a device).  The
hand-written chains draw ``Flip``, ``Swap`` and ``TableFlip`` proposals
themselves (:func:`smol_tpu_torch.ops.chain.rank_sequence`, ...), from the
same sublattice probabilities.  ``MultiStep`` chains several sub-steps of
a base usher, ``Composite`` mixes ushers by weight; on the device both
run on the per-step path only.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from smol_tpu_torch.moca.metadata import Metadata
from smol_tpu_torch.ops import mc
from smol_tpu_torch.utils.class_utils import get_subclasses, get_subclasses_str

__all__ = [
    "MCUsher",
    "Flip",
    "Swap",
    "MultiStep",
    "Composite",
    "mcusher_factory",
    "available_step_types",
]


def _species_spec(sublattice):
    """A sublattice's species for a spec (a system file's carry none)."""
    if sublattice.site_space is None:
        return [int(code) for code in sublattice.encoding]
    return [str(sp) for sp in sublattice.species]


class MCUsher:
    """Proposer over the active sublattices of an ensemble."""

    def __init__(self, sublattices, sublattice_probabilities=None, rng=None):
        self.sublattices = sublattices
        self.active_sublattices = [s for s in sublattices if s.is_active]
        if sublattice_probabilities is None:
            probs = np.full(len(self.active_sublattices),
                            1.0 / len(self.active_sublattices))
        else:
            probs = self._checked(sublattice_probabilities)
        self._sublatt_probs = probs
        self._rng = np.random.default_rng(rng)
        self.spec = Metadata(
            type(self).__name__,
            sublattices=[_species_spec(s) for s in self.sublattices],
            sublattice_probabilities=self._sublatt_probs.tolist(),
        )
        self._tables = None

    def _checked(self, probabilities) -> np.ndarray:
        if len(probabilities) != len(self.active_sublattices):
            raise AttributeError(
                "Sublattice probabilities must match number of active sublattices."
            )
        if abs(sum(probabilities) - 1) > 1e-12:
            raise ValueError("Sublattice probabilities must sum to one.")
        return np.asarray(probabilities, dtype=np.float64)

    @property
    def sublattice_probabilities(self):
        return self._sublatt_probs

    @sublattice_probabilities.setter
    def sublattice_probabilities(self, value):
        self._sublatt_probs = self._checked(value)
        self._tables = None

    @property
    def tables(self) -> mc.SublatticeTables:
        """The active sublattices as padded host tensors (built once a
        setting)."""
        if self._tables is None:
            self._tables = mc.sublattice_tables(self.sublattices, self._sublatt_probs)
        return self._tables

    def propose_step(self, occupancy) -> list:
        """Host proposal on one occupancy [N]: a list of (site, code) flips."""
        raise NotImplementedError

    def compute_log_priori_factor(self, occupancy, step) -> float:
        """Log a-priori factor of a step (0 for a symmetric proposal)."""
        return 0.0

    def update_aux_state(self, step, *args, **kwargs):
        """Update the usher's aux state after an accepted step (none here)."""
        return

    def set_aux_state(self, occupancy, *args, **kwargs):
        """Set the usher's aux state from an occupancy (none here)."""
        return

    def get_random_sublattice(self):
        """An active sublattice, drawn with the sublattice probabilities."""
        return self._rng.choice(self.active_sublattices, p=self._sublatt_probs)

    def device_proposal(self, device="cuda"):
        """(proposal, step width): ``propose(occu [W, N], generator) ->
        (sites, codes, valid, log_priori)`` over tables on ``device``."""
        raise NotImplementedError

    def device_log_priori(self, device="cuda"):
        """``(occu, sites, codes, valid) -> [W]`` log a-priori factor, or
        None for a symmetric proposal."""
        return None


class Flip(MCUsher):
    """Single-site flip to a different allowed code (semigrand moves)."""

    def propose_step(self, occupancy):
        sublattice = self.get_random_sublattice()
        site = self._rng.choice(sublattice.active_sites)
        choices = sorted(set(sublattice.encoding.tolist()) - {int(occupancy[site])})
        return [(int(site), int(self._rng.choice(choices)))]

    def device_proposal(self, device="cuda"):
        return partial(mc.flip_proposal, self.tables.to(device)), 1


class Swap(MCUsher):
    """Canonical swap of two differently-occupied sites of one sublattice."""

    def propose_step(self, occupancy):
        sublattice = self.get_random_sublattice()
        site1 = self._rng.choice(sublattice.active_sites)
        species1 = occupancy[site1]
        options = sublattice.active_sites[occupancy[sublattice.active_sites] != species1]
        if options.size > 0:
            site2 = self._rng.choice(options)
            return [(int(site1), int(occupancy[site2])), (int(site2), int(species1))]
        return []

    def device_proposal(self, device="cuda"):
        return partial(mc.swap_proposal, self.tables.to(device)), 2


class MultiStep(MCUsher):
    """Several chained sub-steps of a base usher (``smol_tpu/moca/kernel/
    mcusher.py:144``).

    Args:
        sublattices: all sublattices.
        mcusher: the base usher, or its step type.
        step_lengths: one length, or the lengths to choose from.
        step_probabilities: the probability of each length (default
            uniform).
    """

    def __init__(self, sublattices, mcusher, step_lengths, step_probabilities=None,
                 rng=None):
        super().__init__(sublattices, rng=rng)
        if isinstance(step_lengths, int):
            self._step_lens = np.array([step_lengths], dtype=int)
        else:
            self._step_lens = np.array(step_lengths, dtype=int)
        if step_probabilities is not None:
            if abs(sum(step_probabilities) - 1) > 1e-12:
                raise ValueError("step_probabilities must sum to 1.")
            if len(step_probabilities) != len(self._step_lens):
                raise ValueError("step_lengths and step_probabilities mismatch.")
            self._step_p = np.array(step_probabilities, dtype=np.float64)
        else:
            self._step_p = np.full(len(self._step_lens), 1 / len(self._step_lens))
        if isinstance(mcusher, str):
            mcusher = mcusher_factory(mcusher, self.sublattices, rng=rng)
        self._mcusher = mcusher
        self.spec.step = self._mcusher.spec
        self.spec.step_lengths = self._step_lens.tolist()
        self.spec.step_probabilities = self._step_p.tolist()

    @property
    def sublattice_probabilities(self):
        return self._mcusher.sublattice_probabilities

    @sublattice_probabilities.setter
    def sublattice_probabilities(self, value):
        self._mcusher.sublattice_probabilities = value

    def propose_step(self, occupancy):
        """A step length, then that many sub-steps of the base usher, each on
        the occupancy the earlier ones left; a sub-step that touches a site
        of an earlier one is dropped (the reference's :180-194)."""
        step_length = self._rng.choice(self._step_lens, p=self._step_p)
        occu = np.asarray(occupancy).copy()
        steps = [self._mcusher.propose_step(occu)]
        for site, code in steps[-1]:
            occu[site] = code
        for _ in range(step_length - 1):
            step = self._mcusher.propose_step(occu)
            taken = {s0 for st in steps for s0, _ in st}
            if all(s not in taken for s, _ in step):
                steps.append(step)
                for site, code in step:
                    occu[site] = code
        return [flip for step in steps for flip in step]

    def device_proposal(self, device="cuda"):
        base, width = self._mcusher.device_proposal(device)
        lengths = torch.as_tensor(self._step_lens, dtype=torch.int64, device=device)
        cum = torch.as_tensor(np.cumsum(self._step_p), dtype=torch.float64, device=device)
        fn = partial(mc.multistep_proposal, base, int(self._step_lens.max()), lengths, cum)
        return fn, int(self._step_lens.max()) * width


class Composite(MCUsher):
    """A mixture of ushers chosen with given weights (``smol_tpu/moca/kernel/
    mcusher.py:207``)."""

    def __init__(self, sublattices, mcushers, mcusher_weights=None, rng=None):
        super().__init__(sublattices, rng=rng)
        self._mcushers = []
        self._weights = []
        self.spec.steps = []
        if mcusher_weights is None:
            mcusher_weights = len(mcushers) * [1]
        for weight, usher in zip(mcusher_weights, mcushers):
            if isinstance(usher, str):
                usher = mcusher_factory(usher, self.sublattices, rng=rng)
            self.add_mcusher(usher, weight)

    @property
    def mcushers(self):
        return self._mcushers

    @property
    def weight(self):
        """The weight of each usher."""
        return self._weights

    @property
    def probabilities(self):
        total = sum(self._weights)
        return [w / total for w in self._weights]

    def add_mcusher(self, mcusher, weight=1):
        self._mcushers.append(mcusher)
        self._weights.append(weight)
        self.spec.steps.append(mcusher.spec)
        self.spec.weights = list(self._weights)

    def propose_step(self, occupancy):
        usher = self._rng.choice(self._mcushers, p=self.probabilities)
        return usher.propose_step(occupancy)

    def device_proposal(self, device="cuda"):
        parts = [usher.device_proposal(device) for usher in self._mcushers]
        width = max(w for _, w in parts)
        cum = torch.as_tensor(np.cumsum(self.probabilities), dtype=torch.float64,
                              device=device)
        return partial(mc.composite_proposal, parts, width, cum), width


def _usher_class(step_type: str):
    """The usher class a step type names, in any spelling of its words
    (``"multi-step"``, ``"multi_step"``, ``"MultiStep"``)."""
    key = step_type.replace("-", "").replace("_", "").lower()
    for name, cls in get_subclasses(MCUsher).items():
        if name.lower() == key:
            return cls
    raise NotImplementedError(
        f"{step_type} is not implemented as a subclass of MCUsher.")


def mcusher_factory(usher_type, sublattices, *args, table_data=None, **kwargs):
    """The usher of ``usher_type`` by class name (``"flip"``, ``"swap"``,
    ``"multi-step"``, ``"composite"`` or ``"table-flip"``).

    ``table_data`` holds the ensemble's ``flip_table`` and ``dim_ids`` (or
    None for a system without them); only the table-flip usher reads it.
    ``args`` and ``kwargs`` go to the usher.
    """
    cls = _usher_class(usher_type)
    if cls.__name__ == "TableFlip":
        kwargs = {**(table_data or {}), **kwargs}
    return cls(sublattices, *args, **kwargs)


def available_step_types() -> tuple:
    """The step types of every usher, as ``mcusher_factory`` takes them."""
    return get_subclasses_str(MCUsher)
