"""MC kernel base classes: walker state, bias, chain options, temperature.

Counterpart of ``smol_tpu/moca/kernel/base.py`` (``MCKernelInterface``
:58-95, ``StandardSingleStepMixin`` :98-150, ``MCKernel`` :153-384,
``ThermalKernelMixin`` :387-430, ``MetropolisAcceptMixin`` :433-444).  The
batched walker state is a dict of tensors on the ensemble's device and
holds the plain ``occupancy`` [W, N] int32 (the reference packs it into
words for its TPU fast path).

A kernel also has the reference's host single-walker API, numpy over one
occupancy [N]: :meth:`StandardSingleStepMixin.single_step` proposes with
the usher's ``propose_step``, takes the step's feature change from the
ensemble's ``compute_feature_vector_change`` (and the bias change from the
bias's ``compute_bias_change``) into the kernel's ``trace``, accepts with
the kernel's ``_accept_step`` and applies the step in place.  The kernel's
``np.random.default_rng(seed)`` is shared by the usher and the bias and is
drawn from in the reference's order, so the same seed gives the
reference's trajectory.

A kernel runs its steps on one of two paths, chosen once from its
configuration, as the reference chooses (``metropolis.py:197-239``):

- the hand-written chains of :mod:`smol_tpu_torch.ops.chain` (one launch
  a window; :class:`ChainKernel`), with shared proposals (or the flip
  sweep), no bias, a ``Flip``, ``Swap`` or ``TableFlip`` usher (one the
  table chain can honour, :func:`~smol_tpu_torch.ops.chain.
  table_move_refusal`) and a system the chain tables take
  (:func:`~smol_tpu_torch.ops.chain.chain_refusal`: no restricted site,
  default encodings);
- the per-step path of :mod:`smol_tpu_torch.ops.mc` everywhere else
  (:meth:`MCKernel.make_step_fn`): plain torch ops over all walkers, each
  walker with its own proposals.

A kernel that fails to build or launch raises; it never falls back.
"""

from __future__ import annotations

import secrets
from math import log

import numpy as np
import torch

from smol_tpu_torch.constants import kB
from smol_tpu_torch.moca.kernel.bias import MCBias, mcbias_factory
from smol_tpu_torch.moca.kernel.mcusher import Flip, MCUsher, Swap, mcusher_factory
from smol_tpu_torch.moca.kernel.tableflip import TableFlip
from smol_tpu_torch.moca.metadata import Metadata
from smol_tpu_torch.moca.trace import StepTrace, Trace
from smol_tpu_torch.ops import chain
from smol_tpu_torch.ops import mc as devmc
from smol_tpu_torch.utils.class_utils import get_subclasses

__all__ = [
    "MCKernelInterface",
    "StandardSingleStepMixin",
    "MCKernel",
    "ChainKernel",
    "ThermalKernelMixin",
    "MetropolisAcceptMixin",
    "ALL_MCUSHERS",
    "ALL_BIAS",
]


def _sum_log_priori(fns, occu, sites, codes, valid):
    total = 0.0
    for f in fns:
        total = total + f(occu, sites, codes, valid)
    return total


# evaluated when a kernel checks them, since subclasses may be defined later;
# staticmethod so that class-attribute access does not bind them as methods
ALL_MCUSHERS = staticmethod(lambda: list(get_subclasses(MCUsher)))
ALL_BIAS = staticmethod(lambda: list(get_subclasses(MCBias)))


def _names(valid):
    return valid() if callable(valid) else valid


class MCKernelInterface:
    """What every MC kernel offers (the reference's :58-95): the ``trace`` of
    its last host step, its ``spec``, ``single_step``,
    ``compute_initial_trace`` and ``set_aux_state``.  Kernels that do not
    follow the propose/accept decomposition (the multicell kernels)
    implement it directly."""

    @property
    def trace(self):
        """The :class:`~smol_tpu_torch.moca.trace.StepTrace` of the last host
        step."""
        return self._trace

    @property
    def spec(self):
        """Metadata specification for reproducibility."""
        return self._spec

    def single_step(self, occupancy):
        """One MC step on one occupancy [N] (changed in place); returns the
        step trace."""
        raise NotImplementedError

    def compute_initial_trace(self, occupancy):
        """Absolute-value trace of one occupancy [N]."""
        raise NotImplementedError

    def set_aux_state(self, occupancy, *args, **kwargs):
        """Set auxiliary state from an initial or checkpoint occupancy."""


class StandardSingleStepMixin:
    """The standard host step: propose, trace, accept, apply, post (the
    reference's :98-150).  Subclasses give ``_accept_step``;
    ``_do_post_step`` is a hook (Wang-Landau's histogram updates)."""

    def _compute_step_trace(self, occupancy, step):
        delta_trace = self._trace.delta_trace
        delta_trace.features = self._ensemble.compute_feature_vector_change(
            occupancy, step)
        delta_trace.enthalpy = np.array(
            np.dot(self.natural_params, delta_trace.features), dtype=np.float64)
        if self._bias is not None:
            delta_trace.bias = np.array(
                self._bias.compute_bias_change(occupancy, step), dtype=np.float64)

    def _accept_step(self, occupancy, step) -> bool:
        """Accept or reject the step on the current delta trace."""
        raise NotImplementedError

    def _do_accept_step(self, occupancy, step):
        for site, code in step:
            occupancy[site] = code
        self.mcusher.update_aux_state(step)
        return occupancy

    def _do_post_step(self):
        return

    def single_step(self, occupancy):
        """One MC step on one occupancy [N] (changed in place)."""
        step = self.mcusher.propose_step(occupancy)
        self._compute_step_trace(occupancy, step)
        if self._accept_step(occupancy, step):
            occupancy = self._do_accept_step(occupancy, step)
        self._trace.occupancy = occupancy
        self._do_post_step()
        return self._trace


class MCKernel(StandardSingleStepMixin, MCKernelInterface):
    """An MC transition kernel over an ensemble.

    Args:
        ensemble: the :class:`~smol_tpu_torch.moca.ensemble.Ensemble`.
        step_type: the usher (``"flip"``, ``"swap"``, ``"multi-step"``,
            ``"composite"`` or ``"table-flip"``); ``args`` and ``kwargs``
            go to it.
        seed: seed of the run's generator.
        bias_type: a bias (``"fugacity-bias"``, ``"square-charge-bias"``,
            ``"square-hyperplane-bias"``), with ``bias_kwargs``.
    """

    valid_mcushers = None  # usher class names this kernel takes (None: all)
    valid_bias = None  # bias class names this kernel takes (None: none)
    track_features = False  # the state carries (and the sampler records) features
    trace_names = ()  # state entries recorded with every sample, by name
    aux_traces = {}  # state entry -> the aux trace that records it

    def __init__(self, ensemble, step_type, *args, seed=None, bias_type=None,
                 bias_kwargs=None, **kwargs):
        self._ensemble = ensemble
        self.natural_params = np.asarray(ensemble.natural_parameters)
        self._seed = int(seed) if seed is not None else secrets.randbits(62)
        # the host steps' generator, shared by the usher and the bias
        self._rng = np.random.default_rng(self._seed)
        self._trace = StepTrace(accepted=np.array(True))
        self._usher = self._bias = None
        self.mcusher = mcusher_factory(step_type, ensemble.sublattices, *args,
                                       table_data=ensemble.table_data, rng=self._rng,
                                       **kwargs)
        self._spec = Metadata(type(self).__name__, seed=self._seed, step=self.mcusher.spec)
        if bias_type is not None:
            self.bias = mcbias_factory(bias_type, ensemble.sublattices, rng=self._rng,
                                       **(bias_kwargs or {}))
            self._spec.bias = self.bias.spec

    # ---------------- properties ----------------

    @property
    def ensemble(self):
        return self._ensemble

    @property
    def seed(self) -> int:
        return self._seed

    @property
    def device(self) -> torch.device:
        return self._ensemble.device

    @property
    def mcusher(self):
        return self._usher

    @mcusher.setter
    def mcusher(self, usher):
        valid = _names(self.valid_mcushers)
        if valid is not None and type(usher).__name__ not in valid:
            raise ValueError(f"{type(usher)} is not a valid MCUsher for this kernel.")
        self._usher = usher

    @property
    def bias(self):
        return self._bias

    @bias.setter
    def bias(self, bias):
        valid = _names(self.valid_bias)
        if valid is None or type(bias).__name__ not in valid:
            raise ValueError(f"{type(bias)} is not a valid MCBias for this kernel.")
        if "bias" not in self._trace.delta_trace.names:
            self._trace.delta_trace.bias = np.zeros(1)
        self._bias = bias

    @property
    def runs_chain(self) -> bool:
        """Whether the kernel's steps run on a hand-written chain (else on the
        per-step path)."""
        return False

    # ---------------- walker state ----------------

    def full_features_fn(self):
        """``occupancies [W, N] -> features [W, F]`` incl. chemical work."""
        return self._ensemble.compute_features

    def state_occupancy(self, state) -> torch.Tensor:
        """[W, N] int32 occupancies of a walker state."""
        return state["occupancy"]

    def initial_state(self, occupancies) -> dict:
        """Batched walker state from [W, N] int occupancies."""
        occupancies = np.atleast_2d(np.asarray(occupancies, dtype=np.int32))
        nsites = self._ensemble.num_sites
        if occupancies.shape[1] != nsites:
            raise ValueError(
                f"occupancies have {occupancies.shape[1]} sites per walker "
                f"but the ensemble supercell has {nsites}"
            )
        # a copy: the chain updates the state in place, never the caller's array
        occu = torch.tensor(occupancies, device=self.device)
        feats = self.full_features_fn()(occu)
        params = torch.as_tensor(self.natural_params, device=self.device)
        nwalkers = occu.shape[0]
        state = {
            "occupancy": occu,
            "enthalpy": (feats @ params).contiguous(),
            "accepted": torch.ones(nwalkers, dtype=torch.bool, device=self.device),
            "naccept": torch.zeros(nwalkers, dtype=torch.int32, device=self.device),
        }
        if self.track_features:
            state["features"] = feats
        return state

    def set_aux_state(self, occupancy, *args, **kwargs):
        """Set the usher's aux state from an initial or checkpoint occupancy."""
        self.mcusher.set_aux_state(occupancy, *args, **kwargs)

    def compute_initial_trace(self, occupancy) -> Trace:
        """Absolute-value trace of one occupancy [N] (host arrays)."""
        trace = Trace()
        trace.occupancy = occupancy
        trace.features = self._ensemble.compute_feature_vector(occupancy)
        trace.enthalpy = np.array([np.dot(self.natural_params, trace.features)],
                                  dtype=np.float64)
        if self._bias is not None:
            trace.bias = np.array([self._bias.compute_bias(occupancy)], dtype=np.float64)
        trace.accepted = np.array([True], dtype=bool)
        return trace

    # ---------------- the per-step path ----------------

    def _device_applier(self):
        """The step applier of the ensemble's batched deltas (with the
        feature change where the kernel tracks features)."""
        processor = self._ensemble.processor
        processor.prepare_deltas()
        table = self._ensemble.chemical_potential_table
        mu = None if table is None else torch.as_tensor(table, dtype=torch.float64,
                                                        device=self.device)
        return devmc.make_step_applier(
            processor.delta_energy, mu_table=mu,
            delta_features_fn=processor.delta_features if self.track_features else None)

    def _device_log_priori(self):
        """The usher's a-priori factor plus the bias change, or None."""
        usher_fn = self.mcusher.device_log_priori(self.device)
        bias_fn = None if self._bias is None else self._bias.device_delta_fn(self.device)
        fns = tuple(f for f in (usher_fn, bias_fn) if f is not None)
        if not fns:
            return None
        if len(fns) == 1:
            return fns[0]
        return lambda *args: _sum_log_priori(fns, *args)

    def make_step_fn(self):
        """One step of every walker on the per-step path,
        ``step(state, generator) -> state``."""
        raise NotImplementedError

    def make_chain_fn(self, n_steps: int):
        """Fused multi-step chain function ``fn(state, generator) -> state``."""
        raise NotImplementedError

    def restore_aux_state(self, state: dict, container) -> dict:
        """``state`` with the kernel's aux state as ``container`` last
        recorded it; a kernel without aux state returns ``state``."""
        return state


class ChainKernel(MCKernel):
    """A kernel whose steps run on the shared-proposal chains of
    :mod:`smol_tpu_torch.ops.chain` where its configuration allows
    (:attr:`runs_chain`), else on the per-step path.

    Args:
        shared_proposals: walkers of one chain block share the proposal
            site sequence (False: every walker draws its own, on the
            per-step path; the flip sweep is walker-independent anyway).
        chain_block_size: walkers per block (the sharing granularity),
            taken as given.
        proposal_mode: ``"random"`` or ``"sweep"`` (flips only).
        rng: ``"philox"`` (run mode) or ``"hash"`` (the reference's
            interpret-mode random numbers, for parity checks).
        chain_delta: the chain's site body, ``"direct"``, ``"qary"``
            (K3's Z_q character rows) or ``"ising"`` (K1-Ising's parity
            rows), each for systems whose tables take it (see
            :func:`~smol_tpu_torch.ops.chain.build_chain_tables`), in every
            chain (flips, swaps, table moves, Wang-Landau); None (the
            default) takes the body
            :func:`~smol_tpu_torch.ops.chain.default_delta` names for the
            system and the chain.
        args, kwargs: go to :class:`MCKernel` (the usher, the seed and the
            bias).
    """

    def __init__(self, ensemble, step_type, *args, shared_proposals=True,
                 chain_block_size=1024, proposal_mode="random", rng="philox",
                 chain_delta=None, **kwargs):
        if proposal_mode not in ("random", "sweep"):
            raise ValueError(f"unknown proposal mode: {proposal_mode!r}")
        if rng not in chain.RNG_MODES:
            raise ValueError(f"unknown rng mode: {rng!r}")
        if chain_delta is not None and chain_delta not in chain.DELTAS:
            raise ValueError(f"unknown chain delta {chain_delta!r}: one of {chain.DELTAS}")
        self.shared_proposals = bool(shared_proposals)
        self.chain_delta = chain_delta
        self.chain_block_size = int(chain_block_size)
        self.proposal_mode = str(proposal_mode)
        self.rng = rng
        super().__init__(ensemble, step_type, *args, **kwargs)
        self._chain_tables = None
        self._runs_chain = self._chain_refusal() is None

    def _chain_refusal(self):
        """Why this configuration takes the per-step path, or None where it
        runs on a chain."""
        if not self.shared_proposals and self.proposal_mode != "sweep":
            return "independent proposals"
        if self._bias is not None:
            return "a bias"
        if type(self.mcusher) not in (Flip, Swap, TableFlip):
            return f"a {type(self.mcusher).__name__} usher"
        ens = self._ensemble
        refusal = chain.chain_refusal(ens.processor, ens.sublattices)
        if refusal is None and type(self.mcusher) is TableFlip:
            refusal = chain.table_move_refusal(self.mcusher)
        return refusal

    @property
    def runs_chain(self) -> bool:
        return self._runs_chain

    @property
    def move(self) -> str:
        """The chain's move: ``"flip"``, ``"swap"`` or ``"table"``, by usher."""
        if isinstance(self.mcusher, TableFlip):
            return "table"
        return "swap" if isinstance(self.mcusher, Swap) else "flip"

    @property
    def chain_name(self) -> str:
        """What runs on the chain, as the execution path names it."""
        return self.move

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
                delta=self.chain_delta or chain.default_delta(
                    ens.processor, ens.sublattices),
            )
        return self._chain_tables


class ThermalKernelMixin:
    """Mixin adding a temperature and beta to a kernel.

    The temperature is a scalar, or a per-walker ladder [W] (replica
    exchange): ``state["beta"]`` is then each walker's 1 / (kB T), f64,
    and the chains read its f32 copy.
    """

    _kB: float = kB

    def __init__(self, temperature, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.temperature = temperature

    @property
    def kB(self):
        """Boltzmann's constant of beta (settable: 1 for unitless
        temperatures, as the SQS search's)."""
        return self._kB

    @kB.setter
    def kB(self, value):
        self._kB = value
        self.beta = 1.0 / (self._kB * self._temperature)

    @property
    def temperature(self):
        """Temperature (a float, or a per-walker array for a ladder)."""
        return self._temperature

    @temperature.setter
    def temperature(self, temperature):
        temperature = np.array(temperature, dtype=np.float64)
        if temperature.ndim > 1:
            raise ValueError("the temperature is a scalar or a per-walker ladder [W]")
        self._temperature = float(temperature) if temperature.ndim == 0 else temperature
        self.beta = 1.0 / (self._kB * self._temperature)
        self._trace.temperature = temperature

    def compute_initial_trace(self, occupancy):
        trace = super().compute_initial_trace(occupancy)
        trace.temperature = np.array([self.temperature], dtype=np.float64)
        return trace

    def initial_state(self, occupancies) -> dict:
        state = super().initial_state(occupancies)
        nwalkers = state["enthalpy"].shape[0]
        beta = np.asarray(self.beta, dtype=np.float64)
        if beta.ndim == 1 and len(beta) != nwalkers:
            raise ValueError(
                f"a temperature ladder of {len(beta)} for {nwalkers} walkers")
        state["beta"] = torch.as_tensor(
            np.broadcast_to(beta, (nwalkers,)).copy(), device=self.device)
        return state


class MetropolisAcceptMixin:
    """The host Metropolis-Hastings test (the reference's :433-444): accept
    where -beta dH + the usher's log a-priori factor (+ the bias change) is
    >= 0, or above the log of a uniform draw of the kernel's generator."""

    def _accept_step(self, occupancy, step):
        log_factor = self.mcusher.compute_log_priori_factor(occupancy, step)
        exponent = -self.beta * self._trace.delta_trace.enthalpy + log_factor
        if self._bias is not None:
            exponent += self._trace.delta_trace.bias
        self._trace.accepted = np.array(
            True if exponent >= 0 else exponent > log(self._rng.random()))
        return self._trace.accepted
