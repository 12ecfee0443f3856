"""MC kernel base classes: walker state, chain options and temperature.

Counterpart of ``smol_tpu/moca/kernel/base.py`` (``full_features_fn``
:282, ``state_occupancy``/``initial_state`` :338-384,
``ThermalKernelMixin`` :387-430).  The batched walker state is a dict of
tensors on the ensemble's device and holds the plain ``occupancy`` [W, N]
int32 (the reference packs it into words for its TPU fast path).
:class:`ChainKernel` holds what the kernels that run on the
shared-proposal chains share: the chain's options, its move and its tables.
"""

from __future__ import annotations

import secrets

import numpy as np
import torch

from smol_tpu_torch.constants import kB
from smol_tpu_torch.moca.kernel.mcusher import Swap, mcusher_factory
from smol_tpu_torch.moca.kernel.tableflip import TableFlip
from smol_tpu_torch.ops import chain

__all__ = ["MCKernel", "ChainKernel", "ThermalKernelMixin"]


class MCKernel:
    """An MC transition kernel over an ensemble."""

    track_features = False  # the state carries (and the sampler records) features
    trace_names = ()  # state entries recorded with every sample, by name
    aux_traces = {}  # state entry -> the aux trace that records it

    def __init__(self, ensemble, step_type, *, seed=None, **usher_kwargs):
        self._ensemble = ensemble
        self.natural_params = np.asarray(ensemble.natural_parameters)
        self._seed = int(seed) if seed is not None else secrets.randbits(62)
        self.mcusher = mcusher_factory(
            step_type, ensemble.sublattices, table_data=ensemble.table_data,
            **usher_kwargs,
        )

    @property
    def seed(self) -> int:
        return self._seed

    @property
    def device(self) -> torch.device:
        return self._ensemble.device

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

    def make_chain_fn(self, n_steps: int):
        """Fused multi-step chain function ``fn(state, generator) -> state``."""
        raise NotImplementedError

    def restore_aux_state(self, state: dict, container) -> dict:
        """``state`` with the kernel's aux state as ``container`` last
        recorded it; a kernel without aux state returns ``state``."""
        return state


class ChainKernel(MCKernel):
    """A kernel whose steps run on the shared-proposal chains of
    :mod:`smol_tpu_torch.ops.chain`.

    Args:
        shared_proposals: must be True unless ``proposal_mode="sweep"``:
            walkers of one block share the proposal site sequence.
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
        usher_kwargs: go to the usher of ``step_type``.

    What the reference sends to its per-step path (a bias, independent
    proposals) raises ``NotImplementedError`` naming the ROADMAP.md item
    that ports it; nothing silently takes another path.
    """

    def __init__(self, ensemble, step_type, *, seed=None, bias_type=None,
                 shared_proposals=True, chain_block_size=1024,
                 proposal_mode="random", rng="philox", chain_delta=None,
                 **usher_kwargs):
        if bias_type is not None:
            raise NotImplementedError(
                "MC biases are not ported yet (ROADMAP.md Queue 1 item 6)"
            )
        if proposal_mode not in ("random", "sweep"):
            raise ValueError(f"unknown proposal mode: {proposal_mode!r}")
        if not shared_proposals and proposal_mode != "sweep":
            raise NotImplementedError(
                "independent per-walker proposals are not ported yet "
                "(ROADMAP.md Queue 1 item 6)"
            )
        if rng not in chain.RNG_MODES:
            raise ValueError(f"unknown rng mode: {rng!r}")
        if chain_delta is not None and chain_delta not in chain.DELTAS:
            raise ValueError(f"unknown chain delta {chain_delta!r}: one of {chain.DELTAS}")
        self.chain_delta = chain_delta
        self.chain_block_size = int(chain_block_size)
        self.proposal_mode = str(proposal_mode)
        self.rng = rng
        super().__init__(ensemble, step_type, seed=seed, **usher_kwargs)
        self._chain_tables = None

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
