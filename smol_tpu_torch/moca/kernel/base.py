"""MC kernel base classes: walker state and temperature.

Counterpart of ``smol_tpu/moca/kernel/base.py`` (``full_features_fn``
:282, ``state_occupancy``/``initial_state`` :338-384,
``ThermalKernelMixin`` :387-430).  The batched walker state is a dict of
tensors on the ensemble's device and holds the plain ``occupancy`` [W, N]
int32 (the reference packs it into words for its TPU fast path).
"""

from __future__ import annotations

import secrets

import numpy as np
import torch

from smol_tpu_torch.constants import kB
from smol_tpu_torch.moca.kernel.mcusher import mcusher_factory

__all__ = ["MCKernel", "ThermalKernelMixin"]


class MCKernel:
    """An MC transition kernel over an ensemble."""

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
        return {
            "occupancy": occu,
            "enthalpy": (feats @ params).contiguous(),
            "accepted": torch.ones(nwalkers, dtype=torch.bool, device=self.device),
            "naccept": torch.zeros(nwalkers, dtype=torch.int32, device=self.device),
        }

    def make_chain_fn(self, n_steps: int):
        """Fused multi-step chain function ``fn(state, generator) -> state``."""
        raise NotImplementedError


class ThermalKernelMixin:
    """Mixin adding a temperature and beta to a kernel."""

    _kB: float = kB

    def __init__(self, temperature, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.temperature = temperature

    @property
    def temperature(self) -> float:
        return self._temperature

    @temperature.setter
    def temperature(self, temperature):
        temperature = np.asarray(temperature, dtype=np.float64)
        if temperature.ndim != 0:
            raise NotImplementedError(
                "per-walker temperature ladders are not ported yet "
                "(ROADMAP.md Queue 1 item 6, replica exchange)"
            )
        self._temperature = float(temperature)
        self.beta = 1.0 / (self._kB * self._temperature)

    def initial_state(self, occupancies) -> dict:
        state = super().initial_state(occupancies)
        state["beta"] = torch.full(
            (state["enthalpy"].shape[0],), self.beta, dtype=torch.float64,
            device=self.device,
        )
        return state
