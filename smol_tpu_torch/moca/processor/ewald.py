"""Ewald electrostatic processor.

Counterpart of ``smol_tpu/moca/processor/ewald.py`` (``EwaldProcessor``
:40-108): the single feature is the Ewald energy of the occupied rows,
b . M . b (:mod:`smol_tpu_torch.ops.ewald`).  The matrix and the
(site, code) -> row map come from the system dict; the processor also
keeps them on the host, where the chain folds them into its tables
(:func:`smol_tpu_torch.ops.chain.build_chain_tables`).
"""

from __future__ import annotations

import numpy as np
import torch

from smol_tpu_torch.ops import ewald as ewald_ops

__all__ = ["EwaldProcessor"]


class EwaldProcessor:
    """Ewald energy of a supercell occupancy.

    Args:
        system: a system dict with the Ewald keys (:mod:`smol_tpu_torch.system`).
        device: where the matrix and the evaluations live.
    """

    num_energy_coefs = 1

    def __init__(self, system: dict, device):
        self.device = torch.device(device)
        self.num_sites = int(system["num_sites"])
        self.coef = float(system["ewald_coef"])
        # host copies: the chain-table input
        self.ewald_matrix = np.asarray(system["ewald_matrix"], dtype=np.float64)
        self.ewald_inds = np.asarray(system["ewald_inds"], dtype=np.int64)
        self._matrix = torch.as_tensor(self.ewald_matrix, device=self.device)
        self._inds = torch.as_tensor(self.ewald_inds, device=self.device)

    def compute_features(self, occupancies: torch.Tensor) -> torch.Tensor:
        """Feature vectors [W, 1] f64 of occupancies [W, N]."""
        return ewald_ops.ewald_energy(occupancies, self._matrix, self._inds)[:, None]
