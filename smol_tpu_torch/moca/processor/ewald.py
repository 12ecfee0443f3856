"""Ewald electrostatic processor.

Counterpart of ``smol_tpu/moca/processor/ewald.py`` (``EwaldProcessor``
:40-150): the single feature is the Ewald energy of the occupied rows,
b . M . b (:mod:`smol_tpu_torch.ops.ewald`), and a flip's change the
single-flip delta (``delta_ewald_single_flip``).  The processor builds its
Ewald structure, summation and matrix from ``(subspace, supercell matrix,
ewald term, coefficient)`` (:func:`smol_tpu_torch.system.ewald_summation`,
:func:`~smol_tpu_torch.system.ewald_fields`), or loads the matrix and the
(site, code) -> row map from a system dict (``from_system``); it keeps both
on the host too, where the chain folds them into its tables
(:func:`smol_tpu_torch.ops.chain.build_chain_tables`).
"""

from __future__ import annotations

import numpy as np
import torch

from smol_tpu_torch.cofe.extern.ewald import EwaldTerm
from smol_tpu_torch.moca.processor.base import Processor
from smol_tpu_torch.ops import ewald as ewald_ops
from smol_tpu_torch.serial import process_decoded
from smol_tpu_torch.system import ewald_fields, ewald_summation

__all__ = ["EwaldProcessor"]


class EwaldProcessor(Processor):
    """Ewald energy of a supercell occupancy.

    Args:
        cluster_subspace: the port's ``ClusterSubspace``.
        supercell_matrix: [3, 3] integer supercell matrix.
        ewald_term: the ``EwaldTerm`` (by default ``EwaldTerm()``).
        coefficient: the term's coefficient.
        use_concentration: see :class:`~smol_tpu_torch.moca.processor.base.Processor`.
        device: where the matrix and the evaluations live.
    """

    def __init__(self, cluster_subspace, supercell_matrix, ewald_term=None,
                 coefficient=1.0, use_concentration=False, device="cuda"):
        if ewald_term is None:
            ewald_term = EwaldTerm()
        super().__init__(cluster_subspace, supercell_matrix, coefficient,
                         use_concentration, device)
        self._ewald_term = ewald_term
        self._ewald_summation, inds = ewald_summation(ewald_term, self.structure)
        self._load(ewald_fields(ewald_term, self._ewald_summation, inds, self.coefs))

    @classmethod
    def from_system(cls, system: dict, device, sublattices=None):
        """The processor of a system dict's Ewald keys, on ``device``."""
        processor = cls.__new__(cls)
        processor._init_from_system(system, device, system["ewald_coef"], sublattices)
        processor._ewald_term = processor._ewald_summation = None
        processor._load(system)
        return processor

    def _load(self, fields):
        self.fields = fields  # host arrays: the system keys of this processor
        self.coef = float(fields["ewald_coef"])
        # host copies: the chain-table input
        self.ewald_matrix = np.asarray(fields["ewald_matrix"], dtype=np.float64)
        self.ewald_inds = np.asarray(fields["ewald_inds"], dtype=np.int64)
        self._matrix = torch.as_tensor(self.ewald_matrix, device=self.device)
        self._inds = torch.as_tensor(self.ewald_inds, device=self.device)

    @property
    def ewald_term(self):
        return self._ewald_term

    @property
    def num_features(self) -> int:
        """One: the Ewald energy (the reference's ``ewald.py:83``)."""
        return 1

    @property
    def ewald_summation(self):
        """The ``EwaldSummation`` of the supercell's Ewald structure."""
        self._require_subspace("ewald_summation")
        return self._ewald_summation

    def compute_features(self, occupancies):
        """Feature vectors [W, 1] f64 of occupancies [W, N]."""
        return ewald_ops.ewald_energy(occupancies, self._matrix, self._inds)[:, None]

    def _feature_change(self, occupancy, site, code):
        return ewald_ops.delta_ewald_single_flip(
            occupancy, site, code, self._matrix, self._inds)[:, None]

    def delta_energy(self, occupancies, sites, codes):
        return self.coef * ewald_ops.delta_ewald_single_flip(
            occupancies, sites, codes, self._matrix, self._inds)

    def as_dict(self) -> dict:
        d = super().as_dict()
        d["ewald_term"] = self._ewald_term.as_dict()
        return d

    @classmethod
    def from_dict(cls, d, device="cuda"):
        coefs = d["coefficients"]
        coef = coefs[0] if isinstance(coefs, list) else coefs
        return cls(
            process_decoded(d["cluster_subspace"]),
            np.array(d["supercell_matrix"]),
            ewald_term=process_decoded(d["ewald_term"]),
            coefficient=coef,
            device=device,
        )
