"""Composite processor: concatenated sub-processor features.

Counterpart of ``smol_tpu/moca/processor/composite.py``
(``CompositeProcessor`` :38-112): the features are the sub-processors'
features in order, and so are the coefficients (the standard pairing is
a cluster expansion followed by an Ewald term).  Built from ``(subspace,
supercell matrix)`` and filled with :meth:`CompositeProcessor.add_processor`,
or from sub-processors loaded from a system dict
(:meth:`CompositeProcessor.from_system`).
"""

from __future__ import annotations

import numpy as np
import torch

from smol_tpu_torch.moca.processor.base import Processor
from smol_tpu_torch.serial import process_decoded

__all__ = ["CompositeProcessor"]


class CompositeProcessor(Processor):
    """A processor summing several sub-processors' properties."""

    def __init__(self, cluster_subspace, supercell_matrix, use_concentration=False,
                 device="cuda"):
        super().__init__(cluster_subspace, supercell_matrix, coefficients=[],
                         use_concentration=use_concentration, device=device)
        self._processors = []
        self.coefs = np.empty(0)

    @classmethod
    def from_system(cls, system: dict, device, processors, sublattices=None):
        """The composite of ``processors``, each loaded from the system dict
        (their ``from_system``), on ``device``."""
        composite = cls.__new__(cls)
        composite._init_from_system(system, device, [], sublattices)
        composite._processors = []
        for processor in processors:
            if (processor.num_sites != composite.num_sites
                    or processor.device != composite.device):
                raise ValueError("sub-processors must share the supercell and device")
            composite._processors.append(processor)
        composite.coefs = np.concatenate([np.atleast_1d(p.coefs) for p in processors])
        return composite

    @property
    def processors(self) -> list:
        return self._processors

    @property
    def num_features(self) -> int:
        """The sub-processors' features together (the reference's
        ``composite.py:63``)."""
        return sum(p.num_features for p in self._processors)

    def add_processor(self, processor: Processor):
        """Add a sub-processor (same subspace and supercell required)."""
        if processor.cluster_subspace != self._subspace:
            raise AttributeError("Sub-processor must share the cluster subspace.")
        if not np.array_equal(processor.supercell_matrix, self._scmatrix):
            raise AttributeError("Sub-processor must share the supercell matrix.")
        if processor.device != self.device:
            raise ValueError("Sub-processor must share the device.")
        self._processors.append(processor)
        self.coefs = np.concatenate([self.coefs, np.atleast_1d(processor.coefs)])

    def compute_features(self, occupancies):
        """Feature vectors [W, num_energy_coefs] f64 of occupancies [W, N]."""
        return torch.cat([p.compute_features(occupancies) for p in self._processors],
                         dim=1)

    def prepare_deltas(self):
        for processor in self._processors:
            processor.prepare_deltas()

    def delta_features(self, occupancies, sites, codes):
        """Feature changes [W, num_energy_coefs] f64 of one flip a walker."""
        return torch.cat([p.delta_features(occupancies, sites, codes)
                          for p in self._processors], dim=1)

    def delta_energy(self, occupancies, sites, codes):
        """Energy changes [W] f64 of one flip a walker: the sub-processors'
        summed in order."""
        total = self._processors[0].delta_energy(occupancies, sites, codes)
        for processor in self._processors[1:]:
            total = total + processor.delta_energy(occupancies, sites, codes)
        return total

    def compute_feature_vector_change(self, occupancy, flips) -> np.ndarray:
        return np.concatenate(
            [p.compute_feature_vector_change(occupancy, flips) for p in self._processors]
        )

    def as_dict(self) -> dict:
        d = super().as_dict()
        d["processors"] = [p.as_dict() for p in self._processors]
        del d["coefficients"]
        return d

    @classmethod
    def from_dict(cls, d, device="cuda"):
        composite = cls(
            process_decoded(d["cluster_subspace"]), np.array(d["supercell_matrix"]),
            device=device,
        )
        for pd in d["processors"]:
            composite.add_processor(Processor.from_dict(pd, device=device))
        return composite
