"""Composite processor: concatenated sub-processor features.

Counterpart of ``smol_tpu/moca/processor/composite.py``
(``CompositeProcessor`` :38-74): the features are the sub-processors'
features in order, and so are the coefficients (the standard pairing is
a cluster expansion followed by an Ewald term).
"""

from __future__ import annotations

import torch

__all__ = ["CompositeProcessor"]


class CompositeProcessor:
    """Features of several processors over one supercell, concatenated."""

    def __init__(self, processors):
        self.processors = list(processors)
        first = self.processors[0]
        if any(p.num_sites != first.num_sites or p.device != first.device
               for p in self.processors):
            raise ValueError("sub-processors must share the supercell and device")
        self.device = first.device
        self.num_sites = first.num_sites
        self.num_energy_coefs = sum(p.num_energy_coefs for p in self.processors)

    def compute_features(self, occupancies: torch.Tensor) -> torch.Tensor:
        """Feature vectors [W, num_energy_coefs] f64 of occupancies [W, N]."""
        return torch.cat([p.compute_features(occupancies) for p in self.processors],
                         dim=1)
