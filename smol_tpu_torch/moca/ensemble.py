"""Thermodynamic ensemble: processor + sublattices + chemical potentials.

Counterpart of ``smol_tpu/moca/ensemble.py`` (``Ensemble`` :85).  The
processor is the one the system file names (``processor_type``, :104-126):
a cluster expansion (the default of a file without the key), whose natural
parameters are its coefficients, then the Ewald coefficient when the
system has an Ewald term (the composite processor of :142-156), or a
cluster decomposition, whose natural parameters are its coefficients (by
default the orbit multiplicities); then -1 for the chemical-work feature
when chemical potentials are set (semigrand; without them the ensemble is
canonical); the
per-(site, code) chemical-potential table feeds both the feature vector
and the flip chain.  Built from a system dict rather than from a cluster
expansion: the host layer that builds systems is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from smol_tpu_torch.moca.processor.composite import CompositeProcessor
from smol_tpu_torch.moca.processor.ewald import EwaldProcessor
from smol_tpu_torch.moca.processor.expansion import (
    ClusterDecompositionProcessor,
    ClusterExpansionProcessor,
)
from smol_tpu_torch.moca.sublattice import sublattices_from_system

PROCESSORS = {"expansion": ClusterExpansionProcessor,
              "decomposition": ClusterDecompositionProcessor}

__all__ = ["Ensemble", "random_occupancies"]


def random_occupancies(ensemble, count: int, seed: int) -> np.ndarray:
    """``count`` uniformly random occupancies [count, N] int32 from ``seed``.

    Each site takes a uniform code of its sublattice; sites outside every
    sublattice take code 0.  Reads only ``num_sites`` and the sublattices'
    ``sites`` and ``encoding``, so any ensemble with those serves.
    """
    codes = np.ones(ensemble.num_sites, dtype=np.int64)
    for sl in ensemble.sublattices:
        codes[sl.sites] = len(sl.encoding)
    rng = np.random.default_rng(seed)
    return (rng.random((count, ensemble.num_sites)) * codes).astype(np.int32)


class Ensemble:
    """A thermodynamic ensemble over a fixed supercell, on one device."""

    def __init__(self, processor, sublattices, natural_parameters,
                 chemical_potential_table=None, table_data=None,
                 site_charges=None):
        self._processor = processor
        self._sublattices = sublattices
        self._params = np.asarray(natural_parameters, dtype=np.float64)
        self._mu_table = (
            None
            if chemical_potential_table is None
            else np.asarray(chemical_potential_table, dtype=np.float64)
        )
        self._mu_dev = (
            None
            if self._mu_table is None
            else torch.as_tensor(self._mu_table, device=processor.device)
        )
        self._table_data = table_data
        self._site_charges = (
            None if site_charges is None
            else np.asarray(site_charges, dtype=np.float64)
        )

    @classmethod
    def from_system(cls, system: dict, device) -> "Ensemble":
        """An ensemble from a system dict, with its tables on ``device``.

        The processor is the one ``processor_type`` names (``"expansion"``
        for a file without the key, or ``"decomposition"``).  A system
        with ``ewald_matrix`` gets the composite processor (the expansion,
        then the Ewald term; with a decomposition it raises
        ``NotImplementedError``); one without a
        ``chemical_potential_table`` is canonical; one with a
        ``flip_table`` can be sampled with table flips.
        """
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but torch sees no CUDA device"
            )
        kind = str(system.get("processor_type", "expansion"))
        if kind not in PROCESSORS:
            raise ValueError(f"unknown processor type {kind!r}")
        if kind == "decomposition" and "ewald_matrix" in system:
            raise NotImplementedError(
                "a cluster decomposition with an Ewald term is not ported yet "
                "(ROADMAP.md Queue 1 item 6)")
        processor = PROCESSORS[kind](system, device)
        if "ewald_matrix" in system:
            processor = CompositeProcessor([processor, EwaldProcessor(system, device)])
        if processor.num_energy_coefs != int(system["num_energy_coefs"]):
            raise ValueError(
                f"the system has {int(system['num_energy_coefs'])} energy "
                f"coefficients but its processors {processor.num_energy_coefs}"
            )
        table_data = None
        if "flip_table" in system:
            ids = np.asarray(system["usher_dim_ids"])
            off = np.asarray(system["usher_dim_ids_offsets"])
            table_data = {
                "flip_table": np.asarray(system["flip_table"]),
                "dim_ids": [ids[off[i]: off[i + 1]] for i in range(len(off) - 1)],
            }
        return cls(
            processor,
            sublattices_from_system(system),
            system["natural_parameters"],
            system.get("chemical_potential_table"),
            table_data=table_data,
            site_charges=system.get("site_charges"),
        )

    # ---------------- properties ----------------

    @property
    def device(self) -> torch.device:
        return self._processor.device

    @property
    def processor(self) -> ClusterExpansionProcessor | CompositeProcessor:
        return self._processor

    @property
    def num_sites(self) -> int:
        return self._processor.num_sites

    @property
    def num_energy_coefs(self) -> int:
        return self._processor.num_energy_coefs

    @property
    def sublattices(self):
        return self._sublattices

    @property
    def natural_parameters(self) -> np.ndarray:
        return self._params

    @property
    def chemical_potential_table(self):
        """[num_sites, max_code+1] f64 per-(site, code) chemical potentials."""
        return self._mu_table

    @property
    def table_data(self):
        """``{"flip_table": [F, D], "dim_ids": per sublattice}`` or None."""
        return self._table_data

    @property
    def site_charges(self):
        """[num_sites, max codes] f64 charge of each (site, code), or None."""
        return self._site_charges

    # ---------------- feature evaluation ----------------

    def compute_features(self, occupancies: torch.Tensor) -> torch.Tensor:
        """Full feature vectors [W, F] f64 of occupancies [W, N].

        With chemical potentials the last column is the chemical work
        sum_i mu[i, occu[i]] (reference ``kernel/base.py:46-55``).
        """
        occupancies = torch.atleast_2d(occupancies).long()
        feats = self._processor.compute_features(occupancies)
        if self._mu_dev is None:
            return feats
        sites = torch.arange(self.num_sites, device=occupancies.device)
        work = self._mu_dev[sites, occupancies].sum(dim=1)
        return torch.cat([feats, work[:, None]], dim=1)

    def compute_feature_vector(self, occupancy) -> np.ndarray:
        """Full feature vector of one occupancy [N], as a host array."""
        occu = torch.as_tensor(np.asarray(occupancy), device=self.device)
        return self.compute_features(occu[None, :])[0].cpu().numpy()
