"""Thermodynamic ensemble: processor + sublattices + chemical potentials.

Counterpart of ``smol_tpu/moca/ensemble.py`` (``Ensemble`` :85).  The
processor is the one the system file names (``processor_type``, :104-126):
a cluster expansion (the default of a file without the key), whose natural
parameters are its coefficients, or a cluster decomposition, whose
natural parameters are its coefficients (by default the orbit
multiplicities); either followed by the Ewald coefficient when the system
has an Ewald term (the composite processor of :142-156); then -1 for the chemical-work feature
when chemical potentials are set (semigrand; without them the ensemble is
canonical); the
per-(site, code) chemical-potential table feeds both the feature vector
and the flip chain.  Built from a system dict (:meth:`Ensemble.from_system`),
which the port builds from a cluster expansion itself
(:meth:`Ensemble.from_cluster_expansion`, :func:`smol_tpu_torch.system.
build_system`) or loads from a file.
"""

from __future__ import annotations

import numpy as np
import torch

from smol_tpu_torch.cofe.space.domain import get_species
from smol_tpu_torch.moca.processor.composite import CompositeProcessor
from smol_tpu_torch.moca.processor.ewald import EwaldProcessor
from smol_tpu_torch.moca.processor.expansion import (
    ClusterDecompositionProcessor,
    ClusterExpansionProcessor,
)
from smol_tpu_torch.moca.sublattice import sublattices_from_system
from smol_tpu_torch.system import site_charges

PROCESSORS = {"expansion": ClusterExpansionProcessor,
              "decomposition": ClusterDecompositionProcessor}

__all__ = ["Ensemble", "chemical_potential_table", "random_occupancies"]


def chemical_potential_table(sublattices, num_sites, chemical_potentials) -> np.ndarray:
    """[num_sites, max code + 1] f64 per-(site, code) chemical potentials.

    ``chemical_potentials`` maps each species of the active sublattices
    (a ``Species`` or its name, ``"vacA0+"`` for a vacancy) to its value;
    other species are ignored and a missing one raises ``ValueError``
    (``smol_tpu/moca/ensemble.py:27-83``).  The sublattices are built ones
    (:func:`~smol_tpu_torch.moca.sublattice.sublattices_from_site_spaces`).
    """
    active = [sl for sl in sublattices if sl.is_active]
    species = list({sp for sl in active for sp in sl.site_space})
    value = {get_species(k): v for k, v in chemical_potentials.items()}
    value = {k: v for k, v in value.items() if k in species}
    if set(value.keys()) != set(species):
        raise ValueError(
            "Chemical potentials are missing species; need values for "
            f"each of: {species}"
        )
    num_cols = max(max(sl.encoding) for sl in sublattices) + 1
    table = np.zeros((num_sites, num_cols))
    for sl in active:
        ordered = [value[sp] for sp in sl.site_space]
        table[sl.sites[:, None], sl.encoding] = ordered
    return table


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch sees no CUDA device"
        )
    return device


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
    def from_system(cls, system: dict, device, sublattices=None) -> "Ensemble":
        """An ensemble from a system dict, with its tables on ``device``.

        The processor is the one ``processor_type`` names (``"expansion"``
        for a file without the key, or ``"decomposition"``).  A system
        with ``ewald_matrix`` gets the composite processor (the expansion
        or decomposition, then the Ewald term); one without a
        ``chemical_potential_table`` is canonical; one with a
        ``flip_table`` can be sampled with table flips.  ``sublattices``
        are the system's with their site spaces, where the caller built
        them (:meth:`from_cluster_expansion`); a system file's carry no
        species.
        """
        device = _check_device(device)
        kind = str(system.get("processor_type", "expansion"))
        if kind not in PROCESSORS:
            raise ValueError(f"unknown processor type {kind!r}")
        if sublattices is None:
            sublattices = sublattices_from_system(system)
        processor = PROCESSORS[kind](system, device, sublattices)
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
        charges = system.get("site_charges")
        if charges is None and all(sl.site_space is not None for sl in sublattices):
            allowed = [None] * processor.num_sites  # each site's species, code order
            for sl in sublattices:
                for site in sl.sites:
                    allowed[site] = sl.species
            charges = site_charges(allowed)
        return cls(
            processor,
            sublattices,
            system["natural_parameters"],
            system.get("chemical_potential_table"),
            table_data=table_data,
            site_charges=charges,
        )

    @classmethod
    def from_cluster_expansion(cls, cluster_expansion, supercell_matrix,
                               processor_type="decomposition",
                               use_concentration=False, chemical_potentials=None,
                               device="cuda") -> "Ensemble":
        """An ensemble of a cluster expansion on a supercell, with its tables
        on ``device`` (``smol_tpu/moca/ensemble.py:104-161``).

        The system is built on the host (:func:`smol_tpu_torch.system.
        build_system`, the same arrays a system file holds), then loaded as
        :meth:`from_system` loads one, with the sublattices' site spaces
        (for the table-flip usher's flip table and the charge-neutral
        occupancies of ``generate_random_ordered_occupancy``);
        ``processor_type`` is ``"decomposition"`` (the default) or
        ``"expansion"``, composed with the Ewald term where the subspace has
        one; with ``chemical_potentials`` the ensemble is semigrand.
        """
        from smol_tpu_torch.system import _build

        _check_device(device)
        system, sublattices = _build(
            cluster_expansion, supercell_matrix, processor_type=processor_type,
            chemical_potentials=chemical_potentials,
            use_concentration=use_concentration)
        return cls.from_system(system, device, sublattices)

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
        """[num_sites, max codes] f64 charge of each (site, code): the
        system's, or its built sublattices' species'; else None."""
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
