"""Thermodynamic ensemble: processor + sublattices + chemical potentials.

Counterpart of ``smol_tpu/moca/ensemble.py`` (``ChemicalPotentialManager``
:27-84, ``Ensemble`` :85-275), with its constructor, ``Ensemble(processor,
sublattices=None, chemical_potentials=None)``, on the processor's device.
The natural parameters are the processor's coefficients (a cluster
expansion's, or a cluster decomposition's, by default the orbit
multiplicities; with an Ewald term the composite's, the Ewald coefficient
last), then -1 for the chemical-work feature when chemical potentials are
set (semigrand; without them the ensemble is canonical).  Setting
``chemical_potentials`` builds the per-(site, code) table that feeds both
the feature vector (its device copy) and the flip chain.
:meth:`Ensemble.from_cluster_expansion` builds the processors as the
reference does; :meth:`Ensemble.from_system` loads them from a system dict
(:mod:`smol_tpu_torch.system`), whose sublattices carry no species: its
chemical potentials are the file's table, with no values to read back
(reading them raises ``ValueError``, as does setting new ones).
"""

from __future__ import annotations

import numpy as np
import torch

from smol_tpu_torch.cofe.space.domain import get_species
from smol_tpu_torch.moca.processor.base import Processor, check_device
from smol_tpu_torch.moca.processor.composite import CompositeProcessor
from smol_tpu_torch.moca.processor.ewald import EwaldProcessor
from smol_tpu_torch.moca.processor.expansion import (
    ClusterDecompositionProcessor,
    ClusterExpansionProcessor,
)
from smol_tpu_torch.moca.sublattice import sublattices_from_system
from smol_tpu_torch.serial import MSONable, jsanitize, process_decoded
from smol_tpu_torch.system import site_charges

PROCESSORS = {"expansion": ClusterExpansionProcessor,
              "decomposition": ClusterDecompositionProcessor}

__all__ = ["ChemicalPotentialManager", "Ensemble", "chemical_potential_table",
           "cluster_expansion_processor", "random_occupancies"]


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


def cluster_expansion_processor(cluster_expansion, supercell_matrix,
                                processor_type="decomposition", use_concentration=False,
                                device="cuda") -> Processor:
    """The processor of a cluster expansion on a supercell, as the
    reference's ``Ensemble.from_cluster_expansion`` builds it
    (``smol_tpu/moca/ensemble.py:104-161``): the decomposition processor
    (``processor_type="decomposition"``, the default; coefficients the
    orbit multiplicities) or the expansion processor (``"expansion"``; the
    expansion's coefficients but the external terms'), composed with an
    ``EwaldProcessor`` of the expansion's last coefficient where the
    subspace has an Ewald term.  :meth:`Ensemble.from_cluster_expansion`
    and :func:`smol_tpu_torch.system.build_system` both build through it."""
    device = check_device(device)
    subspace = cluster_expansion.cluster_subspace
    n_ext = len(subspace.external_terms)
    if processor_type == "decomposition":
        def make_ce_processor():
            return ClusterDecompositionProcessor(
                subspace, supercell_matrix, cluster_expansion.cluster_interaction_tensors,
                use_concentration=use_concentration, device=device)
    elif processor_type == "expansion":
        def make_ce_processor():
            coefs = cluster_expansion.coefs[:-n_ext] if n_ext else cluster_expansion.coefs
            return ClusterExpansionProcessor(
                subspace, supercell_matrix, coefs, use_concentration=use_concentration,
                device=device)
    else:
        raise ValueError(f"Processor type {processor_type} not supported!")

    if n_ext == 0:
        return make_ce_processor()
    processor = CompositeProcessor(subspace, supercell_matrix,
                                   use_concentration=use_concentration, device=device)
    processor.add_processor(make_ce_processor())
    processor.add_processor(EwaldProcessor(
        subspace, supercell_matrix, ewald_term=subspace.external_terms[0],
        coefficient=cluster_expansion.coefs[-1], use_concentration=use_concentration,
        device=device))
    return processor


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


class ChemicalPotentialManager:
    """Descriptor managing an Ensemble's chemical potentials.

    The reference's (``smol_tpu/moca/ensemble.py:27-84``): setting a dict
    maps its keys to species and drops the species of no active
    sublattice, raises ``ValueError`` where one of them is missing, builds
    the per-(site, code) table (:func:`chemical_potential_table`; on the
    ensemble's device too), appends the -1 natural parameter on the first
    set and records the values in ``thermo_boundaries``; setting ``None``
    removes all of that again.

    An ensemble loaded from a system file (:meth:`Ensemble.from_system`)
    carries the file's table but no species: reading its chemical
    potentials, or setting new ones, raises ``ValueError`` (its table is
    ``chemical_potential_table``); setting ``None`` makes it canonical.
    """

    natural_parameter: float = -1.0

    def __set_name__(self, owner, name):
        self.private_name = "_" + name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        data = getattr(obj, self.private_name, None)
        if data is None:
            return None
        if data["value"] is None:
            raise ValueError(
                "this ensemble was loaded from a system file: its chemical "
                "potentials are the file's per-(site, code) table, "
                "chemical_potential_table, with no species to key them by")
        return data["value"]

    def __set__(self, obj, value):
        if value is None:
            if getattr(obj, self.private_name, None) is not None:
                setattr(obj, self.private_name, None)
                obj.thermo_boundaries.pop("chemical_potentials", None)
                if obj.num_energy_coefs < len(obj._params):
                    obj._params = obj._params[:-1]
                obj._set_mu_table(None)
            return
        if any(sl.site_space is None for sl in obj.active_sublattices):
            raise ValueError(
                "this ensemble was loaded from a system file, whose sublattices "
                "carry no species: chemical potentials cannot be set by species; "
                "build the ensemble from a processor (Ensemble(processor), "
                "from_cluster_expansion or from_dict)")
        value = {get_species(k): v for k, v in value.items()}
        value = {k: v for k, v in value.items() if k in obj.species}
        if set(value.keys()) != set(obj.species):
            raise ValueError(
                "Chemical potentials are missing species; need values for "
                f"each of: {obj.species}"
            )
        if getattr(obj, self.private_name, None) is None:
            obj._params = np.append(obj._params, self.natural_parameter)
        table = chemical_potential_table(obj.sublattices, obj.num_sites, value)
        setattr(obj, self.private_name, {"value": value, "table": table})
        obj._set_mu_table(table)
        obj.thermo_boundaries["chemical_potentials"] = {
            str(k): v for k, v in value.items()
        }


class Ensemble(MSONable):
    """A thermodynamic ensemble over a fixed supercell, on its processor's
    device.

    Args:
        processor: the port's processor (a cluster expansion or
            decomposition, or their composite with an Ewald term).
        sublattices: the processor's default sublattices (the default);
            others (restricted or split) wait for ROADMAP.md Queue 1 item
            5(c).
        chemical_potentials: a dict of species (or names) to values; makes
            the ensemble semigrand.
    """

    natural_parameter: float = -1.0  # for the chemical work feature

    chemical_potentials = ChemicalPotentialManager()

    def __init__(self, processor, sublattices=None, chemical_potentials=None):
        defaults = processor.get_sublattices()
        if sublattices is None:
            sublattices = defaults
        elif list(sublattices) != defaults:
            raise NotImplementedError(
                "sublattices other than the processor's defaults (restricted or "
                "split ones) are not ported yet (ROADMAP.md Queue 1 item 5(c))")
        self.thermo_boundaries = {}
        self._params = np.asarray(processor.coefs, dtype=np.float64)
        self._processor = processor
        self._sublattices = list(sublattices)
        self._chemical_potentials = None
        self._mu_dev = None
        self._table_data = None
        allowed = processor.allowed_species
        if allowed is None and all(sl.site_space is not None for sl in self._sublattices):
            allowed = [None] * processor.num_sites  # each site's species, code order
            for sl in self._sublattices:
                for site in sl.sites:
                    allowed[site] = sl.species
        self._site_charges = None if allowed is None else site_charges(allowed)
        if chemical_potentials is not None:
            self.chemical_potentials = chemical_potentials

    def _set_mu_table(self, table):
        """The host table's device copy, which ``compute_features`` and the
        chains read."""
        self._mu_dev = None if table is None else torch.as_tensor(table, device=self.device)

    @classmethod
    def from_system(cls, system: dict, device, sublattices=None) -> "Ensemble":
        """An ensemble from a system dict, with its tables on ``device``.

        The processor is the one ``processor_type`` names (``"expansion"``
        for a file without the key, or ``"decomposition"``), each loaded with
        its ``from_system``.  A system with ``ewald_matrix`` gets the
        composite processor (the expansion or decomposition, then the Ewald
        term); one without a ``chemical_potential_table`` is canonical; one
        with a ``flip_table`` can be sampled with table flips.
        ``sublattices`` are the system's with their site spaces, where the
        caller built them; a system file's carry no species.
        """
        device = check_device(device)
        kind = str(system.get("processor_type", "expansion"))
        if kind not in PROCESSORS:
            raise ValueError(f"unknown processor type {kind!r}")
        if sublattices is None:
            sublattices = sublattices_from_system(system)
        processor = PROCESSORS[kind].from_system(system, device, sublattices)
        if "ewald_matrix" in system:
            processor = CompositeProcessor.from_system(
                system, device,
                [processor, EwaldProcessor.from_system(system, device, sublattices)],
                sublattices)
        if processor.num_energy_coefs != int(system["num_energy_coefs"]):
            raise ValueError(
                f"the system has {int(system['num_energy_coefs'])} energy "
                f"coefficients but its processors {processor.num_energy_coefs}"
            )
        ensemble = cls(processor)
        table = system.get("chemical_potential_table")
        if table is not None:  # the file's table: no values to read back
            table = np.asarray(table, dtype=np.float64)
            ensemble._chemical_potentials = {"value": None, "table": table}
            ensemble._params = np.append(ensemble._params, cls.natural_parameter)
            ensemble._set_mu_table(table)
        if not np.array_equal(ensemble.natural_parameters, system["natural_parameters"]):
            raise ValueError("the system's natural parameters are not its processors' "
                             "coefficients (then -1 with a chemical-potential table)")
        if "flip_table" in system:
            ids = np.asarray(system["usher_dim_ids"])
            off = np.asarray(system["usher_dim_ids_offsets"])
            ensemble._table_data = {
                "flip_table": np.asarray(system["flip_table"]),
                "dim_ids": [ids[off[i]: off[i + 1]] for i in range(len(off) - 1)],
            }
        if "site_charges" in system:
            ensemble._site_charges = np.asarray(system["site_charges"], dtype=np.float64)
        return ensemble

    @classmethod
    def from_cluster_expansion(cls, cluster_expansion, supercell_matrix,
                               processor_type="decomposition",
                               use_concentration=False, device="cuda",
                               **kwargs) -> "Ensemble":
        """An ensemble of a cluster expansion on a supercell, with its tables
        on ``device`` (``smol_tpu/moca/ensemble.py:104-161``), its processor
        :func:`cluster_expansion_processor`'s; ``kwargs`` go to the
        constructor (``chemical_potentials`` makes the ensemble
        semigrand)."""
        return cls(cluster_expansion_processor(
            cluster_expansion, supercell_matrix, processor_type, use_concentration,
            device), **kwargs)

    # ---------------- properties ----------------

    @property
    def device(self) -> torch.device:
        return self._processor.device

    @property
    def processor(self) -> Processor:
        return self._processor

    @property
    def num_sites(self) -> int:
        return self._processor.num_sites

    @property
    def num_energy_coefs(self) -> int:
        return len(self._processor.coefs)

    @property
    def system_size(self) -> int:
        return self._processor.size

    @property
    def sublattices(self):
        return self._sublattices

    @property
    def active_sublattices(self):
        return [s for s in self._sublattices if s.is_active]

    @property
    def restricted_sites(self) -> np.ndarray:
        return np.concatenate([s.restricted_sites for s in self._sublattices])

    @property
    def species(self) -> list:
        """The species of the active sublattices (an ensemble loaded from a
        system file has none: ``ValueError``)."""
        return list(
            {sp for subl in self.active_sublattices for sp in subl.species}
        )

    @property
    def natural_parameters(self) -> np.ndarray:
        return self._params

    @property
    def chemical_potential_table(self):
        """[num_sites, max_code+1] f64 per-(site, code) chemical potentials."""
        if self._chemical_potentials is None:
            return None
        return self._chemical_potentials["table"]

    @property
    def table_data(self):
        """``{"flip_table": [F, D], "dim_ids": per sublattice}`` or None."""
        return self._table_data

    @property
    def site_charges(self):
        """[num_sites, max codes] f64 charge of each (site, code): the
        system's, or its species'; None for a system without either."""
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

    def compute_feature_vector_change(self, occupancy, step) -> np.ndarray:
        """Feature-vector change of a list of (site, new code) flips, the
        chemical work's change last (the reference's :218-227)."""
        delta = self._processor.compute_feature_vector_change(occupancy, step)
        table = self.chemical_potential_table
        if table is not None:
            dwork = sum(
                table[site][code] - table[site][occupancy[site]]
                for site, code in step
            )
            delta = np.append(delta, dwork)
        return delta

    # ---------------- sublattice management ----------------

    def split_sublattice_by_species(self, sublattice_id, occu, species_in_partitions):
        """Split a sublattice by its occupied species: not ported."""
        self._sublattices[sublattice_id].split_by_species(occu, species_in_partitions)

    def restrict_sites(self, sites):
        """Freeze sites: not ported."""
        for sublattice in self._sublattices:
            sublattice.restrict_sites(sites)

    def as_dict(self) -> dict:
        return {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
            "thermo_boundaries": jsanitize(self.thermo_boundaries),
            "processor": self._processor.as_dict(),
            "sublattices": [s.as_dict() for s in self._sublattices],
        }

    @classmethod
    def from_dict(cls, d, device="cuda"):
        """The ensemble of an ``as_dict`` record (the port's, or the
        reference's: its ``smol_tpu.*`` classes map onto the port's), its
        processor on ``device``."""
        ensemble = cls(
            Processor.from_dict(d["processor"], device=device),
            [process_decoded(s) for s in d["sublattices"]],
        )
        mus = d.get("thermo_boundaries", {}).get("chemical_potentials")
        if mus is not None:
            ensemble.chemical_potentials = mus
        return ensemble
