"""Sublattice: supercell sites sharing one site space.

A minimal counterpart of ``smol_tpu/moca/sublattice.py``: the site
indices, the unrestricted (active) sites, the codes the sites may take
and, where the system carries it, the fraction of each code (the site
space's composition).  Read from a system dict
(:func:`sublattices_from_system`: species names stay with the builder), or
built from a supercell's site spaces (:func:`sublattices_from_site_spaces`,
which keeps each sublattice's site space and so its species), as the
reference's processors build their default sublattices.  A built
sublattice is serialized as the reference's is (``as_dict``/``from_dict``,
``smol_tpu/moca/sublattice.py:178-194``), so that either package's saved
ensemble loads into the port.  Restricting (freezing) sites and splitting
a sublattice by its occupied species are the reference's
(``smol_tpu/moca/sublattice.py:66-125``): a frozen site keeps its code, and
the hand-written chains refuse such sublattices, so kernels over them run
on the per-step path (:mod:`smol_tpu_torch.ops.mc`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from smol_tpu_torch.cofe.space.domain import SiteSpace, Vacancy
from smol_tpu_torch.crystal.species import Composition
from smol_tpu_torch.serial import MSONable, process_decoded

__all__ = ["Sublattice", "sublattices_from_site_spaces", "sublattices_from_system"]


@dataclass(eq=False)
class Sublattice(MSONable):
    """A set of supercell sites with a common set of codes."""

    sites: np.ndarray  # [n] int64 site indices
    active_sites: np.ndarray  # [n_active] int64 unrestricted sites
    encoding: np.ndarray  # [n_codes] int32 allowed codes
    composition: np.ndarray | None = None  # [n_codes] f64 fraction of each code
    site_space: object = None  # the SiteSpace of a built sublattice

    @property
    def is_active(self) -> bool:
        return len(self.active_sites) > 0

    @property
    def species(self) -> tuple:
        """The species of the site space, in code order (a built sublattice;
        one read from a system file carries none and raises)."""
        if self.site_space is None:
            raise ValueError(
                "this sublattice carries no species: it was read from a system "
                "file; build the ensemble with Ensemble.from_cluster_expansion")
        return tuple(self.site_space.keys())

    @property
    def restricted_sites(self) -> np.ndarray:
        return np.setdiff1d(self.sites, self.active_sites)

    def restrict_sites(self, sites):
        """Freeze the given sites (no MC step may touch them)."""
        self.active_sites = np.array(
            [i for i in self.active_sites if i not in sites], dtype=np.int64
        )

    def reset_restricted_sites(self):
        """Reactivate all sites (no-op for single-species sublattices)."""
        n_species = len(self.encoding) if self.site_space is None else len(self.site_space)
        if n_species > 1:
            self.active_sites = self.sites.copy()

    def split_by_species(self, occu, species_in_partitions) -> list["Sublattice"]:
        """Split into sublattices by the species ``occu`` puts on the sites.

        ``species_in_partitions`` lists each part's species (or their
        codes); a part of one species is restricted whole.  The
        reference's (``smol_tpu/moca/sublattice.py:75-125``); a sublattice
        read from a system file carries no species and raises
        ``ValueError``.
        """
        if self.site_space is None:
            raise ValueError(
                "this sublattice carries no species: it was read from a system "
                "file; build the ensemble with Ensemble.from_cluster_expansion")
        occu = np.asarray(occu)
        if all(
            isinstance(sp, (int, np.integer))
            for part in species_in_partitions
            for sp in part
        ):
            codes_in_partitions = species_in_partitions
        else:
            def get_index(sp, species):
                if isinstance(sp, Vacancy):
                    for i, sp2 in enumerate(species):
                        if isinstance(sp2, Vacancy):
                            return i
                return species.index(sp)

            codes_in_partitions = [
                [self.encoding[get_index(sp, self.species)] for sp in part]
                for part in species_in_partitions
            ]

        parts = []
        for species_codes in codes_in_partitions:
            part_comp, part_sites, part_actives = {}, [], []
            part_codes = sorted(species_codes)
            for code in part_codes:
                sp_id = int(np.where(self.encoding == code)[0][0])
                sp = self.species[sp_id]
                part_comp[sp] = self.site_space[sp]
                part_sites.extend(self.sites[occu[self.sites] == code].tolist())
                part_actives.extend(
                    self.active_sites[occu[self.active_sites] == code].tolist()
                )
            total = sum(part_comp.values())
            part_comp = Composition(
                {
                    sp: amt / total
                    for sp, amt in part_comp.items()
                    if not isinstance(sp, Vacancy)
                }
            )
            space = SiteSpace(part_comp)
            part = Sublattice(
                sites=np.unique(np.array(part_sites, dtype=np.int64)),
                active_sites=np.array(part_actives, dtype=np.int64),
                encoding=np.array(part_codes, dtype=np.int32),
                composition=_fractions(space),
                site_space=space,
            )
            if len(part_codes) == 1:
                part.restrict_sites(part.sites)
            parts.append(part)
        return parts

    def __eq__(self, other):
        return (
            isinstance(other, Sublattice)
            and other.site_space == self.site_space
            and np.array_equal(other.encoding, self.encoding)
            and np.array_equal(other.sites, self.sites)
            and np.array_equal(other.active_sites, self.active_sites)
        )

    def as_dict(self) -> dict:
        """The reference's record of a built sublattice (one read from a
        system file records ``site_space`` None, and only the port loads it)."""
        return {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
            "site_space": None if self.site_space is None else self.site_space.as_dict(),
            "sites": self.sites.tolist(),
            "active_sites": self.active_sites.tolist(),
            "encoding": self.encoding.tolist(),
        }

    @classmethod
    def from_dict(cls, d):
        space = None if d["site_space"] is None else process_decoded(d["site_space"])
        return cls(
            sites=np.unique(np.asarray(d["sites"], dtype=np.int64)),
            active_sites=np.asarray(d["active_sites"], dtype=np.int64),
            encoding=np.asarray(d["encoding"], dtype=np.int32),
            composition=None if space is None else _fractions(space),
            site_space=space,
        )


def _fractions(space) -> np.ndarray:
    """[n_codes] f64 the site space's fraction of each code."""
    return np.array([space[sp] for sp in space], dtype=np.float64)


def sublattices_from_site_spaces(site_spaces, allowed_species) -> list[Sublattice]:
    """One sublattice a site space, in the order given: the sites whose
    allowed species are the space's (``smol_tpu/moca/processor/base.py``
    ``get_sublattices`` :127-140); a space of one species has no active
    site (``smol_tpu/moca/sublattice.py:37-44``)."""
    sublattices = []
    for space in site_spaces:
        species = list(space.keys())
        sites = np.unique(np.array(
            [i for i, allowed in enumerate(allowed_species) if allowed == species],
            dtype=np.int64))
        sublattices.append(Sublattice(
            sites=sites,
            active_sites=sites.copy() if len(space) > 1 else np.zeros(0, np.int64),
            encoding=np.arange(len(space), dtype=np.int32),
            composition=_fractions(space),
            site_space=space,
        ))
    return sublattices


def _split(system, name):
    flat = np.asarray(system[name])
    off = np.asarray(system[name + "_offsets"])
    return [flat[off[i]: off[i + 1]] for i in range(len(off) - 1)]


def sublattices_from_system(system: dict) -> list[Sublattice]:
    """The system's sublattices, in the reference's order."""
    sites = _split(system, "sublattice_sites")
    compositions = [None] * len(sites)
    if "sublattice_composition" in system:
        offsets = np.asarray(system["sublattice_encoding_offsets"])
        flat = np.asarray(system["sublattice_composition"], dtype=np.float64)
        compositions = [flat[offsets[i]: offsets[i + 1]] for i in range(len(sites))]
    return [
        Sublattice(
            sites=s.astype(np.int64),
            active_sites=a.astype(np.int64),
            encoding=e.astype(np.int32),
            composition=c,
        )
        for s, a, e, c in zip(
            sites,
            _split(system, "sublattice_active_sites"),
            _split(system, "sublattice_encoding"),
            compositions,
        )
    ]
