"""Sublattice: supercell sites sharing one site space.

A minimal counterpart of ``smol_tpu/moca/sublattice.py``: the site
indices, the unrestricted (active) sites, the codes the sites may take
and, where the system carries it, the fraction of each code (the site
space's composition).  Read from a system dict
(:func:`sublattices_from_system`: species names stay with the builder), or
built from a supercell's site spaces (:func:`sublattices_from_site_spaces`,
which keeps each sublattice's site space and so its species), as the
reference's processors build their default sublattices.  Restricting and
splitting sites waits for ROADMAP.md Queue 1 item 5(c).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Sublattice", "sublattices_from_site_spaces", "sublattices_from_system"]


@dataclass
class Sublattice:
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

    def restrict_sites(self, sites):
        """Freeze sites: not ported (the chains refuse restricted sites)."""
        raise NotImplementedError(
            "restricting sublattice sites is not ported yet (ROADMAP.md Queue 1 "
            "item 5(c)); the chains take no restricted site (item 6)")

    def split_by_species(self, occu, species_in_partitions):
        """Split by occupied species: not ported."""
        raise NotImplementedError(
            "splitting sublattices is not ported yet (ROADMAP.md Queue 1 item 5(c))")


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
