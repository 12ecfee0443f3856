"""Sublattice: supercell sites sharing one site space.

A minimal counterpart of ``smol_tpu/moca/sublattice.py``, built from a
system dict: the site indices, the unrestricted (active) sites, the codes
the sites may take and, where the system carries it, the fraction of each
code (the site space's composition).  Species names stay with the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Sublattice", "sublattices_from_system"]


@dataclass
class Sublattice:
    """A set of supercell sites with a common set of codes."""

    sites: np.ndarray  # [n] int64 site indices
    active_sites: np.ndarray  # [n_active] int64 unrestricted sites
    encoding: np.ndarray  # [n_codes] int32 allowed codes
    composition: np.ndarray | None = None  # [n_codes] f64 fraction of each code

    @property
    def is_active(self) -> bool:
        return len(self.active_sites) > 0


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
