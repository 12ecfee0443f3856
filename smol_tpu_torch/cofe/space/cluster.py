"""Cluster: a set of sites (fractional coords) within a lattice.

Counterpart of ``smol_tpu/cofe/space/cluster.py``, whose code it copies. In
this module "the reference" is smol (CederGroupHub/smol).

Mirrors the reference Cluster (smol/cofe/space/cluster.py): coordinates are
centroid-normalized so symmetry-equivalent clusters compare equal after an
integer recentering translation.
"""

from __future__ import annotations

import json
import os
from fnmatch import fnmatch

import numpy as np

from smol_tpu_torch.constants import SITE_TOL
from smol_tpu_torch.crystal.coord import is_coord_subset
from smol_tpu_torch.crystal.lattice import Lattice
from smol_tpu_torch.serial import MSONable, process_decoded

__all__ = ["Cluster"]


class Cluster(MSONable):
    """An undecorated cluster of sites in a lattice."""

    def __init__(self, site_spaces, frac_coords, lattice: Lattice):
        frac_coords = np.atleast_2d(np.array(frac_coords, dtype=np.float64))
        centroid = frac_coords.mean(axis=0)
        shift = np.floor(centroid)
        self._centroid = centroid - shift
        self._frac_coords = frac_coords - shift
        self._lattice = lattice
        self.site_spaces = list(site_spaces)
        self.id = None

    @property
    def centroid(self) -> np.ndarray:
        return self._centroid

    @property
    def frac_coords(self) -> np.ndarray:
        return self._frac_coords

    @property
    def lattice(self) -> Lattice:
        return self._lattice

    @property
    def diameter(self) -> float:
        """Maximum distance between any two sites."""
        coords = self._lattice.get_cartesian_coords(self._frac_coords)
        d2 = np.sum((coords[None] - coords[:, None]) ** 2, axis=-1)
        return float(np.sqrt(d2.max()))

    @property
    def radius(self) -> float:
        return self.diameter / 2.0

    @property
    def sites(self) -> list:
        """The cluster sites as PeriodicSite objects (reference cluster.py:96)."""
        from smol_tpu_torch.crystal.structure import PeriodicSite

        return [
            PeriodicSite(space.composition, fc, self._lattice)
            for space, fc in zip(self.site_spaces, self._frac_coords)
        ]

    def get_distance(self, i: int, j: int) -> float:
        """Cartesian distance between sites i and j (reference cluster.py:101)."""
        coords = self._lattice.get_cartesian_coords(self._frac_coords[[i, j]])
        return float(np.linalg.norm(coords[0] - coords[1]))

    def copy(self) -> "Cluster":
        """An independent copy of the cluster (reference cluster.py:112)."""
        new = Cluster(
            list(self.site_spaces), self._frac_coords.copy(), self._lattice.copy()
        )
        new.id = self.id
        return new

    @classmethod
    def from_sites(cls, sites, lattice=None) -> "Cluster":
        """Create a cluster from (Periodic)Site objects (reference cluster.py:208).

        With lattice=None, the lattice is taken from the first site.
        """
        from smol_tpu_torch.cofe.space.domain import get_site_spaces

        if lattice is None:
            lattice = sites[0].lattice
        frac_coords = [
            lattice.get_fractional_coords(site.coords) for site in sites
        ]
        site_spaces = get_site_spaces(sites)
        return cls(site_spaces, frac_coords, lattice)

    def to(self, fmt: str = None, filename: str = None):
        """Write the cluster as JSON or YAML, to a string or file.

        Mirrors the reference's watered-down Molecule.to (cluster.py:123):
        fmt overrides the filename suffix; with no filename the string is
        returned.
        """
        fmt = "" if fmt is None else fmt.lower()
        fname = os.path.basename(filename or "")
        if fmt == "json" or fnmatch(fname, "*.json*") or fnmatch(fname, "*.mson*"):
            if filename:
                with open(filename, "wt", encoding="utf8") as f:
                    return json.dump(self.as_dict(), f)
            return json.dumps(self.as_dict())
        if fmt == "yaml" or fnmatch(fname, "*.yaml*"):
            import yaml

            if filename:
                with open(filename, "wt", encoding="utf8") as f:
                    return yaml.safe_dump(self.as_dict(), f)
            return yaml.safe_dump(self.as_dict())
        raise ValueError(f"Invalid format: `{fmt}`")

    @classmethod
    def from_str(cls, input_string: str, fmt) -> "Cluster":
        """Read a cluster from a JSON or YAML string (reference cluster.py:162)."""
        if fmt == "json":
            return cls.from_dict(json.loads(input_string))
        if fmt == "yaml":
            import yaml

            return cls.from_dict(yaml.safe_load(input_string))
        raise ValueError(f"Invalid format: `{fmt}`")

    @classmethod
    def from_file(cls, filename: str) -> "Cluster":
        """Read a cluster from a .json/.mson/.yaml file (reference cluster.py:185)."""
        filename = str(filename)
        with open(filename, "rt", encoding="utf8", errors="replace") as file:
            contents = file.read()
        fname = os.path.basename(filename)
        if fnmatch(fname, "*.json*") or fnmatch(fname, "*.mson*"):
            return cls.from_str(contents, fmt="json")
        if fnmatch(fname, "*.yaml*"):
            return cls.from_str(contents, fmt="yaml")
        raise ValueError("Cannot determine file type.")

    def assign_ids(self, cluster_id: int) -> int:
        self.id = cluster_id
        return cluster_id + 1

    def __len__(self):
        return len(self._frac_coords)

    def __getitem__(self, index):
        return self.sites[index]

    def __eq__(self, other):
        """Equality up to an integer recentering translation."""
        if self._frac_coords.shape != other._frac_coords.shape:
            return False
        othersites = other._frac_coords + np.round(self._centroid - other._centroid)
        return is_coord_subset(self._frac_coords, othersites, atol=SITE_TOL)

    def __repr__(self):
        return (
            f"Cluster(n={len(self)}, diameter={self.diameter:.4f}, "
            f"centroid={np.round(self._centroid, 4).tolist()})"
        )

    def as_dict(self) -> dict:
        return {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
            "site_spaces": [s.as_dict() for s in self.site_spaces],
            "frac_coords": self._frac_coords.tolist(),
            "lattice": self._lattice.as_dict(),
        }

    @classmethod
    def from_dict(cls, d):
        return cls(
            [process_decoded(s) for s in d["site_spaces"]],
            d["frac_coords"],
            process_decoded(d["lattice"]),
        )
