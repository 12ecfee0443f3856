"""Periodic sites and structures.

Counterpart of ``smol_tpu/crystal/structure.py``, whose code it copies,
without its file formats. In this module "the reference" is smol
(CederGroupHub/smol).

Replaces the pymatgen Structure/PeriodicSite subset used by the reference:
construction from species+coords, supercell generation, neighbor search
within a sphere, species access, serialization.
"""

from __future__ import annotations

import numpy as np

from smol_tpu_torch.crystal.coord import lattice_points_in_supercell
from smol_tpu_torch.crystal.lattice import Lattice
from smol_tpu_torch.crystal.species import Composition, Species, get_species
from smol_tpu_torch.serial import MSONable, process_decoded


def _as_composition(species) -> Composition:
    if isinstance(species, Composition):
        return species
    if isinstance(species, Species):
        return Composition({species: 1.0})
    if isinstance(species, str):
        return Composition({get_species(species): 1.0})
    if isinstance(species, dict):
        return Composition(species)
    raise ValueError(f"Cannot interpret species {species!r}")


class Site(MSONable):
    """A site in Cartesian space with a (possibly disordered) composition."""

    def __init__(self, species, coords, properties=None):
        self.species = _as_composition(species)
        self.coords = np.array(coords, dtype=np.float64)
        self.properties = properties or {}

    @property
    def specie(self) -> Species:
        """The single species at an ordered site."""
        if len(self.species) != 1:
            raise AttributeError("Site is disordered; no single specie.")
        return next(iter(self.species))

    @property
    def species_string(self) -> str:
        return ", ".join(f"{sp}:{amt:g}" for sp, amt in self.species.items())

    def distance(self, other) -> float:
        return float(np.linalg.norm(self.coords - other.coords))

    def __repr__(self):
        return f"Site: {self.species_string} ({self.coords[0]:.4f}, {self.coords[1]:.4f}, {self.coords[2]:.4f})"


class PeriodicSite(Site):
    """A site within a periodic lattice, stored in fractional coordinates."""

    def __init__(self, species, frac_coords, lattice: Lattice, properties=None, label=None):
        self.lattice = lattice
        self.frac_coords = np.array(frac_coords, dtype=np.float64)
        self.label = label
        super().__init__(
            species, lattice.get_cartesian_coords(self.frac_coords), properties
        )

    @property
    def index(self):
        """Index within a parent structure (set by neighbor searches)."""
        return getattr(self, "_index", None)

    def __repr__(self):
        return (
            f"PeriodicSite: {self.species_string} "
            f"[{self.frac_coords[0]:.4f}, {self.frac_coords[1]:.4f}, {self.frac_coords[2]:.4f}]"
        )

    def as_dict(self) -> dict:
        return {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
            "species": self.species.as_dict(),
            "frac_coords": self.frac_coords.tolist(),
            "lattice": self.lattice.as_dict(),
            "properties": self.properties,
            "label": self.label,
        }

    @classmethod
    def from_dict(cls, d):
        return cls(
            process_decoded(d["species"]),
            d["frac_coords"],
            process_decoded(d["lattice"]),
            properties=d.get("properties"),
            label=d.get("label"),
        )


class Structure(MSONable):
    """A periodic crystal structure: a lattice plus periodic sites."""

    def __init__(self, lattice, species, frac_coords, site_properties=None, labels=None):
        """Initialize a Structure.

        Args:
            lattice: Lattice or 3x3 matrix.
            species: sequence of Composition/Species/str/dict per site.
            frac_coords: (N, 3) fractional coordinates.
            site_properties: optional dict {name: list of per-site values}.
            labels: optional per-site labels.
        """
        self._lattice = lattice if isinstance(lattice, Lattice) else Lattice(lattice)
        frac_coords = np.atleast_2d(np.array(frac_coords, dtype=np.float64))
        if len(species) != len(frac_coords):
            raise ValueError("species and frac_coords length mismatch")
        props = site_properties or {}
        self._sites = []
        for i, (sp, fc) in enumerate(zip(species, frac_coords)):
            site_props = {k: v[i] for k, v in props.items()}
            label = labels[i] if labels is not None else None
            self._sites.append(
                PeriodicSite(sp, fc, self._lattice, properties=site_props, label=label)
            )
            self._sites[-1]._index = i

    @classmethod
    def from_sites(cls, sites) -> "Structure":
        lattice = sites[0].lattice
        return cls(
            lattice,
            [s.species for s in sites],
            [s.frac_coords for s in sites],
            site_properties=_collect_props(sites),
            labels=[s.label for s in sites],
        )

    @property
    def lattice(self) -> Lattice:
        return self._lattice

    @property
    def sites(self):
        return self._sites

    @property
    def frac_coords(self) -> np.ndarray:
        return np.array([s.frac_coords for s in self._sites])

    @property
    def cart_coords(self) -> np.ndarray:
        return self._lattice.get_cartesian_coords(self.frac_coords)

    @property
    def num_sites(self) -> int:
        return len(self._sites)

    @property
    def site_properties(self) -> dict:
        return _collect_props(self._sites)

    @property
    def composition(self) -> Composition:
        total = {}
        for site in self._sites:
            for sp, amt in site.species.items():
                total[sp] = total.get(sp, 0.0) + amt
        return Composition(total)

    @property
    def charge(self) -> float:
        return float(sum(site.species.charge() for site in self._sites))

    @property
    def is_ordered(self) -> bool:
        return all(
            len(s.species) == 1 and abs(s.species.num_atoms - 1) < 1e-8
            for s in self._sites
        )

    def copy(self) -> "Structure":
        return Structure.from_sites(self._sites)

    def make_supercell(self, scaling_matrix) -> "Structure":
        """Expand this structure in place by an integer supercell matrix.

        Site ordering matches pymatgen/smol: for each prim site, all its
        lattice-translation images are consecutive (pymatgen Structure.
        make_supercell ordering: site-major, translations inner), which the
        reference's occupancy encoding relies on.
        """
        scm = np.asarray(scaling_matrix, dtype=np.int64)
        if scm.size == 1:
            scm = np.eye(3, dtype=np.int64) * int(scm)
        elif scm.size == 3:
            scm = np.diag(scm.ravel())
        scm = scm.reshape(3, 3)
        new_lattice = Lattice(scm @ self._lattice.matrix)
        frac_pts = lattice_points_in_supercell(scm)  # frac coords w.r.t. new cell
        inv = np.linalg.inv(scm)
        new_sites = []
        for site in self._sites:
            base = site.frac_coords @ inv  # prim frac -> supercell frac
            for pt in frac_pts:
                fc = np.mod(base + pt, 1.0)
                new_sites.append(
                    PeriodicSite(
                        site.species,
                        fc,
                        new_lattice,
                        properties=dict(site.properties),
                        label=site.label,
                    )
                )
        self._lattice = new_lattice
        self._sites = new_sites
        for i, s in enumerate(self._sites):
            s._index = i
        return self

    def get_sites_in_sphere(self, center, radius, include_index=True):  # noqa: ARG002
        # include_index kept for API parity; indices are always attached.
        """All periodic site images within ``radius`` of Cartesian ``center``.

        Returns PeriodicSite objects whose ``frac_coords`` are the unwrapped
        image coordinates, with ``.index`` set to the originating site index
        (as the reference uses in orbit generation,
        smol/cofe/space/clusterspace.py:1522).
        """
        center = np.asarray(center, dtype=np.float64)
        center_frac = self._lattice.get_fractional_coords(center)
        ginv = np.linalg.inv(self._lattice.metric_tensor)
        spans = radius * np.sqrt(np.diag(ginv)) + 1e-8
        frac = self.frac_coords
        results = []
        ranges = [
            np.arange(
                int(np.floor(center_frac[i] - spans[i] - 1)),
                int(np.ceil(center_frac[i] + spans[i] + 1)) + 1,
            )
            for i in range(3)
        ]
        images = np.stack(np.meshgrid(*ranges, indexing="ij"), axis=-1).reshape(-1, 3)
        # vectorized distance over (sites, images)
        all_frac = frac[:, None, :] + images[None, :, :]
        diff = all_frac - center_frac
        d2 = np.einsum("sid,de,sie->si", diff, self._lattice.metric_tensor, diff)
        hits = np.argwhere(d2 <= radius * radius + 1e-12)
        for site_idx, img_idx in hits:
            site = self._sites[site_idx]
            new_site = PeriodicSite(
                site.species,
                all_frac[site_idx, img_idx],
                self._lattice,
                properties=dict(site.properties),
                label=site.label,
            )
            new_site._index = int(site_idx)
            results.append(new_site)
        return results

    def __len__(self):
        return len(self._sites)

    def __iter__(self):
        return iter(self._sites)

    def __getitem__(self, idx):
        return self._sites[idx]

    def replace(self, idx, species, coords=None, properties=None) -> None:
        """Replace the species (and optionally coords) at one site.

        Mirrors ``pymatgen.core.Structure.replace`` (used in reference
        notebooks to decorate disordered supercells into ordered ones);
        ``species`` accepts a species string/object or an occupancy dict.
        """
        site = self._sites[idx]
        new = PeriodicSite(
            species,
            site.frac_coords if coords is None else np.asarray(coords),
            self._lattice,
            properties=(
                dict(site.properties) if properties is None else properties
            ),
            label=site.label,
        )
        new._index = idx
        self._sites[idx] = new

    def __setitem__(self, idx, species) -> None:
        """``structure[i] = "Au"`` species assignment (pymatgen parity)."""
        self.replace(idx, species)

    def __eq__(self, other):
        if not isinstance(other, Structure):
            return False
        if len(self) != len(other) or self._lattice != other._lattice:
            return False
        return all(
            s1.species == s2.species
            and np.allclose(s1.frac_coords, s2.frac_coords, atol=1e-8)
            for s1, s2 in zip(self._sites, other._sites)
        )

    def __repr__(self):
        lines = [
            f"Structure ({len(self)} sites)",
            f"lattice: {np.round(self._lattice.matrix, 6).tolist()}",
        ]
        lines += [repr(s) for s in self._sites]
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
            "lattice": self._lattice.as_dict(),
            "sites": [s.as_dict() for s in self._sites],
        }

    @classmethod
    def from_dict(cls, d):
        sites = [PeriodicSite.from_dict(sd) for sd in d["sites"]]
        return cls.from_sites(sites)

    @classmethod
    def from_file(cls, filename) -> "Structure":
        """Read a structure from a POSCAR/CONTCAR or CIF file: not ported."""
        raise NotImplementedError(
            "POSCAR and CIF files (smol_tpu/crystal/fileio.py) are not ported "
            "yet (ROADMAP.md Queue 1 item 5(a))")

    @classmethod
    def from_str(cls, text: str, fmt: str) -> "Structure":
        """Parse a structure from a string (``fmt``: 'poscar' or 'cif'): not
        ported."""
        raise NotImplementedError(
            "POSCAR and CIF files (smol_tpu/crystal/fileio.py) are not ported "
            "yet (ROADMAP.md Queue 1 item 5(a))")

    def to(self, filename, fmt: str | None = None) -> None:
        """Write this structure to a POSCAR or CIF file: not ported."""
        raise NotImplementedError(
            "POSCAR and CIF files (smol_tpu/crystal/fileio.py) are not ported "
            "yet (ROADMAP.md Queue 1 item 5(a))")


def _collect_props(sites) -> dict:
    keys = set()
    for s in sites:
        keys.update(s.properties)
    return {k: [s.properties.get(k) for s in sites] for k in keys}
