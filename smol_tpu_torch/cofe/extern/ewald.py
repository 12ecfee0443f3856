"""EwaldTerm: electrostatics as an extra cluster-expansion feature.

Counterpart of ``smol_tpu/cofe/extern/ewald.py``, whose code it copies. In
this module "the reference" is smol (CederGroupHub/smol).

Mirrors the reference EwaldTerm (smol/cofe/extern/ewald.py): expands every
site into one Ewald-matrix row per allowed (non-vacancy) species so a single
matrix serves all configurations; the feature value of an occupancy is the
occupied-row submatrix sum.
"""

from __future__ import annotations

import numpy as np

from smol_tpu_torch.cofe.space.domain import Vacancy, get_allowed_species
from smol_tpu_torch.crystal import PeriodicSite, Structure
from smol_tpu_torch.crystal.ewald import EwaldSummation
from smol_tpu_torch.serial import MSONable

__all__ = ["EwaldTerm"]


class EwaldTerm(MSONable):
    """External Ewald electrostatic term for a ClusterSubspace."""

    ewald_term_options = ("total", "real", "reciprocal", "point")

    def __init__(
        self, eta=None, real_space_cut=None, recip_space_cut=None, use_term="total"
    ):
        self.eta = eta
        self.real_space_cut = real_space_cut
        self.recip_space_cut = recip_space_cut
        if use_term not in self.ewald_term_options:
            raise AttributeError(
                f"Invalid use_term {use_term}; options: {self.ewald_term_options}."
            )
        self.use_term = use_term

    @staticmethod
    def get_ewald_structure(structure) -> tuple[Structure, np.ndarray]:
        """Expand each site into one row per allowed species.

        Returns (ewald_structure, ewald_inds) where ewald_inds[site, code] is
        the Ewald row of (site, species) or -1 for vacancies
        (reference ewald.py:64-100).
        """
        site_spaces = get_allowed_species(structure)
        nbits = np.array([len(sp) - 1 for sp in site_spaces])
        ewald_inds, ewald_sites = [], []
        for space, site in zip(site_spaces, structure):
            inds = np.zeros(max(nbits) + 1) - 1
            for i, spec in enumerate(space):
                if isinstance(spec, Vacancy):
                    continue
                inds[i] = len(ewald_sites)
                ewald_sites.append(
                    PeriodicSite(spec, site.frac_coords, site.lattice)
                )
            ewald_inds.append(inds)
        ewald_inds = np.array(ewald_inds, dtype=np.int32)
        return Structure.from_sites(ewald_sites), ewald_inds

    @staticmethod
    def get_ewald_occu(occu, num_ewald_sites, ewald_inds) -> np.ndarray:
        """Boolean occupied-row selector for an encoded occupancy."""
        i_inds = ewald_inds[np.arange(len(occu)), occu]
        b_inds = np.zeros(num_ewald_sites + 1, dtype=bool)
        b_inds[i_inds] = True
        return b_inds[:-1]

    def get_ewald_matrix(self, ewald_summation: EwaldSummation) -> np.ndarray:
        """The pair matrix corresponding to ``use_term``."""
        if self.use_term == "total":
            matrix = ewald_summation.total_energy_matrix
        elif self.use_term == "reciprocal":
            matrix = ewald_summation.reciprocal_space_energy_matrix
        elif self.use_term == "real":
            matrix = ewald_summation.real_space_energy_matrix
        else:
            matrix = np.diag(ewald_summation.point_energy_matrix)
        return matrix.astype(np.float64)

    def value_from_occupancy(self, occu, structure) -> np.ndarray:
        """Extensive Ewald feature value for an occupancy of ``structure``."""
        ewald_structure, ewald_inds = self.get_ewald_structure(structure)
        summation = EwaldSummation(
            ewald_structure,
            real_space_cut=self.real_space_cut,
            recip_space_cut=self.recip_space_cut,
            eta=self.eta,
        )
        matrix = self.get_ewald_matrix(summation)
        ew_occu = self.get_ewald_occu(occu, matrix.shape[0], ewald_inds)
        return np.array([np.sum(matrix[ew_occu, :][:, ew_occu])])

    def __repr__(self):
        return f"EwaldTerm({self.use_term})"

    def as_dict(self) -> dict:
        return {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
            "eta": self.eta,
            "real_space_cut": self.real_space_cut,
            "recip_space_cut": self.recip_space_cut,
            "use_term": self.use_term,
        }

    @classmethod
    def from_dict(cls, d):
        return cls(
            eta=d["eta"],
            real_space_cut=d["real_space_cut"],
            recip_space_cut=d["recip_space_cut"],
            use_term=d["use_term"],
        )
