"""Site spaces: allowed species and their measures at a site.

Counterpart of ``smol_tpu/cofe/space/domain.py``, whose code it copies. In
this module "the reference" is smol (CederGroupHub/smol).

Mirrors the reference's domain module (smol/cofe/space/domain.py): a
SiteSpace is an ordered mapping species -> measure whose sorted order fixes
the integer encoding used by basis functions and occupancy strings.
Vacancies are auto-appended when total occupancy < 1 and always sort last.
"""

from __future__ import annotations

from collections import OrderedDict
from collections.abc import Hashable, Mapping

from smol_tpu_torch.crystal.species import Composition, Species, Vacancy, get_species
from smol_tpu_torch.serial import MSONable, process_decoded

__all__ = ["SiteSpace", "Vacancy", "get_site_spaces", "get_allowed_species", "get_species"]


class SiteSpace(Mapping, Hashable, MSONable):
    """An ordered site space: allowed species with measures summing to 1.

    The species order (ascending species sort, vacancy last) implicitly
    defines the integer code of each species at sites with this space
    (reference: domain.py:158-161).
    """

    def __init__(self, composition: Composition):
        if composition.num_atoms < 0 or composition.num_atoms > 1 + 1e-8:
            raise ValueError(
                f"Composition must have 0 <= num_atoms <= 1, got {composition.num_atoms}."
            )
        n_vac = sum(isinstance(sp, Vacancy) for sp in composition)
        if n_vac > 1:
            raise ValueError(f"Multiple vacancies in composition {composition}.")
        if n_vac == 1 and abs(composition.num_atoms - 1) > 1e-8:
            raise ValueError(
                f"Composition {composition} has a Vacancy but num_atoms != 1."
            )

        self._composition = composition
        self._data = OrderedDict(sorted(composition.items()))
        if composition.num_atoms < 0.99:
            self._data[Vacancy()] = 1.0 - composition.num_atoms

    @property
    def composition(self) -> Composition:
        """The underlying composition (without the implicit vacancy)."""
        return self._composition

    @property
    def codes(self) -> tuple:
        """Integer codes of the species."""
        return tuple(range(len(self)))

    def __getitem__(self, item):
        return self._data[get_species(item) if not isinstance(item, Species) else item]

    def __len__(self):
        return len(self._data)

    def __iter__(self):
        return iter(self._data)

    def __eq__(self, other):
        if not isinstance(other, SiteSpace):
            return False
        return list(self._data.items()) == list(other._data.items())

    def __lt__(self, other):
        return list(self._data.keys()) < list(other._data.keys())

    def __hash__(self):
        return hash(tuple(str(sp) for sp in self._data))

    def __str__(self):
        return "SiteSpace: " + " ".join(
            f"{sp}:{amt:g}" for sp, amt in self._data.items()
        )

    def __repr__(self):
        return str(self)

    def as_dict(self) -> dict:
        return {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
            "composition": self._composition.as_dict(),
        }

    @classmethod
    def from_dict(cls, d):
        return cls(process_decoded(d["composition"]))


def get_site_spaces(structure, include_measure: bool = False) -> list[SiteSpace]:
    """Get the site space of every site in a (disordered) structure.

    Vacancies are included at sites whose composition sums to < 1. With
    ``include_measure`` the site composition is used as the measure;
    otherwise measures are uniform (reference: domain.py:47-82).
    """
    spaces = []
    for site in structure:
        if include_measure:
            spaces.append(SiteSpace(site.species))
        else:
            num = len(site.species)
            if site.species.num_atoms < 0.99:
                num += 1
            spaces.append(
                SiteSpace(Composition({sp: 1.0 / num for sp in site.species}))
            )
    return spaces


def get_allowed_species(structure) -> list[list]:
    """Ordered allowed species at each site (the encoding order)."""
    return [list(space.keys()) for space in get_site_spaces(structure)]
