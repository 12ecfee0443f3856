"""Self-contained crystal-structure core (replaces the pymatgen dependency).

Counterpart of ``smol_tpu/crystal/__init__.py``.
"""

from smol_tpu_torch.crystal.coord import (
    coord_list_mapping,
    coord_list_mapping_pbc,
    is_coord_subset,
    is_coord_subset_pbc,
    lattice_points_in_supercell,
    pbc_diff,
)
from smol_tpu_torch.crystal.lattice import Lattice
from smol_tpu_torch.crystal.species import (
    Composition,
    DummySpecies,
    Element,
    Species,
    Vacancy,
    get_species,
)
from smol_tpu_torch.crystal.structure import PeriodicSite, Site, Structure
from smol_tpu_torch.crystal.symmetry import SymmOp, get_symmetry_operations

__all__ = [
    "Lattice",
    "Structure",
    "PeriodicSite",
    "Site",
    "Species",
    "Element",
    "DummySpecies",
    "Vacancy",
    "Composition",
    "get_species",
    "SymmOp",
    "get_symmetry_operations",
    "pbc_diff",
    "is_coord_subset",
    "is_coord_subset_pbc",
    "coord_list_mapping",
    "coord_list_mapping_pbc",
    "lattice_points_in_supercell",
]
