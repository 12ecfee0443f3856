"""Readers for pymatgen-format JSON documents (reference interop).

Counterpart of ``smol_tpu/crystal/pmg_compat.py``, whose code it copies,
without its entries. In this module "the reference" is smol
(CederGroupHub/smol).

The reference (CederGroupHub/smol) serializes everything through pymatgen
and monty MSON tags — prim structures, training entries, and whole saved
workflows carry ``"@module": "pymatgen.*"`` markers.  pymatgen is not a
dependency here, so this module translates those documents into the
native :mod:`smol_tpu_torch.crystal` types: a user migrating from the reference
can load their existing ``*.json`` / ``*.mson`` data files directly.

Supported classes (the ones reference-smol documents actually contain):

- ``pymatgen.core.structure.Structure`` (sites carry ``species`` rows of
  ``{element, oxidation_state, occu}`` plus fractional ``abc``),
- ``pymatgen.core.lattice.Lattice``,
- ``pymatgen.core.periodic_table.{Element, Species, DummySpecies}``,
- ``pymatgen.entries.computed_entries.ComputedStructureEntry``
  (``entry.energy`` = ``energy + correction``, matching pymatgen),
- monty-encoded ``numpy`` arrays (``{"@module": "numpy", "@class":
  "array", "dtype": ..., "data": ...}``).

Reference analog: monty.json.MontyDecoder.process_decoded as used
throughout smol (e.g. smol/cofe/space/clusterspace.py:1634-1725,
smol/io.py:43).
"""

from __future__ import annotations

import json

import numpy as np

__all__ = [
    "is_pmg_dict",
    "decode_pmg",
    "load_pmg_json",
]


def is_pmg_dict(d: dict) -> bool:
    """True when ``d`` is an ``@module``-tagged pymatgen/numpy document."""
    mod = d.get("@module", "")
    return mod.startswith("pymatgen") or mod == "numpy"


def _species_from_row(row: dict):
    """One ``{element, oxidation_state, occu}`` row -> (Species, occu)."""
    from smol_tpu_torch.crystal.species import DummySpecies, Element, Species

    symbol = row["element"]
    oxi = row.get("oxidation_state", None)
    occu = float(row.get("occu", 1.0))
    if symbol.startswith(("X", "Dummy")) and symbol not in ("Xe",):
        sp = DummySpecies(symbol, 0 if oxi is None else oxi)
    elif oxi is None:
        sp = Element(symbol)
    else:
        sp = Species(symbol, oxi)
    return sp, occu


def _species_dict(site: dict) -> dict:
    comp = {}
    for row in site["species"]:
        sp, occu = _species_from_row(row)
        comp[sp] = comp.get(sp, 0.0) + occu
    return comp


def _structure_from_dict(d: dict):
    from smol_tpu_torch.crystal.lattice import Lattice
    from smol_tpu_torch.crystal.structure import Structure

    lattice = Lattice(np.asarray(d["lattice"]["matrix"], dtype=np.float64))
    species = [_species_dict(site) for site in d["sites"]]
    frac = [site["abc"] for site in d["sites"]]
    labels = [site.get("label") for site in d["sites"]]
    return Structure(lattice, species, frac, labels=labels)


def _lattice_from_dict(d: dict):
    from smol_tpu_torch.crystal.lattice import Lattice

    return Lattice(np.asarray(d["matrix"], dtype=np.float64))


def _entry_from_dict(d: dict):
    raise NotImplementedError(
        f"{d['@class']} (smol_tpu/crystal/entries.py) is not ported yet "
        "(ROADMAP.md Queue 1 item 7)")


def _pmg_species_from_dict(d: dict):
    from smol_tpu_torch.crystal.species import Element, Species

    if "oxidation_state" in d and d["oxidation_state"] is not None:
        return Species(d["element"], d["oxidation_state"])
    return Element(d["element"])


def decode_pmg(d: dict):
    """Decode one ``@module``-tagged pymatgen/numpy dict, or return None.

    Nested tagged documents are resolved recursively; untagged values are
    left as plain JSON data.
    """
    mod = d.get("@module", "")
    cls = d.get("@class", "")
    if mod == "numpy" and cls == "array":
        return np.asarray(d["data"], dtype=d.get("dtype"))
    if not mod.startswith("pymatgen"):
        return None
    if cls == "Structure" or cls == "IStructure":
        return _structure_from_dict(d)
    if cls == "Lattice":
        return _lattice_from_dict(d)
    if cls == "ComputedStructureEntry" or cls == "ComputedEntry":
        return _entry_from_dict(d)
    if cls in ("Species", "Specie", "Element", "DummySpecies", "DummySpecie"):
        return _pmg_species_from_dict(d)
    return None


def load_pmg_json(path: str):
    """Load a JSON file, resolving pymatgen/monty tags to native objects."""
    from smol_tpu_torch.serial import process_decoded

    with open(path) as fh:
        return process_decoded(json.load(fh))
