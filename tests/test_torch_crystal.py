"""The port's crystal layer against ``smol_tpu``'s on the same inputs.

``smol_tpu_torch.crystal`` copies ``smol_tpu/crystal`` (species, lattice,
structure, symmetry and the pymatgen reader) without importing it.  The
same inputs must give the same results: species names, charges, equality
and order (the order fixes every site space's codes), lattices, supercells
and their lattice points bit for bit, and the symmetry operations of a
prim in the reference's order (the order picks each orbit's
representative cluster, and so every packed array).
"""

import json
from pathlib import Path

import numpy as np
import pytest

from smol_tpu_torch.crystal import (
    Composition,
    Lattice,
    Structure,
    get_species,
    get_symmetry_operations,
    lattice_points_in_supercell,
)
from smol_tpu_torch.crystal.pmg_compat import load_pmg_json
from smol_tpu_torch.serial import process_decoded

DATA = Path(__file__).resolve().parent / "data"
NAMES = ("Li+", "Mn3+", "Mn4+", "O2-", "F-", "vacA0+", "Au", "Ag", "Cu", "Ni3+", "Ni4+",
         "Fe2+", "Fe3+", "Pd", "Pt", "Zr4+", "Ca2+", "Vacancy", "Li")
SUPERCELLS = (np.diag([2, 2, 2]), np.diag([3, 1, 2]),
              np.array([[1, 1, 0], [0, 1, 1], [1, 0, 1]]),
              np.array([[2, -1, 0], [0, 1, 1], [1, 0, 3]]))


def _prims():
    from smol_tpu.benchmarks import systems as ref_systems

    from smol_tpu_torch.benchmarks import systems

    return {name: (getattr(systems, name)(), getattr(ref_systems, name)())
            for name in ("fcc_binary_prim", "fcc_ternary_prim", "spinel_prim")}


def _assert_same_structure(mine, theirs):
    assert len(mine) == len(theirs)
    np.testing.assert_array_equal(mine.lattice.matrix, theirs.lattice.matrix)
    np.testing.assert_array_equal(mine.frac_coords, theirs.frac_coords)
    for a, b in zip(mine, theirs):
        assert [(str(sp), amt) for sp, amt in a.species.items()] == \
            [(str(sp), amt) for sp, amt in b.species.items()]


def test_species_parse_and_order():
    from smol_tpu.crystal import get_species as ref_get_species

    mine = [get_species(name) for name in NAMES]
    theirs = [ref_get_species(name) for name in NAMES]
    for a, b in zip(mine, theirs):
        assert (type(a).__name__, str(a), a.symbol) == (type(b).__name__, str(b), b.symbol)
        assert getattr(a, "oxi_state", None) == getattr(b, "oxi_state", None)
    # the order that fixes site-space codes, and equality
    assert [str(s) for s in sorted(mine)] == [str(s) for s in sorted(theirs)]
    for i, a in enumerate(mine):
        for j, b in enumerate(mine):
            assert (a == b) == (theirs[i] == theirs[j])
            assert (a < b) == (theirs[i] < theirs[j])
    assert len(set(mine)) == len(set(theirs))


def test_composition():
    from smol_tpu.crystal import Composition as RefComposition

    spec = {"Li+": 0.5, "Mn3+": 0.25, "Mn4+": 0.25}
    mine, theirs = Composition(spec), RefComposition(spec)
    assert [(str(k), v) for k, v in mine.items()] == [(str(k), v) for k, v in theirs.items()]
    assert mine.num_atoms == theirs.num_atoms


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lattice(seed):
    from smol_tpu.crystal import Lattice as RefLattice

    matrix = np.random.default_rng(seed).normal(size=(3, 3)) + 4 * np.eye(3)
    mine, theirs = Lattice(matrix), RefLattice(matrix)
    for name in ("lengths", "angles", "volume", "inv_matrix", "metric_tensor"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(theirs, name))
    np.testing.assert_array_equal(mine.reciprocal_lattice.matrix,
                                  theirs.reciprocal_lattice.matrix)
    frac = np.random.default_rng(seed + 10).random((5, 3))
    np.testing.assert_array_equal(mine.get_cartesian_coords(frac),
                                  theirs.get_cartesian_coords(frac))
    np.testing.assert_array_equal(mine.get_fractional_coords(frac),
                                  theirs.get_fractional_coords(frac))
    params = (3.1, 4.2, 5.3, 80.0, 95.0, 110.0)
    np.testing.assert_array_equal(Lattice.from_parameters(*params).matrix,
                                  RefLattice.from_parameters(*params).matrix)


@pytest.mark.parametrize("k", range(len(SUPERCELLS)))
def test_supercells(k):
    from smol_tpu.crystal import lattice_points_in_supercell as ref_points

    scm = SUPERCELLS[k]
    np.testing.assert_array_equal(lattice_points_in_supercell(scm), ref_points(scm))
    for mine, theirs in _prims().values():
        _assert_same_structure(mine.copy().make_supercell(scm),
                               theirs.copy().make_supercell(scm))


def test_fcc_symmetry_operations_in_reference_order():
    from smol_tpu.crystal import get_symmetry_operations as ref_ops

    for name, (mine, theirs) in _prims().items():
        ops, ref = get_symmetry_operations(mine), ref_ops(theirs)
        if name == "fcc_binary_prim":
            assert len(ops) == 48
        assert len(ops) == len(ref)
        for a, b in zip(ops, ref):
            np.testing.assert_array_equal(a.rotation, b.rotation)
            np.testing.assert_array_equal(a.translation, b.translation)


def test_pmg_json_reads_as_reference():
    from smol_tpu.crystal.pmg_compat import load_pmg_json as ref_load

    mine, theirs = load_pmg_json(str(DATA / "lno_prim.json")), ref_load(
        str(DATA / "lno_prim.json"))
    assert isinstance(mine, Structure)
    _assert_same_structure(mine, theirs)
    ops, ref = get_symmetry_operations(mine), get_symmetry_operations(theirs)
    assert len(ops) == len(ref)


def test_reference_structure_dict_decodes_to_port():
    from smol_tpu.serial import SmolJSONEncoder

    mine, theirs = _prims()["spinel_prim"]
    doc = json.loads(json.dumps(theirs.as_dict(), cls=SmolJSONEncoder))
    assert doc["@module"].startswith("smol_tpu.")
    decoded = process_decoded(doc)
    assert type(decoded) is Structure
    _assert_same_structure(decoded, theirs)
    again = process_decoded(json.loads(json.dumps(decoded.as_dict())))
    _assert_same_structure(again, mine)


def test_file_formats_wait_for_their_item():
    with pytest.raises(NotImplementedError, match=r"5\(a\)"):
        Structure.from_str("", "poscar")
