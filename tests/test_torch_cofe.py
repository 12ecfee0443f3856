"""The port's cluster-space layer against ``smol_tpu``'s on the same inputs.

``smol_tpu_torch.cofe`` copies ``smol_tpu/cofe/space`` and
``cofe/expansion.py`` (with ``ops/packing.py``) without importing them.
A subspace built from the same prim and cutoffs must have the same orbits
in the same order (the order fixes the function ids), the same
multiplicities, bit combinations and correlation tensors, and pack a
supercell into the same arrays: integers exactly, f64 within 1e-12
relative (|diff| <= 1e-12 * max(1, max |reference|)).  Correlations go
through the port's packed evaluation (``ops/correlations.py``), and the
27 structures of ``tests/data/golden_lno_ce.json`` must give smol's own
stored correlation vectors within 1e-12 relative.  A ``ClusterExpansion``
that ``smol_tpu`` saved loads in the port and builds the ensemble that
``smol_tpu`` exports; a class the port lacks raises ``NotImplementedError``
naming its ROADMAP.md item.
"""

import dataclasses
import json
from itertools import permutations
from pathlib import Path

import numpy as np
import pytest

from smol_tpu_torch.cofe import ClusterExpansion, ClusterSubspace
from smol_tpu_torch.cofe.space.domain import get_allowed_species
from smol_tpu_torch.crystal import Lattice, Structure
from smol_tpu_torch.crystal.pmg_compat import decode_pmg, load_pmg_json
from smol_tpu_torch.ops.packing import pack_supercell
from smol_tpu_torch.serial import process_decoded
from smol_tpu_torch.system import build_system

DATA = Path(__file__).resolve().parent / "data"
REL_TOL = 1e-12
BASES = ("indicator", "sinusoid", "polynomial", "chebyshev", "legendre")
ROCKSALT = np.array([[0, 0.5, 0.5], [0.5, 0, 0.5], [0.5, 0.5, 0]])


def _close(mine, theirs, what):
    mine, theirs = np.asarray(mine), np.asarray(theirs)
    assert mine.shape == theirs.shape, what
    if theirs.dtype.kind == "f":
        scale = max(1.0, float(np.abs(theirs).max(initial=0.0)))
        assert float(np.abs(mine - theirs).max(initial=0.0)) <= REL_TOL * scale, what
    else:
        assert mine.dtype == theirs.dtype and np.array_equal(mine, theirs), what


def _ternary(module):
    lat = module.Lattice(ROCKSALT * 3.9)
    return module.Structure(lat, [{"Au": 1 / 3, "Ag": 1 / 3, "Cu": 1 / 3}], [[0, 0, 0]])


def _quaternary(module):
    return module.Structure(
        module.Lattice(ROCKSALT * 4.2),
        [{sp: 0.25 for sp in ("Au", "Ag", "Cu", "Pd")}, {"Ni": 0.5, "Pt": 0.5}],
        [[0, 0, 0], [0.5, 0.5, 0.5]])


def _binary(module):
    lat = module.Lattice(ROCKSALT * 3.8)
    return module.Structure(lat, [{"Au": 0.5, "Cu": 0.5}], [[0, 0, 0]])


def _subspaces(prim, cutoffs, **kwargs):
    import smol_tpu.crystal as ref_crystal
    from smol_tpu.cofe import ClusterSubspace as RefSubspace

    import smol_tpu_torch.crystal as crystal

    return (ClusterSubspace.from_cutoffs(prim(crystal), cutoffs, **kwargs),
            RefSubspace.from_cutoffs(prim(ref_crystal), cutoffs, **kwargs))


def _assert_same_subspace(mine, theirs, scm):
    assert (mine.num_orbits, mine.num_corr_functions, mine.num_clusters) == \
        (theirs.num_orbits, theirs.num_corr_functions, theirs.num_clusters)
    np.testing.assert_array_equal(mine.orbit_multiplicities, theirs.orbit_multiplicities)
    np.testing.assert_array_equal(mine.function_orbit_ids, theirs.function_orbit_ids)
    for a, b in zip(mine.orbits, theirs.orbits):
        assert (a.id, a.bit_id, a.multiplicity, len(a)) == (b.id, b.bit_id, b.multiplicity,
                                                            len(b))
        np.testing.assert_array_equal(a.base_cluster.frac_coords, b.base_cluster.frac_coords)
        assert a.base_cluster.diameter == b.base_cluster.diameter
        for x, y in zip(a.bit_combos, b.bit_combos):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a.bit_combo_multiplicities, b.bit_combo_multiplicities)
        for x, y in zip(a.site_bases, b.site_bases):
            _close(x.function_array, y.function_array, f"orbit {a.id} basis")
        for x, y in zip(a.correlation_tensors, b.correlation_tensors):
            _close(x, y, f"orbit {a.id} correlation tensor")
    packed = pack_supercell(mine, scm)
    from smol_tpu.ops.packing import pack_supercell as ref_pack

    ref = ref_pack(theirs, scm)
    for field in dataclasses.fields(packed):
        _close(getattr(packed, field.name), getattr(ref, field.name), field.name)


@pytest.mark.parametrize("orthonormal", [True, False])
@pytest.mark.parametrize("basis", BASES)
def test_ternary_subspace_matches_reference(basis, orthonormal):
    mine, theirs = _subspaces(_ternary, {2: 5.0, 3: 4.0}, basis=basis,
                              orthonormal=orthonormal)
    _assert_same_subspace(mine, theirs, np.diag([2, 2, 2]))


@pytest.mark.parametrize("basis", BASES)
def test_quaternary_subspace_matches_reference(basis):
    mine, theirs = _subspaces(_quaternary, {2: 4.5, 3: 3.0}, basis=basis)
    _assert_same_subspace(mine, theirs, np.array([[1, 1, 0], [0, 1, 1], [1, 0, 1]]))


def test_four_site_clusters_match_reference():
    mine, theirs = _subspaces(_binary, {2: 5.0, 3: 4.0, 4: 3.0})
    assert 4 in mine.orbits_by_size
    _assert_same_subspace(mine, theirs, np.diag([2, 2, 2]))


def test_correlations_match_reference():
    mine, theirs = _subspaces(_quaternary, {2: 4.5, 3: 3.0}, basis="chebyshev")
    scm = np.diag([2, 2, 2])
    supercell = mine.structure.copy().make_supercell(scm)
    codes = np.array([len(species) for species in get_allowed_species(supercell)])
    occ = (np.random.default_rng(4).random((8, len(codes))) * codes).astype(np.int32)
    for o in occ:
        _close(mine.corr_from_occupancy(o, scm), theirs.corr_from_occupancy(o, scm), "corr")


def _golden_subspace():
    golden = json.loads((DATA / "golden_lno_ce.json").read_text())
    built = golden["construction"]
    subspace = ClusterSubspace.from_cutoffs(
        load_pmg_json(str(DATA / "lno_prim.json")),
        {int(k): v for k, v in built["cutoffs"].items()}, basis=built["basis"])
    return golden, subspace


def _entry_args(entry):
    return dict(scmatrix=np.asarray(entry["supercell_matrix"]),
                site_mapping=[int(x) for x in entry["site_mapping"]])


def test_golden_correlations_from_structures():
    """smol's stored vectors within 1e-12 relative; orbits tied in smol's
    sort key keep an order from pymatgen's neighbour search, so each tied
    group's columns may be permuted, one permutation for all 27 (as
    ``tests/test_integration/test_golden_parity.py`` allows)."""
    golden, subspace = _golden_subspace()
    mine = np.array([subspace.corr_from_structure(decode_pmg(e["structure"]),
                                                  **_entry_args(e))
                     for e in golden["entries"]])
    stored = np.array([e["correlations"] for e in golden["entries"]])
    assert mine.shape == stored.shape == (27, subspace.num_corr_functions)
    groups = {}
    for orbit in subspace.orbits:
        key = (orbit.num_sites, round(orbit.base_cluster.diameter, 6), orbit.multiplicity,
               len(orbit))
        groups.setdefault(key, []).append(range(orbit.bit_id, orbit.bit_id + len(orbit)))
    perm = np.arange(mine.shape[1])
    for blocks in (g for g in groups.values() if len(g) > 1):
        cols = np.concatenate(blocks)
        best = min(permutations(blocks), key=lambda order: np.abs(
            mine[:, np.concatenate(order)] - stored[:, cols]).max())
        perm[cols] = np.concatenate(best)
    rel = np.abs(mine[:, perm] - stored) / np.maximum(1.0, np.abs(stored))
    assert rel.max() <= REL_TOL


def test_golden_structures_match_reference():
    """Correlations and cluster interactions of the golden structures as
    ``smol_tpu`` computes them, column for column."""
    from smol_tpu.cofe import ClusterExpansion as RefExpansion
    from smol_tpu.cofe import ClusterSubspace as RefSubspace
    from smol_tpu.crystal.pmg_compat import decode_pmg as ref_decode
    from smol_tpu.crystal.pmg_compat import load_pmg_json as ref_load

    golden, subspace = _golden_subspace()
    ref = RefSubspace.from_cutoffs(ref_load(str(DATA / "lno_prim.json")), {2: 5, 3: 4.1},
                                   basis="sinusoid")
    coefs = np.asarray(golden["coefs"])
    ce, ref_ce = ClusterExpansion(subspace, coefs), RefExpansion(ref, coefs)
    for entry in golden["entries"][:9]:
        args = _entry_args(entry)
        mine_s, ref_s = decode_pmg(entry["structure"]), ref_decode(entry["structure"])
        _close(subspace.corr_from_structure(mine_s, **args),
               ref.corr_from_structure(ref_s, **args), "corr")
        _close(ce.cluster_interactions_from_structure(mine_s, **args),
               ref_ce.cluster_interactions_from_structure(ref_s, **args), "interactions")
        np.testing.assert_array_equal(
            subspace.occupancy_from_structure(mine_s, encode=True, **args),
            ref.occupancy_from_structure(ref_s, encode=True, **args))


def _reference_doc(obj):
    from smol_tpu.serial import SmolJSONEncoder

    return json.loads(json.dumps(obj.as_dict(), cls=SmolJSONEncoder))


@pytest.mark.parametrize("kind", ["decomposition", "expansion"])
def test_saved_reference_expansion_builds_the_exported_system(kind):
    from smol_tpu.benchmarks.systems import fcc_ternary_prim, random_expansion
    from smol_tpu.moca import Ensemble as RefEnsemble

    from smol_tpu_torch.system import export_system

    mus = {"Au": 0.05, "Ag": 0.0, "Cu": -0.05}
    ref_ce = random_expansion(fcc_ternary_prim(), {2: 5.5, 3: 4.0}, seed=7)
    ref_ce.cluster_subspace.get_orbit_indices(np.diag([3, 3, 3]))  # saved with the dict
    doc = _reference_doc(ref_ce)
    assert doc["@module"] == "smol_tpu.cofe.expansion"
    ce = process_decoded(doc)
    assert type(ce) is ClusterExpansion
    np.testing.assert_array_equal(ce.coefs, ref_ce.coefs)
    exported = export_system(RefEnsemble.from_cluster_expansion(
        ref_ce, np.diag([3, 3, 3]), processor_type=kind, chemical_potentials=mus))
    built = build_system(ce, np.diag([3, 3, 3]), processor_type=kind,
                         chemical_potentials=mus)
    assert sorted(built) == sorted(exported)
    for key in exported:
        np.testing.assert_array_equal(built[key], exported[key], err_msg=key)
    # and the port's own dict round-trips
    again = ClusterExpansion.from_dict(json.loads(json.dumps(ce.as_dict())))
    assert again.cluster_subspace == ce.cluster_subspace
    np.testing.assert_array_equal(again.coefs, ce.coefs)


def test_classes_the_port_lacks_name_their_item():
    from smol_tpu.benchmarks.systems import random_expansion, spinel_prim
    from smol_tpu.cofe import PottsSubspace

    from smol_tpu_torch.cofe.extern import EwaldTerm

    ref_ce = random_expansion(spinel_prim(), {2: 4.0}, seed=11, ewald=True)
    ewald = process_decoded(_reference_doc(ref_ce))  # ported: decodes to the port's
    assert type(ewald) is ClusterExpansion
    terms = ewald.cluster_subspace.external_terms
    assert [type(t) for t in terms] == [EwaldTerm] and terms[0].use_term == "total"
    np.testing.assert_array_equal(ewald.coefs, ref_ce.coefs)
    potts = _reference_doc(PottsSubspace.from_cutoffs(_binary(__import__(
        "smol_tpu.crystal", fromlist=["Lattice"])), {2: 3.0}))
    with pytest.raises(NotImplementedError, match=r"PottsSubspace.*5\(b\)"):
        process_decoded(potts)


def test_structure_matching_waits_for_its_item():
    """Structure matching is ported (the name is the refusal's it replaced):
    without a supercell matrix or a site mapping, a golden structure's
    matrix, occupancy and correlations are ``smol_tpu``'s own; the
    matcher's keywords reach it."""
    from smol_tpu.cofe import ClusterSubspace as RefSubspace
    from smol_tpu.crystal.pmg_compat import decode_pmg as ref_decode
    from smol_tpu.crystal.pmg_compat import load_pmg_json as ref_load

    golden, subspace = _golden_subspace()
    ref = RefSubspace.from_cutoffs(ref_load(str(DATA / "lno_prim.json")), {2: 5, 3: 4.1},
                                   basis="sinusoid")
    entry = golden["entries"][0]
    structure, ref_structure = decode_pmg(entry["structure"]), ref_decode(entry["structure"])
    scmatrix = subspace.scmatrix_from_structure(structure)
    np.testing.assert_array_equal(scmatrix, ref.scmatrix_from_structure(ref_structure))
    assert abs(np.linalg.det(scmatrix)) == abs(np.linalg.det(entry["supercell_matrix"]))
    np.testing.assert_array_equal(
        subspace.occupancy_from_structure(structure, encode=True),
        ref.occupancy_from_structure(ref_structure, encode=True))
    _close(subspace.corr_from_structure(structure), ref.corr_from_structure(ref_structure),
           "corr")
    from smol_tpu_torch.cofe.extern import EwaldTerm

    size = len(subspace)  # external terms are ported: one Ewald term a subspace
    subspace.add_external_term(EwaldTerm())
    assert len(subspace) == size + 1
    with pytest.raises(ValueError, match="already has"):
        subspace.add_external_term(EwaldTerm(use_term="real"))
    prim = Structure(Lattice(ROCKSALT * 3.8), [{"Au": 0.5, "Cu": 0.5}], [[0, 0, 0]])
    loose = ClusterSubspace.from_cutoffs(prim, {2: 3.0}, ltol=0.3)
    assert loose._sc_matcher.ltol == loose._site_matcher.ltol == 0.3
