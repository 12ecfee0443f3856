"""The port's structure matching and supercell enumeration against smol_tpu's.

``smol_tpu_torch/crystal/matcher.py`` and ``capp/generate/enumerate.py``
copy ``smol_tpu``'s modules (numpy and scipy), so on the same inputs they
must give the same answers exactly: the cases of
``tests/test_crystal/test_matcher.py`` (rotated, strained, sheared,
rattled and combined fcc supercells, a rotated spinel, a wrong lattice, a
site rattled past ``stol``, equivalent and inequivalent orderings) go
through both ``StructureMatcher``s, which must return the same supercell
matrices, site mappings and fits.  The cluster subspace then matches a
structure without a given matrix or mapping, as ``smol_tpu``'s does.
"""

import numpy as np
import pytest

import smol_tpu.crystal as ref_crystal
from smol_tpu.capp.generate.enumerate import enumerate_supercell_matrices as ref_enumerate
from smol_tpu.cofe import ClusterSubspace as RefSubspace
from smol_tpu.crystal.matcher import StructureMatcher as RefMatcher

import smol_tpu_torch.crystal as crystal
from smol_tpu_torch.benchmarks.systems import fcc_binary_prim, spinel_prim
from smol_tpu_torch.capp.generate.enumerate import enumerate_supercell_matrices
from smol_tpu_torch.capp.generate.random import generate_random_ordered_occupancy
from smol_tpu_torch.cofe import ClusterSubspace
from smol_tpu_torch.crystal.matcher import StructureMatcher
from smol_tpu_torch.moca.processor.expansion import ClusterExpansionProcessor


def _rotation(axis, angle):
    axis = np.asarray(axis, dtype=float)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def _distort(structure, rotate=None, strain=None, rattle=0.0, translate=None, seed=0):
    """A port structure with rotation, strain, rattling and translation
    applied (``tests/test_crystal/test_matcher.py:_distort``)."""
    rng = np.random.default_rng(seed)
    lat = structure.lattice.matrix.copy()
    if strain is not None:
        lat = lat @ (np.eye(3) + np.asarray(strain))
    if rotate is not None:
        lat = lat @ rotate.T
    cart = structure.frac_coords @ lat
    if rattle:
        cart = cart + rng.normal(scale=rattle, size=cart.shape)
    if translate is not None:
        cart = cart + np.asarray(translate)
    frac = cart @ np.linalg.inv(lat)
    return crystal.Structure(crystal.Lattice(lat), [dict(s.species) for s in structure],
                             frac % 1)


def _reference(structure):
    """The same structure in ``smol_tpu``'s types."""
    return ref_crystal.Structure(
        ref_crystal.Lattice(structure.lattice.matrix),
        [{str(sp): amount for sp, amount in site.species.items()} for site in structure],
        structure.frac_coords)


def _ordered(prim, cutoffs, scm, seed):
    """(port subspace, an ordered supercell structure of a random occupancy)."""
    subspace = ClusterSubspace.from_cutoffs(prim, cutoffs)
    proc = ClusterExpansionProcessor(subspace, scm, np.ones(subspace.num_corr_functions),
                                     device="cpu")
    occu = generate_random_ordered_occupancy(proc, rng=np.random.default_rng(seed))
    return subspace, proc.structure_from_occupancy(occu)


def _same_answers(mine, theirs, structure, target):
    """Both matchers' supercell candidates and mapping of ``structure`` onto
    ``target`` (a prim or an ideal supercell), and their fit."""
    ref_structure, ref_target = _reference(structure), _reference(target)
    cands = mine.get_supercell_matrix_candidates(structure, target)
    ref_cands = theirs.get_supercell_matrix_candidates(ref_structure, ref_target)
    assert len(cands) == len(ref_cands)
    for a, b in zip(cands, ref_cands):
        np.testing.assert_array_equal(a, b)
    mapping, ref_mapping = mine.get_mapping(target, structure), theirs.get_mapping(
        ref_target, ref_structure)
    assert (mapping is None) == (ref_mapping is None)
    if mapping is not None:
        np.testing.assert_array_equal(mapping, ref_mapping)
    assert mine.fit(structure, target) == theirs.fit(ref_structure, ref_target)
    return cands, mapping


CASES = {
    "ideal": dict(),
    "rotated": dict(rotate=_rotation([1, 2, 3], 0.7)),
    "strained": dict(strain=np.diag([0.02, -0.015, 0.01])),
    "sheared": dict(strain=[[0, 0.01, 0], [0.01, 0, 0], [0, 0, 0]]),
    "rattled": dict(rattle=0.08),
    "all-combined": dict(rotate=_rotation([1, 0, 1], 0.4), strain=np.diag([0.02, 0.02, -0.01]),
                         rattle=0.05),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fcc_supercell_matches_reference(case):
    """An ordered fcc 2x2x2 supercell, distorted as the reference's tests
    distort it: the matchers agree on the matrix, the mapping onto the
    ideal supercell and the fit, and the port's subspace recovers the
    undistorted correlations without a given matrix."""
    scm = np.diag([2, 2, 2])
    subspace, structure = _ordered(fcc_binary_prim(), {2: 4.0}, scm, seed=11)
    distorted = _distort(structure, translate=[0.31, -0.12, 0.07], seed=4, **CASES[case])
    supercell = subspace.structure.copy().make_supercell(scm)
    cands, mapping = _same_answers(StructureMatcher(), RefMatcher(), distorted,
                                   subspace.structure)
    assert cands and abs(abs(np.linalg.det(cands[0])) - 8) < 0.5
    _same_answers(StructureMatcher(), RefMatcher(), distorted, supercell)
    found = subspace.scmatrix_from_structure(distorted)
    assert abs(abs(np.linalg.det(found)) - 8) < 0.5
    expect = subspace.corr_from_occupancy(
        subspace.occupancy_from_structure(structure, scmatrix=scm, encode=True), scm)
    np.testing.assert_allclose(subspace.corr_from_structure(distorted), expect,
                               rtol=0, atol=1e-10)


def test_subspace_matching_equals_reference():
    """Without a supercell matrix or a site mapping the port's subspace finds
    the reference's matrix and occupancy, and the same correlations, for a
    rotated, rattled spinel and a strained fcc supercell."""
    for prim, cutoffs, scm, distortion in (
        (spinel_prim(), {2: 4.0}, np.eye(3, dtype=int),
         dict(rotate=_rotation([1, 1, 0], 0.5), rattle=0.04, seed=9)),
        (fcc_binary_prim(), {2: 4.0, 3: 3.0}, [[1, 1, 0], [0, 2, 0], [0, 0, 2]],
         dict(strain=np.diag([0.01, 0.0, -0.01]), translate=[0.1, 0.2, 0.3])),
    ):
        subspace, structure = _ordered(prim, cutoffs, np.asarray(scm), seed=3)
        ref = RefSubspace.from_cutoffs(_reference(prim), cutoffs)
        distorted = _distort(structure, **distortion)
        ref_distorted = _reference(distorted)
        np.testing.assert_array_equal(subspace.scmatrix_from_structure(distorted),
                                      ref.scmatrix_from_structure(ref_distorted))
        np.testing.assert_array_equal(
            subspace.occupancy_from_structure(distorted, encode=True),
            ref.occupancy_from_structure(ref_distorted, encode=True))
        mine = subspace.corr_from_structure(distorted)
        theirs = ref.corr_from_structure(ref_distorted)
        assert float(np.abs(mine - theirs).max()) <= 1e-12 * max(1.0, np.abs(theirs).max())
        refined = subspace.refine_structure(distorted)
        np.testing.assert_allclose(refined.frac_coords,
                                   ref.refine_structure(ref_distorted).frac_coords,
                                   rtol=0, atol=1e-12)


def test_rejections_and_fits_match_reference():
    """A wrong lattice, a site rattled past ``stol``, a rotated copy that
    fits and another ordering that does not: both matchers agree."""
    prim = fcc_binary_prim()
    bad = crystal.Structure(crystal.Lattice(np.eye(3) * 3.123), [{"Au": 1.0}], [[0, 0, 0]])
    assert StructureMatcher().get_supercell_matrix(bad, prim) is None
    assert RefMatcher().get_supercell_matrix(_reference(bad), _reference(prim)) is None
    scm = np.diag([2, 2, 2])
    subspace, structure = _ordered(prim, {2: 4.0}, scm, seed=11)
    supercell = subspace.structure.copy().make_supercell(scm)
    rattled = _distort(structure, rattle=1.5, seed=2)
    assert StructureMatcher(stol=0.2).get_mapping(supercell, rattled) is None
    assert RefMatcher(stol=0.2).get_mapping(_reference(supercell), _reference(rattled)) is None
    rotated = _distort(structure, rotate=_rotation([0, 1, 1], 1.1), seed=1)
    species = [dict(s.species) for s in structure]
    flip = next(i for i, d in enumerate(species) if any(str(k) == "Au" for k in d))
    species[flip] = {"Cu": 1.0}
    other = crystal.Structure(structure.lattice, species, structure.frac_coords)
    for s1, s2, fits in ((structure, rotated, True), (other, rotated, False)):
        assert StructureMatcher().fit(s1, s2) is fits
        assert RefMatcher().fit(_reference(s1), _reference(s2)) is fits


@pytest.mark.parametrize("size", [1, 2, 4, 8])
def test_supercell_enumeration_matches_reference(size):
    """The distinct supercell matrices of each size, in the reference's
    order, for the fcc and spinel prims' symmetry operations."""
    counts = []
    for prim in (fcc_binary_prim(), spinel_prim()):
        symops = ClusterSubspace.from_cutoffs(prim, {2: 3.0}).symops
        ref_symops = RefSubspace.from_cutoffs(_reference(prim), {2: 3.0}).symops
        mine, theirs = enumerate_supercell_matrices(size, symops), ref_enumerate(
            size, ref_symops)
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, b)
        counts.append(len(mine))
    assert size != 8 or counts[0] == 20  # bench sqs's twenty fcc shapes
