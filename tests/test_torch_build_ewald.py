"""The port builds systems with an Ewald term itself, as ``bench.py`` does.

Bench ``spinel-ewald`` (``bench.py:359-393``) builds the spinel expansion
with an Ewald term, the default processor (a cluster decomposition composed
with the Ewald term), a charge-neutral start and table flips whose flip
table the ``TableFlip`` usher derives from a ``CompositionSpace``.  Each
piece of the port is held to ``smol_tpu`` on the CPU:

- ``EwaldSummation``: the total, real, reciprocal and point matrices equal
  the reference's (whose real sums go through its native library, loaded
  by ``reference_native``, as the committed files were written) and the
  total the committed ``ewald_matrix``, to 1e-12 relative (|diff| <= 1e-12
  * max(1, max |reference|)); where numpy's matrix products round as they
  did when the files were written they are equal bit for bit, because the
  port's host library writes out the two fused multiply-adds that the
  reference's build contracts (``scripts/ewald_host_terms.py`` finds the
  steps where two hosts round otherwise);
- the golden LNO expansion with an Ewald term: the port's correlation
  vectors of the 27 structures against smol's stored ones (the cluster
  columns to 1e-10 after the tied-orbit permutation, the Ewald column to
  1e-10 relative, smol's pymatgen Ewald sum), as ``smol_tpu``'s own golden
  test holds its own;
- ``build_system`` reproduces every array of the four Ewald files, the two
  small table files and ``torch_spinel_ewald_cd_sgc_2x2x2.npz``, the usher's
  keys included: integers exactly, f64 to 1e-12 relative;
- ``CompositionSpace`` (through the ``TableFlip`` usher that derives it):
  the flip table, basis, constraint system, vertices and base solutions
  equal the reference's, with the basis optimised and the table made
  ergodic, and its dict round-trips;
- ``generate_random_ordered_occupancy`` in its three modes equals the
  reference's from one seed, the charge-neutral one the committed
  ``initial_occupancy``;
- the decomposition + Ewald features are within 1e-12 relative of
  ``smol_tpu``'s composite;
- the table-flip twin on the system built here, with the flip table its
  usher derives, against the interpret-mode reference chain, occupancy for
  occupancy (``test_torch_tableflip._trajectory_parity``'s rule), with
  parity (e) < 1e-9 and the net charge kept.
"""

import functools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from smol_tpu_torch.benchmarks.systems import random_expansion, spinel_prim
from smol_tpu_torch.capp.generate.random import generate_random_ordered_occupancy
from smol_tpu_torch.cofe import ClusterSubspace
from smol_tpu_torch.cofe.extern import EwaldTerm
from smol_tpu_torch.crystal.ewald import EwaldSummation
from smol_tpu_torch.crystal.pmg_compat import decode_pmg, load_pmg_json
from smol_tpu_torch.moca.composition import CompositionSpace
from smol_tpu_torch.moca.ensemble import Ensemble as TorchEnsemble
from smol_tpu_torch.moca.kernel.tableflip import TableFlip as TorchTableFlip
from smol_tpu_torch.system import build_system, load_system

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from export_torch_systems import (  # noqa: E402
    BENCH_MUS,
    data_path,
    limn_tiny_ensemble,
    lmof_ensemble,
    reference_native,
)
from test_torch_build import _limn_tiny, _lmof  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
REL_TOL = 1e-12
SCRIPT_KEYS = ("initial_occupancy",)
LMOF_MUS = {"Li+": 0.1, "Mn3+": -0.2, "vacA0+": 0.0, "O2-": 0.0, "F-": 0.05}
LIMN_MUS = {"Li+": 0.08, "vacA0+": 0.0, "Mn3+": 0.0, "Mn4+": -0.03}


@functools.lru_cache(maxsize=None)
def _spinel_ewald():
    return random_expansion(spinel_prim(), {2: 5.3, 3: 3.7}, seed=11, ewald=True)


def _close(mine, theirs, tol=REL_TOL):
    """The largest |diff| of two f64 arrays, asserted within ``tol`` of
    max(1, max |theirs|)."""
    diff = float(np.abs(np.asarray(mine) - np.asarray(theirs)).max(initial=0.0))
    assert diff <= tol * max(1.0, float(np.abs(theirs).max(initial=0.0))), diff
    return diff


@functools.lru_cache(maxsize=None)
def _reference_spinel(cell, processor_type="decomposition"):
    """The reference's bench spinel CE + Ewald ensemble on ``cell``, with the
    bench chemical potentials (built once)."""
    from smol_tpu.benchmarks.systems import random_expansion as ref_expansion
    from smol_tpu.benchmarks.systems import spinel_prim as ref_prim
    from smol_tpu.moca import Ensemble

    reference_native()  # the Ewald sums the committed files hold
    ce = ref_expansion(ref_prim(), {2: 5.3, 3: 3.7}, seed=11, ewald=True)
    return Ensemble.from_cluster_expansion(ce, np.diag(cell), processor_type=processor_type,
                                           chemical_potentials=BENCH_MUS)


# ---------------- EwaldSummation ----------------

@pytest.mark.parametrize("use_term", EwaldTerm.ewald_term_options)
@pytest.mark.parametrize("n", [1, 2])
def test_ewald_summation_terms_equal_reference(use_term, n):
    from smol_tpu.cofe.extern import EwaldTerm as RefEwaldTerm
    from smol_tpu.crystal.ewald import EwaldSummation as RefEwaldSummation

    ref = _reference_spinel((n, n, n))
    ref_structure = ref.processor.processors[1]._ewald_structure
    theirs = RefEwaldTerm(use_term=use_term).get_ewald_matrix(
        RefEwaldSummation(ref_structure))
    ce = _spinel_ewald()
    supercell = ce.cluster_subspace.structure.copy().make_supercell(np.diag([n] * 3))
    structure, inds = EwaldTerm.get_ewald_structure(supercell)
    np.testing.assert_array_equal(inds, ref.processor.processors[1]._ewald_inds)
    summation = EwaldSummation(structure)
    mine = EwaldTerm(use_term=use_term).get_ewald_matrix(summation)
    assert mine.dtype == np.float64 and mine.shape == theirs.shape
    _close(mine, theirs)
    if use_term == "total":  # the committed matrix and the sum of the terms
        _close(mine, load_system(data_path(f"spinel_ewald_{n}x{n}x{n}"))["ewald_matrix"]
               if n == 2 else theirs)
        parts = summation.real_space_energy_matrix + summation.reciprocal_space_energy_matrix
        parts[np.diag_indices_from(parts)] += summation.point_energy_matrix
        np.testing.assert_array_equal(mine, parts)


def test_golden_ewald_correlations_match_smol():
    """The golden LNO expansion with an Ewald term (smol's stored vectors)."""
    from itertools import permutations

    golden = json.loads((DATA / "golden_lno_ce_ewald.json").read_text())
    built = golden["construction"]
    assert built["ewald"]
    subspace = ClusterSubspace.from_cutoffs(
        load_pmg_json(str(DATA / "lno_prim.json")),
        {int(k): v for k, v in built["cutoffs"].items()}, basis=built["basis"])
    subspace.add_external_term(EwaldTerm())
    mine = np.array([subspace.corr_from_structure(
        decode_pmg(e["structure"]), scmatrix=np.asarray(e["supercell_matrix"]),
        site_mapping=[int(x) for x in e["site_mapping"]]) for e in golden["entries"]])
    stored = np.array([e["correlations"] for e in golden["entries"]], dtype=np.float64)
    assert mine.shape == stored.shape == (27, subspace.num_corr_functions + 1)
    groups = {}
    for orbit in subspace.orbits:
        key = (orbit.num_sites, round(orbit.base_cluster.diameter, 6), orbit.multiplicity,
               len(orbit.bit_combos))
        groups.setdefault(key, []).append(range(orbit.bit_id, orbit.bit_id + len(orbit)))
    perm = np.arange(subspace.num_corr_functions)
    for blocks in (g for g in groups.values() if len(g) > 1):
        cols = np.concatenate(blocks)
        best = min(permutations(blocks), key=lambda order: np.abs(
            mine[:, np.concatenate(order)] - stored[:, cols]).max())
        perm[cols] = np.concatenate(best)
    assert np.abs(mine[:, perm] - stored[:, :-1]).max() < 1e-10
    rel = np.abs(mine[:, -1] - stored[:, -1]) / np.maximum(1.0, np.abs(stored[:, -1]))
    assert rel.max() < 1e-10, rel.max()


# ---------------- build_system ----------------

# file stem -> (expansion, supercell diagonal, processor type, chemical
# potentials, table flips), as scripts/export_torch_systems.py builds each
BUILDS = {
    "spinel_ewald_2x2x2": (_spinel_ewald, 2, "expansion", None, False),
    "spinel_ewald_3x3x3": (_spinel_ewald, 3, "expansion", None, False),
    "spinel_ewald_sgc_2x2x2": (_spinel_ewald, 2, "expansion", BENCH_MUS, True),
    "spinel_ewald_sgc_3x3x3": (_spinel_ewald, 3, "expansion", BENCH_MUS, True),
    "spinel_ewald_cd_sgc_2x2x2": (_spinel_ewald, 2, "decomposition", BENCH_MUS, True),
    "lmof_2x2x2": (_lmof, 2, "expansion", LMOF_MUS, True),
    "limn_tiny_2x1x1": (_limn_tiny, (2, 1, 1), "expansion", LIMN_MUS, True),
}


@pytest.mark.parametrize("stem", sorted(BUILDS))
def test_build_reproduces_committed_file_with_usher_keys(stem):
    make, n, kind, mus, table = BUILDS[stem]
    built = build_system(make(), np.diag(np.broadcast_to(n, 3)), processor_type=kind,
                         chemical_potentials=mus, table_flip=table)
    stored = load_system(data_path(stem))
    assert sorted(built) == sorted(k for k in stored if k not in SCRIPT_KEYS)
    assert ("flip_table" in stored) == table
    assert ("ewald_matrix" in stored) == stem.startswith("spinel_ewald")
    for key in built:
        mine, theirs = np.asarray(built[key]), np.asarray(stored[key])
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape, key
        if theirs.dtype.kind == "f":
            _close(mine, theirs)
        else:
            np.testing.assert_array_equal(mine, theirs, err_msg=key)


def test_from_cluster_expansion_builds_bench_spinel_ewald():
    """The ensemble bench ``spinel-ewald`` builds: the decomposition
    composed with the Ewald term, its natural parameters the orbit
    multiplicities, the Ewald coefficient and -1, its sublattices' species
    and site charges."""
    stored = load_system(data_path("spinel_ewald_cd_sgc_2x2x2"))
    port = TorchEnsemble.from_cluster_expansion(
        _spinel_ewald(), np.diag([2, 2, 2]), chemical_potentials=BENCH_MUS, device="cpu")
    assert [type(p).__name__ for p in port.processor.processors] == [
        "ClusterDecompositionProcessor", "EwaldProcessor"]
    np.testing.assert_array_equal(port.natural_parameters, stored["natural_parameters"])
    np.testing.assert_array_equal(port.site_charges, stored["site_charges"])
    assert port.table_data is None  # the usher derives its table
    assert [str(sp) for sl in port.sublattices for sp in sl.species] == [
        "Li+", "vacA", "Mn3+", "Mn4+", "O2-"]
    subs = port.processor.get_sublattices()
    assert subs is not port.sublattices and [len(s.sites) for s in subs] == [16, 32, 64]


# ---------------- CompositionSpace ----------------

def _reference_systems():
    """(name, reference sublattices, port sublattices) of the table systems."""
    ref_spinel = _reference_spinel((1, 1, 1))
    port_spinel = TorchEnsemble.from_cluster_expansion(
        _spinel_ewald(), np.diag([1, 1, 1]), chemical_potentials=BENCH_MUS, device="cpu")
    port_lmof = TorchEnsemble.from_cluster_expansion(
        _lmof(), np.diag([2, 1, 1]), processor_type="expansion",
        chemical_potentials=LMOF_MUS, device="cpu")
    port_limn = TorchEnsemble.from_cluster_expansion(
        _limn_tiny(), np.diag([2, 1, 1]), processor_type="expansion",
        chemical_potentials=LIMN_MUS, device="cpu")
    return {
        "spinel": (ref_spinel.sublattices, port_spinel.sublattices),
        "lmof": (lmof_ensemble((2, 1, 1)).sublattices, port_lmof.sublattices),
        "limn_tiny": (limn_tiny_ensemble().sublattices, port_limn.sublattices),
    }


_SYSTEMS = {}


def _sublattices(name):
    if not _SYSTEMS:
        _SYSTEMS.update(_reference_systems())
    return _SYSTEMS[name]


OPTIONS = {
    "default": {},
    "optimize_basis": {"optimize_basis": True},
    "table_ergodic": {"table_ergodic": True},
    "not_charge_balanced": {"charge_balanced": False},
}


@pytest.mark.parametrize("options", sorted(OPTIONS))
@pytest.mark.parametrize("name", ["limn_tiny", "lmof", "spinel"])
def test_composition_space_equals_reference(name, options):
    from smol_tpu.moca.kernel.tableflip import TableFlip

    ref_subs, port_subs = _sublattices(name)
    theirs = TableFlip(ref_subs, **OPTIONS[options])
    mine = TorchTableFlip(port_subs, **OPTIONS[options])
    np.testing.assert_array_equal(mine.flip_table, theirs.flip_table)
    assert mine.flip_table.dtype == np.int64
    assert [list(ids) for ids in mine.dim_ids] == [list(ids) for ids in theirs.dim_ids]
    a, b = mine._comp_space, theirs._comp_space
    assert a.sublattice_sizes == b.sublattice_sizes
    assert [[str(sp) for sp in sl] for sl in a.site_spaces] == [
        [str(sp) for sp in sl] for sl in b.site_spaces]
    assert [str(sp) for sp in a.species] == [str(sp) for sp in b.species]
    assert a.species_ids == b.species_ids
    np.testing.assert_array_equal(a._A, b._A)
    np.testing.assert_array_equal(a._b, b._b)
    np.testing.assert_array_equal(a.basis, b.basis)
    np.testing.assert_array_equal(a.prim_vertices, b.prim_vertices)
    assert a.min_supercell_size == b.min_supercell_size
    np.testing.assert_array_equal(a.get_supercell_base_solution(), b.get_supercell_base_solution())
    np.testing.assert_array_equal(a.min_supercell_grid, b.min_supercell_grid)
    np.testing.assert_array_equal(a.get_centroid_composition(), b.get_centroid_composition())
    assert a.flip_reactions == b.flip_reactions
    # the dict round-trips, and names the reference's fields
    again = CompositionSpace.from_dict(json.loads(json.dumps(a.as_dict())))
    np.testing.assert_array_equal(again.flip_table, a.flip_table)
    np.testing.assert_array_equal(again.basis, a.basis)
    assert again.min_supercell_size == a.min_supercell_size
    mine_d, theirs_d = a.as_dict(), b.as_dict()
    assert sorted(mine_d) == sorted(theirs_d)
    for key in ("sublattice_sizes", "charge_neutral", "optimize_basis", "table_ergodic",
                "min_supercell_size", "n0", "vs", "flip_table", "other_constraints"):
        assert mine_d[key] == theirs_d[key], key


def test_composition_space_other_constraints_equal_reference():
    """A user constraint, as a string and as a vector."""
    from smol_tpu.moca.kernel.tableflip import TableFlip

    ref_subs, port_subs = _sublattices("lmof")
    for constraint in (["F- <= 0.5"], [([0, 0, 0, 0, 1], 0.5, "leq")]):
        theirs = TableFlip(ref_subs, other_constraints=constraint)
        mine = TorchTableFlip(port_subs, other_constraints=constraint)
        np.testing.assert_array_equal(mine.flip_table, theirs.flip_table)
        a, b = mine._comp_space, theirs._comp_space
        np.testing.assert_array_equal(a._A_leq, b._A_leq)
        np.testing.assert_array_equal(a._b_leq, b._b_leq)
        np.testing.assert_array_equal(a.min_supercell_grid, b.min_supercell_grid)


# ---------------- random occupancies ----------------

@pytest.fixture(scope="module")
def spinel_pair():
    """(reference ensemble, port ensemble) of bench ``spinel-ewald`` 2x2x2."""
    ref = _reference_spinel((2, 2, 2))
    port = TorchEnsemble.from_cluster_expansion(
        _spinel_ewald(), np.diag([2, 2, 2]), chemical_potentials=BENCH_MUS, device="cpu")
    return ref, port


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("mode", ["unconstrained", "charge_neutral", "composition"])
def test_random_occupancy_modes_equal_reference(spinel_pair, mode, seed):
    from smol_tpu.capp.generate.random import (
        generate_random_ordered_occupancy as ref_generate,
    )
    from smol_tpu.crystal.species import Composition as RefComposition
    from smol_tpu_torch.crystal.species import Composition

    ref, port = spinel_pair
    kwargs = {"unconstrained": {}, "charge_neutral": {"charge_neutral": True}}.get(mode)
    mine_kwargs = theirs_kwargs = kwargs
    if mode == "composition":
        fractions = [{"Li+": 0.25}, {"Mn3+": 0.5, "Mn4+": 0.5}, {"O2-": 1.0}]
        theirs_kwargs = {"composition": [RefComposition(f) for f in fractions]}
        mine_kwargs = {"composition": [Composition(f) for f in fractions]}
    theirs = ref_generate(ref.processor, rng=np.random.default_rng(seed), **theirs_kwargs)
    mine = generate_random_ordered_occupancy(port.processor, rng=np.random.default_rng(seed),
                                             **mine_kwargs)
    assert mine.dtype == theirs.dtype == np.int32
    np.testing.assert_array_equal(mine, theirs)
    species = generate_random_ordered_occupancy(
        port.processor, rng=np.random.default_rng(seed), encoded=False, **mine_kwargs)
    assert [str(sp) for sp in species] == [str(sp) for sp in ref.processor.decode_occupancy(theirs)]
    net = port.site_charges[np.arange(port.num_sites), mine].sum()
    if mode == "charge_neutral":
        assert net == 0
        if seed == 0:  # the bench's start, as the committed files hold it
            for stem in ("spinel_ewald_sgc_2x2x2", "spinel_ewald_cd_sgc_2x2x2"):
                np.testing.assert_array_equal(
                    mine, load_system(data_path(stem))["initial_occupancy"])
    if mode == "composition":  # 4 Li+ of 16 sites, half the Mn each
        counts = [np.bincount(mine[sl.sites], minlength=len(sl.encoding)).tolist()
                  for sl in port.sublattices]
        assert counts == [[4, 12], [16, 16], [64]]


def test_random_occupancy_refusals():
    stored = TorchEnsemble.from_system(load_system(data_path("spinel_ewald_2x2x2")), "cpu")
    with pytest.raises(ValueError, match="no species"):  # a file's sublattices
        generate_random_ordered_occupancy(stored.processor, charge_neutral=True, rng=0)
    port = TorchEnsemble.from_cluster_expansion(
        _spinel_ewald(), np.diag([1, 1, 1]), chemical_potentials=BENCH_MUS, device="cpu")
    from smol_tpu_torch.crystal.species import Composition

    with pytest.raises(ValueError, match="not compatible"):
        generate_random_ordered_occupancy(port.processor, rng=0, composition=[
            Composition(c) for c in ({"Li+": 0.3}, {"Mn3+": 0.5}, {"O2-": 1.0})])
    with pytest.raises(TimeoutError):
        generate_random_ordered_occupancy(port.processor, charge_neutral=True, rng=0,
                                          num_attempts=0)


# ---------------- features ----------------

@pytest.mark.parametrize("kind", ["decomposition", "expansion"])
def test_ewald_composite_features_equal_reference(spinel_pair, kind):
    ref, port = spinel_pair
    if kind == "expansion":
        ref = _reference_spinel((2, 2, 2), processor_type="expansion")
        port = TorchEnsemble.from_cluster_expansion(
            _spinel_ewald(), np.diag([2, 2, 2]), processor_type="expansion",
            chemical_potentials=BENCH_MUS, device="cpu")
    np.testing.assert_array_equal(port.natural_parameters, ref.natural_parameters)
    occs = np.stack([generate_random_ordered_occupancy(
        port.processor, charge_neutral=True, rng=np.random.default_rng(s)) for s in range(6)]
        + [generate_random_ordered_occupancy(port.processor, rng=np.random.default_rng(s))
           for s in range(6)])
    mine = port.compute_features(torch.as_tensor(occs)).numpy()
    theirs = np.array([ref.compute_feature_vector(o) for o in occs])
    assert mine.shape == theirs.shape
    _close(mine, theirs)


# ---------------- the table-flip twin on the built system ----------------

@pytest.mark.parametrize("cell,W,n_steps", [((1, 1, 1), 64, 400), ((2, 2, 2), 8, 150)],
                         ids=["1x1x1", "2x2x2"])
def test_built_table_twin_matches_interpret_reference(cell, W, n_steps, monkeypatch):
    """(c) on bench ``spinel-ewald`` built by the port (the decomposition
    composed with the Ewald term, the usher's derived flip table) against
    the interpret-mode reference chain on the reference's build."""
    from smol_tpu.moca.kernel.tableflip import TableFlip
    from test_torch_tableflip import _trajectory_parity

    ref = _reference_spinel(cell)
    port = TorchEnsemble.from_cluster_expansion(
        _spinel_ewald(), np.diag(cell), chemical_potentials=BENCH_MUS, device="cpu")
    assert port.table_data is None
    slack, n_chunks, nacc = _trajectory_parity(
        "spinel_ewald_cd", cell, W, n_steps, 1000.0, 0, monkeypatch,
        systems=(ref, TableFlip(ref.sublattices), port))
    assert 0.0 < slack < 1e-4 and n_chunks == 1 and nacc.max() > 0


def test_restricting_and_splitting_sites_name_their_item(spinel_pair):
    """Restricting and splitting the built spinel's sublattices, as the
    reference's (held to smol_tpu's in ``tests/test_torch_restricted.py``)."""
    ref, port = spinel_pair
    sublattice = port.processor.get_sublattices()[0]
    theirs = ref.processor.get_sublattices()[0]
    for sl in (sublattice, theirs):
        sl.restrict_sites(sublattice.sites[:2])
    np.testing.assert_array_equal(sublattice.active_sites, theirs.active_sites)
    assert len(sublattice.restricted_sites) == 2
    occu = np.zeros(port.num_sites, dtype=int)
    occu[sublattice.sites[::2]] = 1
    parts = sublattice.split_by_species(occu, [[0], [1]])
    for mine, other in zip(parts, theirs.split_by_species(occu, [[0], [1]])):
        np.testing.assert_array_equal(mine.sites, other.sites)
        np.testing.assert_array_equal(mine.active_sites, other.active_sites)
        np.testing.assert_array_equal(mine.encoding, other.encoding)
        assert not mine.is_active  # a part of one species is frozen whole
