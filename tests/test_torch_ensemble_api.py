"""The port's ensemble host API against smol_tpu's: the chemical-potential
setter, the reference's constructor and properties, and serialization.

Setting ``ensemble.chemical_potentials`` (the reference's
``ChemicalPotentialManager``) must validate and map the dict as the
reference does, raise its ``ValueError`` for a dict that lacks a species,
build the same per-(site, code) table (host copy and the device copy the
features and chains read) and append the same -1 natural parameter; setting
``None`` undoes it; a sampler built after the set takes flips, after the
reset swaps (``tests/test_api_parity.py:151-163``).  An ensemble's
``as_dict`` JSON loads into the other package, with and without chemical
potentials, and evaluates the same features
(``tests/test_moca/test_serialization.py:41-69``).  Floats within 1e-12
relative (|diff| <= 1e-12 * max(1, max |reference|)), inputs from numpy
seeds.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from smol_tpu.serial import SmolJSONEncoder

from smol_tpu_torch.benchmarks.systems import fcc_binary_prim, random_expansion, spinel_prim
from smol_tpu_torch.cofe import ClusterExpansion, ClusterSubspace
from smol_tpu_torch.moca.ensemble import ChemicalPotentialManager, Ensemble
from smol_tpu_torch.moca.processor.expansion import ClusterDecompositionProcessor
from smol_tpu_torch.moca.sampler.sampler import Sampler
from smol_tpu_torch.serial import SmolJSONEncoder as PortEncoder
from smol_tpu_torch.system import build_system, load_system

REL_TOL = 1e-12
FCC_MUS = {"Au": 0.1, "Cu": -0.3}
SPINEL_MUS = {"Li+": 0.1, "vacA0+": 0.0, "Mn3+": 0.05, "Mn4+": 0.0}  # bench spinel's


def _close(mine, theirs):
    mine, theirs = np.asarray(mine, dtype=np.float64), np.asarray(theirs, dtype=np.float64)
    assert mine.shape == theirs.shape
    diff = float(np.abs(mine - theirs).max(initial=0.0))
    assert diff <= REL_TOL * max(1.0, float(np.abs(theirs).max(initial=0.0))), diff


def _fcc_expansions():
    """(port, reference) fcc Au-Cu expansions of the reference's
    serialization tests: pairs to 4.2, normal coefficients from seed 11."""
    import smol_tpu.benchmarks.systems as ref_systems
    from smol_tpu.cofe import ClusterExpansion as RefExpansion
    from smol_tpu.cofe import ClusterSubspace as RefSubspace

    out = []
    for expansion, subspace, prim in (
            (ClusterExpansion, ClusterSubspace, fcc_binary_prim()),
            (RefExpansion, RefSubspace, ref_systems.fcc_binary_prim())):
        cs = subspace.from_cutoffs(prim, {2: 4.2})
        coefs = np.random.default_rng(11).normal(scale=0.02, size=cs.num_corr_functions)
        coefs[0] = -1.0
        out.append(expansion(cs, coefs))
    return out


@pytest.fixture()
def fcc():
    """(port, reference) ensembles of the fcc expansion on 2x2x2."""
    from smol_tpu.moca import Ensemble as RefEnsemble

    mine, theirs = _fcc_expansions()
    return (Ensemble.from_cluster_expansion(mine, np.diag([2, 2, 2]), device="cpu"),
            RefEnsemble.from_cluster_expansion(theirs, np.diag([2, 2, 2])))


@pytest.fixture(scope="module")
def spinel():
    """(port, reference) bench spinel CE ensembles on 2x2x2, canonical, and the
    port's expansion."""
    import smol_tpu.benchmarks.systems as ref_systems
    from smol_tpu.moca import Ensemble as RefEnsemble

    ce = random_expansion(spinel_prim(), {2: 5.3, 3: 3.7}, seed=11)
    ref_ce = ref_systems.random_expansion(ref_systems.spinel_prim(), {2: 5.3, 3: 3.7},
                                          seed=11)
    return (Ensemble.from_cluster_expansion(ce, np.diag([2, 2, 2]), device="cpu"),
            RefEnsemble.from_cluster_expansion(ref_ce, np.diag([2, 2, 2])), ce)


def _occupancies(ensemble, count, seed):
    codes = np.ones(ensemble.num_sites, dtype=np.int64)
    for sl in ensemble.sublattices:
        codes[sl.sites] = len(sl.encoding)
    rng = np.random.default_rng(seed)
    return (rng.random((count, ensemble.num_sites)) * codes).astype(np.int32)


def test_chemical_potential_setter_matches_reference(fcc):
    """The set, the reset to None and the missing-species ValueError, as
    the reference's own API test runs them, beside the reference."""
    mine, theirs = fcc
    assert isinstance(type(mine).chemical_potentials, ChemicalPotentialManager)
    n_coefs = len(mine.natural_parameters)
    for ensemble in (mine, theirs):
        ensemble.chemical_potentials = {"Au": 0.1, "Cu": -0.1}
    assert len(mine.natural_parameters) == n_coefs + 1
    assert mine.natural_parameters[-1] == -1.0
    np.testing.assert_array_equal(mine.natural_parameters, theirs.natural_parameters)
    table = mine.chemical_potential_table
    assert table.shape[0] == mine.num_sites
    np.testing.assert_array_equal(table, theirs.chemical_potential_table)
    assert mine.thermo_boundaries == theirs.thermo_boundaries
    assert {str(k): v for k, v in mine.chemical_potentials.items()} == \
        {str(k): v for k, v in theirs.chemical_potentials.items()}
    occupancy = _occupancies(mine, 1, seed=0)[0]
    _close(mine.compute_feature_vector(occupancy), theirs.compute_feature_vector(occupancy))
    for ensemble in (mine, theirs):
        ensemble.chemical_potentials = None
    assert len(mine.natural_parameters) == n_coefs
    assert mine.chemical_potential_table is None and mine.chemical_potentials is None
    assert mine.thermo_boundaries == theirs.thermo_boundaries == {}
    assert len(mine.compute_feature_vector(occupancy)) == n_coefs
    for ensemble in (mine, theirs):
        with pytest.raises(ValueError, match="missing species"):
            ensemble.chemical_potentials = {"Au": 0.1}  # missing Cu


def test_spinel_setter_builds_the_bench_table(spinel):
    """On the bench spinel a dict without every species raises, and the
    bench's chemical potentials, set after the build, give the table and
    natural parameters that passing them to the build gives, bit for bit,
    and the reference's."""
    mine, theirs, ce = spinel
    with pytest.raises(ValueError, match="missing species"):
        mine.chemical_potentials = {"Li+": 0.1}
    assert mine.chemical_potential_table is None
    mine.chemical_potentials = SPINEL_MUS
    theirs.chemical_potentials = SPINEL_MUS
    try:
        built = build_system(ce, np.diag([2, 2, 2]), chemical_potentials=SPINEL_MUS)
        np.testing.assert_array_equal(mine.chemical_potential_table,
                                      built["chemical_potential_table"])
        np.testing.assert_array_equal(mine.natural_parameters, built["natural_parameters"])
        np.testing.assert_array_equal(mine.chemical_potential_table,
                                      theirs.chemical_potential_table)
        np.testing.assert_array_equal(mine.natural_parameters, theirs.natural_parameters)
        rng = np.random.default_rng(4)
        for occupancy in _occupancies(mine, 2, seed=1):
            _close(mine.compute_feature_vector(occupancy),
                   theirs.compute_feature_vector(occupancy))
            active = np.concatenate([sl.active_sites for sl in mine.active_sublattices])
            step = []
            for site in rng.choice(active, size=2, replace=False):
                codes = len(mine.processor.allowed_species[site])
                step.append((int(site), int((occupancy[site] + 1) % codes)))
            _close(mine.compute_feature_vector_change(occupancy, step),
                   theirs.compute_feature_vector_change(occupancy, step))
    finally:
        mine.chemical_potentials = theirs.chemical_potentials = None


def test_sampler_move_follows_the_setter(fcc):
    """Semigrand flips after the set, canonical swaps after the reset."""
    mine, _ = fcc
    assert Sampler.from_ensemble(mine, 1000.0, nwalkers=4, seed=1, device="cpu") \
        .execution_path().startswith("cpu-twin[swap]")
    mine.chemical_potentials = FCC_MUS
    sampler = Sampler.from_ensemble(mine, 1000.0, nwalkers=4, seed=1, device="cpu")
    assert sampler.execution_path().startswith("cpu-twin[flip]")
    sampler.run(20, _occupancies(mine, 4, seed=2), thin_by=10)
    samples = sampler.samples
    feats = samples.get_feature_vectors()
    assert feats.shape[1] == len(mine.natural_parameters)
    assert float(np.abs(feats @ mine.natural_parameters - samples.get_enthalpies()).max()) < 1e-9
    mine.chemical_potentials = None
    assert Sampler.from_ensemble(mine, 1000.0, nwalkers=4, seed=1, device="cpu") \
        .execution_path().startswith("cpu-twin[swap]")


def _renamed(doc, old, new):
    if isinstance(doc, dict):
        doc = {k: _renamed(v, old, new) for k, v in doc.items()}
        module = doc.get("@module")
        if isinstance(module, str) and (module == old or module.startswith(old + ".")):
            doc["@module"] = new + module[len(old):]
        return doc
    if isinstance(doc, list):
        return [_renamed(v, old, new) for v in doc]
    return doc


@pytest.mark.parametrize("mus", [None, FCC_MUS])
def test_ensemble_json_round_trips_both_ways(fcc, mus):
    """The port's JSON into the port, the reference's into the port, and the
    port's (its modules named as the reference's) into the reference."""
    from smol_tpu.moca import Ensemble as RefEnsemble

    mine, theirs = fcc
    if mus is not None:
        mine.chemical_potentials = theirs.chemical_potentials = mus
    port_doc = json.loads(json.dumps(mine.as_dict(), cls=PortEncoder))
    ref_doc = json.loads(json.dumps(theirs.as_dict(), cls=SmolJSONEncoder))
    again = Ensemble.from_dict(port_doc, device="cpu")
    from_ref = Ensemble.from_dict(ref_doc, device="cpu")
    back = RefEnsemble.from_dict(_renamed(port_doc, "smol_tpu_torch", "smol_tpu"))
    assert isinstance(back, RefEnsemble) and type(back.processor) is type(theirs.processor)
    for ensemble in (again, from_ref):
        assert isinstance(ensemble.processor, ClusterDecompositionProcessor)
        assert (ensemble.chemical_potentials is None) == (mus is None)
        np.testing.assert_array_equal(ensemble.natural_parameters, mine.natural_parameters)
        assert ensemble.thermo_boundaries == mine.thermo_boundaries
    np.testing.assert_array_equal(back.natural_parameters, theirs.natural_parameters)
    for occupancy in _occupancies(mine, 2, seed=3):
        expect = theirs.compute_feature_vector(occupancy)
        np.testing.assert_array_equal(again.compute_feature_vector(occupancy),
                                      mine.compute_feature_vector(occupancy))
        _close(from_ref.compute_feature_vector(occupancy), expect)
        _close(back.compute_feature_vector(occupancy), expect)


def test_reference_properties_and_refusals(spinel):
    """``system_size``, ``active_sublattices``, ``restricted_sites`` and
    ``species`` as the reference's; so are other sublattices than the
    processor's defaults, in the constructor and through
    ``from_cluster_expansion``, and restricting sites."""
    mine, theirs, ce = spinel
    assert mine.system_size == theirs.system_size == 8
    assert len(mine.active_sublattices) == len(theirs.active_sublattices)
    for sl, ref_sl in zip(mine.active_sublattices, theirs.active_sublattices):
        np.testing.assert_array_equal(sl.sites, ref_sl.sites)
    np.testing.assert_array_equal(mine.restricted_sites, theirs.restricted_sites)
    assert sorted(map(str, mine.species)) == sorted(map(str, theirs.species))
    assert mine.num_energy_coefs == theirs.num_energy_coefs
    from smol_tpu.moca import Ensemble as RefEnsemble

    subset = Ensemble(mine.processor, mine.sublattices[:1])
    ref_subset = RefEnsemble(theirs.processor, theirs.sublattices[:1])
    assert len(subset.sublattices) == len(ref_subset.sublattices) == 1
    np.testing.assert_array_equal(subset.sublattices[0].sites, ref_subset.sublattices[0].sites)
    built = Ensemble.from_cluster_expansion(ce, np.diag([2, 2, 2]), device="cpu",
                                            sublattices=mine.sublattices[1:])
    assert built.sublattices == mine.sublattices[1:]
    pinned = [int(mine.active_sublattices[0].sites[0])]
    for ensemble in (mine, theirs):
        ensemble.restrict_sites(pinned)
    np.testing.assert_array_equal(mine.restricted_sites, theirs.restricted_sites)
    assert pinned[0] in mine.restricted_sites
    for ensemble in (mine, theirs):
        ensemble.reset_restricted_sites()
    np.testing.assert_array_equal(mine.restricted_sites, theirs.restricted_sites)


def test_file_ensemble_keeps_its_table_and_refuses_species():
    """An ensemble loaded from a semigrand system file carries the file's
    table and the -1 natural parameter but no species: reading its chemical
    potentials or setting new ones raises ``ValueError`` (so it is never
    read as canonical), and setting ``None`` makes it canonical."""
    system = load_system(Path(__file__).resolve().parent / "data" / "torch_spinel_2x2x2.npz")
    ensemble = Ensemble.from_system(system, "cpu")
    table = ensemble.chemical_potential_table
    np.testing.assert_array_equal(table, system["chemical_potential_table"])
    np.testing.assert_array_equal(ensemble.natural_parameters, system["natural_parameters"])
    assert ensemble.natural_parameters[-1] == -1.0
    with pytest.raises(ValueError, match="system file"):
        ensemble.chemical_potentials
    with pytest.raises(ValueError, match="carries no species"):
        ensemble.species
    with pytest.raises(ValueError, match="system file"):
        ensemble.chemical_potentials = SPINEL_MUS
    np.testing.assert_array_equal(ensemble.chemical_potential_table, table)
    np.testing.assert_array_equal(ensemble.natural_parameters, system["natural_parameters"])
    assert Sampler.from_ensemble(ensemble, 1000.0, nwalkers=2, device="cpu") \
        .execution_path().startswith("cpu-twin[flip]")
    ensemble.chemical_potentials = None
    assert ensemble.chemical_potentials is None and ensemble.chemical_potential_table is None
    np.testing.assert_array_equal(ensemble.natural_parameters,
                                  system["natural_parameters"][:-1])
    assert Sampler.from_ensemble(ensemble, 1000.0, nwalkers=2, device="cpu") \
        .execution_path().startswith("cpu-twin[swap]")
