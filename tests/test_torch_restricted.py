"""Restricted and split sublattices in the port, against smol_tpu's.

- ``Sublattice.restrict_sites``, ``reset_restricted_sites`` and
  ``split_by_species`` (by codes and by species), and the ensemble's
  ``restrict_sites``, ``reset_restricted_sites`` and
  ``split_sublattice_by_species``, give the same sites, active sites,
  encodings and site spaces as the reference's on the same ensemble (bench
  ``spinel`` 2x2x2 and a ternary FCC), the same chemical-potential table
  after a split, and survive the JSON round trip (the port's record, and
  the reference's loaded into the port);
- ``chain.chain_refusal`` names the restriction (or the split's
  encodings), and the kernels take the per-step path (``cpu-step[...]``);
- per-step semigrand flips on the 8-site Au-Cu (``torch_aucu_nn_2x2x2.npz``)
  with 2 sites pinned never move them; their mean enthalpy is within 5
  standard errors (over walkers) of the exact Boltzmann average over the 64
  states the restriction allows, and parity (e) is below 1e-9;
- canonical swaps on a split ternary ensemble keep each part's
  composition at every record.
"""

import functools
import json
import sys
from itertools import product
from pathlib import Path

import numpy as np
import pytest
import torch

from smol_tpu.serial import SmolJSONEncoder

from smol_tpu_torch.benchmarks.systems import fcc_ternary_prim, random_expansion, spinel_prim
from smol_tpu_torch.constants import kB
from smol_tpu_torch.moca.ensemble import Ensemble
from smol_tpu_torch.moca.sampler.sampler import Sampler
from smol_tpu_torch.moca.sublattice import Sublattice
from smol_tpu_torch.ops import chain
from smol_tpu_torch.serial import SmolJSONEncoder as PortEncoder
from smol_tpu_torch.system import load_system

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from export_torch_systems import data_path  # noqa: E402

SPINEL_MUS = {"Li+": 0.1, "vacA0+": 0.0, "Mn3+": 0.05, "Mn4+": 0.0}  # bench spinel's
SE_LIMIT = 5.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module's runs: the per-step path's small
    operations run no faster on more, and far slower when the test
    workers' threads oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


EXPANSIONS = {  # kind -> (prim's name, cutoffs, seed, chemical potentials)
    "spinel": ("spinel_prim", {2: 5.3, 3: 3.7}, 11, SPINEL_MUS),
    "ternary": ("fcc_ternary_prim", {2: 5.5, 3: 4.0}, 7, {"Au": 0.05, "Ag": 0.0, "Cu": -0.05}),
}


@functools.lru_cache(maxsize=None)
def _expansion(kind):
    """The port's expansion of one kind, built once (ensembles are built
    from it anew, since the tests restrict and split their sublattices)."""
    prim, cutoffs, seed, _ = EXPANSIONS[kind]
    prims = {"spinel_prim": spinel_prim, "fcc_ternary_prim": fcc_ternary_prim}
    return random_expansion(prims[prim](), cutoffs, seed=seed)


@functools.lru_cache(maxsize=None)
def _ref_expansion(kind):
    import smol_tpu.benchmarks.systems as ref_systems

    prim, cutoffs, seed, _ = EXPANSIONS[kind]
    return ref_systems.random_expansion(getattr(ref_systems, prim)(), cutoffs, seed=seed)


def _port(kind):
    """The port's ensemble of one expansion on 2x2x2, semigrand."""
    return Ensemble.from_cluster_expansion(_expansion(kind), np.diag([2, 2, 2]),
                                           chemical_potentials=EXPANSIONS[kind][3],
                                           device="cpu")


def _pair(kind):
    """(port, reference) ensembles of one expansion on 2x2x2, semigrand."""
    from smol_tpu.moca import Ensemble as RefEnsemble

    theirs = RefEnsemble.from_cluster_expansion(_ref_expansion(kind), np.diag([2, 2, 2]),
                                                chemical_potentials=EXPANSIONS[kind][3])
    return _port(kind), theirs


def _same_sublattices(mine, theirs):
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a.sites, b.sites)
        np.testing.assert_array_equal(a.active_sites, b.active_sites)
        assert a.active_sites.dtype == np.int64
        np.testing.assert_array_equal(a.encoding, b.encoding)
        assert [str(sp) for sp in a.species] == [str(sp) for sp in b.species]
        assert [a.site_space[sp] for sp in a.species] == pytest.approx(
            [b.site_space[sp] for sp in b.species], rel=1e-12)
        assert a.is_active == b.is_active


def _random_occupancy(ensemble, seed):
    occ = np.zeros(ensemble.num_sites, dtype=np.int32)
    rng = np.random.default_rng(seed)
    for sl in ensemble.sublattices:
        occ[sl.sites] = rng.choice(sl.encoding, len(sl.sites))
    return occ


@pytest.mark.parametrize("kind", ["spinel", "ternary"])
def test_sublattice_methods_match_reference(kind):
    mine_ens, their_ens = _pair(kind)
    occ = _random_occupancy(their_ens, seed=1)
    rng = np.random.default_rng(2)
    for mine, theirs in zip(mine_ens.processor.get_sublattices(),
                            their_ens.processor.get_sublattices()):
        pinned = rng.choice(mine.sites, max(1, len(mine.sites) // 3), replace=False)
        for sl in (mine, theirs):
            sl.restrict_sites(pinned)
        _same_sublattices([mine], [theirs])
        assert len(mine.restricted_sites) == (len(pinned) if len(mine.species) > 1
                                              else len(mine.sites))
        np.testing.assert_array_equal(mine.restricted_sites, theirs.restricted_sites)
        if len(mine.species) < 2:
            continue
        # split by codes and by species, from the restricted sublattice
        codes = [list(mine.encoding[:1]), list(mine.encoding[1:])]
        _same_sublattices(mine.split_by_species(occ, codes),
                          theirs.split_by_species(occ, codes))
        by_species = [[mine.species[-1]], list(mine.species[:-1])]
        ref_species = [[theirs.species[-1]], list(theirs.species[:-1])]
        parts = mine.split_by_species(occ, by_species)
        _same_sublattices(parts, theirs.split_by_species(occ, ref_species))
        for part in parts:  # the JSON round trip, the port's and the reference's
            back = Sublattice.from_dict(json.loads(json.dumps(part.as_dict(),
                                                              cls=PortEncoder)))
            assert back == part
        their_parts = theirs.split_by_species(occ, ref_species)
        loaded = [Sublattice.from_dict(json.loads(json.dumps(p.as_dict(),
                                                             cls=SmolJSONEncoder)))
                  for p in their_parts]
        _same_sublattices(loaded, their_parts)
        for sl in (mine, theirs):
            sl.reset_restricted_sites()
        _same_sublattices([mine], [theirs])
        assert len(mine.restricted_sites) == 0


def test_ensemble_methods_match_reference():
    mine, theirs = _pair("spinel")
    occ = _random_occupancy(theirs, seed=3)
    pinned = np.concatenate([sl.sites[:2] for sl in mine.active_sublattices])
    for ens in (mine, theirs):
        ens.restrict_sites(pinned)
    _same_sublattices(mine.sublattices, theirs.sublattices)
    np.testing.assert_array_equal(np.sort(mine.restricted_sites),
                                  np.sort(theirs.restricted_sites))
    for ens in (mine, theirs):
        ens.reset_restricted_sites()
        ens.restrict_sites(pinned[:1])
    _same_sublattices(mine.sublattices, theirs.sublattices)
    # split the Li sublattice into its Li+ and its vacancy sites: both parts
    # frozen, the chemical potentials set again over the rest
    li = next(i for i, sl in enumerate(mine.sublattices) if "Li+" in map(str, sl.species))
    for ens in (mine, theirs):
        ens.split_sublattice_by_species(li, occ, [[0], [1]])
    _same_sublattices(mine.sublattices, theirs.sublattices)
    assert sorted(map(str, mine.species)) == sorted(map(str, theirs.species))
    np.testing.assert_array_equal(mine.chemical_potential_table,
                                  theirs.chemical_potential_table)
    np.testing.assert_array_equal(mine.natural_parameters, theirs.natural_parameters)
    assert mine.thermo_boundaries == theirs.thermo_boundaries
    features = mine.compute_feature_vector(occ)
    np.testing.assert_allclose(features, theirs.compute_feature_vector(occ), rtol=1e-12,
                               atol=1e-12)
    # JSON both ways: the port's record, and the reference's, into the port
    for doc, encoder in ((mine.as_dict(), PortEncoder), (theirs.as_dict(), SmolJSONEncoder)):
        back = Ensemble.from_dict(json.loads(json.dumps(doc, cls=encoder)), device="cpu")
        _same_sublattices(back.sublattices, theirs.sublattices)
        np.testing.assert_array_equal(back.chemical_potential_table,
                                      theirs.chemical_potential_table)
        np.testing.assert_array_equal(back.natural_parameters, theirs.natural_parameters)
    # any sublattices, in the constructor and from the cluster expansion
    again = Ensemble(mine.processor, mine.sublattices)
    _same_sublattices(again.sublattices, theirs.sublattices)


def test_chain_refusal_and_paths():
    nn = Ensemble.from_system(load_system(data_path("aucu_nn_2x2x2")), "cpu")
    assert chain.chain_refusal(nn.processor, nn.sublattices) is None
    nn.restrict_sites([0, 5])
    assert chain.chain_refusal(nn.processor, nn.sublattices) == \
        "sublattices with restricted sites"
    sampler = Sampler.from_ensemble(nn, 1000.0, 4, seed=1, device="cpu")
    assert not sampler.mckernel.runs_chain
    assert sampler.execution_path(10) == "cpu-step[flip]+general+independent-proposals"
    wl = Sampler.from_ensemble(nn, kernel_type="wang-landau", min_enthalpy=-1.0,
                               max_enthalpy=1.0, bin_size=0.1, nwalkers=4, seed=1,
                               device="cpu")
    assert wl.execution_path(10) == "cpu-step[flip]+general+independent-proposals"
    nn.reset_restricted_sites()
    assert Sampler.from_ensemble(nn, 1000.0, 4, seed=1, device="cpu").mckernel.runs_chain
    # a split part that keeps a code other than 0 is refused too: the chain
    # tables would read its frozen sites as code 0
    ternary = _port("ternary")
    occ = _random_occupancy(ternary, seed=4)
    ternary.split_sublattice_by_species(0, occ, [[0, 1], [2]])
    assert chain.chain_refusal(ternary.processor, ternary.sublattices) == \
        "non-default sublattice encodings"


def test_pinned_flips_match_enumeration():
    system = load_system(data_path("aucu_nn_2x2x2"))
    nn = Ensemble.from_system(system, "cpu")
    pinned, temperature, walkers = [1, 6], 600.0, 64
    start = np.random.default_rng(5).integers(0, 2, (walkers, 8)).astype(np.int32)
    start[:, pinned] = [1, 0]
    states = np.array(list(product((0, 1), repeat=8)), dtype=np.int32)
    states = states[(states[:, pinned] == [1, 0]).all(axis=1)]
    assert len(states) == 64
    h = (nn.compute_features(torch.as_tensor(states))
         @ torch.as_tensor(nn.natural_parameters)).numpy()
    w = np.exp(-(h - h.min()) / (kB * temperature))
    exact = float(h @ w / w.sum())
    nn.restrict_sites(pinned)
    sampler = Sampler.from_ensemble(nn, temperature, walkers, seed=7, device="cpu")
    sampler.run(3000, start, thin_by=10)
    occ = sampler.samples.get_occupancies(flat=False)
    assert np.all(occ[:, :, pinned] == [1, 0])
    enth = sampler.samples.get_enthalpies(flat=False)[30:]  # [S, W]
    means = enth.mean(axis=0)
    se = means.std(ddof=1) / np.sqrt(walkers)
    assert abs(means.mean() - exact) < SE_LIMIT * se, (means.mean(), exact, se)
    assert np.unique(occ.reshape(-1, 8), axis=0).shape[0] > 32
    feats = sampler.samples.get_feature_vectors()
    assert np.abs(feats @ nn.natural_parameters - sampler.samples.get_enthalpies()).max() < 1e-9


@pytest.mark.parametrize("partition", [[[0], [1, 2]], [[0, 1], [2]]], ids=["0|12", "01|2"])
def test_split_swaps_keep_part_compositions(partition):
    ternary = _port("ternary")
    ternary.chemical_potentials = None  # canonical: swaps
    occ = (np.arange(ternary.num_sites) % 3).astype(np.int32)
    ternary.split_sublattice_by_species(0, occ, partition)
    parts = ternary.sublattices
    assert [list(p.encoding) for p in parts] == partition
    sampler = Sampler.from_ensemble(ternary, 2000.0, 16, seed=8, device="cpu")
    assert sampler.execution_path(10) == "cpu-step[swap]+general+independent-proposals"
    sampler.run(400, occ, thin_by=10)
    records = sampler.samples.get_occupancies(flat=False)  # [S, W, N]
    assert (records != occ).any()
    for part in parts:
        for code in part.encoding:
            kept = (records[..., part.sites] == code).sum(axis=-1)
            assert np.all(kept == (occ[part.sites] == code).sum())
    feats = sampler.samples.get_feature_vectors()
    assert np.abs(feats @ ternary.natural_parameters
                  - sampler.samples.get_enthalpies()).max() < 1e-9
