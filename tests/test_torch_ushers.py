"""The port's ushers on the per-step path, and per-step replica exchange.

The port's copies of ``tests/test_moca/test_ushers.py:53-124`` on its
batched device proposals (one draw a walker, 400 walkers a call): a
multi-step proposal holds 1 to 3 flips of distinct sites, each to another
code of its site, applied in order; the step-probability checks; a
composite of flips and swaps weighted 1:2 takes each (with its share
within 5 binomial standard errors); the factory and the usher API
(``sublattice_probabilities``, ``spec``, ``available_step_types``); the
uniformly random kernel visits every site's codes uniformly.  Multi-step
and composite runs take the per-step path and keep parity (e), recorded
enthalpy = features . theta to 1e-9.

Per-step replica exchange: on the 8-site Au-Cu FCC of
``tests/data/torch_aucu_nn_2x2x2.npz`` with flips at zero chemical
potential, a ladder of 6 temperatures x 8 copies with an exchange every 10
steps and ``thin_by=15`` (which the period does not divide, so the run
takes the per-step path): every record's temperatures are a permutation of
the ladder, and each rung's mean enthalpy is within 5 standard errors of
exact enumeration (256 states; batch means over the records of the
replicas at that rung), as ``tests/test_torch_tempering.py`` holds the
chain.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from smol_tpu_torch.benchmarks.systems import fcc_binary_prim, fcc_ternary_prim
from smol_tpu_torch.cofe import ClusterExpansion, ClusterSubspace
from smol_tpu_torch.constants import kB
from smol_tpu_torch.moca.ensemble import Ensemble
from smol_tpu_torch.moca.kernel.mcusher import (
    Composite,
    Flip,
    MultiStep,
    Swap,
    available_step_types,
    mcusher_factory,
)
from smol_tpu_torch.moca.sampler.sampler import Sampler
from smol_tpu_torch.ops.mc import apply_flips
from smol_tpu_torch.parallel import make_temperature_ladder
from smol_tpu_torch.system import load_system

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from export_torch_systems import data_path  # noqa: E402

WALKERS = 400


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors, so that parallel test
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ensemble():
    cs = ClusterSubspace.from_cutoffs(fcc_ternary_prim(), {2: 3.0})
    rng = np.random.default_rng(13)
    coefs = rng.normal(scale=0.02, size=cs.num_corr_functions)
    coefs[0] = -0.7
    exp = ClusterExpansion(cs, coefs)
    return Ensemble.from_cluster_expansion(exp, np.diag([2, 2, 2]), device="cpu")


def _random_occu(ensemble, seed=0):
    rng = np.random.default_rng(seed)
    sizes = np.ones(ensemble.num_sites, dtype=np.int64)
    for subl in ensemble.sublattices:
        sizes[subl.sites] = len(subl.encoding)
    return (rng.random(ensemble.num_sites) * sizes).astype(np.int32)


def _proposals(usher, occu, seed):
    propose, width = usher.device_proposal("cpu")
    occ = torch.as_tensor(np.tile(occu, (WALKERS, 1)))
    sites, codes, valid, _ = propose(occ, torch.Generator().manual_seed(seed))
    assert sites.shape == codes.shape == valid.shape == (WALKERS, width)
    return occ, sites, codes, valid


def _valid_codes(ensemble, occ, sites, codes, valid):
    """Every valid flip takes a code of its site's sublattice, other than
    the code the site holds when the flip applies."""
    allowed = {int(s): set(sl.encoding.tolist()) for sl in ensemble.sublattices
               for s in sl.sites}
    work = occ.clone()
    for k in range(sites.shape[1]):
        for w in np.flatnonzero(valid[:, k].numpy()):
            site, code = int(sites[w, k]), int(codes[w, k])
            assert code in allowed[site] and code != int(work[w, site])
        work = apply_flips(work, sites[:, k:k + 1], codes[:, k:k + 1], valid[:, k:k + 1])


def test_multistep_proposals(ensemble):
    usher = MultiStep(ensemble.sublattices, "flip", step_lengths=3)
    occ, sites, codes, valid = _proposals(usher, _random_occu(ensemble, 1), seed=1)
    counts = valid.sum(dim=1).numpy()
    assert counts.min() >= 1 and counts.max() <= 3 and (counts == 3).any()
    for w in range(WALKERS):  # no repeated sites among the valid flips
        used = sites[w][valid[w]].tolist()
        assert len(set(used)) == len(used)
    _valid_codes(ensemble, occ, sites, codes, valid)
    # lengths by probability: a step holds one flip at length 1, or at length
    # 2 where its second flip draws the first's site (1 in 8) and is dropped
    usher = MultiStep(ensemble.sublattices, "flip", step_lengths=[1, 2],
                      step_probabilities=[0.25, 0.75])
    _, _, _, valid = _proposals(usher, _random_occu(ensemble, 1), seed=2)
    ones = float((valid.sum(dim=1) == 1).double().mean())
    exact = 0.25 + 0.75 / ensemble.num_sites
    assert abs(ones - exact) < 5 * np.sqrt(exact * (1 - exact) / WALKERS)


def test_multistep_probabilities_validation(ensemble):
    with pytest.raises(ValueError):
        MultiStep(ensemble.sublattices, "flip", step_lengths=[1, 2],
                  step_probabilities=[0.9, 0.3])
    with pytest.raises(ValueError):
        MultiStep(ensemble.sublattices, "flip", step_lengths=[1, 2, 3],
                  step_probabilities=[0.5, 0.5])


def test_composite_proposals(ensemble):
    usher = Composite(ensemble.sublattices, ["flip", "swap"], mcusher_weights=[1, 2])
    assert len(usher.mcushers) == 2
    np.testing.assert_allclose(usher.probabilities, [1 / 3, 2 / 3])
    occ, sites, codes, valid = _proposals(usher, _random_occu(ensemble, 2), seed=3)
    sizes = valid.sum(dim=1).numpy()
    assert set(np.unique(sizes)) == {1, 2}  # both flip (1) and swap (2) get chosen
    share = float((sizes == 2).mean())
    assert abs(share - 2 / 3) < 5 * np.sqrt(2 / 9 / WALKERS)
    _valid_codes(ensemble, occ, sites, codes, valid)
    swaps = sizes == 2  # a swap exchanges the two sites' codes
    np.testing.assert_array_equal(codes[swaps, 0], occ[swaps].gather(1, sites[swaps][:, 1:])[:, 0])
    assert usher.spec.as_dict()["weights"] == [1, 2]


def test_mcusher_factory(ensemble):
    assert isinstance(mcusher_factory("flip", ensemble.sublattices), Flip)
    assert isinstance(mcusher_factory("swap", ensemble.sublattices), Swap)
    assert isinstance(
        mcusher_factory("multi-step", ensemble.sublattices, "flip", step_lengths=2),
        MultiStep)
    assert available_step_types() == ("flip", "swap", "multi-step", "composite", "table-flip")
    usher = Flip(ensemble.sublattices)
    with pytest.raises(ValueError, match="sum to one"):
        usher.sublattice_probabilities = [0.5]
    with pytest.raises(AttributeError, match="match"):
        usher.sublattice_probabilities = [0.5, 0.5]
    step = MultiStep(ensemble.sublattices, usher, step_lengths=[1, 2])
    step.sublattice_probabilities = [1.0]
    assert usher.sublattice_probabilities.tolist() == [1.0]
    assert step.spec.as_dict()["step"]["cls_name"] == "Flip"


@pytest.mark.parametrize("step_type,kwargs", [
    ("multi-step", {"mcusher": "flip", "step_lengths": [1, 2, 3]}),
    ("composite", {"mcushers": ["flip", "swap"], "mcusher_weights": [1, 2]}),
])
def test_multistep_and_composite_runs(step_type, kwargs):
    """Both ushers run on the per-step path, with parity (e)."""
    ens = Ensemble.from_system(load_system(data_path("spinel_2x2x2")), "cpu")
    sampler = Sampler.from_ensemble(ens, 1000.0, nwalkers=16, seed=5, device="cpu",
                                    step_type=step_type, **kwargs)
    assert sampler.execution_path(10) == \
        f"cpu-step[{step_type}]+general+independent-proposals"
    occ0 = np.random.default_rng(0).integers(0, 2, (16, ens.num_sites)).astype(np.int32)
    sampler.run(200, occ0, thin_by=10)
    feats = sampler.samples.get_feature_vectors()
    assert np.abs(feats @ ens.natural_parameters - sampler.samples.get_enthalpies()).max() \
        < 1e-9
    assert 0 < sampler.efficiency() < 1


def test_uniformly_random_kernel():
    """Infinite-T kernel: every composition visited uniformly (binary cell)."""
    cs = ClusterSubspace.from_cutoffs(fcc_binary_prim(), {2: 3.0})
    coefs = np.zeros(cs.num_corr_functions)
    coefs[0] = 1.0
    ens = Ensemble.from_cluster_expansion(ClusterExpansion(cs, coefs), np.diag([2, 1, 1]),
                                          device="cpu")
    ens.chemical_potentials = {"Au": 0.0, "Cu": 0.0}  # flips allowed
    sampler = Sampler.from_ensemble(ens, kernel_type="uniformly-random", step_type="flip",
                                    nwalkers=8, seed=21, device="cpu")
    occu = np.zeros((8, ens.num_sites), dtype=np.int32)
    sampler.run(4000, occu, thin_by=4)
    occus = sampler.samples.get_occupancies(discard=200)
    # each site occupied half the time under uniform sampling
    freqs = occus.reshape(-1, ens.num_sites).mean(axis=0)
    np.testing.assert_allclose(freqs, 0.5, atol=0.1)


def test_per_step_replica_exchange_matches_enumeration():
    system = load_system(data_path("aucu_nn_2x2x2"))
    port = Ensemble.from_system(system, "cpu")
    h = system["exact_enthalpies"]
    temperatures = make_temperature_ladder(600.0, 4000.0, 6)
    copies = 8
    ladder = np.tile(temperatures, copies)  # every pair is a valid exchange
    W = len(ladder)
    sampler = Sampler.from_ensemble(port, temperature=ladder, nwalkers=W, seed=23,
                                    device="cpu", replica_exchange_period=10)
    assert sampler.execution_path(15) == (
        "cpu-step[flip]+general+independent-proposals+replica-exchange@10")
    occ0 = np.random.default_rng(4).integers(0, 2, (W, port.num_sites))
    sampler.run(4005, occ0, thin_by=15)
    assert sampler._state["pt_counter"] == 4005
    assert int(sampler._state["pt_accepted"].sum()) > 0
    recorded_ladder = 1.0 / (kB * (1.0 / (kB * ladder)))  # T -> beta -> T, rounded
    all_temps = sampler.samples.get_temperatures(flat=False)
    for t in all_temps:  # every record a permutation of the ladder, exactly
        np.testing.assert_array_equal(np.sort(t), np.sort(recorded_ladder))
    assert not np.array_equal(all_temps[-1], all_temps[0])  # exchanges happened
    discard = 27
    enth = sampler.samples.get_enthalpies(discard=discard, flat=False)  # [S, W]
    temps = sampler.samples.get_temperatures(discard=discard, flat=False)
    batches = 10
    for t in temperatures:
        at = np.isclose(temps, t, rtol=1e-12, atol=0)
        assert np.all(at.sum(axis=1) == copies)
        series = np.where(at, enth, 0.0).sum(axis=1) / copies  # [S]
        means = np.array([b.mean() for b in np.array_split(series, batches)])
        sem = means.std(ddof=1) / np.sqrt(batches)
        weights = np.exp(-(h - h.min()) / (kB * t))
        exact = float(h @ weights / weights.sum())
        assert abs(series.mean() - exact) < 5 * sem, (t, series.mean(), exact, sem)
    feats = sampler.samples.get_feature_vectors()
    assert np.abs(feats @ port.natural_parameters - sampler.samples.get_enthalpies()).max() \
        < 1e-9
