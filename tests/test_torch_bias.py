"""The port's MC biases against smol_tpu's, and biased runs against exact results.

- (exact) ``compute_bias``, ``compute_bias_change`` and the batched device
  delta (``device_delta_fn``) of the fugacity, square-charge and
  square-hyperplane biases equal the reference's on the same occupancies
  and steps (numpy-seeded; the reference's device delta vmapped over
  walkers) within 1e-12 relative (|diff| <= 1e-12 * max(1, max
  |reference|)), and the device bias values its ``compute_bias``;
- (statistical) the port's copies of ``tests/test_moca/test_bias.py``:
  the fugacity tables and change, the fugacity-biased semigrand run on the
  8-site Au-Cu cell against enumeration (mean enthalpy and mean Au count,
  the reference's tolerances) with parity (e), recorded enthalpy =
  features . theta to 1e-9, the square-charge bias driving a charged
  rocksalt toward neutrality, and the square-hyperplane bias; and the
  uniformly random kernel with a fugacity bias, which then tests each step
  at beta 0 and samples each site's fugacity fraction.
"""

import functools
from itertools import product

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smol_tpu.benchmarks.systems import fcc_binary_prim as ref_fcc_binary_prim
from smol_tpu.benchmarks.systems import random_expansion as ref_random_expansion
from smol_tpu.crystal import Lattice as RefLattice
from smol_tpu.crystal import Structure as RefStructure
from smol_tpu.moca import Ensemble as RefEnsemble
from smol_tpu.moca.kernel.bias import mcbias_factory as ref_mcbias_factory

from smol_tpu_torch.benchmarks.systems import fcc_binary_prim, random_expansion
from smol_tpu_torch.constants import kB
from smol_tpu_torch.crystal import Lattice, Structure
from smol_tpu_torch.moca.ensemble import Ensemble
from smol_tpu_torch.moca.kernel.bias import (
    FugacityBias,
    SquareChargeBias,
    SquareHyperplaneBias,
    available_bias_types,
    mcbias_factory,
)
from smol_tpu_torch.moca.sampler.sampler import Sampler

REL_TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors, so that parallel test
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(mine, theirs, what):
    mine, theirs = np.asarray(mine, dtype=np.float64), np.asarray(theirs, dtype=np.float64)
    assert mine.shape == theirs.shape, what
    diff = float(np.abs(mine - theirs).max(initial=0.0))
    assert diff <= REL_TOL * max(1.0, float(np.abs(theirs).max(initial=0.0))), (what, diff)


def _rocksalt(lattice, structure):
    a = 4.2
    lat = lattice(np.array([[0, 0.5, 0.5], [0.5, 0, 0.5], [0.5, 0.5, 0]]) * a)
    return structure(lat, [{"Li+": 0.5, "Mn3+": 0.5}, {"O2-": 0.5, "F-": 0.5}],
                     [[0, 0, 0], [0.5, 0.5, 0.5]])


ROCKSALT_MUS = {"Li+": 0.0, "Mn3+": 0.0, "O2-": 0.0, "F-": 0.0}


@functools.lru_cache(maxsize=None)
def _ensembles(system):
    """(port ensemble on the CPU, reference ensemble) of a test system."""
    if system == "aucu":
        return (Ensemble.from_cluster_expansion(
                    random_expansion(fcc_binary_prim(), {2: 3.0}, seed=1), np.diag([2, 2, 2]),
                    device="cpu"),
                RefEnsemble.from_cluster_expansion(
                    ref_random_expansion(ref_fcc_binary_prim(), {2: 3.0}, seed=1),
                    np.diag([2, 2, 2])))
    return (Ensemble.from_cluster_expansion(
                random_expansion(_rocksalt(Lattice, Structure), {2: 3.1}, seed=2),
                np.diag([2, 1, 1]), device="cpu", chemical_potentials=ROCKSALT_MUS),
            RefEnsemble.from_cluster_expansion(
                ref_random_expansion(_rocksalt(RefLattice, RefStructure), {2: 3.1}, seed=2),
                np.diag([2, 1, 1]), chemical_potentials=ROCKSALT_MUS))


BIASES = {
    "fugacity-bias": ("aucu", {"fugacity_fractions": [{"Au": 0.75, "Cu": 0.25}]}),
    "square-charge-bias": ("rocksalt", {"penalty": 2.0}),
    "square-hyperplane-bias": ("aucu", {"hyperplane_normals": [[1.0, 0.0]],
                                        "hyperplane_intercepts": [4.0], "penalty": 1.5}),
}


@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("bias_type", sorted(BIASES))
def test_bias_values_and_changes_equal_reference(bias_type, width):
    system, kwargs = BIASES[bias_type]
    port, ref = _ensembles(system)
    mine = mcbias_factory(bias_type, port.sublattices, **kwargs)
    theirs = ref_mcbias_factory(bias_type, ref.sublattices, **kwargs)
    assert type(mine).__name__ == type(theirs).__name__
    assert mine.spec.as_dict()["cls_name"] == theirs.spec.as_dict()["cls_name"]
    rng = np.random.default_rng(width)
    W, n = 32, port.num_sites
    ncodes = np.ones(n, dtype=np.int64)
    for sl in port.sublattices:
        ncodes[sl.sites] = len(sl.encoding)
    occu = (rng.random((W, n)) * ncodes).astype(np.int32)
    sites = np.stack([rng.choice(n, size=width, replace=False) for _ in range(W)]).astype(np.int32)
    codes = ((occu[np.arange(W)[:, None], sites] + rng.integers(1, 2, sites.shape))
             % ncodes[sites]).astype(np.int32)
    valid = rng.random((W, width)) < 0.8
    for w in range(W):
        _close(mine.compute_bias(occu[w]), theirs.compute_bias(occu[w]), "bias")
        step = [(int(s), int(c)) for s, c, v in zip(sites[w], codes[w], valid[w]) if v]
        _close(mine.compute_bias_change(occu[w], step),
               theirs.compute_bias_change(occu[w], step), "bias change")
    ref_delta = jax.vmap(theirs.device_delta_fn())(
        jnp.asarray(occu), jnp.asarray(sites), jnp.asarray(codes), jnp.asarray(valid))
    t = torch.as_tensor
    delta = mine.device_delta_fn("cpu")(t(occu), t(sites).long(), t(codes).long(), t(valid))
    _close(delta.numpy(), np.asarray(ref_delta), "device delta")
    _close(mine.device_bias_fn("cpu")(t(occu)).numpy(),
           [theirs.compute_bias(o) for o in occu], "device bias")


def test_fugacity_bias_tables_and_change(rng):
    port, _ = _ensembles("aucu")
    bias = FugacityBias(port.sublattices)
    occu = rng.integers(0, 2, 8).astype(np.int32)
    b0 = bias.compute_bias(occu)
    step = [(0, 1 - int(occu[0]))]
    delta = bias.compute_bias_change(occu, step)
    occu2 = occu.copy()
    occu2[0] = step[0][1]
    assert delta == pytest.approx(bias.compute_bias(occu2) - b0, abs=1e-12)
    fn = bias.device_delta_fn("cpu")
    d_dev = float(fn(torch.as_tensor(occu)[None], torch.tensor([[0]]),
                     torch.tensor([[step[0][1]]]), torch.tensor([[True]]))[0])
    assert d_dev == pytest.approx(delta, abs=1e-12)
    assert available_bias_types() == (
        "fugacity-bias", "square-charge-bias", "square-hyperplane-bias")
    with pytest.raises(ValueError, match="add to one"):
        bias.fugacity_fractions = [{"Au": 0.5, "Cu": 0.6}]


def _biased_exact(ens, bias, temperature):
    beta = 1 / (kB * temperature)
    occus = np.array(list(product((0, 1), repeat=8)), dtype=np.int32)
    hs = ens.compute_features(torch.as_tensor(occus)).numpy() @ ens.natural_parameters
    weights = -beta * hs + np.array([bias.compute_bias(o) for o in occus])
    weights = np.exp(weights - weights.max())
    weights /= weights.sum()
    return float(hs @ weights), float((8 - occus.sum(axis=1)) @ weights)


def test_biased_sgc_matches_enumeration():
    """Flip MC with a fugacity bias samples exp(-beta H + bias)."""
    ens = Ensemble.from_cluster_expansion(
        random_expansion(fcc_binary_prim(), {2: 3.0}, seed=5), np.diag([2, 2, 2]),
        device="cpu", chemical_potentials={"Au": 0.0, "Cu": 0.0})
    temperature = 2000.0
    fractions = [{"Au": 0.75, "Cu": 0.25}]
    exact_h, exact_au = _biased_exact(
        ens, FugacityBias(ens.sublattices, fugacity_fractions=fractions), temperature)
    nwalkers = 64
    rng = np.random.default_rng(1)
    occu = rng.integers(0, 2, (nwalkers, 8)).astype(np.int32)
    sampler = Sampler.from_ensemble(
        ens, step_type="flip", temperature=temperature, nwalkers=nwalkers, seed=3,
        device="cpu", bias_type="fugacity-bias",
        bias_kwargs={"fugacity_fractions": fractions})
    assert sampler.execution_path(10) == "cpu-step[flip]+general+independent-proposals"
    assert sampler.mckernel.spec.bias.fugacity_fractions == [{"Au": 0.75, "Cu": 0.25}]
    sampler.run(12000, occu, thin_by=10)
    mc_h = sampler.samples.mean_enthalpy(discard=300)
    occs = sampler.samples.get_occupancies(discard=300)
    mc_au = float((occs == 0).sum(axis=1).mean())
    sem = np.sqrt(sampler.samples.enthalpy_variance(discard=300)
                  / sampler.samples.get_enthalpies(discard=300).shape[0])
    assert abs(mc_h - exact_h) < max(10 * sem, 3e-3), (mc_h, exact_h)
    assert abs(mc_au - exact_au) < 0.1, (mc_au, exact_au)
    feats = sampler.samples.get_feature_vectors()  # parity (e)
    assert np.abs(feats @ ens.natural_parameters - sampler.samples.get_enthalpies()).max() \
        < 1e-9


def test_square_charge_bias():
    ens, _ = _ensembles("rocksalt")
    bias = mcbias_factory("square-charge-bias", ens.sublattices, penalty=2.0)
    assert isinstance(bias, SquareChargeBias)
    # neutral occupancy has zero bias; charged has negative
    occu_neutral = np.array([0, 0, 1, 1], dtype=np.int32)  # LiLi FF
    charge = sum((ens.processor.allowed_species[i][occu_neutral[i]].oxi_state or 0)
                 for i in range(ens.num_sites))
    assert charge == 0
    assert bias.compute_bias(occu_neutral) == pytest.approx(0.0)
    occu_charged = np.zeros(ens.num_sites, dtype=np.int32)
    assert bias.compute_bias(occu_charged) < 0

    # a biased flip run drives the system toward neutrality
    nwalkers = 16
    sampler = Sampler.from_ensemble(ens, step_type="flip", temperature=1000.0,
                                    nwalkers=nwalkers, seed=5, device="cpu",
                                    bias_type="square-charge-bias",
                                    bias_kwargs={"penalty": 2.0})
    sampler.run(3000, np.tile(occu_charged, (nwalkers, 1)), thin_by=30)
    occs = sampler.samples.get_occupancies(discard=50)
    charges = np.array([sum((ens.processor.allowed_species[i][o[i]].oxi_state or 0)
                            for i in range(ens.num_sites)) for o in occs])
    assert np.abs(charges).mean() < 1.0


def test_square_hyperplane_bias(rng):
    """-penalty * ||A n - b||^2 over species counts, host and device."""
    ens = Ensemble.from_cluster_expansion(
        random_expansion(fcc_binary_prim(), {2: 3.0}, seed=3), np.diag([2, 2, 2]),
        device="cpu")
    # one hyperplane: exactly 4 Au (dim 0) in the 8-site cell
    bias = mcbias_factory("square-hyperplane-bias", ens.sublattices,
                          hyperplane_normals=[[1.0, 0.0]], hyperplane_intercepts=[4.0],
                          penalty=1.5)
    assert isinstance(bias, SquareHyperplaneBias)
    with pytest.raises(ValueError):
        SquareHyperplaneBias(ens.sublattices, [[1.0, 0.0]], [4.0], penalty=-1.0)
    occu = rng.integers(0, 2, 8).astype(np.int32)
    n_au = int(np.sum(occu == 0))
    assert bias.compute_bias(occu) == pytest.approx(-1.5 * (n_au - 4.0) ** 2)
    occu_on = np.array([0, 0, 0, 0, 1, 1, 1, 1], dtype=np.int32)
    assert bias.compute_bias(occu_on) == pytest.approx(0.0)
    step = [(2, 1 - int(occu[2]))]
    occu2 = occu.copy()
    occu2[2] = step[0][1]
    delta = bias.compute_bias_change(occu, step)
    assert delta == pytest.approx(bias.compute_bias(occu2) - bias.compute_bias(occu),
                                  abs=1e-12)
    d_dev = float(bias.device_delta_fn("cpu")(
        torch.as_tensor(occu)[None], torch.tensor([[2]]), torch.tensor([[step[0][1]]]),
        torch.tensor([[True]]))[0])
    assert d_dev == pytest.approx(delta, abs=1e-10)


def test_uniformly_random_with_a_bias_samples_the_fractions():
    """At infinite temperature with a fugacity bias, each site holds Au with
    its fugacity fraction (the step is a Metropolis test at beta 0)."""
    ens = Ensemble.from_cluster_expansion(
        random_expansion(fcc_binary_prim(), {2: 3.0}, seed=5), np.diag([2, 2, 2]),
        device="cpu", chemical_potentials={"Au": 0.0, "Cu": 0.0})
    sampler = Sampler.from_ensemble(ens, kernel_type="uniformly-random", nwalkers=32, seed=4,
                                    device="cpu", bias_type="fugacity-bias",
                                    bias_kwargs={"fugacity_fractions": [{"Au": 0.75,
                                                                         "Cu": 0.25}]})
    sampler.run(2000, np.zeros((32, 8), dtype=np.int32), thin_by=10)
    occs = sampler.samples.get_occupancies(discard=20)
    au = [str(sp) for sp in ens.sublattices[0].species].index("Au")
    assert abs(float((occs == au).mean()) - 0.75) < 0.02
    assert 0 < sampler.efficiency() < 1  # the bias rejects some steps
    assert "beta" not in sampler._state
