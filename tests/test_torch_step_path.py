"""The port's per-step Monte Carlo path against smol_tpu's, and exact results.

- (exact) the step applier: the same occupancies, sites, codes and valid
  masks through the reference's ``make_step_applier`` (its processors'
  ``delta_energy_fn`` and ``delta_features_fn``, vmapped over walkers) and
  the port's (the processors' batched ``delta_energy`` and
  ``delta_features``) give the same new occupancies, and dH and dfeat
  within 1e-12 relative (|diff| <= 1e-12 * max(1, max |reference|)), with
  and without a chemical-potential table: the bench spinel CE (expansion
  and decomposition), the spinel CE + Ewald composite, and the golden LNO
  expansion of ``tests/data/golden_lno_ce.json``;
- the proposals, against their exact probabilities (within 5 binomial
  standard errors over 200000 draws, one batched call): each (site, code)
  of a flip with unequal sublattice probabilities, and each (site 1,
  site 2) of a swap, whose partner is uniform among the sublattice's sites
  of another code, with an empty step where there is none;
- (statistical) the port's copies of ``tests/test_moca/test_sampling.py``'s
  enumeration tests on the 8-site Au-Cu cell, on the per-step path
  (``shared_proposals=False``) and with the reference's tolerances:
  canonical swaps and semigrand flips, and the uniformly random kernel;
- parity (e), recorded enthalpy = features . theta to 1e-9, on a per-step
  canonical run of the spinel CE + Ewald, whose swaps keep every walker's
  composition exactly;
- ``anneal`` (``tests/test_moca/test_sampling.py:182``) and ``sample``,
  whose traces' enthalpies equal their features . theta; both take the
  reference's parameters in its order.
"""

import functools
import inspect
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smol_tpu.moca.sampler.sampler import Sampler as RefSampler
from smol_tpu.ops import mc as ref_mc

from smol_tpu_torch.benchmarks.systems import fcc_ternary_prim, random_expansion
from smol_tpu_torch.cofe import ClusterExpansion, ClusterSubspace
from smol_tpu_torch.constants import kB
from smol_tpu_torch.crystal import Lattice, Structure
from smol_tpu_torch.moca.ensemble import Ensemble
from smol_tpu_torch.moca.sampler.sampler import Sampler
from smol_tpu_torch.moca.trace import Trace
from smol_tpu_torch.ops import mc
from smol_tpu_torch.system import load_system

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_processor_api import _pair  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
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


def _steps(processor, walkers, width, seed):
    """Occupancies [W, N] and steps (sites, codes, valid) [W, S] of distinct
    active sites, each to another of its codes, about 3 in 4 valid."""
    rng = np.random.default_rng(seed)
    codes = np.array([len(species) for species in processor.allowed_species])
    occu = (rng.random((walkers, len(codes))) * codes).astype(np.int32)
    active = np.flatnonzero(codes > 1)
    sites = np.stack([rng.choice(active, size=width, replace=False) for _ in range(walkers)])
    shift = rng.integers(1, codes[sites])
    new = ((occu[np.arange(walkers)[:, None], sites] + shift) % codes[sites]).astype(np.int32)
    valid = rng.random((walkers, width)) < 0.75
    return occu, sites.astype(np.int32), new, valid


APPLIER_CASES = [("spinel", kind) for kind in ("expansion", "decomposition", "composite")] \
    + [("lno", "expansion")]


@pytest.mark.parametrize("with_mu", [False, True], ids=["canonical", "semigrand"])
@pytest.mark.parametrize("system,kind", APPLIER_CASES)
def test_step_applier_equals_reference(system, kind, with_mu):
    mine, theirs = _pair(system, kind)
    occu, sites, codes, valid = _steps(mine, 16, 3, seed=len(kind) + with_mu)
    mu = None
    if with_mu:
        ncol = max(len(species) for species in mine.allowed_species)
        mu = np.random.default_rng(9).normal(scale=0.1, size=(mine.num_sites, ncol))
    nfeat = len(theirs.coefs) + with_mu
    ref_apply = ref_mc.make_step_applier(
        theirs.delta_energy_fn, mu_table=None if mu is None else jnp.asarray(mu),
        delta_features_fn=theirs.delta_features_fn, num_features=nfeat)
    ref_occu, ref_dh, ref_df = jax.vmap(ref_apply)(
        jnp.asarray(occu), jnp.asarray(sites), jnp.asarray(codes), jnp.asarray(valid))
    apply = mc.make_step_applier(
        mine.delta_energy, mu_table=None if mu is None else torch.as_tensor(mu),
        delta_features_fn=mine.delta_features)
    t = torch.as_tensor
    new_occu, dh, df = apply(t(occu), t(sites).long(), t(codes).long(), t(valid))
    np.testing.assert_array_equal(new_occu.numpy(), np.asarray(ref_occu))
    _close(dh.numpy(), np.asarray(ref_dh), "dH")
    _close(df.numpy(), np.asarray(ref_df), "dfeat")
    # the energy delta is the feature delta dotted with the natural parameters
    params = np.append(mine.coefs, -1.0) if with_mu else mine.coefs
    _close(dh.numpy(), df.numpy() @ params, "dH against dfeat . theta")
    energy_only = mc.make_step_applier(
        mine.delta_energy, mu_table=None if mu is None else torch.as_tensor(mu))
    _, dh2, none = energy_only(t(occu), t(sites).long(), t(codes).long(), t(valid))
    assert none is None and torch.equal(dh2, dh)


# ---------------- the proposals against their exact probabilities ----------------

DRAWS = 200_000


def _within(counts, probs, what):
    expect = probs * DRAWS
    sigma = np.sqrt(DRAWS * probs * (1 - probs))
    assert np.all(np.abs(counts - expect) <= 5 * sigma + 1e-9), (what, counts, expect)


def test_flip_proposal_frequencies():
    """Every (site, code) of a flip: p_sublattice / n_active / (n_codes - 1)."""
    spinel = Ensemble.from_system(load_system(DATA / "torch_spinel_2x2x2.npz"), "cpu")
    ternary = Ensemble.from_cluster_expansion(
        random_expansion(fcc_ternary_prim(), {2: 3.0}, seed=2), np.diag([2, 2, 2]),
        device="cpu")
    for ens, probs in ((spinel, [0.3, 0.7]), (ternary, None)):
        tables = mc.sublattice_tables(ens.sublattices, probs)
        occ = np.random.default_rng(1).integers(0, 2, ens.num_sites).astype(np.int32)
        gen = torch.Generator().manual_seed(4)
        sites, codes, valid, log_priori = mc.flip_proposal(
            tables, torch.as_tensor(np.tile(occ, (DRAWS, 1))), gen)
        assert sites.shape == codes.shape == valid.shape == (DRAWS, 1)
        assert bool(valid.all()) and log_priori == 0.0
        ncode = max(len(s.encoding) for s in ens.sublattices)
        counts = np.bincount(sites[:, 0].numpy() * ncode + codes[:, 0].numpy(),
                             minlength=ens.num_sites * ncode)
        exact = np.zeros(ens.num_sites * ncode)
        active = [s for s in ens.sublattices if s.is_active]
        p = probs or [1.0 / len(active)] * len(active)
        for prob, s in zip(p, active):
            for site in s.active_sites:
                for code in s.encoding:
                    if code != occ[site]:
                        exact[site * ncode + code] = prob / len(s.active_sites) / (
                            len(s.encoding) - 1)
        assert np.all(counts[exact == 0] == 0)
        _within(counts, exact, "flip (site, code)")


def test_swap_proposal_frequencies_and_empty_steps():
    """Site 1 uniform on the sublattice, site 2 uniform among its sites of
    another code, their codes exchanged; no valid flip where every site of
    the sublattice holds one code."""
    ens = Ensemble.from_system(load_system(DATA / "torch_spinel_ewald_2x2x2.npz"), "cpu")
    tables = mc.sublattice_tables(ens.sublattices, [0.4, 0.6])
    occ = np.asarray(load_system(DATA / "torch_spinel_ewald_2x2x2.npz")["initial_occupancy"])
    gen = torch.Generator().manual_seed(5)
    sites, codes, valid, _ = mc.swap_proposal(
        tables, torch.as_tensor(np.tile(occ, (DRAWS, 1)).astype(np.int32)), gen)
    assert bool(valid.all())
    s1, s2 = sites[:, 0].numpy(), sites[:, 1].numpy()
    np.testing.assert_array_equal(codes[:, 0].numpy(), occ[s2])
    np.testing.assert_array_equal(codes[:, 1].numpy(), occ[s1])
    n = ens.num_sites
    counts = np.bincount(s1 * n + s2, minlength=n * n)
    exact = np.zeros(n * n)
    for prob, s in zip([0.4, 0.6], [s for s in ens.sublattices if s.is_active]):
        for i in s.active_sites:
            others = [j for j in s.active_sites if occ[j] != occ[i]]
            for j in others:
                exact[i * n + j] = prob / len(s.active_sites) / len(others)
    assert np.all(counts[exact == 0] == 0)
    _within(counts, exact, "swap (site 1, site 2)")
    # one code on the first sublattice: its swaps are empty steps
    flat = occ.copy()
    first = [s for s in ens.sublattices if s.is_active][0]
    flat[first.active_sites] = 0
    sites, _, valid, _ = mc.swap_proposal(
        tables, torch.as_tensor(np.tile(flat, (4000, 1)).astype(np.int32)), gen)
    on_first = np.isin(sites[:, 0].numpy(), first.active_sites)
    assert on_first.any() and not valid[on_first].any() and valid[~on_first].all()


# ---------------- the reference's enumeration tests, per step ----------------


@functools.lru_cache(maxsize=None)
def _small_ce():
    """``tests/test_moca/test_sampling.py``'s ``small_ce``, in the port."""
    a = 3.8
    lat = Lattice(np.array([[0, 0.5, 0.5], [0.5, 0, 0.5], [0.5, 0.5, 0]]) * a)
    prim = Structure(lat, [{"Au": 0.5, "Cu": 0.5}], [[0, 0, 0]])
    cs = ClusterSubspace.from_cutoffs(prim, {2: 3.0})
    rng = np.random.default_rng(5)
    coefs = rng.normal(scale=0.02, size=cs.num_corr_functions)
    coefs[0] = -0.5
    return ClusterExpansion(cs, coefs)


def _ensemble(**kwargs):
    return Ensemble.from_cluster_expansion(_small_ce(), np.diag([2, 2, 2]), device="cpu",
                                           **kwargs)


def enumerate_boltzmann(ensemble, temperature, fixed_n=None):
    """Exact canonical/semigrand averages on a tiny binary cell."""
    occus = ((np.arange(2 ** ensemble.num_sites)[:, None]
              >> np.arange(ensemble.num_sites)[::-1]) & 1).astype(np.int32)
    if fixed_n is not None:
        occus = occus[occus.sum(axis=1) == fixed_n]
    energies = ensemble.compute_features(torch.as_tensor(occus)).numpy() \
        @ ensemble.natural_parameters
    weights = -energies / (kB * temperature)
    weights = np.exp(weights - weights.max())
    return float(energies @ (weights / weights.sum()))


def _sem(samples, discard):
    return np.sqrt(samples.enthalpy_variance(discard=discard)
                   / samples.get_enthalpies(discard=discard).shape[0])


def test_canonical_matches_enumeration():
    ens = _ensemble()
    temperature = 2000.0
    exact = enumerate_boltzmann(ens, temperature, fixed_n=4)
    rng = np.random.default_rng(3)
    nwalkers = 64
    occu = np.zeros((nwalkers, 8), dtype=np.int32)
    for w in range(nwalkers):
        occu[w, rng.choice(8, 4, replace=False)] = 1
    sampler = Sampler.from_ensemble(ens, temperature=temperature, nwalkers=nwalkers,
                                    seed=17, device="cpu", shared_proposals=False)
    assert sampler.execution_path(10) == "cpu-step[swap]+general+independent-proposals"
    sampler.run(16000, occu, thin_by=10)
    mc_mean = sampler.samples.mean_enthalpy(discard=400)
    sem = _sem(sampler.samples, 400)
    assert abs(mc_mean - exact) < max(10 * sem, 5e-3), (mc_mean, exact, sem)
    occus = sampler.samples.get_occupancies(flat=False)
    assert np.all(occus.sum(axis=-1) == 4)  # swaps keep the composition


def test_semigrand_matches_enumeration():
    ens = _ensemble(chemical_potentials={"Au": 0.05, "Cu": -0.05})
    temperature = 2000.0
    exact = enumerate_boltzmann(ens, temperature)
    rng = np.random.default_rng(4)
    nwalkers = 64
    occu = rng.integers(0, 2, (nwalkers, 8)).astype(np.int32)
    sampler = Sampler.from_ensemble(ens, temperature=temperature, nwalkers=nwalkers,
                                    seed=23, device="cpu", shared_proposals=False)
    assert sampler.execution_path(10) == "cpu-step[flip]+general+independent-proposals"
    sampler.run(16000, occu, thin_by=10)
    mc_mean = sampler.samples.mean_enthalpy(discard=400)
    sem = _sem(sampler.samples, 400)
    assert abs(mc_mean - exact) < max(10 * sem, 5e-3), (mc_mean, exact, sem)


def test_uniformly_random_kernel():
    ens = _ensemble(chemical_potentials={"Au": 0.0, "Cu": 0.0})
    rng = np.random.default_rng(0)
    occu = rng.integers(0, 2, (16, 8)).astype(np.int32)
    sampler = Sampler.from_ensemble(ens, kernel_type="uniformly-random", nwalkers=16,
                                    seed=2, device="cpu")
    assert "temperature" not in sampler.samples.traced_values
    sampler.run(4000, occu, thin_by=10)
    # infinite temperature: mean site occupancy ~ 0.5
    occus = sampler.samples.get_occupancies(discard=100)
    assert abs(occus.mean() - 0.5) < 0.05
    assert np.all(sampler.samples.get_trace_value("accept_rate") == 1.0)


# ---------------- parity (e), anneal and sample ----------------


def test_per_step_swaps_keep_compositions_and_parity():
    system = load_system(DATA / "torch_spinel_ewald_2x2x2.npz")
    ens = Ensemble.from_system(system, "cpu")
    sampler = Sampler.from_ensemble(ens, 1000.0, nwalkers=32, seed=7, device="cpu",
                                    shared_proposals=False)
    assert sampler.execution_path(20) == "cpu-step[swap]+general+independent-proposals"
    occ0 = np.tile(np.asarray(system["initial_occupancy"]), (32, 1))
    sampler.run(400, occ0, thin_by=20)
    occ = sampler.samples.get_occupancies(flat=False)  # [S, W, N]
    for sl in ens.sublattices:
        for code in sl.encoding:
            np.testing.assert_array_equal((occ[..., sl.sites] == code).sum(axis=-1),
                                          (occ0[0, sl.sites] == code).sum())
    feats = sampler.samples.get_feature_vectors()
    enth = sampler.samples.get_enthalpies()
    assert np.abs(feats @ ens.natural_parameters - enth).max() < 1e-9
    assert 0 < sampler.efficiency() < 1
    nmove = sampler._state["nmove"].numpy()
    assert np.all(nmove > 0) and np.all(nmove <= 400)


@pytest.mark.parametrize("shared_proposals", [True, False], ids=["chain", "per-step"])
def test_anneal(shared_proposals):
    """``tests/test_moca/test_sampling.py:182``; without chemical potentials
    the enthalpy is the energy."""
    ens = _ensemble()
    rng = np.random.default_rng(0)
    occu = rng.integers(0, 2, (8, 8)).astype(np.int32)
    sampler = Sampler.from_ensemble(ens, temperature=2000.0, nwalkers=8, seed=3,
                                    device="cpu", shared_proposals=shared_proposals)
    sampler.anneal([2000.0, 500.0, 100.0], 500, occu, thin_by=10)
    temps = sampler.samples.get_temperatures(flat=False)
    assert temps.shape[0] == 150
    assert temps[0, 0] == pytest.approx(2000.0)
    assert temps[-1, 0] == pytest.approx(100.0)
    np.testing.assert_allclose(temps[50:100], 500.0, rtol=1e-12)
    # energies should not increase on average as T drops
    e = sampler.samples.get_enthalpies(flat=False).mean(axis=1)
    assert e[140:].mean() <= e[:50].mean() + 1e-8
    with pytest.raises(ValueError, match="greater than start"):
        sampler.anneal([100.0, 500.0], 10)
    sampler.clear_samples()
    assert sampler.samples.num_samples == 0
    sampler.run(20, thin_by=10)  # the walkers go on from where they were
    assert sampler.samples.num_samples == 2


def test_sample_yields_traces():
    ens = Ensemble.from_system(load_system(DATA / "torch_spinel_2x2x2.npz"), "cpu")
    sampler = Sampler.from_ensemble(ens, 1000.0, nwalkers=4, seed=5, device="cpu")
    occ0 = np.random.default_rng(2).integers(0, 2, (4, ens.num_sites)).astype(np.int32)
    traces = list(sampler.sample(100, occ0, thin_by=10))
    assert len(traces) == 10 and all(isinstance(t, Trace) for t in traces)
    assert sampler.samples.num_samples == 0  # nothing goes to the container
    for trace in traces:
        assert trace.occupancy.shape == (4, ens.num_sites)
        assert trace.features.shape == (4, len(ens.natural_parameters))
        np.testing.assert_allclose(trace.temperature, 1000.0, rtol=1e-12)
        assert np.abs(trace.features @ ens.natural_parameters - trace.enthalpy).max() < 1e-9
    assert not np.array_equal(traces[-1].occupancy, occ0)


@pytest.mark.parametrize("method", ["sample", "anneal"])
def test_reference_signatures(method):
    mine = inspect.signature(getattr(Sampler, method)).parameters
    theirs = inspect.signature(getattr(RefSampler, method)).parameters
    assert [(n, p.default) for n, p in mine.items()] == \
        [(n, p.default) for n, p in theirs.items()]
