"""The port's per-step Wang-Landau against smol_tpu's ``_wl_step`` and exact
densities of states.

Where the Wang-Landau chain cannot take a configuration (independent
proposals, the ``TableFlip``, ``MultiStep`` and ``Composite`` ushers,
systems the chain tables refuse) the reference runs ``_wl_step``
(``smol_tpu/ops/mc.py:528-655``), and so does the port
(``ops/mc.py:make_wang_landau_step``).  On the CPU, inputs from numpy seeds:

- one step: both take the same proposals (a deterministic function of the
  occupancy, with a log a-priori factor) and the same acceptance draws (the
  reference's ``_accept_metropolis`` patched inside the test, and the
  port's, to one threshold); from random planes, with an update every 2
  and a flatness check every 3 counted steps, the integer planes equal
  exactly and the f64 planes within 1e-12, step after step;
- the 8-site Au-Cu (``torch_aucu_nn_2x2x2.npz``) with independent
  proposals, its log-DOS and mean features against exact, is
  ``tests/test_torch_wanglandau_step_dos.py``;
- a ``table-flip`` Wang-Landau on the tiny {Li+, vacancy} x {Mn3+, Mn4+}
  cell is within 0.5 of the enumerated charge-neutral DOS, every sample
  neutral;
- a run resumes from its container on the per-step path;
- a ``bias_type`` raises ``ValueError``, as the reference's does.
"""

import sys
from itertools import product
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import smol_tpu.ops.mc as ref_mc
import smol_tpu_torch.ops.mc as port_mc
from smol_tpu.moca.kernel.wanglandau import WangLandau as RefWangLandau
from smol_tpu_torch.benchmarks.systems import fcc_binary_prim
from smol_tpu_torch.cofe import ClusterExpansion, ClusterSubspace
from smol_tpu_torch.moca.ensemble import Ensemble as TorchEnsemble
from smol_tpu_torch.moca.kernel.wanglandau import WangLandau
from smol_tpu_torch.moca.sampler.sampler import Sampler as TorchSampler
from smol_tpu_torch.system import load_system

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from export_torch_systems import aucu_nn_ensemble, data_path  # noqa: E402

DOS_TOL = 0.5  # on every walker's log-DOS
THRESHOLD = -0.7  # the patched acceptance: exponent > THRESHOLD


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module's runs: the per-step path's small
    operations run no faster on more, and far slower when the test
    workers' threads oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def nn():
    """The 8-site system: (port ensemble, its file, mid-bin window)."""
    system = load_system(data_path("aucu_nn_2x2x2"))
    levels = np.unique(np.round(system["exact_enthalpies"], 9))
    bin_size = float(levels[1] - levels[0])
    window = dict(min_enthalpy=float(levels[0] - bin_size / 2),
                  max_enthalpy=float(levels[-1] + bin_size), bin_size=bin_size)
    return TorchEnsemble.from_system(system, "cpu"), system, window


def _ref_propose(key, occu):
    """One walker: flip a site chosen by the occupancy, and a second one on
    odd sums; a log a-priori factor from the first site."""
    n = occu.shape[0]
    total = jnp.sum(occu * jnp.arange(1, n + 1))
    first = (total * 5 + 3) % n
    sites = jnp.stack([first, (first + 1 + total % 3) % n])
    codes = 1 - occu[sites]
    valid = jnp.stack([jnp.bool_(True), total % 2 == 1])
    return sites, codes, valid, 0.05 * (first % 3) - 0.05


def _port_propose(occu, generator):
    n = occu.shape[1]
    total = (occu.long() * torch.arange(1, n + 1)).sum(dim=1)
    first = (total * 5 + 3) % n
    sites = torch.stack([first, (first + 1 + total % 3) % n], dim=1)
    codes = 1 - occu.gather(1, sites).long()
    valid = torch.stack([torch.ones_like(total, dtype=torch.bool), total % 2 == 1], dim=1)
    return sites, codes, valid, 0.05 * (first % 3).double() - 0.05


def _random_planes(port, num_levels, W, seed):
    rng = np.random.default_rng(seed)
    occ = rng.integers(0, 2, (W, port.num_sites)).astype(np.int32)
    features = port.compute_features(torch.as_tensor(occ)).numpy()
    visited = rng.random((W, num_levels)) < 0.6
    entropy = np.where(visited, rng.random((W, num_levels)) * 5 + 0.5, 0.0)
    histogram = np.where(visited, rng.integers(1, 20, (W, num_levels)), 0).astype(np.int32)
    flat = rng.random(W) < 0.5  # about half the walkers flat
    histogram[flat] = np.where(visited[flat], 10, 0)
    return {
        "occupancy": occ,
        "enthalpy": features @ port.natural_parameters,
        "features": features,
        "entropy": entropy,
        "histogram": histogram,
        "occurrences": (histogram + rng.integers(0, 5, (W, num_levels))).astype(np.int32),
        "mean_features": rng.normal(size=(W, num_levels, features.shape[1])),
        "mod_factor": 2.0 ** -rng.integers(0, 5, W).astype(np.float64),
        "wl_counter": rng.integers(0, 12, W).astype(np.int32),
        "naccept": np.zeros(W, dtype=np.int32),
        "accepted": np.ones(W, dtype=bool),
    }


def test_one_step_equals_reference(nn, monkeypatch):
    port, _, window = nn
    # the window leaves out the top level, so some moves leave it
    window = dict(window, max_enthalpy=window["max_enthalpy"] - 2 * window["bin_size"])
    params = dict(flatness=0.8, check_period=3, update_period=2)
    ref_kernel = RefWangLandau(aucu_nn_ensemble(), "flip", **window, **params)
    port_kernel = WangLandau(port, "flip", **window, **params)
    num_levels = len(ref_kernel._levels)
    ref_step = ref_mc.make_wang_landau_step(
        _ref_propose, ref_kernel._device_applier(), window["min_enthalpy"],
        window["bin_size"], num_levels, mod_divisor=2.0, **params)
    port_step = port_mc.make_wang_landau_step(
        _port_propose, port_kernel._device_applier(), window["min_enthalpy"],
        window["bin_size"], mod_divisor=2.0, **params)
    monkeypatch.setattr(ref_mc, "_accept_metropolis", lambda key, exponent: exponent > THRESHOLD)
    monkeypatch.setattr(port_mc, "_accept_metropolis",
                        lambda generator, exponent: exponent > THRESHOLD)
    ref_step = jax.jit(ref_step)  # traced once, with the patched acceptance
    planes = _random_planes(port, num_levels, 64, seed=1)
    ref_state = {k: jnp.asarray(v) for k, v in planes.items()}
    port_state = {k: torch.as_tensor(v.copy()) for k, v in planes.items()}
    resets = updates = rejected = 0
    for k in range(6):
        before = port_state["histogram"].clone()
        ref_state = ref_step(ref_state, jax.random.key(k))
        port_state = port_step(port_state, torch.Generator().manual_seed(k))
        for name in ("occupancy", "histogram", "occurrences", "wl_counter", "naccept",
                     "accepted"):
            np.testing.assert_array_equal(port_state[name].numpy(),
                                          np.asarray(ref_state[name]), err_msg=name)
        for name in ("enthalpy", "features", "entropy", "mean_features", "mod_factor"):
            np.testing.assert_allclose(port_state[name].numpy(), np.asarray(ref_state[name]),
                                       rtol=0, atol=1e-12, err_msg=name)
        after = port_state["histogram"]
        resets += int(((after == 0).all(dim=1) & (before > 0).any(dim=1)).sum())
        updates += int((after > before).any(dim=1).sum())
        rejected += int((~port_state["accepted"]).sum())
    assert resets > 0 and updates > 0 and rejected > 0  # every branch was taken


def _exact_dos(entropy, energies, lo, bin_size):
    """Per walker, the largest |log-DOS estimate - exact| over the visited
    bins (both relative to the first)."""
    dos = np.bincount(np.floor((energies - lo) / bin_size).astype(int),
                      minlength=entropy.shape[1])
    visited = dos > 0
    assert np.all(entropy[:, visited] > 0) and np.all(entropy[:, ~visited] == 0)
    estimate = entropy[:, visited] - entropy[:, visited][:, :1]
    exact = np.log(dos[visited]) - np.log(dos[visited][0])
    return np.abs(estimate - exact).max(axis=1)


def test_table_flip_density_of_states():
    port = TorchEnsemble.from_system(load_system(data_path("limn_tiny_2x1x1")), "cpu")
    n = port.num_sites
    codes = {s: sl.encoding for sl in port.sublattices for s in sl.sites}
    states = np.array([bits for bits in product(*(codes[s] for s in range(n)))],
                      dtype=np.int32)
    charge = port.site_charges[np.arange(n), states].sum(axis=1)
    states = states[charge == 0]
    energies = (port.compute_features(torch.as_tensor(states))
                @ torch.as_tensor(port.natural_parameters)).numpy()
    # bins of 2 meV: 4 states on the lowest level, then one, then one
    bin_size = 0.002
    lo = float(energies.min() - bin_size / 2)
    bins = int(np.ceil((energies.max() - lo) / bin_size)) + 1
    W, nsteps = 16, 3000
    sampler = TorchSampler.from_ensemble(
        port, kernel_type="wang-landau", step_type="table-flip", nwalkers=W, seed=3,
        device="cpu", min_enthalpy=lo, max_enthalpy=lo + bins * bin_size,
        bin_size=bin_size, flatness=0.8, check_period=200)
    assert sampler.execution_path(nsteps // 4) == \
        "cpu-step[table-flip]+general+independent-proposals"
    sampler.run(nsteps, states[0], thin_by=nsteps // 4)
    occs = sampler.samples.get_occupancies()
    assert np.all(port.site_charges[np.arange(n), occs].sum(axis=1) == 0)
    entropy = sampler.samples.get_trace_value("entropy", flat=False)[-1]
    assert np.all(sampler._state["mod_factor"].numpy() < 1e-2)
    worst = _exact_dos(entropy, energies, lo, bin_size)
    assert np.all(worst < DOS_TOL), worst


def test_resume_from_container(nn):
    port, _, window = nn
    kwargs = dict(kernel_type="wang-landau", step_type="flip", nwalkers=2, seed=5,
                  device="cpu", check_period=100, shared_proposals=False, **window)
    sampler = TorchSampler.from_ensemble(port, **kwargs)
    occ0 = np.random.default_rng(3).integers(0, 2, (2, 8)).astype(np.int32)
    sampler.run(600, occ0, thin_by=200)
    samples = sampler.samples
    last_entropy = samples.get_trace_value("entropy", flat=False)[-1]
    last_mod = samples.get_trace_value("mod_factor", flat=False)[-1]
    fresh = TorchSampler.from_ensemble(port, **kwargs)
    resumed = TorchSampler(fresh.mckernel, samples, nwalkers=2)
    resumed.run(200, thin_by=200)
    np.testing.assert_array_equal(resumed._state["occupancy"].numpy().shape, (2, 8))
    entropy = samples.get_trace_value("entropy", flat=False)[-1]
    assert (entropy >= last_entropy).all() and entropy.sum() > last_entropy.sum()
    gained = entropy.sum(axis=1) - last_entropy.sum(axis=1)
    assert np.all(gained <= 200 * last_mod + 1e-9)  # from the restored mod_factor
    assert samples.num_samples == 4 and samples.num_aux_records == 2


@pytest.mark.parametrize("bias", ["fugacity-bias", "square-charge-bias"])
def test_bias_type_raises_value_error(nn, bias):
    port, _, window = nn
    subspace = ClusterSubspace.from_cutoffs(fcc_binary_prim(), {2: 2.8})
    coefs = np.zeros(subspace.num_corr_functions)
    coefs[-1] = 0.1
    built = TorchEnsemble.from_cluster_expansion(  # aucu_nn_ensemble, in the port
        ClusterExpansion(subspace, coefs), np.diag([2, 2, 2]), processor_type="expansion",
        chemical_potentials={"Au": 0.0, "Cu": 0.0}, device="cpu")
    with pytest.raises(ValueError, match="not a valid MCBias"):
        RefWangLandau(aucu_nn_ensemble(), "flip", **window, bias_type=bias)
    with pytest.raises(ValueError, match="not a valid MCBias"):
        WangLandau(built, "flip", **window, bias_type=bias)
    for step_type in ("multi-step", "composite"):
        options = ({"mcusher": "flip", "step_lengths": [1, 2]} if step_type == "multi-step"
                   else {"mcushers": ["flip", "swap"]})
        kernel = WangLandau(port, step_type, **window, **options)
        assert not kernel.runs_chain and kernel.make_step_fn() is not None
