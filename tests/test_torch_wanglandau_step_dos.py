"""The port's per-step Wang-Landau against the exact density of states and
the exact mean features.

The 8-site Au-Cu (``torch_aucu_nn_2x2x2.npz``, 256 states, 9 levels of
nearest-neighbour energy) with independent proposals, so on the per-step
path (``ops/mc.py:make_wang_landau_step``), 64 walkers x 8000 steps, one
run for both tests:

- the walkers' mean log-DOS is within 0.25 of the exact degeneracies at
  every level, and the median walker's within 0.5 (the limit of the K6
  chain's density of states on the card).  Sound runs leave the mean 0.01
  to 0.11 off (12 seeds on the CPU); a sampler that breaks detailed balance
  is off at every walker alike (the reference's per-step table-flip
  Wang-Landau, which leaves out the a-priori factor, by 0.72, ROADMAP.md
  Queue 3 C10).  A single walker of a short run may be off by more than
  0.5, through the levels it found late (the K6 check holds every walker to
  0.5 after 200000 steps);
- the per-step mean-feature estimator (``occurrences`` as its count) is
  within the reference's own limit of the exact conditional means
  (``tests/test_moca/test_wanglandau.py:346``); the within-bin distribution
  is uniform whatever the entropy, so the run's length is enough.

Split from ``tests/test_torch_wanglandau_step.py`` so that ``--dist
loadfile`` runs it on a worker of its own.
"""

import sys
from itertools import product
from pathlib import Path

import numpy as np
import pytest
import torch

from smol_tpu_torch.moca.ensemble import Ensemble as TorchEnsemble
from smol_tpu_torch.moca.sampler.sampler import Sampler as TorchSampler
from smol_tpu_torch.system import load_system

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from export_torch_systems import data_path  # noqa: E402

MEAN_DOS_TOL = 0.25  # on the walkers' mean log-DOS
DOS_TOL = 0.5  # on the median walker's log-DOS
W, NSTEPS = 64, 8000


@pytest.fixture(scope="module")
def run():
    """The run both tests read, on one torch thread: the per-step path's
    small operations run no faster on more, and far slower when the test
    workers' threads oversubscribe the cores.  (port ensemble, its file,
    the window's lower edge and bin, the sampler)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _run()
    finally:
        torch.set_num_threads(threads)


def _run():
    system = load_system(data_path("aucu_nn_2x2x2"))
    port = TorchEnsemble.from_system(system, "cpu")
    levels = np.unique(np.round(system["exact_enthalpies"], 9))
    bin_size = float(levels[1] - levels[0])
    lo = float(levels[0] - bin_size / 2)
    sampler = TorchSampler.from_ensemble(
        port, kernel_type="wang-landau", step_type="flip", nwalkers=W, seed=9,
        device="cpu", flatness=0.7, check_period=250, shared_proposals=False,
        min_enthalpy=lo, max_enthalpy=float(levels[-1] + bin_size), bin_size=bin_size)
    assert not sampler.mckernel.runs_chain
    assert sampler.execution_path(NSTEPS // 4) == \
        "cpu-step[flip]+general+independent-proposals"
    occ0 = np.random.default_rng(0).integers(0, 2, (W, 8)).astype(np.int32)
    sampler.run(NSTEPS, occ0, thin_by=NSTEPS // 4)
    return port, system, lo, bin_size, sampler


def test_independent_proposals_density_of_states(run):
    port, system, lo, bin_size, sampler = run
    entropy = sampler.samples.get_trace_value("entropy", flat=False)[-1]
    dos = np.bincount(np.floor((system["exact_enthalpies"] - lo) / bin_size).astype(int),
                      minlength=entropy.shape[1])
    visited = dos > 0
    assert np.all(entropy[:, visited] > 0) and np.all(entropy[:, ~visited] == 0)
    estimate = entropy[:, visited] - entropy[:, visited][:, :1]
    exact = np.log(dos[visited]) - np.log(dos[visited][0])
    assert np.abs(estimate.mean(axis=0) - exact).max() < MEAN_DOS_TOL
    assert np.median(np.abs(estimate - exact).max(axis=1)) < DOS_TOL
    np.testing.assert_array_equal(sampler._state["wl_counter"].numpy(), NSTEPS)
    feats = sampler.samples.get_feature_vectors()
    assert np.abs(feats @ port.natural_parameters
                  - sampler.samples.get_enthalpies()).max() < 1e-9


def test_independent_proposals_mean_features(run):
    """The per-step estimator: each bin's mean features against the exact
    conditional means over its states (the reference's test and limits)."""
    port, system, lo, bin_size, sampler = run
    samples = sampler.samples
    occurrences = samples.get_trace_value("occurrences", flat=False)[-1]
    np.testing.assert_array_equal(occurrences.sum(axis=1), NSTEPS)
    assert np.all(samples.get_trace_value("cumulative_mean_counts") == 0)  # the chain's
    states = np.array(list(product((0, 1), repeat=8)), dtype=np.int32)
    exact_f = port.compute_features(torch.as_tensor(states)).numpy()
    bins = np.floor((system["exact_enthalpies"] - lo) / bin_size).astype(int)
    mean = samples.get_trace_value("cumulative_mean_features", flat=False)[-1]
    checked = 0
    for b in np.unique(bins):
        ok = occurrences[:, b] >= 30
        if ok.sum() < 2:
            continue
        err = np.abs(mean[ok, b].mean(axis=0) - exact_f[bins == b].mean(axis=0)).max()
        assert err < 0.15, (b, err)
        checked += 1
    assert checked >= 4
