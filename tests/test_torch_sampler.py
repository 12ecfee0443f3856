"""The port's Sampler on the CPU against smol_tpu's own CPU run.

On the bench spinel (2x2x2, bench chemical potentials, T = 1000 K, 256
walkers, fixed seeds):

- the port's mean enthalpy agrees with smol_tpu's within 5 combined
  standard errors.  The port shares proposal sequences within blocks of
  16 walkers, so its standard error comes from the 16 block means;
  smol_tpu's CPU path proposes independently per walker, so its standard
  error comes from the 256 walker means;
- every recorded enthalpy equals the recorded (lazily derived) features
  dotted with the natural parameters to < 1e-9 (parity e);
- the records stay on the run's device and the statistics match the
  host arrays they reduce.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from smol_tpu.moca import Sampler
from smol_tpu_torch.moca.ensemble import Ensemble as TorchEnsemble
from smol_tpu_torch.moca.ensemble import random_occupancies
from smol_tpu_torch.moca.sampler.sampler import Sampler as TorchSampler
from smol_tpu_torch.system import load_system

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from export_torch_systems import spinel_ensemble, system_path  # noqa: E402

W = 256
NSTEPS = 2000
THIN = 10
DISCARD = 50  # samples


def _initial(ensemble, seed=0):
    return random_occupancies(ensemble, W, seed)


@pytest.fixture(scope="module")
def port_run():
    ens = TorchEnsemble.from_system(load_system(system_path("2x2x2")), "cpu")
    sampler = TorchSampler.from_ensemble(
        ens, 1000.0, W, seed=3, device="cpu", chain_block_size=16
    )
    sampler.run(NSTEPS, _initial(ens), thin_by=THIN)
    return ens, sampler


def test_mean_enthalpy_matches_reference(port_run):
    _, sampler = port_run
    enth = sampler.samples.get_enthalpies(discard=DISCARD, flat=False)  # [S, W]
    block_means = enth.reshape(enth.shape[0], W // 16, 16).mean(axis=(0, 2))
    port_mean = float(sampler.samples.mean_enthalpy(discard=DISCARD))
    port_se = block_means.std(ddof=1) / np.sqrt(len(block_means))

    ref_ens = spinel_ensemble(2)
    ref = Sampler.from_ensemble(ref_ens, temperature=1000.0, nwalkers=W, seed=3)
    ref.run(NSTEPS, _initial(ref_ens), thin_by=THIN)
    ref_enth = np.asarray(ref.samples.get_enthalpies(discard=DISCARD, flat=False))
    walker_means = ref_enth.mean(axis=0)
    ref_mean = float(walker_means.mean())
    ref_se = walker_means.std(ddof=1) / np.sqrt(W)

    combined = np.hypot(port_se, ref_se)
    assert abs(port_mean - ref_mean) < 5 * combined, (port_mean, ref_mean, combined)
    eff = float(sampler.efficiency(discard=DISCARD))
    assert 0.0 < eff < 1.0


def test_recorded_enthalpy_equals_features_dot_theta(port_run):
    ens, sampler = port_run
    feats = sampler.samples.get_feature_vectors()
    enth = sampler.samples.get_enthalpies()
    assert feats.shape == (sampler.samples.num_samples * W, len(ens.natural_parameters))
    assert np.abs(feats @ ens.natural_parameters - enth).max() < 1e-9


def test_records_and_statistics(port_run):
    ens, sampler = port_run
    samples = sampler.samples
    assert samples.num_samples == NSTEPS // THIN
    assert sampler.execution_path(THIN) == "cpu-twin[flip]+direct+shared-proposals"
    occ = samples.get_occupancies(discard=DISCARD, flat=False)
    assert occ.shape == (NSTEPS // THIN - DISCARD, W, ens.num_sites)
    enth = samples.get_enthalpies(discard=DISCARD)
    np.testing.assert_allclose(samples.mean_enthalpy(discard=DISCARD), enth.mean(), rtol=1e-12)
    np.testing.assert_allclose(
        samples.enthalpy_variance(discard=DISCARD), enth.var(), rtol=1e-10
    )
    assert samples.get_minimum_enthalpy(discard=DISCARD) == enth.min()
    per_walker = samples.mean_enthalpy(discard=DISCARD, flat=False)
    assert per_walker.shape == (W,)
    feats = samples.get_feature_vectors(discard=DISCARD)
    ncoef = ens.num_energy_coefs
    np.testing.assert_allclose(
        samples.mean_energy(discard=DISCARD),
        (feats[:, :ncoef] @ ens.natural_parameters[:ncoef]).mean(),
        rtol=1e-12,
    )
    temps = samples.get_trace_value("temperature")
    np.testing.assert_allclose(temps, 1000.0, rtol=1e-12)
    for batch in samples._batches:
        assert all(v.device.type == "cpu" for v in batch.values())


def test_restored_traces_are_filled(port_run):
    """A container restored with features serves them without recomputing."""
    from smol_tpu_torch.moca.sampler.container import SampleContainer

    ens, sampler = port_run
    names = sampler.samples.traced_values
    traces = {
        name: sampler.samples.get_trace_value(name, discard=190, flat=False)
        for name in names
    }
    restored = SampleContainer(ens, names, traces=traces)

    def never(_):
        raise AssertionError("restored features were recomputed")

    restored.set_derived_value("features", never)
    np.testing.assert_array_equal(
        restored.get_feature_vectors(), sampler.samples.get_feature_vectors(discard=190)
    )
    assert restored.num_samples == 10


def test_continue_run_and_seed_reproducibility(port_run):
    ens, _ = port_run
    runs = []
    for _ in range(2):
        s = TorchSampler.from_ensemble(ens, 1000.0, 8, seed=11, device="cpu")
        s.run(40, _initial(ens)[:8], thin_by=20)
        s.run(40, thin_by=20)  # continues from the current state
        runs.append(s.samples.get_occupancies())
    assert runs[0].shape == (4 * 8, ens.num_sites)
    np.testing.assert_array_equal(runs[0], runs[1])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        s.run(20, thin_by=20, stream_chunk=5)
    occ = torch.as_tensor(_initial(ens)[:8])
    assert not torch.equal(occ, torch.as_tensor(runs[0][-8:]))


def test_run_leaves_initial_occupancies_untouched(port_run):
    """The walker state is a copy: a run repeats from the same array."""
    ens, _ = port_run
    occ0 = _initial(ens)[:8]
    before = occ0.copy()
    runs = []
    for _ in range(2):
        s = TorchSampler.from_ensemble(ens, 1000.0, 8, seed=5, device="cpu")
        s.run(40, occ0, thin_by=20)
        runs.append(s.samples.get_enthalpies())
    np.testing.assert_array_equal(occ0, before)
    np.testing.assert_array_equal(runs[0], runs[1])


@pytest.mark.parametrize("pool", [True, False])
def test_reductions_match_numpy(pool):
    """The four segment reductions equal numpy on the concatenated rows."""
    from smol_tpu_torch.ops import reductions

    rng = np.random.default_rng(0)
    parts = [rng.normal(size=(5, 4)), rng.normal(size=(3, 4))]
    masks = [np.array([0, 1, 1, 0, 1], bool), np.array([1, 0, 1], bool)]
    segments = [torch.as_tensor(p) for p in parts]
    rows = sum(int(m.sum()) for m in masks)
    picked = np.concatenate([p[m] for p, m in zip(parts, masks)])
    axis = (0, 1) if pool else 0
    mean, var, low = reductions.masked_stats_segments(segments, masks, rows, pool)
    np.testing.assert_allclose(mean, picked.mean(axis=axis), rtol=1e-13)
    np.testing.assert_allclose(var, picked.var(axis=axis), rtol=1e-12)
    np.testing.assert_array_equal(low, picked.min(axis=axis))
    np.testing.assert_allclose(
        reductions.masked_mean_segments(segments, masks, rows, pool),
        picked.mean(axis=axis), rtol=1e-13,
    )
    np.testing.assert_allclose(
        reductions.masked_sqdev_segments(segments, masks, rows, mean, pool),
        picked.var(axis=axis), rtol=1e-12,
    )
    np.testing.assert_array_equal(
        reductions.masked_min_segments(segments, masks, pool), picked.min(axis=axis)
    )
