"""The port's multicell kernel and its host sampler against smol_tpu's.

The reference's SQS generator offers, beside its walker-parallel search, a
sampler that hops one walker among the supercell shapes: a
``MulticellMetropolis`` over one kB = 1 Metropolis kernel a shape, run by
``Sampler.run`` on its host loop.  Here, on the CPU, with four of the
8-site shapes of bench ``sqs``'s cutoffs in the unnormalized sinusoid basis
(the port's processors exported from the reference's) and the same seeds.
The basis takes the values +-1, so every correlation is an exact sum and
both packages score symmetric-equivalent occupancies alike to the bit: a
swap between them changes the score by exactly 0 in both, and neither
draws for its accept.  (In the orthonormal indicator basis the two round
such a zero to opposite signs of 1e-17, and then one draws and the other
does not.)

- ``MulticellMetropolis.single_step`` equals the reference's over 1200
  steps: the kernel index, the occupancy and the accept flag at every step,
  the features within ``|diff| <= 1e-12 max(1, max |reference|)``;
- its ``ValueError``s are the reference's;
- ``Sampler.run`` on it fills the container as the reference's
  ``_run_host`` does (occupancies, kernel indices, accepts, features and
  enthalpies), and parity (e) holds: the recorded enthalpy equals features
  . theta to < 1e-9;
- ``StochasticSQSGenerator.sampler`` builds that sampler and runs.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from smol_tpu.benchmarks.systems import fcc_binary_prim
from smol_tpu.capp import StochasticSQSGenerator as RefGenerator
from smol_tpu.moca import Ensemble as RefEnsemble
from smol_tpu.moca.kernel.metropolis import Metropolis as RefMetropolis
from smol_tpu.moca.kernel.metropolis import UniformlyRandom as RefUniform
from smol_tpu.moca.kernel.multicell import MulticellKernel as RefMulticellKernel
from smol_tpu.moca.kernel.multicell import MulticellMetropolis as RefMulticell
from smol_tpu.moca.sampler.sampler import Sampler as RefSampler
from smol_tpu_torch.capp import StochasticSQSGenerator
from smol_tpu_torch.moca.ensemble import Ensemble
from smol_tpu_torch.moca.kernel import (
    Metropolis,
    MulticellKernel,
    MulticellMetropolis,
    UniformlyRandom,
)
from smol_tpu_torch.moca.processor.distance import CorrelationDistanceProcessor
from smol_tpu_torch.moca.sampler.sampler import Sampler
from smol_tpu_torch.system import export_distance_system

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from export_torch_systems import SQS_CUTOFFS  # noqa: E402

SHAPES = (0, 3, 7, 11)
TEMPERATURE = 2.0
TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _processors():
    """(reference processors, port processors on the CPU) of SHAPES."""
    refs = RefGenerator.from_structure(fcc_binary_prim(), SQS_CUTOFFS, supercell_size=8,
                                       basis="sinusoid", orthonormal=False).processors
    refs = [refs[s] for s in SHAPES]
    return refs, [CorrelationDistanceProcessor.from_system(export_distance_system(p), "cpu")
                  for p in refs]


@functools.lru_cache(maxsize=None)
def _other_size_processor(reference=False):
    """A 4-site shape of the same subspace (reference's, or the port's)."""
    ref = RefGenerator.from_structure(fcc_binary_prim(), SQS_CUTOFFS, supercell_size=4,
                                      basis="sinusoid", orthonormal=False).processors[0]
    if reference:
        return ref
    return CorrelationDistanceProcessor.from_system(export_distance_system(ref), "cpu")


def _multicells(seed=17, **kwargs):
    """(port multicell, reference multicell), kB = 1, the same seeds."""
    refs, ports = _processors()
    mine, theirs = [], []
    for i, (ref, port) in enumerate(zip(refs, ports)):
        kernel = Metropolis(Ensemble(port), "swap", TEMPERATURE, seed=seed + i)
        kernel.kB = 1.0
        mine.append(kernel)
        kernel = RefMetropolis(RefEnsemble(ref), "swap", TEMPERATURE, seed=seed + i)
        kernel.kB = 1.0
        theirs.append(kernel)
    port = MulticellMetropolis(mine, TEMPERATURE, seed=seed, **kwargs)
    ref = RefMulticell(theirs, TEMPERATURE, seed=seed, **kwargs)
    port.kB = ref.kB = 1.0
    return port, ref


def _start():
    return (np.arange(8) % 2).astype(np.int32)


def _close(mine, theirs):
    mine, theirs = np.asarray(mine, dtype=np.float64), np.asarray(theirs, dtype=np.float64)
    assert mine.shape == theirs.shape
    bound = TOL * max(1.0, float(np.abs(theirs).max(initial=0.0)))
    assert float(np.abs(mine - theirs).max(initial=0.0)) <= bound


def test_single_steps_equal_reference():
    mine, theirs = _multicells(kernel_hop_periods=[3, 5], kernel_hop_probabilities=[0.4, 0.6])
    mine_occ, theirs_occ = _start(), _start()
    mine.set_aux_state(mine_occ)
    theirs.set_aux_state(theirs_occ)
    hops = set()
    for _ in range(1200):
        trace = mine.single_step(mine_occ)
        expect = theirs.single_step(theirs_occ)
        assert int(trace.kernel_index) == int(expect.kernel_index)
        np.testing.assert_array_equal(mine_occ, theirs_occ)
        assert bool(trace.accepted) == bool(expect.accepted)
        _close(trace.delta_trace.features, expect.delta_trace.features)
        hops.add(int(trace.kernel_index))
    assert hops == set(range(len(SHAPES)))  # every shape was visited
    _close(mine._features, theirs._features)
    init = mine.compute_initial_trace(mine_occ)
    assert int(init.kernel_index[0]) == int(theirs.compute_initial_trace(
        theirs_occ).kernel_index[0])
    mine.temperature = 0.5  # retunes every kernel, as the reference's
    assert all(k.temperature == 0.5 for k in mine.mckernels)


def test_validation_errors_equal_reference():
    refs, ports = _processors()
    mine = [Metropolis(Ensemble(p), "swap", TEMPERATURE, seed=1) for p in ports]
    theirs = [RefMetropolis(RefEnsemble(p), "swap", TEMPERATURE, seed=1) for p in refs]
    mixed_mine = [mine[0], UniformlyRandom(Ensemble(ports[1]), "swap", seed=1)]
    mixed_theirs = [theirs[0], RefUniform(RefEnsemble(refs[1]), "swap", seed=1)]
    for cls, kernels in ((MulticellKernel, mixed_mine), (RefMulticellKernel, mixed_theirs)):
        with pytest.raises(ValueError, match="same type"):
            cls(kernels)
    small = Metropolis(Ensemble(_other_size_processor()), "swap", TEMPERATURE, seed=1)
    ref_small = RefMetropolis(RefEnsemble(_other_size_processor(True)), "swap", TEMPERATURE,
                              seed=1)
    for cls, kernels in ((MulticellMetropolis, [mine[0], small]),
                         (RefMulticell, [theirs[0], ref_small])):
        with pytest.raises(ValueError, match="same number of sites"):
            cls(kernels, TEMPERATURE)
    for kwargs, match in (
        ({"kernel_probabilities": [0.5, 0.6, 0.1, 0.1]}, "do not sum to 1"),
        ({"kernel_probabilities": [0.5, 0.5]}, "length must equal"),
        ({"kernel_hop_periods": [2, 3], "kernel_hop_probabilities": [0.5, 0.6]},
         "do not sum to 1"),
        ({"kernel_hop_periods": [2, 3], "kernel_hop_probabilities": [1.0]}, "do not match"),
    ):
        for cls, kernels in ((MulticellMetropolis, mine), (RefMulticell, theirs)):
            with pytest.raises(ValueError, match=match):
                cls(kernels, TEMPERATURE, **kwargs)
    mine_uniform = [UniformlyRandom(Ensemble(p), "swap", seed=1) for p in ports]
    ref_uniform = [RefUniform(RefEnsemble(p), "swap", seed=1) for p in refs]
    for cls, kernels in ((MulticellMetropolis, mine_uniform), (RefMulticell, ref_uniform)):
        with pytest.raises(ValueError, match="must be of type Metropolis"):
            cls(kernels, TEMPERATURE)


def test_sampler_run_fills_container_as_reference():
    mine, theirs = _multicells(seed=41)
    sampler = Sampler(mine, Sampler._empty_container(mine.mckernels[0].ensemble, mine, 1))
    ref_sampler = RefSampler(theirs, RefSampler._empty_container(
        theirs.mckernels[0].ensemble, theirs, 1))
    assert sampler.execution_path() == "host-single-step"
    sampler.run(600, _start()[None], thin_by=20)
    ref_sampler.run(600, _start()[None], thin_by=20)
    samples, expect = sampler.samples, ref_sampler.samples
    assert samples.num_samples == expect.num_samples == 30
    np.testing.assert_array_equal(samples.get_occupancies(), expect.get_occupancies())
    for name in ("kernel_index", "accepted"):
        np.testing.assert_array_equal(samples.get_trace_value(name),
                                      expect.get_trace_value(name))
    for name in ("features", "enthalpy", "accept_rate", "temperature"):
        _close(samples.get_trace_value(name), expect.get_trace_value(name))
    feats = samples.get_trace_value("features")
    parity = np.abs(feats @ samples.natural_parameters - samples.get_trace_value("enthalpy"))
    assert parity.max() < 1e-9
    # the host loop continues from the last record, and refuses streaming
    sampler.run(40, thin_by=20)
    assert samples.num_samples == 32
    with pytest.raises(ValueError, match="streaming"):
        sampler.run(20, thin_by=20, stream_chunk=5)


def test_generator_sampler_builds_and_runs():
    _, ports = _processors()
    generator = StochasticSQSGenerator.from_processors(ports, device="cpu")
    sampler = generator.sampler
    assert sampler is generator.sampler  # built once
    assert isinstance(sampler.mckernel, MulticellMetropolis)
    assert all(k.kB == 1.0 for k in sampler.mckernel.mckernels)
    sampler.run(200, _start()[None], thin_by=10)
    samples = sampler.samples
    index = samples.get_trace_value("kernel_index")
    exact = np.array([ports[k].compute_feature_vector(o)
                      for k, o in zip(index, samples.get_occupancies())])
    np.testing.assert_allclose(samples.get_trace_value("features"), exact, rtol=0, atol=1e-12)
    assert set(index.tolist()) <= set(range(len(ports)))
