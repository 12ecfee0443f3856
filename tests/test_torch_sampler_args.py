"""The port's ``Sampler.run`` and ``from_ensemble`` take the reference's arguments.

``run`` has ``smol_tpu``'s parameters in ``smol_tpu``'s order
(``smol_tpu/moca/sampler/sampler.py:348-361``), so a positional call means
the same in both packages: ``run(10, occ, 10, True)`` asks for progress,
which prints one line a launch of windows on the host.  HDF5 streaming
(``stream_chunk``, ``stream_file``, ``keep_last_chunk``, ``swmr_mode``) and
``profile_dir`` are not ported and raise ``NotImplementedError`` naming
ROADMAP.md Queue 1 item 6; ``from_ensemble(..., seeds=...)`` takes the
first seed, as the reference does.
"""

import inspect
from pathlib import Path

import numpy as np
import pytest

from smol_tpu.moca.sampler.sampler import Sampler as RefSampler

from smol_tpu_torch.moca.ensemble import Ensemble
from smol_tpu_torch.moca.sampler.sampler import Sampler
from smol_tpu_torch.system import load_system

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture(scope="module")
def ensemble():
    """The bench spinel's semigrand 2x2x2 file (flips)."""
    return Ensemble.from_system(load_system(DATA / "torch_spinel_2x2x2.npz"), "cpu")


def _start(ensemble, walkers):
    codes = np.ones(ensemble.num_sites, dtype=np.int64)
    for sl in ensemble.sublattices:
        codes[sl.sites] = len(sl.encoding)
    rng = np.random.default_rng(0)
    return (rng.random((walkers, ensemble.num_sites)) * codes).astype(np.int32)


def test_run_takes_the_reference_parameters_in_order():
    mine = list(inspect.signature(Sampler.run).parameters.items())
    theirs = list(inspect.signature(RefSampler.run).parameters.items())
    assert [name for name, _ in mine] == [name for name, _ in theirs]
    assert [p.default for _, p in mine] == [p.default for _, p in theirs]


def test_positional_progress_prints_each_launch(ensemble, capsys):
    """``run(10, occ, 10, True)``: the fourth argument is ``progress``."""
    sampler = Sampler.from_ensemble(ensemble, 1000.0, 4, seed=2, device="cpu")
    sampler.run(40, _start(ensemble, 4), 10, True, samples_per_launch=2)
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(" (")[0] for line in lines] == ["sampled 2/4", "sampled 4/4"]
    assert all("M attempts/s" in line for line in lines)
    assert sampler.samples.num_samples == 4
    quiet = Sampler.from_ensemble(ensemble, 1000.0, 4, seed=2, device="cpu")
    quiet.run(40, _start(ensemble, 4), 10, False, samples_per_launch=2)
    assert capsys.readouterr().out == ""
    np.testing.assert_array_equal(quiet.samples.get_occupancies(),
                                  sampler.samples.get_occupancies())


@pytest.mark.parametrize("option", [
    {"stream_chunk": 2}, {"stream_file": "samples.h5"}, {"keep_last_chunk": True},
    {"swmr_mode": True}, {"profile_dir": "profile"},
])
def test_streaming_and_profiling_name_their_item(ensemble, option):
    sampler = Sampler.from_ensemble(ensemble, 1000.0, 2, seed=2, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        sampler.run(10, _start(ensemble, 2), **option)
    assert sampler.samples.num_samples == 0


def test_seeds_name_their_item(ensemble):
    """``seeds``: the first seeds the one kernel where ``seed`` is None, as in
    the reference; the device is checked as before."""
    sampler = Sampler.from_ensemble(ensemble, 1000.0, 2, device="cpu", seeds=[1, 2])
    assert sampler.seeds == [1] and sampler.mckernel.seed == 1
    assert sampler.mckernels == [sampler.mckernel] and sampler.nwalkers == 2
    seeded = Sampler.from_ensemble(ensemble, 1000.0, 2, device="cpu", seed=1)
    for s in (sampler, seeded):
        s.run(20, _start(ensemble, 2), thin_by=10)
    np.testing.assert_array_equal(sampler.samples.get_occupancies(),
                                  seeded.samples.get_occupancies())
    assert Sampler.from_ensemble(ensemble, 1000.0, 2, device="cpu", seed=5,
                                 seeds=[1, 2]).seeds == [5]
    with pytest.raises(ValueError, match="lives on"):
        Sampler.from_ensemble(ensemble, 1000.0, 2, device="meta", seeds=[1, 2])
