"""The port's SampleContainer getters against smol_tpu's on the same traces.

A port run of bench ``spinel`` 2x2x2 (semigrand, 6 walkers, records in
three launches of device batches) gives the traces; the reference's
``SampleContainer`` is filled with the same recorded arrays.  Every getter
of the reference's API (``smol_tpu/moca/sampler/container.py:127-450``)
then gives the same values, integers exactly and f64 within 1e-12
(relative to the values' scale), with ``discard``, ``thin_by`` and
``flat`` varied: ``total_mc_steps``, ``shape``, ``get_energies``,
``get_orbit_factors``, ``energy_variance``, ``mean_feature_vector``,
``feature_vector_variance``, ``get_minimum_energy`` and both minimum
occupancies, each sublattice's and the total species counts and
compositions with their means and variances, and ``get_sampled_structures``
(species and fractional coordinates).  ``as_dict``/``from_dict`` round
trip, the port's record with and without its ensemble and the reference's
record into the port; ``vacuum`` leaves one host batch that reads the same.
"""

import json

import numpy as np
import pytest
import torch

from smol_tpu.moca.sampler.container import SampleContainer as RefContainer
from smol_tpu.moca.trace import Trace
from smol_tpu.serial import SmolJSONEncoder

from smol_tpu_torch.benchmarks.systems import random_expansion, spinel_prim
from smol_tpu_torch.moca.ensemble import Ensemble
from smol_tpu_torch.moca.sampler.container import SampleContainer
from smol_tpu_torch.moca.sampler.sampler import Sampler
from smol_tpu_torch.serial import SmolJSONEncoder as PortEncoder

SPINEL_MUS = {"Li+": 0.1, "vacA0+": 0.0, "Mn3+": 0.05, "Mn4+": 0.0}
REL_TOL = 1e-12
SELECTIONS = [(0, 1, True), (2, 3, False), (5, 1, True)]
W, THIN, NSTEPS = 6, 10, 120


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
def containers():
    """(port sampler, port container, reference container, reference ensemble)."""
    import smol_tpu.benchmarks.systems as ref_systems
    from smol_tpu.moca import Ensemble as RefEnsemble

    mine = Ensemble.from_cluster_expansion(
        random_expansion(spinel_prim(), {2: 5.3, 3: 3.7}, seed=11), np.diag([2, 2, 2]),
        chemical_potentials=SPINEL_MUS, device="cpu")
    theirs = RefEnsemble.from_cluster_expansion(
        ref_systems.random_expansion(ref_systems.spinel_prim(), {2: 5.3, 3: 3.7}, seed=11),
        np.diag([2, 2, 2]), chemical_potentials=SPINEL_MUS)
    sampler = Sampler.from_ensemble(mine, 1000.0, W, seed=3, device="cpu")
    occ0 = np.zeros((W, mine.num_sites), dtype=np.int32)
    rng = np.random.default_rng(1)
    for sl in mine.sublattices:
        occ0[:, sl.sites] = rng.choice(sl.encoding, (W, len(sl.sites)))
    sampler.run(NSTEPS, occ0, thin_by=THIN, samples_per_launch=5)  # batches of 5, 5, 2
    port = sampler.samples
    assert len(port._batches) == 3
    traces = {name: port.get_trace_value(name, flat=False) for name in port.traced_values}
    ref = RefContainer(theirs, Trace(**{k: np.empty((0, *v.shape[1:]), v.dtype)
                                        for k, v in traces.items()}),
                       theirs.thermo_boundaries)
    ref.save_sampled_traces(Trace(**traces), thinned_by=THIN)
    return sampler, port, ref, theirs


def _same(mine, theirs, what):
    mine, theirs = np.asarray(mine), np.asarray(theirs)
    assert mine.shape == theirs.shape, what
    if np.issubdtype(theirs.dtype, np.integer) or theirs.dtype == bool:
        np.testing.assert_array_equal(mine, theirs, err_msg=what)
    else:
        scale = max(1.0, float(np.abs(theirs).max(initial=0.0)))
        assert float(np.abs(mine - theirs).max(initial=0.0)) <= REL_TOL * scale, what


def _same_dicts(mine, theirs, what):
    assert sorted(map(str, mine)) == sorted(map(str, theirs)), what
    ref = {str(k): v for k, v in theirs.items()}
    for key, value in mine.items():
        _same(value, ref[str(key)], f"{what}[{key}]")


def _getters_agree(mine, theirs, mine_subl, their_subl, orbit_ids):
    assert mine.shape == theirs.shape == (W, 112)
    assert mine.total_mc_steps == theirs.total_mc_steps == NSTEPS
    for discard, thin, flat in SELECTIONS:
        args = dict(discard=discard, thin_by=thin, flat=flat)
        what = f"({discard}, {thin}, {flat})"
        for name in ("get_energies", "energy_variance", "mean_feature_vector",
                     "feature_vector_variance", "get_minimum_energy",
                     "get_minimum_enthalpy_occupancy", "get_minimum_energy_occupancy",
                     "get_enthalpies", "get_occupancies", "mean_enthalpy",
                     "enthalpy_variance", "mean_energy", "get_minimum_enthalpy"):
            _same(getattr(mine, name)(**args), getattr(theirs, name)(**args), name + what)
        _same(mine.get_orbit_factors(orbit_ids, **args),
              theirs.get_orbit_factors(orbit_ids, **args), "get_orbit_factors" + what)
        for ms, ts in zip(mine_subl, their_subl):
            for name in ("get_sublattice_species_counts", "get_sublattice_compositions",
                         "mean_sublattice_composition", "sublattice_composition_variance"):
                _same(getattr(mine, name)(ms, **args), getattr(theirs, name)(ts, **args),
                      name + what)
        for name in ("get_species_counts", "get_compositions", "mean_composition",
                     "composition_variance"):
            _same_dicts(getattr(mine, name)(**args), getattr(theirs, name)(**args),
                        name + what)


def test_getters_equal_reference(containers):
    _, port, ref, theirs = containers
    n_features = len(port.natural_parameters)
    orbit_ids = np.arange(n_features) % 4
    _getters_agree(port, ref, port.sublattices, ref.sublattices, orbit_ids)
    with pytest.raises(ValueError, match="not recognized"):
        port.get_sublattice_species_counts(ref.sublattices[0])


def test_sampled_structures_equal_reference(containers):
    _, port, ref, _ = containers
    indices = [0, 7, W * 12 - 1]
    for mine, theirs in zip(port.get_sampled_structures(indices),
                            ref.get_sampled_structures(indices)):
        assert [str(s.specie) for s in mine] == [str(s.specie) for s in theirs]
        np.testing.assert_allclose(mine.frac_coords, theirs.frac_coords, rtol=0, atol=1e-12)
        np.testing.assert_allclose(mine.lattice.matrix, theirs.lattice.matrix, rtol=1e-12)


def test_records_round_trip(containers):
    sampler, port, ref, theirs = containers
    orbit_ids = np.arange(len(port.natural_parameters)) % 4
    mine_doc = json.loads(json.dumps(port.as_dict(), cls=PortEncoder))
    assert len(port._batches) == 1  # vacuum: one host batch
    assert all(v.device.type == "cpu" for v in port._batches[0].values())
    _getters_agree(port, ref, port.sublattices, ref.sublattices, orbit_ids)
    assert set(mine_doc) == set(ref.as_dict())
    for doc, ensemble in ((mine_doc, sampler.mckernel.ensemble), (mine_doc, None),
                          (json.loads(json.dumps(ref.as_dict(), cls=SmolJSONEncoder)), None)):
        back = SampleContainer.from_dict(doc, ensemble=ensemble)
        assert back.num_samples == port.num_samples
        assert back.metadata.cls_name == "SampleContainer"
        _getters_agree(back, ref, back.sublattices, ref.sublattices, orbit_ids)
        assert (back.ensemble is None) == (ensemble is None)
