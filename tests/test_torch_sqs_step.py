"""The SQS search off the distance chain: the per-step path, against smol_tpu.

Where the reference's distance chain refuses a shape (another step type
than swaps, the cluster-interaction distance, tables over its 8 MB budget,
a restricted sublattice) its generator anneals that shape on its per-step
path, and so does the port's.  Here, on the CPU:

- the distance processors' batched ``delta_energy`` and ``delta_features``
  (two full evaluations a flip) equal the reference's ``delta_energy_fn``
  and ``delta_features_fn`` on random flips, for the correlation and the
  cluster-interaction distance, on a binary and a ternary FCC 2x2x2; the
  cluster-interaction features equal the reference's ``compute_feature_
  vector``; tolerance ``|diff| <= 1e-12 max(1, max |reference|)``;
- the choice of path equals the reference's ``build_distance_tables``
  (tables or None) on bench ``sqs``'s 20 8-site shapes (tables), on a
  shape of ``sqs-ternary12-step`` (Au-Ag-Cu FCC ``{2: 7, 3: 5}`` at size
  12, 60 features: over the budget, None) and on a restricted sublattice
  (None); ``tests/test_torch_sqs_wide.py`` holds it on ``sqs-fcc8-wide``
  (tables, 41 features);
- per-step ``generate`` with swaps (on the cluster-interaction distance)
  keeps every composition, with flips it does not have to; both run on the
  per-step path (``cpu-step``) and store scores equal to exact rescores,
  never behind a walker's start; a batch of shapes mixing both paths
  reports ``mixed:``;
- on one 8-site shape of bench ``sqs``'s cutoffs with the
  cluster-interaction distance (swaps, per step in both packages), every
  walker of both packages' searches reaches the optimum found by
  enumerating the 70 half-filled occupancies.
"""

import functools
import sys
from itertools import combinations
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smol_tpu.benchmarks.systems import fcc_binary_prim, fcc_ternary_prim
from smol_tpu.capp import StochasticSQSGenerator as RefGenerator
from smol_tpu.cofe import ClusterSubspace
from smol_tpu.moca.processor.distance import ClusterInteractionDistanceProcessor as RefCI
from smol_tpu.moca.processor.distance import CorrelationDistanceProcessor as RefCD
from smol_tpu.ops import pallas_sqs
from smol_tpu_torch.benchmarks.systems import fcc_binary_prim as port_binary
from smol_tpu_torch.benchmarks.systems import fcc_ternary_prim as port_ternary
from smol_tpu_torch.capp import StochasticSQSGenerator
from smol_tpu_torch.cofe import ClusterSubspace as PortSubspace
from smol_tpu_torch.moca.processor.distance import (
    ClusterInteractionDistanceProcessor,
    CorrelationDistanceProcessor,
)
from smol_tpu_torch.ops import sqs
from smol_tpu_torch.system import export_distance_system, load_systems

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from export_torch_systems import SQS_CUTOFFS, data_path, sqs_generator  # noqa: E402

TOL = 1e-12
TERNARY_CUTOFFS = {2: 7.0, 3: 5.0}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(mine, theirs):
    mine, theirs = np.asarray(mine, dtype=np.float64), np.asarray(theirs, dtype=np.float64)
    assert mine.shape == theirs.shape
    bound = TOL * max(1.0, float(np.abs(theirs).max(initial=0.0)))
    assert float(np.abs(mine - theirs).max(initial=0.0)) <= bound


PRIMS = {"binary": (fcc_binary_prim, port_binary, {2: 5.0, 3: 3.5}),
         "ternary": (fcc_ternary_prim, port_ternary, {2: 4.0, 3: 3.0})}


@functools.lru_cache(maxsize=None)
def _pair(kind, system):
    """(reference processor, port processor on the CPU) on FCC 2x2x2."""
    ref_prim, port_prim, cutoffs = PRIMS[system]
    scm = np.diag([2, 2, 2])
    ref_space = ClusterSubspace.from_cutoffs(ref_prim(), cutoffs)
    if kind == "correlation":
        ref = RefCD(ref_space, scm)
        return ref, CorrelationDistanceProcessor.from_system(export_distance_system(ref), "cpu")
    port_space = PortSubspace.from_cutoffs(port_prim(), cutoffs)
    return RefCI(ref_space, scm), ClusterInteractionDistanceProcessor(port_space, scm,
                                                                      device="cpu")


@pytest.mark.parametrize("system", sorted(PRIMS))
@pytest.mark.parametrize("kind", ["correlation", "cluster-interaction"])
def test_batched_deltas_equal_reference(kind, system):
    ref, port = _pair(kind, system)
    rng = np.random.default_rng(3)
    codes = np.array([len(sp) for sp in ref.allowed_species])
    W = 24
    occ = (rng.random((W, ref.num_sites)) * codes).astype(np.int32)
    sites = rng.integers(0, ref.num_sites, W)
    new = np.array([rng.integers(codes[s]) for s in sites])
    expect_e = jax.vmap(lambda o, s, c: ref.delta_energy_fn(o, s, c, None))(
        jnp.asarray(occ), jnp.asarray(sites, dtype=jnp.int32), jnp.asarray(new, dtype=jnp.int32))
    expect_f = jax.vmap(lambda o, s, c: ref.delta_features_fn(o, s, c, None))(
        jnp.asarray(occ), jnp.asarray(sites, dtype=jnp.int32), jnp.asarray(new, dtype=jnp.int32))
    args = (torch.as_tensor(occ), torch.as_tensor(sites), torch.as_tensor(new))
    _close(port.delta_energy(*args).numpy(), np.asarray(expect_e))
    _close(port.delta_features(*args).numpy(), np.asarray(expect_f))
    _close(port.compute_features(torch.as_tensor(occ)).numpy(),
           np.stack([ref.compute_feature_vector(o) for o in occ]))
    for o in occ[:4]:
        _close(port.compute_feature_vector(o), ref.compute_feature_vector(o))
        step = [(0, int((o[0] + 1) % codes[0])), (5, int((o[5] + 1) % codes[5]))]
        _close(port.compute_feature_vector_change(o, step),
               ref.compute_feature_vector_change(o, step))
    if kind == "cluster-interaction":
        doc = port.as_dict()
        again = ClusterInteractionDistanceProcessor.from_dict(doc, device="cpu")
        _close(again.compute_features(torch.as_tensor(occ)).numpy(),
               port.compute_features(torch.as_tensor(occ)).numpy())
        np.testing.assert_array_equal(doc["target_vector"], ref.as_dict()["target_vector"])


def _reference_shape(prim, cutoffs, size, scm):
    """The reference generator's processor of one supercell shape."""
    return RefGenerator.from_structure(prim(), cutoffs, supercell_size=size,
                                       supercell_matrices=[scm]).processors[0]


def _path_pairs():
    refs = sqs_generator("sqs_fcc8").processors
    ports = [CorrelationDistanceProcessor.from_system(s, "cpu")
             for s in load_systems(data_path("sqs_fcc8"))]
    pairs = list(zip(refs, ports))
    ternary = _reference_shape(fcc_ternary_prim, TERNARY_CUTOFFS, 12, np.diag([3, 2, 2]))
    pairs.append((ternary, CorrelationDistanceProcessor.from_system(
        export_distance_system(ternary), "cpu")))
    return pairs


def test_path_choice_equals_reference():
    pairs = _path_pairs()
    chosen = []
    for ref, port in pairs:
        theirs = pallas_sqs.build_distance_tables(ref, ref.get_sublattices())
        mine = sqs.build_distance_tables(port)
        assert (mine is None) == (theirs is None)
        chosen.append(mine is not None)
        if mine is not None:
            assert mine.num_feats == theirs.num_feats
            np.testing.assert_array_equal(mine.feature_ids, theirs.perm)
    assert chosen == [True] * 20 + [False]  # the bench's shapes; the ternary's
    ternary = pairs[-1][1]
    assert len(ternary.target_vector) - 1 == 60  # its 60 features took no part in it
    # a restricted sublattice: no tables in either package
    ref, port = pairs[0]
    sublattices = ref.get_sublattices()
    sublattices[0].restrict_sites(sublattices[0].sites[:1])
    assert pallas_sqs.build_distance_tables(ref, sublattices) is None
    restricted = CorrelationDistanceProcessor.from_system(port.system, "cpu")
    restricted.get_sublattices()[0].active_sites = restricted.get_sublattices()[0].sites[1:]
    assert sqs.build_distance_tables(restricted) is None


def _bench_ports(count):
    systems = load_systems(data_path("sqs_fcc8"))[:count]
    return [CorrelationDistanceProcessor.from_system(s, "cpu") for s in systems]


def _held(generator, canonical):
    """Compositions (canonical) and exact stored scores of a finished search."""
    for rec in generator.stage_records:
        proc = generator.processors[rec["shape"]]
        if canonical:
            assert torch.all(rec["occupancy"].sum(dim=1) == proc.num_sites // 2)
    for (shape, occupancies, scores, _), start in zip(generator._best,
                                                      generator.start_scores):
        proc = generator.processors[shape]
        exact = proc.compute_scores(torch.as_tensor(occupancies)).numpy()
        assert np.abs(exact - scores).max() < 1e-12
        assert np.all(scores <= start.numpy() + 1e-12)  # never loses ground


def test_per_step_generate_keeps_its_invariants():
    space = PortSubspace.from_cutoffs(port_binary(), SQS_CUTOFFS)
    scms = [p.supercell_matrix for p in _bench_ports(2)]
    interaction = StochasticSQSGenerator.from_processors(
        [ClusterInteractionDistanceProcessor(space, scm, use_concentration=True, device="cpu")
         for scm in scms], device="cpu")
    interaction.generate(mcmc_steps=60, temperatures=[2.0, 0.2], nwalkers=8, seed=5)
    assert interaction.execution_path == "cpu-step"
    _held(interaction, canonical=True)
    with pytest.warns(UserWarning, match="Step type flip"):
        flips = StochasticSQSGenerator.from_processors(_bench_ports(2), device="cpu",
                                                       step_type="flip")
    flips.generate(mcmc_steps=60, temperatures=[2.0, 0.2], nwalkers=8, seed=5)
    assert flips.execution_path == "cpu-step"
    _held(flips, canonical=False)
    changed = any(bool(torch.any(rec["occupancy"].sum(dim=1) != 4))
                  for rec in flips.stage_records)
    assert changed  # flips move the composition
    # a restricted shape beside an unrestricted one: the two paths
    ports = _bench_ports(2)
    sublattice = ports[1].get_sublattices()[0]
    sublattice.active_sites = sublattice.sites[1:]
    mixed = StochasticSQSGenerator.from_processors(ports, device="cpu")
    mixed.generate(mcmc_steps=20, temperatures=[1.0], nwalkers=4, seed=2)
    assert mixed.execution_path == "mixed:cpu-step,cpu-twin[distance]"
    _held(mixed, canonical=True)


def test_every_walker_reaches_enumerated_optimum():
    """Swaps on the cluster-interaction distance, which the reference's
    chain refuses: both packages' searches run per step, and every walker
    ends at the least score of the 70 half-filled occupancies."""
    scm = _bench_ports(4)[3].supercell_matrix
    mine = StochasticSQSGenerator.from_structure(
        port_binary(), SQS_CUTOFFS, 8, feature_type="cluster-interaction",
        supercell_matrices=[scm], device="cpu")
    ref = RefGenerator.from_structure(fcc_binary_prim(), SQS_CUTOFFS, supercell_size=8,
                                      feature_type="cluster-interaction",
                                      supercell_matrices=[scm])
    halves = np.zeros((70, 8), dtype=np.int32)
    for i, ones in enumerate(combinations(range(8), 4)):
        halves[i, list(ones)] = 1
    scores = mine.processors[0].compute_scores(torch.as_tensor(halves)).numpy()
    _close(scores, [ref.processors[0].compute_property(o) for o in halves])
    optimum = float(scores.min())
    temperatures = np.linspace(2.0, 0.05, 4)
    mine.generate(mcmc_steps=100, temperatures=temperatures, nwalkers=16, seed=7)
    ref.generate(mcmc_steps=100, temperatures=temperatures, nwalkers=16, seed=7)
    assert ref.execution_path == "xla-step" and mine.execution_path == "cpu-step"
    assert np.all(np.abs(mine._best[0][2] - optimum) <= 1e-9)
    assert all(abs(rec["score"] - optimum) <= 1e-9 for rec in ref._best)
