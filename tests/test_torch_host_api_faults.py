"""The reference's host call forms that the port refused (faults P11-P14),
on the port with ``device="cpu"`` against ``smol_tpu``.

- P11: the SQS generator scores an ordered structure, as the reference's
  ``compute_score(structure, supercell_matrix=None)`` and
  ``compute_feature_distance`` do: with the shape's matrix and without it
  (the subspace finds it), on the probe generator (``fcc_binary_prim()``,
  cutoffs ``{2: 4.0}``, size 8);
- P12: the reference's constructor ``SQSGenerator(cluster_subspace,
  supercell_size, feature_type=..., target_vector=..., target_weights=...,
  use_concentration=..., match_weight=..., match_tol=...,
  supercell_matrices=..., processors=...)`` gives the reference's shapes
  and distance processors, refuses what the reference refuses, and
  ``StochasticSQSGenerator`` takes ``step_type``, ``temperature`` and
  ``kernel_kwargs``; ``from_processors`` builds through it;
  ``get_best_sqs(..., reduction_algorithm=None)`` runs and its records
  unpack as the reference's four fields (those of shapes loaded from a
  system file with no structure);
- P13: ``Sampler.from_ensemble(ensemble, *args, ...)`` passes every
  positional argument after the ensemble to the kernel (Wang-Landau's
  window, Metropolis's temperature and, through the kernel, the usher's
  sublattice probabilities), with ``nwalkers``, ``seed`` and ``device``
  keyword-only;
- P14: every processor's ``num_features``, on each committed system file
  against the reference's processor of the same system (built by
  ``scripts/export_torch_systems.py`` at the smallest size of its kind:
  the count of features does not depend on the supercell), the Ewald part
  of each composite, and the distance processors of both kinds.
"""

import inspect
import sys
from pathlib import Path

import numpy as np
import pytest

from smol_tpu.benchmarks.systems import fcc_binary_prim as ref_fcc
from smol_tpu.capp import StochasticSQSGenerator as RefGenerator
from smol_tpu.capp.generate.special.sqs import SQS as RefSQS
from smol_tpu.cofe import ClusterSubspace as RefSubspace
from smol_tpu.moca import Sampler as RefSampler
from smol_tpu.moca.processor.distance import (
    ClusterInteractionDistanceProcessor as RefInteraction,
)
from smol_tpu.moca.processor.distance import CorrelationDistanceProcessor as RefCorrelation
from smol_tpu_torch.benchmarks.systems import fcc_binary_prim
from smol_tpu_torch.capp import StochasticSQSGenerator
from smol_tpu_torch.capp.generate.special.sqs import SQS
from smol_tpu_torch.cofe import ClusterSubspace
from smol_tpu_torch.moca.ensemble import Ensemble
from smol_tpu_torch.moca.processor.base import Processor
from smol_tpu_torch.moca.processor.distance import (
    ClusterInteractionDistanceProcessor,
    CorrelationDistanceProcessor,
)
from smol_tpu_torch.moca.sampler.sampler import Sampler
from smol_tpu_torch.system import load_system, load_systems

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import export_torch_systems as systems  # noqa: E402

CUTOFFS = {2: 4.0}
SIZE = 8


@pytest.fixture(scope="module")
def probe():
    """The reference's and the port's generators of the probe."""
    return (RefGenerator.from_structure(ref_fcc(), CUTOFFS, SIZE),
            StochasticSQSGenerator.from_structure(fcc_binary_prim(), CUTOFFS, SIZE,
                                                  device="cpu"))


@pytest.fixture(scope="module")
def subspaces():
    return (RefSubspace.from_cutoffs(ref_fcc(), CUTOFFS),
            ClusterSubspace.from_cutoffs(fcc_binary_prim(), CUTOFFS))


# ---------------- P11 ----------------

@pytest.mark.parametrize("with_matrix", [True, False])
@pytest.mark.parametrize("shape", [0, 19])
def test_score_of_a_structure(probe, shape, with_matrix):
    ref, mine = probe
    occupancy = np.random.default_rng(shape).permutation(np.arange(SIZE) % 2).astype(np.int32)
    ref_structure = ref.processors[shape].structure_from_occupancy(occupancy)
    structure = mine.processors[shape].structure_from_occupancy(occupancy)
    matrices = ((ref.processors[shape].supercell_matrix, mine.processors[shape].supercell_matrix)
                if with_matrix else (None, None))
    try:
        expect = (ref.compute_score(ref_structure, matrices[0]),
                  ref.compute_feature_distance(ref_structure, matrices[0]))
    except ValueError as error:  # a matrix the subspace finds that no shape has
        with pytest.raises(ValueError, match=str(error)[:20]):
            mine.compute_score(structure, matrices[1])
        return
    assert mine.compute_score(structure, matrices[1]) == pytest.approx(expect[0], abs=1e-12)
    np.testing.assert_allclose(mine.compute_feature_distance(structure, matrices[1]),
                               np.asarray(expect[1]), rtol=0, atol=1e-12)
    if with_matrix:  # the shape's own processor scored it
        assert mine.compute_score(structure, matrices[1]) == pytest.approx(
            mine.processors[shape].compute_property(occupancy), abs=1e-15)


# ---------------- P12 ----------------

def _same_processors(mine, ref):
    assert len(mine.processors) == len(ref.processors)
    for p, q in zip(mine.processors, ref.processors):
        np.testing.assert_array_equal(p.supercell_matrix, q.supercell_matrix)
        np.testing.assert_array_equal(p.coefs, np.asarray(q.coefs))
        np.testing.assert_array_equal(p.target_vector, np.asarray(q.target_vector))
        assert p.match_tol == q.match_tol
        assert p.num_features == q.num_features
    assert mine.feature_type == ref.feature_type
    assert mine.supercell_size == ref.supercell_size


def test_constructor_forms(probe, subspaces):
    ref_space, space = subspaces
    ref, mine = probe
    # the default: every shape of the size, least skewed first
    _same_processors(StochasticSQSGenerator(space, SIZE, device="cpu"), ref)
    # every argument of the reference's constructor
    n = len(space)
    options = dict(target_vector=np.linspace(0.0, 0.5, n), target_weights=np.arange(1, n),
                   use_concentration=False, match_weight=2.0, match_tol=1e-3,
                   supercell_matrices=[p.supercell_matrix for p in ref.processors[:3]])
    _same_processors(StochasticSQSGenerator(space, SIZE, device="cpu", **options),
                     RefGenerator(ref_space, SIZE, **options))
    interaction = dict(feature_type="cluster-interaction",
                       target_vector=np.full(space.num_orbits, 0.1),
                       supercell_matrices=options["supercell_matrices"][:2])
    _same_processors(StochasticSQSGenerator(space, SIZE, device="cpu", **interaction),
                     RefGenerator(ref_space, SIZE, **interaction))
    # from_processors builds through the constructor, inferring the rest
    _same_processors(StochasticSQSGenerator.from_processors(mine.processors[:2], device="cpu"),
                     RefGenerator.from_processors(ref.processors[:2]))
    # the stochastic generator's own keywords
    with pytest.warns(UserWarning, match="Step type flip"):
        flips = StochasticSQSGenerator(space, SIZE, device="cpu", step_type="flip",
                                       temperature=2.0, kernel_kwargs={"seed": 3},
                                       supercell_matrices=options["supercell_matrices"][:1])
    assert (flips._step_type, flips._temperature, flips._kernel_kwargs) == (
        "flip", 2.0, {"seed": 3})


@pytest.mark.parametrize("bad", [
    {"feature_type": "energy"},
    {"target_weights": np.ones(2)},
    {"target_vector": np.zeros(2)},
    {"supercell_matrices": [np.eye(3)]},  # determinant 1, not 8
    {"supercell_matrices": [np.eye(2) * 2]},  # not 3x3
    {"supercell_matrices": [np.diag([2, 2, 2])], "processors": "both"},
])
def test_constructor_refusals(probe, subspaces, bad):
    ref, mine = probe
    ref_space, space = subspaces
    if bad.get("processors") == "both":
        bad = {**bad, "processors": mine.processors[:1]}
        ref_bad = {**bad, "processors": ref.processors[:1]}
    else:
        ref_bad = bad
    with pytest.raises(ValueError) as ref_error:
        RefGenerator(ref_space, SIZE, **ref_bad)
    with pytest.raises(ValueError, match=str(ref_error.value)[:25]):
        StochasticSQSGenerator(space, SIZE, device="cpu", **bad)


def test_best_sqs_records(probe):
    ref, mine = probe
    generator = StochasticSQSGenerator.from_processors(mine.processors[:2], device="cpu")
    generator.generate(mcmc_steps=10, temperatures=[1.0], nwalkers=4, seed=0)
    best = generator.get_best_sqs(3, remove_duplicates=False, reduction_algorithm=None)
    assert SQS._fields == RefSQS._fields
    assert len(best) == 3
    for record in best:
        structure, score, feature_distance, supercell_matrix = record
        assert structure is record.structure and score == record.score
        assert feature_distance is record.feature_distance
        assert supercell_matrix is record.supercell_matrix
        assert generator.compute_score(structure, supercell_matrix) == pytest.approx(score,
                                                                                     abs=1e-9)
        np.testing.assert_array_equal(
            record.processor.occupancy_from_structure(structure), record.occupancy)
    # the reference's signature
    assert (list(inspect.signature(generator.get_best_sqs).parameters)
            == list(inspect.signature(ref.get_best_sqs).parameters))


def test_best_sqs_records_of_loaded_shapes():
    """Shapes loaded from a system file have no subspace: their records
    carry no structure, and only the matching of duplicates, which needs
    one, raises."""
    shapes = load_systems(systems.data_path("sqs_fcc8"))[:2]
    procs = [CorrelationDistanceProcessor.from_system(s, "cpu") for s in shapes]
    generator = StochasticSQSGenerator.from_processors(procs, device="cpu")
    generator.generate(mcmc_steps=10, temperatures=[1.0], nwalkers=4, seed=0)
    best = generator.get_best_sqs(3, remove_duplicates=False)
    assert len(best) == 3
    for structure, score, feature_distance, supercell_matrix in best:
        assert structure is None and np.isfinite(score)
        assert feature_distance.shape == (procs[0].num_features,)
        assert any(np.array_equal(supercell_matrix, p.supercell_matrix) for p in procs)
    assert [r.score for r in best] == sorted(r.score for r in best)
    with pytest.raises(ValueError, match="system dict"):
        generator.get_best_sqs(3, remove_duplicates=True)


# ---------------- P13 ----------------

@pytest.fixture(scope="module")
def aucu_wl():
    """Bench wang-landau's Au-Cu 3x3x3: the reference's ensemble and the
    port's from the committed file."""
    return (systems.aucu_ensemble(3),
            Ensemble.from_system(load_system(systems.data_path("aucu_wl_3x3x3")), "cpu"))


def test_wang_landau_window_by_position(aucu_wl):
    ref_ens, ens = aucu_wl
    args = (-1.0, 1.0, 0.1)
    ref = RefSampler.from_ensemble(ref_ens, *args, kernel_type="wang-landau", step_type="flip")
    mine = Sampler.from_ensemble(ens, *args, kernel_type="wang-landau", step_type="flip",
                                 device="cpu")
    np.testing.assert_array_equal(mine.mckernel.levels, np.asarray(ref.mckernel.levels))
    assert mine.mckernel.bin_size == ref.mckernel.bin_size
    assert mine.nwalkers == ref.nwalkers == 1
    occupancy = np.random.default_rng(0).integers(0, 2, (1, ens.num_sites)).astype(np.int32)
    mine.run(20, occupancy)
    assert mine.samples.num_samples == 20
    assert mine.execution_path(1).startswith("cpu-")


def test_metropolis_arguments_by_position(aucu_wl):
    ref_ens, ens = aucu_wl
    # the temperature to the kernel, the sublattice probabilities through it to the usher
    ref = RefSampler.from_ensemble(ref_ens, 1500.0, [1.0], nwalkers=2, seed=4)
    mine = Sampler.from_ensemble(ens, 1500.0, [1.0], nwalkers=2, seed=4, device="cpu")
    assert mine.mckernel.temperature == ref.mckernel.temperature == 1500.0
    assert mine.nwalkers == ref.nwalkers == 2 and mine.seeds == [4]
    assert (mine.mckernel.mcusher.spec.sublattice_probabilities
            == ref.mckernel.mcusher.spec.sublattice_probabilities == [1.0])
    # a number in the usher's place fails in both, as an argument of the usher
    with pytest.raises(TypeError):
        RefSampler.from_ensemble(ref_ens, 1000.0, 4)
    with pytest.raises(TypeError):
        Sampler.from_ensemble(ens, 1000.0, 4, device="cpu")


# ---------------- P14 ----------------

# each committed system file -> the export script's function that makes its
# system and
# the smallest size of its kind
SYSTEM_MAKERS = {
    "spinel_2x2x2": ("spinel_ensemble", 2), "spinel_3x3x3": ("spinel_ensemble", 2),
    "spinel_ewald_2x2x2": ("spinel_ewald_ensemble", 2),
    "spinel_ewald_3x3x3": ("spinel_ewald_ensemble", 2),
    "aucu_4x4x4": ("aucu_ensemble", 2), "aucu_wl_3x3x3": ("aucu_ensemble", 2),
    "aucu_nn_2x2x2": ("aucu_nn_ensemble", None),
    "sgc_6x6x6": ("sgc_ensemble", 2), "sgc_3x3x3": ("sgc_ensemble", 2),
    "sgc_wl_3x3x3": ("sgc_ensemble", 2),
    "spinel_cd_2x2x2": ("spinel_cd_ensemble", 2), "aucu_pt_3x3x3": ("aucu_pt_ensemble", 2),
    "rocksalt_q4_2x2x2": ("rocksalt_q4_ensemble", 2),
    "spinel_ewald_sgc_2x2x2": ("spinel_ewald_sgc_ensemble", 2),
    "spinel_ewald_sgc_3x3x3": ("spinel_ewald_sgc_ensemble", 2),
    "spinel_ewald_cd_sgc_2x2x2": ("spinel_ewald_cd_sgc_ensemble", 2),
    "lmof_2x2x2": ("lmof_ensemble", (2, 2, 2)), "limn_tiny_2x1x1": ("limn_tiny_ensemble", None),
}
_REFERENCE = {}


def _reference_processor(maker, arg):
    if (maker, arg) not in _REFERENCE:
        make = getattr(systems, maker)
        _REFERENCE[(maker, arg)] = (make() if arg is None else make(arg)).processor
    return _REFERENCE[(maker, arg)]


def test_every_system_file_is_listed():
    committed = {p.name[len("torch_"):-len(".npz")] for p in (ROOT / "tests" / "data").glob(
        "torch_*.npz") if "twin" not in p.name}
    assert committed == set(SYSTEM_MAKERS) | set(systems.SQS)


@pytest.mark.parametrize("stem", sorted(SYSTEM_MAKERS))
def test_num_features_equal_reference(stem):
    ref = _reference_processor(*SYSTEM_MAKERS[stem])
    mine = Ensemble.from_system(load_system(systems.data_path(stem)), "cpu").processor
    assert type(mine).__name__ == type(ref).__name__
    assert mine.num_features == ref.num_features == len(mine.coefs)
    if hasattr(ref, "processors"):  # a composite: each part, the Ewald term's 1 too
        assert [p.num_features for p in mine.processors] == [
            p.num_features for p in ref.processors]


@pytest.mark.parametrize("stem", sorted(systems.SQS))
def test_distance_num_features_equal_reference(stem):
    loaded = [CorrelationDistanceProcessor.from_system(system, "cpu")
              for system in load_systems(systems.data_path(stem))]
    space = RefSubspace.from_cutoffs(ref_fcc(), systems.SQS_CUTOFFS)
    ref = RefCorrelation(space, np.diag([2, 2, 2]))
    assert {p.num_features for p in loaded} == {ref.num_features}


def test_interaction_distance_num_features(probe, subspaces):
    ref_space, space = subspaces
    ref = RefInteraction(ref_space, np.diag([2, 2, 2]))
    mine = ClusterInteractionDistanceProcessor(space, np.diag([2, 2, 2]), device="cpu")
    assert mine.num_features == ref.num_features == space.num_orbits
    built = probe[1].processors[0]
    assert built.num_features == RefCorrelation(ref_space, np.diag([2, 2, 2])).num_features
    with pytest.raises(NotImplementedError):  # the base's, which each processor overrides
        Processor.num_features.fget(built)
