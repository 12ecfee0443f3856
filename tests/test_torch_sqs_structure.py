"""SQS from a structure: the port's enumeration, structures and duplicate removal.

``StochasticSQSGenerator.from_structure(fcc_binary_prim(), cutoffs={2: 5.0,
3: 3.5}, supercell_size=8)`` (bench ``sqs``, ``bench.py:440-449``) must
build, on the port alone, the 20 distance systems of
``tests/data/torch_sqs_fcc8.npz`` array for array: the shapes in the
reference's order, the local tables padded to the widest.  Then on one
fixed set of records (occupancies with repeats and symmetry-equivalent
copies, each shape's scores) ``get_best_sqs`` with and without duplicate
removal returns what ``smol_tpu``'s returns on the same records, and each
``SQS.structure`` is the reference's structure of that occupancy.
"""

import warnings
from pathlib import Path

import numpy as np
import pytest

from smol_tpu_torch.benchmarks.systems import fcc_binary_prim
from smol_tpu_torch.capp import StochasticSQSGenerator
from smol_tpu_torch.system import load_systems

DATA = Path(__file__).resolve().parent / "data"
SMALL_CUTOFFS = {2: 4.0}
SHAPES = 6  # of the twenty, in the records
PER_SHAPE = 5


def test_from_structure_builds_the_bench_file():
    built = StochasticSQSGenerator.from_structure(
        fcc_binary_prim(), cutoffs={2: 5.0, 3: 3.5}, supercell_size=8, device="cpu")
    stored = load_systems(DATA / "torch_sqs_fcc8.npz")
    assert len(built.processors) == len(stored) == 20
    for processor, system in zip(built.processors, stored):
        assert sorted(processor.system) == sorted(system)
        for key, value in system.items():
            mine = np.asarray(processor.system[key])
            assert mine.dtype == value.dtype and mine.shape == value.shape, key
            np.testing.assert_array_equal(mine, value, err_msg=key)
    assert built.cluster_subspace is built.processors[0].cluster_subspace


def _records(processors, seed):
    """Per shape [PER_SHAPE, N] occupancies at half composition: a random one,
    itself again, a lattice translation of it and two more random ones."""
    rng = np.random.default_rng(seed)
    out = []
    for processor in processors:
        n = processor.num_sites
        first = rng.permutation(np.arange(n) % 2).astype(np.int32)
        structure = processor.structure
        shifted = structure.frac_coords + structure.frac_coords[1] - structure.frac_coords[0]
        image = [int(np.argmin(np.abs(((structure.frac_coords - f) + 0.5) % 1 - 0.5).sum(1)))
                 for f in shifted]
        translated = np.empty(n, dtype=np.int32)
        translated[image] = first
        others = [rng.permutation(np.arange(n) % 2).astype(np.int32) for _ in range(2)]
        out.append(np.stack([first, first, translated, *others]))
    return out


@pytest.fixture(scope="module")
def generators():
    """(port generator, reference generator) of the small fcc subspace, the
    same records in both."""
    from smol_tpu.benchmarks.systems import fcc_binary_prim as ref_prim
    from smol_tpu.capp import StochasticSQSGenerator as RefGenerator

    mine = StochasticSQSGenerator.from_structure(fcc_binary_prim(), SMALL_CUTOFFS, 8,
                                                 device="cpu")
    theirs = RefGenerator.from_structure(ref_prim(), SMALL_CUTOFFS, supercell_size=8)
    mine._best, theirs._best = [], []
    for shape, occupancies in enumerate(_records(mine.processors[:SHAPES], seed=5)):
        processor = mine.processors[shape]
        features = np.stack([processor.compute_feature_vector(o) for o in occupancies])
        scores = features @ processor.coefs
        mine._best.append((shape, occupancies, scores, features))
        theirs._best.extend({"shape": shape, "occupancy": o, "score": float(s), "features": f}
                            for o, s, f in zip(occupancies, scores, features))
    return mine, theirs


def _same(best, ref_best):
    assert len(best) == len(ref_best)
    for sqs, ref_sqs in zip(best, ref_best):
        assert sqs.score == ref_sqs.score
        np.testing.assert_array_equal(sqs.supercell_matrix, ref_sqs.supercell_matrix)
        np.testing.assert_array_equal(sqs.feature_distance, ref_sqs.feature_distance)
        structure, ref_structure = sqs.structure, ref_sqs.structure
        assert [str(s.specie) for s in structure] == [str(s.specie) for s in ref_structure]
        np.testing.assert_allclose(structure.frac_coords, ref_structure.frac_coords,
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(structure.lattice.matrix, ref_structure.lattice.matrix,
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("remove_duplicates", [True, False])
@pytest.mark.parametrize("count", [5, 100])
def test_best_sqs_equal_reference(generators, remove_duplicates, count):
    """The ranking, the structures and, with duplicates removed, which ones
    the matcher drops, on the same records as the reference; asking for
    more than there are warns in both."""
    mine, theirs = generators
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        best = mine.get_best_sqs(count, remove_duplicates=remove_duplicates)
    with warnings.catch_warnings(record=True) as ref_caught:
        warnings.simplefilter("always")
        ref_best = theirs.get_best_sqs(count, remove_duplicates=remove_duplicates)
    _same(best, ref_best)
    assert [str(w.message) for w in caught] == [str(w.message) for w in ref_caught]
    if remove_duplicates and count == 100:  # the repeats and translations went
        assert len(best) < SHAPES * PER_SHAPE - SHAPES
    for sqs in best:
        np.testing.assert_array_equal(sqs.processor.occupancy_from_structure(sqs.structure),
                                      sqs.occupancy)


def test_generate_then_best_structures():
    """A short search from the structure, then its best distinct SQS: each a
    half Au, half Cu structure of 8 sites whose score is its exact one."""
    generator = StochasticSQSGenerator.from_structure(fcc_binary_prim(), SMALL_CUTOFFS, 8,
                                                      device="cpu")
    generator.generate(mcmc_steps=20, temperatures=[2.0, 0.5], nwalkers=4, seed=0)
    best = generator.get_best_sqs(num_structures=3)
    assert len(best) == 3 and all(a.score <= b.score for a, b in zip(best, best[1:]))
    for sqs in best:
        structure = sqs.structure
        assert len(structure) == 8
        assert sorted(str(s.specie) for s in structure) == ["Au"] * 4 + ["Cu"] * 4
        assert abs(generator.compute_score(sqs.structure, sqs.supercell_matrix)
                   - sqs.score) < 1e-12
