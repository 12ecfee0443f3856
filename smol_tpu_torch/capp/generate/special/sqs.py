"""Special quasi-random structure (SQS) generation on the distance chain.

Counterpart of ``smol_tpu/capp/generate/special/sqs.py``
(``StochasticSQSGenerator`` :274).  Each supercell shape anneals a batch of
walkers of canonical swaps against its distance processor's score
d = -w L + ||W (f - f_T)||_1 at kB = 1
(https://doi.org/10.1016/j.calphad.2013.06.006): one composition-exact
start, a random permutation of it within each sublattice per walker, then
per temperature one launch of the distance chain for all the shapes of the
size (:mod:`smol_tpu_torch.ops.sqs`, the CUDA kernel on the card, its plain
torch twin on the CPU; each shape draws as its own launch would, and sums
as the launch's lanes do), each walker
keeping its best (score, occupancy); the best occupancies are rescored
exactly at the end.  The generator is built from a disordered structure
as the reference builds it (:meth:`SQSGenerator.from_structure`: the
subspace from its cutoffs, every supercell shape of the size that the
prim's symmetry tells apart, one distance processor each, their local
tables padded to the widest), or from distance processors
(:meth:`SQSGenerator.from_processors`).  The best structures come back as
:class:`SQS` records, symmetry-equivalent ones removed by the
``StructureMatcher`` (``crystal/matcher.py``).
"""

from __future__ import annotations

import warnings
from abc import ABC, abstractmethod
from dataclasses import dataclass, field

import numpy as np
import torch

from smol_tpu_torch.capp.generate.enumerate import enumerate_supercell_matrices
from smol_tpu_torch.cofe import ClusterSubspace
from smol_tpu_torch.crystal.matcher import StructureMatcher
from smol_tpu_torch.moca.processor.distance import CorrelationDistanceProcessor
from smol_tpu_torch.ops.sqs import build_distance_tables, make_batched_distance_chain

__all__ = ["SQS", "SQSGenerator", "StochasticSQSGenerator", "random_starts"]


@dataclass(frozen=True)
class SQS:
    """One SQS found: its occupancy [N] int32, its exact score and distance
    features, its supercell matrix, and the processor of its shape, which
    gives its ``structure``."""

    occupancy: np.ndarray
    score: float
    feature_distance: np.ndarray
    supercell_matrix: np.ndarray
    processor: object = field(default=None, repr=False, compare=False)

    @property
    def structure(self):
        """The ordered structure of the occupancy (the reference's
        ``SQS.structure``); a processor loaded from a system dict has no
        structure and raises ``ValueError``."""
        return self.processor.structure_from_occupancy(self.occupancy)


def _composition_occupancy(processor, rng, tol=1e-6) -> np.ndarray:
    """A random encoded occupancy [N] int32 at the sublattices' compositions.

    Each sublattice of ``processor.get_sublattices()`` gets round(x * n)
    sites of each code of fraction x, drawn without replacement from its
    sites in code order (``rng.choice``, as the reference's
    ``_gen_composition_occu``, ``capp/generate/random.py:105``).  Raises
    ``ValueError`` where a code's count x * n is not within ``tol`` of an
    integer.
    """
    sublattices = processor.get_sublattices()
    occu = np.zeros(sum(len(sl.sites) for sl in sublattices), dtype=np.int64)
    for sl in sublattices:
        if sl.composition is None:
            raise ValueError("the system carries no sublattice compositions")
        for fraction in sl.composition:
            count = len(sl.sites) * fraction
            if abs(round(count) - count) > tol:
                raise ValueError("composition is not compatible with supercell size.")
        remaining = list(sl.sites)
        for fraction, code in zip(sl.composition, sl.encoding):
            sites = rng.choice(remaining, size=round(fraction * len(sl.sites)),
                               replace=False)
            occu[sites] = code
            remaining = [i for i in remaining if i not in sites]
    return np.ascontiguousarray(occu, dtype=np.int32)


def random_starts(processor, nwalkers, rng) -> np.ndarray:
    """Starting occupancies [nwalkers, N] int32 of one shape: one
    composition-exact occupancy, then an independent uniform permutation of
    it within each sublattice per walker (the reference's :436-448, with the
    same draws from the numpy generator ``rng``)."""
    occu0 = _composition_occupancy(processor, rng)
    occus = np.tile(occu0, (nwalkers, 1))
    for sl in processor.get_sublattices():
        sites = np.asarray(sl.sites)
        if len(sites) < 2:
            continue
        perms = rng.random((nwalkers, len(sites))).argsort(axis=1)
        occus[:, sites] = occu0[sites][perms]
    return occus


def _matrix_key(matrix):
    return tuple(sorted(tuple(row) for row in np.asarray(matrix).tolist()))


class SQSGenerator(ABC):
    """An SQS search over the supercell shapes of its distance processors."""

    def __init__(self, processors, device="cuda"):
        if not processors:
            raise ValueError("at least one processor is required")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch sees no CUDA device; pass "
                "device='cpu' to run the plain torch chain on the CPU"
            )
        for p in processors:
            if type(p).__name__ != "CorrelationDistanceProcessor":
                raise NotImplementedError(
                    f"{type(p).__name__}: only the correlation distance is ported "
                    "(ROADMAP.md Queue 1 item 6)"
                )
            if p.device.type != device.type or (
                device.index is not None and p.device != device
            ):
                raise ValueError(f"a processor lives on {p.device}, not on {device}")
        if len({p.size for p in processors}) != 1:
            raise ValueError("processors must have one supercell size")
        self._processors = list(processors)
        self.device = device
        self.supercell_size = processors[0].size
        self._best = []  # per shape: (occupancies [W, N], scores [W], features [W, F])

    @classmethod
    def from_structure(cls, structure, cutoffs, supercell_size, basis="indicator",
                       orthonormal=True, use_concentration=True, feature_type="correlation",
                       target_vector=None, target_weights=None, match_weight=1.0,
                       match_tol=1e-5, supercell_matrices=None, device="cuda", **kwargs):
        """A generator of a disordered structure (the reference's :150-164
        and its constructor, :63-148): the subspace of ``cutoffs`` (built
        with ``use_concentration``), then one correlation distance processor
        (built with the constructor's default ``use_concentration=True``) for
        each of ``supercell_matrices`` or, by default, each supercell shape
        of ``supercell_size`` that the prim's symmetry tells apart, least
        skewed first (``enumerate_supercell_matrices``, reversed), their
        local tables padded to the widest; ``kwargs`` go to the
        generator."""
        subspace = ClusterSubspace.from_cutoffs(
            structure, cutoffs, basis=basis, orthonormal=orthonormal,
            use_concentration=use_concentration)
        if feature_type == "cluster-interaction":
            raise NotImplementedError(
                "the cluster-interaction distance is not ported yet (ROADMAP.md "
                "Queue 1 item 6)")
        if feature_type == "correlation":
            num_features = len(subspace)
        else:
            raise ValueError(
                f"feature_type {feature_type} not supported; options are "
                "'correlation', 'cluster-interaction'.")
        if target_weights is None:
            target_weights = np.ones(num_features - 1)
        elif len(target_weights) != num_features - 1:
            raise ValueError(f"target_weights must be of length {num_features - 1}")
        if target_vector is None:
            target_vector = np.zeros(num_features)
        elif len(target_vector) != num_features:
            raise ValueError(f"target vector must be of length {num_features}")
        if supercell_matrices is not None:
            for scm in supercell_matrices:
                if np.asarray(scm).shape != (3, 3):
                    raise ValueError("supercell matrices must be 3x3")
                if not np.isclose(abs(np.linalg.det(scm)), supercell_size):
                    raise ValueError("supercell matrices must have determinant equal to "
                                     "supercell_size")
        else:
            supercell_matrices = enumerate_supercell_matrices(supercell_size,
                                                              subspace.symops)
            supercell_matrices.reverse()  # least-skewed last -> first used
        processors = [
            CorrelationDistanceProcessor(
                subspace, scm, use_concentration=True, target_vector=target_vector,
                target_weights=target_weights, match_weight=match_weight,
                match_tol=match_tol, device=device)
            for scm in supercell_matrices
        ]
        width = max(p.local_width for p in processors)
        for p in processors:
            p.repad_local_tables(width)
        return cls(processors, device=device, **kwargs)

    @classmethod
    def from_processors(cls, processors, device="cuda", **kwargs):
        """A generator over prebuilt distance processors, one per shape
        (the reference's :171-194)."""
        return cls(processors, device=device, **kwargs)

    @property
    def processors(self):
        return self._processors

    @property
    def cluster_subspace(self):
        """The shapes' cluster subspace (None for processors loaded from
        system dicts)."""
        return self._processors[0].cluster_subspace

    @property
    def num_structures(self) -> int:
        return sum(len(scores) for _, _, scores, _ in self._best)

    @abstractmethod
    def generate(self, *args, **kwargs):
        """Run the SQS search."""

    def _processor_of(self, supercell_matrix):
        if supercell_matrix is None:
            if len(self._processors) == 1:
                return self._processors[0]
            raise ValueError("with several shapes, give the supercell matrix")
        key = _matrix_key(supercell_matrix)
        for processor in self._processors:
            if _matrix_key(processor.supercell_matrix) == key:
                return processor
        raise ValueError("No processor matches the given supercell matrix.")

    def compute_score(self, occupancy, supercell_matrix=None) -> float:
        """Exact SQS score of an occupancy [N] of one of the shapes."""
        return self._processor_of(supercell_matrix).compute_property(occupancy)

    def compute_feature_distance(self, occupancy, supercell_matrix=None) -> np.ndarray:
        """Distance features of an occupancy [N] of one of the shapes."""
        return self._processor_of(supercell_matrix).compute_feature_vector(occupancy)

    def get_best_sqs(self, num_structures=1, remove_duplicates=True):
        """The best SQS found so far, ranked by score (ties in shape, then
        walker order), as the reference's :237-263.

        ``remove_duplicates`` drops a structure that the ``StructureMatcher``
        fits to a better one kept before it.  The ranking is walked only
        until ``num_structures`` are kept, and an occupancy of a shape seen
        before is dropped without a fit (it fits its first occurrence, or
        the kept structure that one fitted): what is returned is the
        reference's, which builds and matches every record first.
        """
        if num_structures > self.num_structures:
            warnings.warn(
                f"num_structures exceeds the {self.num_structures} structures "
                "generated; returning at most that many."
            )
        records = sorted(
            (float(score), i, w)
            for i, (_, _, scores, _) in enumerate(self._best)
            for w, score in enumerate(scores)
        )
        best, structures, seen = [], [], set()
        matcher = StructureMatcher()
        for score, i, w in records:
            if len(best) == num_structures:
                break
            shape, occupancies, _, features = self._best[i]
            processor = self._processors[shape]
            sqs = SQS(occupancy=occupancies[w], score=score, feature_distance=features[w],
                      supercell_matrix=processor.supercell_matrix, processor=processor)
            if remove_duplicates:
                key = (shape, occupancies[w].tobytes())
                if key in seen:
                    continue
                seen.add(key)
                structure = sqs.structure
                if any(matcher.fit(structure, kept) for kept in structures):
                    continue
                structures.append(structure)
            best.append(sqs)
        if len(best) < num_structures:
            warnings.warn(f"Only {len(best)} distinct SQS could be returned.")
        return best


class StochasticSQSGenerator(SQSGenerator):
    """Simulated-annealing SQS search, walker-parallel per supercell shape.

    Each shape runs a batch of canonical-swap chains (kB = 1 temperatures)
    on the distance chain; walkers in blocks of 512 (the reference's kernel
    blocks) share their swap pairs.
    """

    def __init__(self, processors, device="cuda", step_type="swap"):
        if step_type != "swap":
            raise NotImplementedError(
                f"step_type={step_type!r}: only swaps run on the distance chain, and "
                "the per-step path is not ported yet (ROADMAP.md Queue 1 item 6)"
            )
        super().__init__(processors, device=device)
        self._tables = {}  # shape -> DistanceTables
        self._chains = {}  # steps -> [(shapes, batched chain fn)]
        self.stage_records = []
        self.start_scores = []

    @property
    def execution_path(self) -> str:
        """``"cuda-distance-chain"`` on the card, ``"cpu-twin[distance]"`` on
        the CPU; ``"not-run"`` before the first ``generate``."""
        if not self.stage_records:
            return "not-run"
        return "cuda-distance-chain" if self.device.type == "cuda" else "cpu-twin[distance]"

    @property
    def sampler(self):
        """The reference's MulticellMetropolis sampler: not ported."""
        raise NotImplementedError(
            "the multicell sampler is not ported yet (ROADMAP.md Queue 1 item 6)"
        )

    def _chain_fns(self, mcmc_steps):
        """[(shapes, chain fn)]: one batched distance chain per group of
        shapes whose tables stack (equal ranks and features: every shape of
        one size), for ``mcmc_steps`` steps."""
        key = int(mcmc_steps)
        if key not in self._chains:
            for shape, processor in enumerate(self._processors):
                if shape not in self._tables:
                    self._tables[shape] = build_distance_tables(processor)
            groups = {}
            for shape, tables in self._tables.items():
                groups.setdefault((tables.num_ranks, tables.num_feats), []).append(shape)
            self._chains[key] = [
                (shapes, make_batched_distance_chain(
                    [self._tables[s] for s in shapes], key,
                    [self._processors[s].compute_corr for s in shapes]))
                for shapes in groups.values()
            ]
        return self._chains[key]

    def generate(self, mcmc_steps, temperatures=None, initial_occupancies=None,
                 clear_previous=True, max_save_num=None, nwalkers=32,
                 progress=False, seed=None):
        """Run the annealed search (the reference's :383-517).

        Args:
            mcmc_steps: swap attempts per temperature per walker.
            temperatures: unitless ladder (default linspace(5, 0.01, 20)).
            initial_occupancies: optional [n_shapes, N] start points.
            clear_previous: drop previously found structures.
            max_save_num: cap on stored structures (each walker's best).
            nwalkers: walkers per supercell shape.
            progress: print each shape's best score.
            seed: seed of the numpy generator that draws the starts and the
                seeds of the chains' generators.

        Every shape draws its starts and its generator's seed from the numpy
        generator in shape order, as the reference's loop over shapes does;
        then each temperature is one launch of the distance chain for all
        shapes (per chunk), each shape drawing its pairs and seed from its
        own generator, which gives what one launch per shape would at the
        same lanes a walker (:func:`smol_tpu_torch.ops.sqs.launch_lanes`:
        they follow the launch's walkers and set the order in which a
        walker's feature changes are summed).
        ``start_scores`` then holds each shape's starting scores [W], and
        ``stage_records``, shape by shape and for every temperature, the
        shape, the temperature and the walkers' occupancies, scores and
        accept counts at the end of that launch (all on the generator's
        device).
        """
        if temperatures is None:
            temperatures = np.linspace(5.0, 0.01, 20)
        if clear_previous:
            self._best = []
        rng = np.random.default_rng(seed)
        self.start_scores = []
        states, generators = [], []
        for shape, processor in enumerate(self._processors):
            rng.integers(2**31)  # the reference's kernel seed: keeps its draws
            if initial_occupancies is not None:
                occu0 = np.asarray(initial_occupancies[shape], dtype=np.int32)
                occus = np.tile(occu0, (nwalkers, 1))
            else:
                occus = random_starts(processor, nwalkers, rng)
            generator = torch.Generator(device=self.device)
            generator.manual_seed(int(rng.integers(2**31)))
            occu = torch.as_tensor(occus, dtype=torch.int32, device=self.device)
            scores = processor.compute_scores(occu)
            self.start_scores.append(scores.clone())
            states.append({
                "occupancy": occu, "enthalpy": scores,
                "naccept": torch.zeros(nwalkers, dtype=torch.int32, device=self.device),
                "best_enthalpy": scores.clone(), "best_occupancy": occu.clone(),
            })
            generators.append(generator)
        records = [[] for _ in states]
        chain_fns = self._chain_fns(mcmc_steps)
        for temp in temperatures:
            for state in states:
                state["beta"] = torch.full((nwalkers,), 1.0 / float(temp),
                                           dtype=torch.float64, device=self.device)
                state["window_naccept"] = torch.zeros_like(state["naccept"])
            for shapes, chain_fn in chain_fns:
                chain_fn([states[s] for s in shapes], [generators[s] for s in shapes])
            for shape, state in enumerate(states):
                records[shape].append({
                    "shape": shape, "temperature": float(temp),
                    "occupancy": state["occupancy"].clone(),
                    "enthalpy": state["enthalpy"].clone(),
                    "naccept": state["window_naccept"],
                })
        self.stage_records = [record for shape_records in records
                              for record in shape_records]
        for shape, (processor, state) in enumerate(zip(self._processors, states)):
            # exact batched rescore: the stored score is the processor's
            features = processor.compute_features(state["best_occupancy"])
            best_scores = features @ torch.as_tensor(processor.coefs, device=self.device)
            self._best.append((shape, state["best_occupancy"].cpu().numpy(),
                               best_scores.cpu().numpy(), features.cpu().numpy()))
            if progress:
                print(f"shape {shape}: best score {float(best_scores.min()):.6f}")
        if max_save_num is not None and self.num_structures > max_save_num:
            self._keep_best(max_save_num)

    def _keep_best(self, count):
        """Keep the ``count`` best structures (ties in shape, walker order)."""
        scores = np.concatenate([s for _, _, s, _ in self._best])
        order = np.argsort(scores, kind="stable")[:count]
        keep = np.zeros(len(scores), dtype=bool)
        keep[order] = True
        kept, start = [], 0
        for shape, occupancies, shape_scores, features in self._best:
            mine = keep[start: start + len(shape_scores)]
            start += len(shape_scores)
            if mine.any():
                kept.append((shape, occupancies[mine], shape_scores[mine], features[mine]))
        self._best = kept
