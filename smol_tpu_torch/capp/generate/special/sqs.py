"""Special quasi-random structure (SQS) generation.

Counterpart of ``smol_tpu/capp/generate/special/sqs.py``
(``StochasticSQSGenerator`` :274).  Each supercell shape anneals a batch of
walkers against its distance processor's score
d = -w L + ||W (f - f_T)||_1 at kB = 1
(https://doi.org/10.1016/j.calphad.2013.06.006): one composition-exact
start, a random permutation of it within each sublattice per walker, then
the annealing, each walker keeping its best (score, occupancy); the best
occupancies are rescored exactly at the end.  A shape runs where the
reference's runs (``sqs.py:302-312``, ``_chain_anneal_fn`` :350-381):

- canonical swaps of a correlation distance whose tables the reference's
  chain takes (:func:`smol_tpu_torch.ops.sqs.build_distance_tables`) run on
  the distance chain, per temperature one launch for all such shapes of
  the size (:mod:`smol_tpu_torch.ops.sqs`, the CUDA kernel on the card,
  its plain torch twin on the CPU; each shape draws as its own launch
  would, and sums as the launch's lanes do);
- every other shape (another step type, the cluster-interaction distance,
  tables the reference refuses, its 8 MB budget among them) runs on the
  per-step path, as the reference's ``"xla-step"``: a
  :class:`~smol_tpu_torch.moca.kernel.metropolis.Metropolis` kernel of the
  step type at kB = 1 over its ensemble, one step of every walker at a
  time (:meth:`~smol_tpu_torch.moca.kernel.metropolis.Metropolis.make_step_fn`),
  each walker's best tracked after every step (``_step_tracking_best``,
  :39-48).

:attr:`StochasticSQSGenerator.sampler` is the reference's multicell
sampler: one Metropolis kernel a shape under a
:class:`~smol_tpu_torch.moca.kernel.multicell.MulticellMetropolis`, run by
:meth:`~smol_tpu_torch.moca.sampler.sampler.Sampler.run` on its host loop.  The generator is built as the reference builds
it (:class:`SQSGenerator`: from a cluster subspace and a supercell size,
every supercell shape of the size that the prim's symmetry tells apart,
or the given supercell matrices, one distance processor each, their local
tables padded to the widest; or around given distance processors), from a
disordered structure (:meth:`SQSGenerator.from_structure`) or from
distance processors (:meth:`SQSGenerator.from_processors`).  The best
structures come back as :class:`SQS` records, symmetry-equivalent ones
removed by the ``StructureMatcher`` (``crystal/matcher.py``), and an
ordered structure is scored as the reference scores it
(:meth:`SQSGenerator.compute_score`).
"""

from __future__ import annotations

import warnings
from abc import ABC, abstractmethod
from collections import namedtuple

import numpy as np
import torch

from smol_tpu_torch.capp.generate.enumerate import enumerate_supercell_matrices
from smol_tpu_torch.cofe import ClusterSubspace
from smol_tpu_torch.crystal.matcher import StructureMatcher
from smol_tpu_torch.moca.ensemble import Ensemble
from smol_tpu_torch.moca.kernel.metropolis import Metropolis
from smol_tpu_torch.moca.kernel.multicell import MulticellMetropolis
from smol_tpu_torch.moca.processor.distance import (
    ClusterInteractionDistanceProcessor,
    CorrelationDistanceProcessor,
)
from smol_tpu_torch.moca.sampler.sampler import Sampler
from smol_tpu_torch.ops.sqs import build_distance_tables, make_batched_distance_chain

__all__ = ["SQS", "SQSGenerator", "StochasticSQSGenerator", "random_starts"]


class SQS(namedtuple("SQS", ["structure", "score", "feature_distance", "supercell_matrix"])):
    """One SQS found: the reference's record (:36), which unpacks as
    ``(structure, score, feature_distance, supercell_matrix)``; its encoded
    ``occupancy`` [N] int32 and the ``processor`` of its shape ride along
    as attributes."""

    def __new__(cls, structure, score, feature_distance, supercell_matrix, occupancy=None,
                processor=None):
        record = super().__new__(cls, structure, score, feature_distance, supercell_matrix)
        record.occupancy = occupancy
        record.processor = processor
        return record


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
    """An SQS search over the supercell shapes of its distance processors.

    Built as the reference's (``sqs.py:60-147``): one distance processor of
    ``feature_type`` (``"correlation"``, or ``"cluster-interaction"``: one
    feature an orbit) a shape of ``supercell_size`` over
    ``cluster_subspace``, for each of ``supercell_matrices`` or, by
    default, each supercell shape that the prim's symmetry tells apart,
    least skewed first (``enumerate_supercell_matrices``, reversed), with
    ``target_vector`` (by default zeros), ``target_weights`` (by default
    ones), ``use_concentration``, ``match_weight`` and ``match_tol``; or
    around the given ``processors`` (not with ``supercell_matrices``),
    which must share the subspace (None for processors loaded from system
    dicts, which have none) and the size.  The correlation processors'
    local tables are padded to the widest.  ``device`` is where the
    processors live (``"cuda"``: the card; ``"cpu"`` on request).
    """

    def __init__(self, cluster_subspace, supercell_size, feature_type="correlation",
                 target_vector=None, target_weights=None, use_concentration=True,
                 match_weight=1.0, match_tol=1e-5, supercell_matrices=None,
                 processors=None, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch sees no CUDA device; pass "
                "device='cpu' to run the plain torch chain on the CPU"
            )
        if feature_type == "correlation":
            proc_cls = CorrelationDistanceProcessor
        elif feature_type == "cluster-interaction":
            proc_cls = ClusterInteractionDistanceProcessor
        else:
            raise ValueError(
                f"feature_type {feature_type} not supported; options are "
                "'correlation', 'cluster-interaction'.")
        if cluster_subspace is None:  # loaded processors: their own count
            if not processors:
                raise ValueError("a generator without a cluster subspace needs processors")
            num_features = processors[0].num_features
        elif feature_type == "correlation":
            num_features = len(cluster_subspace)
        else:
            num_features = cluster_subspace.num_orbits
        if target_weights is None:
            target_weights = np.ones(num_features - 1)
        elif len(target_weights) != num_features - 1:
            raise ValueError(f"target_weights must be of length {num_features - 1}")
        if target_vector is None:
            target_vector = np.zeros(num_features)
        elif len(target_vector) != num_features:
            raise ValueError(f"target vector must be of length {num_features}")
        if supercell_matrices is not None:
            if processors is not None:
                raise ValueError("processors and supercell_matrices cannot both be specified")
            for scm in supercell_matrices:
                if np.asarray(scm).shape != (3, 3):
                    raise ValueError("supercell matrices must be 3x3")
                if not np.isclose(abs(np.linalg.det(scm)), supercell_size):
                    raise ValueError("supercell matrices must have determinant equal to "
                                     "supercell_size")
        elif processors is None:
            supercell_matrices = enumerate_supercell_matrices(supercell_size,
                                                              cluster_subspace.symops)
            supercell_matrices.reverse()  # least-skewed last -> first used
        if processors is None:
            processors = [
                proc_cls(cluster_subspace, scm, use_concentration=use_concentration,
                         target_vector=target_vector, target_weights=target_weights,
                         match_weight=match_weight, match_tol=match_tol, device=device)
                for scm in supercell_matrices
            ]
        else:
            if not processors:
                raise ValueError("at least one processor is required")
            if processors[0].cluster_subspace != cluster_subspace:
                raise ValueError("Processors must share the generator's cluster subspace")
            if not all(p.size == supercell_size for p in processors):
                raise ValueError("processors must have the generator's size")
            if not all(type(p) is proc_cls for p in processors):
                raise ValueError(f"the processors are not all {proc_cls.__name__}s")
            for p in processors:
                if p.device.type != device.type or (
                    device.index is not None and p.device != device
                ):
                    raise ValueError(f"a processor lives on {p.device}, not on {device}")
        if feature_type == "correlation":
            width = max(p.local_width for p in processors)
            for p in processors:
                if p.local_width != width:
                    p.repad_local_tables(width)
        self.cluster_subspace = cluster_subspace
        self.supercell_size = supercell_size
        self.feature_type = feature_type
        self.device = device
        self._processors = list(processors)
        self._best = []  # per shape: (occupancies [W, N], scores [W], features [W, F])

    @classmethod
    def from_structure(cls, structure, cutoffs, supercell_size, basis="indicator",
                       orthonormal=True, use_concentration=True, **kwargs):
        """A generator of a disordered structure (the reference's :150-164):
        the subspace of ``cutoffs`` (built with ``use_concentration``), then
        the constructor with ``kwargs``, whose ``use_concentration`` for the
        processors keeps its default."""
        subspace = ClusterSubspace.from_cutoffs(
            structure, cutoffs, basis=basis, orthonormal=orthonormal,
            use_concentration=use_concentration)
        return cls(subspace, supercell_size, **kwargs)

    @classmethod
    def from_processors(cls, processors, **kwargs):
        """A generator over prebuilt distance processors, one per shape (the
        reference's :171-194): the subspace, size, feature type, target
        vector and weights, match weight and tolerance are the first
        processor's."""
        if not processors:
            raise ValueError("at least one processor is required")
        p0 = processors[0]
        feature_type = ("correlation" if isinstance(p0, CorrelationDistanceProcessor)
                        else "cluster-interaction")
        return cls(p0.cluster_subspace, p0.size, feature_type=feature_type,
                   target_vector=np.asarray(p0.target_vector),
                   target_weights=np.asarray(p0.coefs[1:]),
                   match_weight=float(-p0.coefs[0]), match_tol=float(p0.match_tol),
                   processors=list(processors), **kwargs)

    @property
    def processors(self):
        return self._processors

    @property
    def num_structures(self) -> int:
        return sum(len(scores) for _, _, scores, _ in self._best)

    @abstractmethod
    def generate(self, *args, **kwargs):
        """Run the SQS search."""

    def compute_score(self, structure, supercell_matrix=None) -> float:
        """Exact SQS score of an ordered structure of one of the shapes (the
        reference's :208-212): its supercell matrix found by the subspace
        where not given, the structure encoded by that shape's processor."""
        processor = self._get_structure_processor(structure, supercell_matrix)
        return processor.compute_property(processor.occupancy_from_structure(structure))

    def compute_feature_distance(self, structure, supercell_matrix=None) -> np.ndarray:
        """Distance features of an ordered structure of one of the shapes
        (the reference's :214-217)."""
        processor = self._get_structure_processor(structure, supercell_matrix)
        return processor.compute_feature_vector(processor.occupancy_from_structure(structure))

    def _get_structure_processor(self, structure, supercell_matrix):
        if supercell_matrix is None:
            if self.cluster_subspace is None:
                raise ValueError("a generator of loaded processors has no cluster subspace "
                                 "to find a structure's supercell matrix")
            supercell_matrix = self.cluster_subspace.scmatrix_from_structure(structure)
        if not np.isclose(abs(np.linalg.det(supercell_matrix)), self.supercell_size):
            raise ValueError("Invalid supercell matrix: determinant must equal supercell_size")
        key = _matrix_key(supercell_matrix)
        for processor in self._processors:
            if _matrix_key(processor.supercell_matrix) == key:
                return processor
        raise ValueError("No processor matches the given supercell matrix.")

    def get_best_sqs(self, num_structures=1, remove_duplicates=True,
                     reduction_algorithm=None):
        """The best SQS found so far, ranked by score (ties in shape, then
        walker order), as the reference's :237-263, whose
        ``reduction_algorithm`` it takes and, as the reference, does not
        use.

        ``remove_duplicates`` drops a structure that the ``StructureMatcher``
        fits to a better one kept before it.  The ranking is walked only
        until ``num_structures`` are kept, and an occupancy of a shape seen
        before is dropped without a fit (it fits its first occurrence, or
        the kept structure that one fitted): what is returned is the
        reference's, which builds and matches every record first.  A
        record's structure is built where its shape's processor has a
        cluster subspace; a processor loaded from a system dict has none,
        so its records carry ``structure=None``, and ``remove_duplicates``,
        which must build them to match them, raises ``ValueError`` there.
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
        best, seen = [], set()
        matcher = StructureMatcher()
        for score, i, w in records:
            if len(best) == num_structures:
                break
            shape, occupancies, _, features = self._best[i]
            if remove_duplicates:
                key = (shape, occupancies[w].tobytes())
                if key in seen:
                    continue
                seen.add(key)
            processor = self._processors[shape]
            structure = (processor.structure_from_occupancy(occupancies[w])
                         if remove_duplicates or processor.cluster_subspace is not None
                         else None)
            if remove_duplicates and any(matcher.fit(structure, kept.structure)
                                         for kept in best):
                continue
            best.append(SQS(structure, score, features[w], processor.supercell_matrix,
                            occupancy=occupancies[w], processor=processor))
        if len(best) < num_structures:
            warnings.warn(f"Only {len(best)} distinct SQS could be returned.")
        return best


def _step_tracking_best(step, state, generator):
    """One step of every walker, then each walker's best (score, occupancy)
    where the step left it lower (the reference's ``_step_tracking_best``,
    :39-48)."""
    state = step(state, generator)
    better = state["enthalpy"] < state["best_enthalpy"]
    state["best_enthalpy"] = torch.where(better, state["enthalpy"], state["best_enthalpy"])
    state["best_occupancy"] = torch.where(better[:, None], state["occupancy"],
                                          state["best_occupancy"])
    return state


class StochasticSQSGenerator(SQSGenerator):
    """Simulated-annealing SQS search, walker-parallel per supercell shape.

    Each shape runs a batch of chains of ``step_type`` moves (kB = 1
    temperatures): canonical swaps of a correlation distance the chain
    takes on the distance chain, where walkers in blocks of 512 (the
    reference's kernel blocks) share their swap pairs; every other shape on
    the per-step path, each walker with its own proposals.

    Takes the arguments of :class:`SQSGenerator` and, keyword-only, as
    the reference's (``sqs.py:282-299``):

    Args:
        step_type: the usher of the search (``"swap"``; another warns, as
            the reference's, and runs on the per-step path).
        temperature: the multicell sampler's temperature (:attr:`sampler`).
        kernel_kwargs: more arguments of each shape's Metropolis kernel.
    """

    def __init__(self, *args, kernel_kwargs=None, step_type="swap", temperature=5.0,
                 **kwargs):
        super().__init__(*args, **kwargs)
        if step_type != "swap":
            warnings.warn(
                f"Step type {step_type} was provided; swap steps are "
                "recommended for fixed-composition SQS searches.",
                UserWarning,
            )
        self._step_type = step_type
        self._temperature = temperature
        self._kernel_kwargs = dict(kernel_kwargs or {})
        self._sampler = None
        self._tables = {}  # shape -> DistanceTables, or None on the per-step path
        self._chains = {}  # steps -> [(shapes, batched chain fn)]
        self._exec_paths = []  # each shape's path in the last generate
        self.stage_records = []
        self.start_scores = []

    @property
    def execution_path(self) -> str:
        """The paths of the last ``generate``: ``"cuda-distance-chain"`` or
        ``"cpu-twin[distance]"`` for the shapes on the distance chain,
        ``"cuda-step"`` or ``"cpu-step"`` for those on the per-step path,
        ``"mixed:<path>,<path>"`` where the shapes took both (the
        reference's :302-312); ``"not-run"`` before the first."""
        if not self._exec_paths:
            return "not-run"
        paths = sorted(set(self._exec_paths))
        return paths[0] if len(paths) == 1 else "mixed:" + ",".join(paths)

    @property
    def sampler(self):
        """A :class:`~smol_tpu_torch.moca.sampler.sampler.Sampler` over a
        :class:`~smol_tpu_torch.moca.kernel.multicell.MulticellMetropolis`
        of one Metropolis kernel of the step type a shape, all at kB = 1
        (the reference's :315-348), one walker on the host loop of
        ``Sampler.run``; built once."""
        if self._sampler is None:
            kernels = []
            for proc in self._processors:
                kernel = Metropolis(Ensemble(proc), self._step_type,
                                    temperature=self._temperature, **self._kernel_kwargs)
                kernel.kB = 1.0  # unitless annealing temperatures
                kernels.append(kernel)
            multicell = MulticellMetropolis(kernels, temperature=self._temperature)
            multicell.kB = 1.0
            container = Sampler._empty_container(kernels[0].ensemble, multicell, 1)
            self._sampler = Sampler(multicell, container, nwalkers=1)
        return self._sampler

    def _shape_tables(self, shape):
        """The shape's distance tables, or None where the reference's chain
        refuses it (another step type than swaps included)."""
        if shape not in self._tables:
            self._tables[shape] = (build_distance_tables(self._processors[shape])
                                   if self._step_type == "swap" else None)
        return self._tables[shape]

    def _chain_fns(self, mcmc_steps):
        """[(shapes, chain fn)]: one batched distance chain per group of
        chain shapes whose tables stack (equal ranks and features: every
        shape of one size), for ``mcmc_steps`` steps."""
        key = int(mcmc_steps)
        if key not in self._chains:
            groups = {}
            for shape in range(len(self._processors)):
                tables = self._shape_tables(shape)
                if tables is not None:
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
            mcmc_steps: steps per temperature per walker.
            temperatures: unitless ladder (default linspace(5, 0.01, 20)).
            initial_occupancies: optional [n_shapes, N] start points.
            clear_previous: drop previously found structures.
            max_save_num: cap on stored structures (each walker's best).
            nwalkers: walkers per supercell shape.
            progress: print each shape's best score.
            seed: seed of the numpy generator that draws the starts and the
                seeds of the shapes' kernels and generators.

        Every shape draws its kernel's seed, its starts and its generator's
        seed from the numpy generator in shape order, as the reference's
        loop over shapes does.  Then each temperature is one launch of the
        distance chain for all the chain shapes (per chunk), each drawing
        its pairs and seed from its own generator, which gives what one
        launch per shape would at the same lanes a walker
        (:func:`smol_tpu_torch.ops.sqs.launch_lanes`: they follow the
        launch's walkers and set the order in which a walker's feature
        changes are summed); and ``mcmc_steps`` steps of the per-step path
        for each other shape, shape by shape, each from its own generator.
        ``start_scores`` then holds each shape's starting scores [W], and
        ``stage_records``, shape by shape and for every temperature, the
        shape, the temperature and the walkers' occupancies, scores and
        accept counts at the end of that temperature (all on the
        generator's device).
        """
        if temperatures is None:
            temperatures = np.linspace(5.0, 0.01, 20)
        if clear_previous:
            self._best = []
        rng = np.random.default_rng(seed)
        self.start_scores = []
        states, generators, kernels = [], [], []
        for shape, processor in enumerate(self._processors):
            kernel_seed = int(rng.integers(2**31))
            if initial_occupancies is not None:
                occu0 = np.asarray(initial_occupancies[shape], dtype=np.int32)
                occus = np.tile(occu0, (nwalkers, 1))
            else:
                occus = random_starts(processor, nwalkers, rng)
            generator = torch.Generator(device=self.device)
            generator.manual_seed(int(rng.integers(2**31)))
            if self._shape_tables(shape) is None:  # the per-step path
                kernel = Metropolis(Ensemble(processor), self._step_type,
                                    temperature=float(temperatures[0]), seed=kernel_seed,
                                    **self._kernel_kwargs)
                kernel.kB = 1.0
                state = kernel.initial_state(occus)
                scores = state["enthalpy"]
            else:
                kernel = None
                occu = torch.as_tensor(occus, dtype=torch.int32, device=self.device)
                scores = processor.compute_scores(occu)
                state = {"occupancy": occu, "enthalpy": scores,
                         "naccept": torch.zeros(nwalkers, dtype=torch.int32,
                                                device=self.device)}
            self.start_scores.append(scores.clone())
            state["best_enthalpy"] = scores.clone()
            state["best_occupancy"] = state["occupancy"].clone()
            states.append(state)
            generators.append(generator)
            kernels.append(kernel)
        cuda = self.device.type == "cuda"
        self._exec_paths = [
            ("cuda-step" if cuda else "cpu-step") if kernel is not None
            else ("cuda-distance-chain" if cuda else "cpu-twin[distance]")
            for kernel in kernels]
        steps = {shape: kernel.make_step_fn() for shape, kernel in enumerate(kernels)
                 if kernel is not None}
        records = [[] for _ in states]
        chain_fns = self._chain_fns(mcmc_steps)
        for temp in temperatures:
            for state in states:
                state["beta"] = torch.full((nwalkers,), 1.0 / float(temp),
                                           dtype=torch.float64, device=self.device)
                state["window_naccept"] = torch.zeros_like(state["naccept"])
            for shapes, chain_fn in chain_fns:
                chain_fn([states[s] for s in shapes], [generators[s] for s in shapes])
            for shape, step in steps.items():
                state = states[shape]
                start = state["naccept"].clone()
                for _ in range(int(mcmc_steps)):
                    state = _step_tracking_best(step, state, generators[shape])
                state["window_naccept"] = state["naccept"] - start
                states[shape] = state
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
