"""Special quasi-random structure (SQS) generation on the distance chain.

Counterpart of ``smol_tpu/capp/generate/special/sqs.py``
(``StochasticSQSGenerator`` :274).  Each supercell shape anneals a batch of
walkers of canonical swaps against its distance processor's score
d = -w L + ||W (f - f_T)||_1 at kB = 1
(https://doi.org/10.1016/j.calphad.2013.06.006): one composition-exact
start, a random permutation of it within each sublattice per walker, then
one launch of the distance chain per temperature (:mod:`smol_tpu_torch.ops.sqs`,
the CUDA kernel on the card, its plain torch twin on the CPU), each walker
keeping its best (score, occupancy); the best occupancies are rescored
exactly at the end.  The generator is built from distance processors
(:meth:`StochasticSQSGenerator.from_processors`); what needs the host layer
(structures, duplicate removal, shape enumeration) raises.
"""

from __future__ import annotations

import warnings
from abc import ABC, abstractmethod
from dataclasses import dataclass

import numpy as np
import torch

from smol_tpu_torch.capp.generate.random import generate_random_ordered_occupancy
from smol_tpu_torch.ops.sqs import build_distance_tables, make_distance_chain

__all__ = ["SQS", "SQSGenerator", "StochasticSQSGenerator", "random_starts"]

HOST_LAYER = "the host layer is not ported yet (ROADMAP.md Queue 1 item 1)"


@dataclass(frozen=True)
class SQS:
    """One SQS found: its occupancy [N] int32, its exact score and distance
    features, and its supercell matrix."""

    occupancy: np.ndarray
    score: float
    feature_distance: np.ndarray
    supercell_matrix: np.ndarray

    @property
    def structure(self):
        raise NotImplementedError(f"an SQS structure needs species and sites: {HOST_LAYER}")


def random_starts(processor, nwalkers, rng) -> np.ndarray:
    """Starting occupancies [nwalkers, N] int32 of one shape: one
    composition-exact occupancy, then an independent uniform permutation of
    it within each sublattice per walker (the reference's :436-448, with the
    same draws from the numpy generator ``rng``)."""
    occu0 = generate_random_ordered_occupancy(processor, rng=rng)
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
                    "(ROADMAP.md Queue 1 item 8)"
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
    def from_structure(cls, *args, **kwargs):
        """Enumerating the supercell shapes of a structure: not ported."""
        raise NotImplementedError(f"the shape enumeration needs crystal symmetry: {HOST_LAYER}")

    @classmethod
    def from_processors(cls, processors, device="cuda", **kwargs):
        """A generator over prebuilt distance processors, one per shape
        (the reference's :171-194)."""
        return cls(processors, device=device, **kwargs)

    @property
    def processors(self):
        return self._processors

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

    def get_best_sqs(self, num_structures=1, remove_duplicates=False):
        """The best SQS found so far, ranked by score (ties in shape, then
        walker order)."""
        if remove_duplicates:
            raise NotImplementedError(
                f"removing duplicates needs a structure matcher: {HOST_LAYER}")
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
        best = []
        for score, i, w in records[:num_structures]:
            shape, occupancies, _, features = self._best[i]
            best.append(SQS(
                occupancy=occupancies[w], score=score, feature_distance=features[w],
                supercell_matrix=self._processors[shape].supercell_matrix,
            ))
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
                "the per-step path is not ported yet (ROADMAP.md Queue 1 item 8)"
            )
        super().__init__(processors, device=device)
        self._tables = {}  # shape -> DistanceTables
        self._chain_fns = {}  # (shape, steps) -> chain fn
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
            "the multicell sampler is not ported yet (ROADMAP.md Queue 1 item 8)"
        )

    def _chain_fn(self, shape, mcmc_steps):
        key = (shape, int(mcmc_steps))
        if key not in self._chain_fns:
            if shape not in self._tables:
                self._tables[shape] = build_distance_tables(self._processors[shape])
            self._chain_fns[key] = make_distance_chain(
                self._tables[shape], int(mcmc_steps),
                self._processors[shape].compute_corr,
            )
        return self._chain_fns[key]

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

        ``start_scores`` then holds each shape's starting scores [W], and
        ``stage_records``, for every launch, the shape, the temperature and
        the walkers' occupancies, scores and accept counts at its end (all
        on the generator's device).
        """
        if temperatures is None:
            temperatures = np.linspace(5.0, 0.01, 20)
        if clear_previous:
            self._best = []
        rng = np.random.default_rng(seed)
        self.stage_records, self.start_scores = [], []
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
            state = {
                "occupancy": occu, "enthalpy": scores,
                "naccept": torch.zeros(nwalkers, dtype=torch.int32, device=self.device),
                "best_enthalpy": scores.clone(), "best_occupancy": occu.clone(),
            }
            chain_fn = self._chain_fn(shape, mcmc_steps)
            for temp in temperatures:
                state["beta"] = torch.full((nwalkers,), 1.0 / float(temp),
                                           dtype=torch.float64, device=self.device)
                state["window_naccept"] = torch.zeros_like(state["naccept"])
                state = chain_fn(state, generator)
                self.stage_records.append({
                    "shape": shape, "temperature": float(temp),
                    "occupancy": state["occupancy"].clone(),
                    "enthalpy": state["enthalpy"].clone(),
                    "naccept": state["window_naccept"],
                })
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
