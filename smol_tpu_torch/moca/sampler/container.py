"""SampleContainer: device-resident traces of an MC run and their statistics.

Counterpart of ``smol_tpu/moca/sampler/container.py``.  Record batches
[k, W, ...] stay on the device where the chain wrote them; a getter copies
only the rows it selects, and the statistics reduce where each batch lives
(:mod:`smol_tpu_torch.ops.reductions`) and copy one result.  Once the
batches kept on the device pass a cap (:attr:`SampleContainer.
pending_bytes_max`), they move to host memory, pinned where a card is
present.  By default they stay while they hold at most 2 GiB (the
reference's cap, ``container.py`` :97-102, 468-486) or at most half of the
device memory free besides them, which ``torch.cuda.mem_get_info`` reads
only past 2 GiB (the call waits for the device).

The ``features`` trace is derived: a sampler that does not track features
registers a function of the occupancies (:meth:`set_derived_value`), and
the container evaluates it on the rows a reader selects, when it reads
them, on the ensemble's device wherever the batch lives, so a batch moved
to the host gives the same values.  A batch that already carries the
derived entry (one restored from saved traces) is served as it is and
never recomputed.

Aux records (counterpart of the reference's aux trace, ``container.py``
:32-78, :506-556) hold bulky cumulative kernel state, such as the
Wang-Landau entropy, histogram and mean-feature planes, on a cadence of
their own: each record is cumulative, so the last one carries the result.
They too stay device tensors until read, and
:meth:`SampleContainer.get_trace_value` serves them by name on the record
axis.  HDF5 storage is not ported yet (ROADMAP.md Queue 1 item 6).

The reference's getters (``container.py:127-450``) read the same records:
energies, feature means and variances, minima and their occupancies,
orbit factors, species counts and compositions (per sublattice and in
total), sampled structures; the means and variances of recorded or derived
quantities reduce on the device (:meth:`SampleContainer.mean_trace_value`),
the others are numpy over the host copy of the selected rows, as the
reference's.  :meth:`SampleContainer.vacuum` gathers every sample into one
host batch (the reference trims its preallocated arrays), and
``as_dict``/``from_dict`` write and read the reference's record.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from smol_tpu_torch.moca.metadata import Metadata
from smol_tpu_torch.ops.reductions import (
    masked_min_segments,
    masked_stats_segments,
)
from smol_tpu_torch.serial import MSONable, jsanitize, process_decoded

__all__ = ["SampleContainer"]


def _batch_bytes(batch) -> int:
    return sum(v.numel() * v.element_size() for v in batch.values())


def _to_host(tensor):
    """A host copy of a device tensor, pinned (a CPU tensor stays)."""
    if tensor.device.type == "cpu":
        return tensor
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor)
    return host


class SampleContainer(MSONable):
    """Holds the sampled traces of an MC run.

    Args:
        ensemble: the ensemble sampled from, or a dict of its specs
            (``num_sites``, ``system_size``, ``natural_parameters``,
            ``num_energy_coefs``; a container read back without its
            ensemble).
        trace_names: the recorded quantities (``occupancy`` first).
        traces: optional restored batch, a dict of arrays [k, W, ...]
            holding every name in ``trace_names``.
        aux_names: the quantities recorded as aux records.
        nwalkers: the walkers of a record (read from the records where
            there are any).
        sampling_metadata: a dict kept as the container's ``metadata``.

    ``pending_bytes_max``: the bytes of record batches kept where the run
    wrote them before they move to host memory.  None (the default) keeps
    up to 2 GiB on a CUDA device, or more while they take at most half of
    the device memory free besides them, and sets no cap on the CPU; set it
    to bound them yourself.
    """

    pending_bytes_max = None
    PENDING_BYTES_KEPT = 2 << 30  # kept on the device without asking (the reference's cap)

    def __init__(self, ensemble, trace_names, traces=None, aux_names=(), nwalkers=None,
                 sampling_metadata=None):
        if isinstance(ensemble, dict):
            self._ensemble, self._ensemble_specs, self._sublattices = None, ensemble, []
        else:
            self._ensemble = ensemble
            self._ensemble_specs = {
                "num_sites": ensemble.num_sites,
                "system_size": ensemble.system_size,
                "natural_parameters": np.asarray(ensemble.natural_parameters),
                "num_energy_coefs": ensemble.num_energy_coefs,
            }
            self._sublattices = ensemble.sublattices
        meta = dict(sampling_metadata or {})
        meta.pop("cls_name", None)
        self.metadata = Metadata("SampleContainer", **meta)
        self._nwalkers = nwalkers
        self.total_mc_steps_per_sample = 1
        self._names = tuple(trace_names)
        self._aux_names = tuple(aux_names)
        self._aux_records = []  # (dict of tensors [W, ...], sample index)
        self._batches = []  # dicts of tensors [k, W, ...], in sample order
        self._pending = []  # indices of the batches kept where they were written
        self._pending_bytes = 0
        self.moved_batches = 0  # batches moved to host memory past the cap
        self._derived = {}  # name -> fn(occupancies [n, N]) -> [n, ...]
        if traces is not None:
            missing = set(self._names) - set(traces)
            if missing:
                raise ValueError(f"restored traces lack {sorted(missing)}")
            self._batches.append(
                {name: torch.as_tensor(np.asarray(v)) for name, v in traces.items()}
            )

    # ---------------- properties ----------------

    @property
    def ensemble(self):
        return self._ensemble

    @property
    def sublattices(self):
        return self._sublattices

    @property
    def natural_parameters(self) -> np.ndarray:
        return np.asarray(self._ensemble_specs["natural_parameters"])

    @property
    def _num_energy_coefs(self) -> int:
        return int(self._ensemble_specs["num_energy_coefs"])

    @property
    def total_mc_steps(self) -> int:
        return self.total_mc_steps_per_sample * self.num_samples

    @property
    def shape(self) -> tuple:
        """(nwalkers, num_sites)."""
        nwalkers = (self._batches[0]["occupancy"].shape[1] if self._batches
                    else self._nwalkers)
        return (nwalkers, int(self._ensemble_specs["num_sites"]))

    @property
    def traced_values(self) -> list:
        return list(self._names + self._aux_names)

    @property
    def aux_traced_values(self) -> list:
        return list(self._aux_names)

    @property
    def num_aux_records(self) -> int:
        return len(self._aux_records)

    @property
    def aux_sample_indices(self) -> np.ndarray:
        """The sample index each aux record was taken at."""
        return np.array([index for _, index in self._aux_records], dtype=np.int64)

    @property
    def num_samples(self) -> int:
        return sum(len(batch["occupancy"]) for batch in self._batches)

    # ---------------- storage ----------------

    def set_derived_value(self, name, fn):
        """Serve ``name`` as ``fn(occupancies [n, N]) -> [n, ...]`` on read."""
        if name not in self._names:
            raise ValueError(f"{name} is not a traced quantity.")
        self._derived[name] = fn

    def save_sampled_traces(self, traces, thinned_by: int = 1):
        """Append a batch of records [k, W, ...], each ``thinned_by`` steps
        apart; it stays where it is until the kept batches pass the cap,
        when they all move to host memory."""
        self.total_mc_steps_per_sample = int(thinned_by)
        if not len(traces["occupancy"]):
            return
        batch = dict(traces)
        self._pending.append(len(self._batches))
        self._batches.append(batch)
        self._pending_bytes += _batch_bytes(batch)
        if self._pending_bytes > self._pending_cap(batch["occupancy"].device):
            for index in self._pending:
                self._batches[index] = {name: _to_host(value) for name, value
                                        in self._batches[index].items()}
            self.moved_batches += len(self._pending)
            self._pending, self._pending_bytes = [], 0

    def _pending_cap(self, device) -> float:
        if self.pending_bytes_max is not None:
            return self.pending_bytes_max
        if device.type != "cuda" or self._pending_bytes <= self.PENDING_BYTES_KEPT:
            return float("inf")
        free, _ = torch.cuda.mem_get_info(device)
        return (free + self._pending_bytes) // 2

    def clear(self):
        """Remove every sample and aux record."""
        self._batches, self._pending, self._aux_records = [], [], []
        self._pending_bytes = 0

    def save_aux_record(self, record: dict, sample_index=None):
        """Append one aux record, tensors [W, ...] that nothing modifies
        later; they stay where they are.  ``sample_index`` is the sample
        the record was taken at (default: the latest)."""
        missing = set(self._aux_names) - set(record)
        if missing:
            raise ValueError(f"the aux record lacks {sorted(missing)}")
        if sample_index is None:
            sample_index = self.num_samples - 1
        self._aux_records.append((dict(record), int(sample_index)))

    # ---------------- trace access ----------------

    def last_trace_value(self, name) -> torch.Tensor:
        """The newest record [W, ...] of a recorded (not derived) or aux
        quantity, as the device tensor it was saved as."""
        if name in self._aux_names:
            if not self._aux_records:
                raise IndexError("no aux record saved")
            return self._aux_records[-1][0][name]
        if name not in self._names:
            raise ValueError(f"{name} is not a traced quantity.")
        if not self._batches:
            raise IndexError("no samples saved")
        return self._batches[-1][name][-1]

    def _selection(self, discard, thin_by):
        """Per-batch boolean host masks of the selected sample rows."""
        masks, offset = [], 0
        start = discard + thin_by - 1
        for batch in self._batches:
            idx = np.arange(len(batch["occupancy"])) + offset
            masks.append((idx >= start) & ((idx - start) % thin_by == 0))
            offset += len(idx)
        return masks

    def _segments(self, name, masks):
        """(values, masks) of ``name`` per batch, derived rows only if selected."""
        segments, kept = [], []
        for batch, mask in zip(self._batches, masks):
            if not mask.any():
                continue
            if name in batch:
                segments.append(batch[name])
                kept.append(mask)
                continue
            if name not in self._derived:
                raise ValueError(f"{name} is not a traced quantity.")
            occ = batch["occupancy"]
            index = torch.as_tensor(np.flatnonzero(mask), device=occ.device)
            rows = occ.index_select(0, index).to(self._ensemble.device)
            values = self._derived[name](rows.reshape(-1, rows.shape[-1]))
            segments.append(values.reshape(*rows.shape[:2], *values.shape[1:]))
            kept.append(np.ones(len(index), dtype=bool))
        return segments, kept

    def get_trace_value(self, name, discard=0, thin_by=1, flat=True):
        """Host array of one traced quantity over the selected samples.

        An aux quantity is served on the aux record axis: ``discard`` and
        ``thin_by`` then select records, not samples.
        """
        if name in self._aux_names:
            records = self._aux_records[discard + thin_by - 1:: thin_by]
            if not records:
                raise IndexError("no aux records selected")
            value = np.stack([record[name].cpu().numpy() for record, _ in records])
            return value.reshape(-1, *value.shape[2:]) if flat else value
        segments, masks = self._segments(name, self._selection(discard, thin_by))
        parts = [
            values.index_select(
                0, torch.as_tensor(np.flatnonzero(m), device=values.device)
            ).cpu().numpy()
            for values, m in zip(segments, masks)
        ]
        if not parts:
            raise IndexError("no samples selected")
        value = np.concatenate(parts)
        return value.reshape(-1, *value.shape[2:]) if flat else value

    def _stats(self, name, discard, thin_by):
        segments, masks = self._segments(name, self._selection(discard, thin_by))
        rows = sum(int(m.sum()) for m in masks)
        if rows == 0:
            raise IndexError("no samples selected")
        return segments, masks, rows

    def mean_trace_value(self, name, discard=0, thin_by=1, flat=True):
        return masked_stats_segments(
            *self._stats(name, discard, thin_by), pool_walkers=flat
        )[0]

    def trace_value_variance(self, name, discard=0, thin_by=1, flat=True):
        return masked_stats_segments(
            *self._stats(name, discard, thin_by), pool_walkers=flat
        )[1]

    def get_occupancies(self, discard=0, thin_by=1, flat=True):
        return self.get_trace_value("occupancy", discard, thin_by, flat)

    def get_enthalpies(self, discard=0, thin_by=1, flat=True):
        return self.get_trace_value("enthalpy", discard, thin_by, flat)

    def get_feature_vectors(self, discard=0, thin_by=1, flat=True):
        return self.get_trace_value("features", discard, thin_by, flat)

    def get_temperatures(self, discard=0, thin_by=1, flat=True):
        """Each walker's temperature at each sample (per-walker under
        replica exchange)."""
        return self.get_trace_value("temperature", discard, thin_by, flat)

    # ---------------- statistics ----------------

    def mean_enthalpy(self, discard=0, thin_by=1, flat=True):
        return self.mean_trace_value("enthalpy", discard, thin_by, flat)

    def enthalpy_variance(self, discard=0, thin_by=1, flat=True):
        return self.trace_value_variance("enthalpy", discard, thin_by, flat)

    def get_minimum_enthalpy(self, discard=0, thin_by=1, flat=True):
        segments, masks, _ = self._stats("enthalpy", discard, thin_by)
        return masked_min_segments(segments, masks, pool_walkers=flat)

    def mean_energy(self, discard=0, thin_by=1, flat=True):
        """Mean energy, without the chemical work when mu were set."""
        if len(self.natural_parameters) == self._num_energy_coefs:
            return self.mean_enthalpy(discard, thin_by, flat)
        return self.get_energies(discard, thin_by, flat).mean(axis=0)

    def sampling_efficiency(self, discard=0, flat=True):
        """Mean acceptance fraction of the recorded windows."""
        return self.mean_trace_value("accept_rate", discard, flat=flat)

    # ---------------- the reference's getters (container.py:301-450) ----------------

    def get_energies(self, discard=0, thin_by=1, flat=True):
        """Energies (excluding chemical work when mu were set)."""
        if len(self.natural_parameters) == self._num_energy_coefs:
            return self.get_enthalpies(discard, thin_by, flat)
        features = self.get_feature_vectors(discard, thin_by, flat)
        return features[..., : self._num_energy_coefs] @ self.natural_parameters[
            : self._num_energy_coefs
        ]

    def get_orbit_factors(self, function_orbit_ids, discard=0, thin_by=1, flat=True):
        """Per-orbit sums of the natural-parameter-weighted features (the
        reference's grouping along the feature axis of every sample)."""
        vals = self.natural_parameters * self.get_feature_vectors(
            discard=discard, thin_by=thin_by, flat=flat
        )
        ids = np.asarray(function_orbit_ids)
        return np.stack(
            [vals[..., ids == i].sum(axis=-1) for i in range(int(ids.max()) + 1)],
            axis=-1,
        )

    def energy_variance(self, discard=0, thin_by=1, flat=True):
        if len(self.natural_parameters) == self._num_energy_coefs:
            return self.enthalpy_variance(discard, thin_by, flat)
        return self.get_energies(discard, thin_by, flat).var(axis=0)

    def mean_feature_vector(self, discard=0, thin_by=1, flat=True):
        return self.mean_trace_value("features", discard, thin_by, flat)

    def feature_vector_variance(self, discard=0, thin_by=1, flat=True):
        return self.trace_value_variance("features", discard, thin_by, flat)

    def get_minimum_energy(self, discard=0, thin_by=1, flat=True):
        return self.get_energies(discard, thin_by, flat).min(axis=0)

    def _minimum_occupancy(self, values, discard, thin_by, flat):
        inds = values.argmin(axis=0)
        occus = self.get_occupancies(discard, thin_by, flat)
        if flat:
            return occus[inds]
        return occus[inds, np.arange(self.shape[0])]

    def get_minimum_enthalpy_occupancy(self, discard=0, thin_by=1, flat=True):
        return self._minimum_occupancy(self.get_enthalpies(discard, thin_by, flat),
                                       discard, thin_by, flat)

    def get_minimum_energy_occupancy(self, discard=0, thin_by=1, flat=True):
        return self._minimum_occupancy(self.get_energies(discard, thin_by, flat),
                                       discard, thin_by, flat)

    def get_sublattice_species_counts(self, sublattice, discard=0, thin_by=1, flat=True):
        """Per-sample counts of each code of a sublattice (encoding order)."""
        if sublattice not in self._sublattices:
            raise ValueError("Sublattice provided is not recognized.")
        sub_occus = self.get_occupancies(discard, thin_by, flat=False)[..., sublattice.sites]
        counts = np.stack(
            [(sub_occus == code).sum(axis=-1) for code in sublattice.encoding], axis=-1
        ).astype(np.float64)
        return counts.reshape(-1, *counts.shape[2:]) if flat else counts

    def get_sublattice_compositions(self, sublattice, discard=0, thin_by=1, flat=True):
        counts = self.get_sublattice_species_counts(sublattice, discard, thin_by, flat)
        return counts / len(sublattice.sites)

    def get_species_counts(self, discard=0, thin_by=1, flat=True):
        """Dict species -> per-sample counts across all sublattices."""
        counts = defaultdict(float)
        for sublattice in self._sublattices:
            sub = self.get_sublattice_species_counts(sublattice, discard, thin_by, flat)
            for species, count in zip(sublattice.species, np.moveaxis(sub, -1, 0)):
                counts[species] = counts[species] + count
        return dict(counts)

    def get_compositions(self, discard=0, thin_by=1, flat=True):
        counts = self.get_species_counts(discard, thin_by, flat)
        return {sp: c / self.shape[1] for sp, c in counts.items()}

    def mean_composition(self, discard=0, thin_by=1, flat=True):
        return {sp: c.mean(axis=0)
                for sp, c in self.get_compositions(discard, thin_by, flat).items()}

    def composition_variance(self, discard=0, thin_by=1, flat=True):
        return {sp: c.var(axis=0)
                for sp, c in self.get_compositions(discard, thin_by, flat).items()}

    def mean_sublattice_composition(self, sublattice, discard=0, thin_by=1, flat=True):
        return self.get_sublattice_compositions(sublattice, discard, thin_by,
                                                flat).mean(axis=0)

    def sublattice_composition_variance(self, sublattice, discard=0, thin_by=1, flat=True):
        return self.get_sublattice_compositions(sublattice, discard, thin_by,
                                                flat).var(axis=0)

    def get_sampled_structures(self, indices=None, flat=True):
        """The sampled occupancies as structures (needs the ensemble)."""
        if self._ensemble is None:
            raise RuntimeError("Ensemble is not available in this container.")
        occus = self.get_occupancies(flat=flat)
        indices = range(len(occus)) if indices is None else indices
        return [self._ensemble.processor.structure_from_occupancy(occus[i])
                for i in indices]

    # ---------------- the reference's record ----------------

    def vacuum(self):
        """Gather every sample into one host batch, the derived values filled
        in, and every aux record into host memory."""
        if len(self._batches) > 1 or any(
                v.device.type != "cpu" for b in self._batches for v in b.values()) or (
                self._batches and set(self._names) - set(self._batches[0])):
            masks = self._selection(0, 1)
            batch = {}
            for name in self._names:
                segments, kept = self._segments(name, masks)
                batch[name] = torch.cat([
                    values.index_select(0, torch.as_tensor(np.flatnonzero(m),
                                                           device=values.device)).cpu()
                    for values, m in zip(segments, kept)])
            self._batches = [batch]
        self._pending, self._pending_bytes = [], 0
        self._aux_records = [({name: value.cpu() for name, value in record.items()}, index)
                             for record, index in self._aux_records]

    def as_dict(self) -> dict:
        """The reference's record (``container.py:740-757``)."""
        self.vacuum()
        batch = self._batches[0] if self._batches else {}
        trace = {name: batch[name].numpy() for name in self._names if name in batch}
        aux = {name: np.stack([record[name].numpy() for record, _ in self._aux_records])
               for name in self._aux_names if self._aux_records}
        return {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
            "ensemble_specs": jsanitize(self._ensemble_specs),
            "metadata": jsanitize(vars(self.metadata)),
            "trace": {k: v.tolist() for k, v in trace.items()},
            "trace_dtypes": {k: str(v.dtype) for k, v in trace.items()},
            "aux_trace": {k: v.tolist() for k, v in aux.items()},
            "aux_dtypes": {k: str(v.dtype) for k, v in aux.items()},
            "aux_indices": self.aux_sample_indices.tolist(),
            "nsamples": self.num_samples,
            "total_mc_steps_per_sample": self.total_mc_steps_per_sample,
            "sublattices": [s.as_dict() for s in self._sublattices],
        }

    @classmethod
    def from_dict(cls, d, ensemble=None):
        """A container of an ``as_dict`` record (the port's or the
        reference's), on ``ensemble`` where given, else on the record's
        specs (then the features are the recorded ones)."""
        specs = dict(d["ensemble_specs"])
        specs["natural_parameters"] = np.array(specs["natural_parameters"])
        traces = {k: np.array(v, dtype=d["trace_dtypes"][k]) for k, v in d["trace"].items()}
        names = tuple(traces)
        aux = {k: np.array(v, dtype=d["aux_dtypes"][k])
               for k, v in d.get("aux_trace", {}).items()}
        nwalkers = traces["occupancy"].shape[1] if traces.get("occupancy") is not None \
            and traces["occupancy"].ndim == 3 else None
        container = cls(ensemble if ensemble is not None else specs, names,
                        traces=traces if d["nsamples"] else None, aux_names=tuple(aux),
                        nwalkers=nwalkers, sampling_metadata=d.get("metadata"))
        container._sublattices = [process_decoded(s) for s in d.get("sublattices", [])]
        for k, index in enumerate(d.get("aux_indices", [])):
            container._aux_records.append(
                ({name: torch.as_tensor(values[k]) for name, values in aux.items()},
                 int(index)))
        container.total_mc_steps_per_sample = d["total_mc_steps_per_sample"]
        return container
