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
"""

from __future__ import annotations

import numpy as np
import torch

from smol_tpu_torch.ops.reductions import (
    masked_min_segments,
    masked_stats_segments,
)

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


class SampleContainer:
    """Holds the sampled traces of an MC run.

    Args:
        ensemble: the ensemble sampled from.
        trace_names: the recorded quantities (``occupancy`` first).
        traces: optional restored batch, a dict of arrays [k, W, ...]
            holding every name in ``trace_names``.
        aux_names: the quantities recorded as aux records.

    ``pending_bytes_max``: the bytes of record batches kept where the run
    wrote them before they move to host memory.  None (the default) keeps
    up to 2 GiB on a CUDA device, or more while they take at most half of
    the device memory free besides them, and sets no cap on the CPU; set it
    to bound them yourself.
    """

    pending_bytes_max = None
    PENDING_BYTES_KEPT = 2 << 30  # kept on the device without asking (the reference's cap)

    def __init__(self, ensemble, trace_names, traces=None, aux_names=()):
        self._ensemble = ensemble
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
    def natural_parameters(self) -> np.ndarray:
        return np.asarray(self._ensemble.natural_parameters)

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

    def save_sampled_traces(self, traces):
        """Append a batch of records [k, W, ...]; it stays where it is until
        the kept batches pass the cap, when they all move to host memory."""
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
        ncoef = self._ensemble.num_energy_coefs
        if len(self.natural_parameters) == ncoef:
            return self.mean_enthalpy(discard, thin_by, flat)
        features = self.get_feature_vectors(discard, thin_by, flat)
        energies = features[..., :ncoef] @ self.natural_parameters[:ncoef]
        return energies.mean(axis=0)

    def sampling_efficiency(self, discard=0, flat=True):
        """Mean acceptance fraction of the recorded windows."""
        return self.mean_trace_value("accept_rate", discard, flat=flat)
