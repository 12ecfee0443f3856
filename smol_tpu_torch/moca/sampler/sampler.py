"""Sampler: drives the flip, swap, table or Wang-Landau chain and stores its traces.

Counterpart of ``smol_tpu/moca/sampler/sampler.py``.  ``run`` drives one
chain call per thinning window (:func:`smol_tpu_torch.ops.mc.run_chain_fused`)
on the ensemble's device; the records stay there, in the
:class:`~smol_tpu_torch.moca.sampler.container.SampleContainer`, until a
reader asks for them.  The device is explicit: with ``device="cuda"`` the
chain runs the CUDA kernel or fails, and it runs on the CPU only when the
caller asks for ``device="cpu"``.
"""

from __future__ import annotations

from warnings import warn

import numpy as np
import torch

from smol_tpu_torch.constants import kB
from smol_tpu_torch.moca.kernel.metropolis import mckernel_factory
from smol_tpu_torch.moca.sampler.container import SampleContainer
from smol_tpu_torch.ops.mc import run_chain_fused

__all__ = ["Sampler"]

TRACE_NAMES = ("occupancy", "features", "enthalpy", "accepted", "accept_rate")


class Sampler:
    """Runs MCMC sampling of an ensemble on one device."""

    def __init__(self, kernel, container, nwalkers=1):
        """Prefer :meth:`from_ensemble`."""
        self._kernel = kernel
        self._container = container
        self._nwalkers = int(nwalkers)
        self._state = None
        self._chain_fns = {}
        self._generator = torch.Generator(device=kernel.device)
        self._generator.manual_seed(kernel.seed)
        if not kernel.track_features:
            container.set_derived_value("features", kernel.full_features_fn())

    @classmethod
    def from_ensemble(cls, ensemble, temperature=None, nwalkers=1, seed=None,
                      device="cuda", step_type=None, kernel_type="Metropolis",
                      replica_exchange_period=None, **kwargs):
        """A Sampler of ``ensemble`` on ``device``.

        The default step type is ``"flip"`` for a semigrand ensemble and
        ``"swap"`` for a canonical one (no chemical potentials), as in the
        reference; ``"table-flip"`` takes the constrained (charge-neutral)
        moves of the system's flip table.  ``kwargs`` go to the kernel:
        :class:`~smol_tpu_torch.moca.kernel.metropolis.Metropolis`, which
        needs a ``temperature``, or, with ``kernel_type="wang-landau"``,
        :class:`~smol_tpu_torch.moca.kernel.wanglandau.WangLandau`, which
        takes none and needs ``min_enthalpy``, ``max_enthalpy`` and
        ``bin_size``.
        """
        if replica_exchange_period is not None:
            raise NotImplementedError(
                "replica exchange is not ported yet (ROADMAP.md Queue 1 item 6)"
            )
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch sees no CUDA device; pass "
                "device='cpu' to run the plain torch chain on the CPU"
            )
        if ensemble.device.type != device.type or (
            device.index is not None and ensemble.device != device
        ):
            raise ValueError(
                f"the ensemble lives on {ensemble.device}, not on {device}"
            )
        if step_type is None:
            step_type = (
                "flip" if ensemble.chemical_potential_table is not None else "swap"
            )
        # a thermal kernel takes its temperature first; Wang-Landau takes none
        args = () if temperature is None else (temperature,)
        kernel = mckernel_factory(
            kernel_type, ensemble, step_type, *args, seed=seed, **kwargs
        )
        names = TRACE_NAMES + (("temperature",) if hasattr(kernel, "temperature") else ())
        container = SampleContainer(
            ensemble, names + tuple(kernel.trace_names),
            aux_names=tuple(kernel.aux_traces.values()))
        return cls(kernel, container, nwalkers=nwalkers)

    # ---------------- properties ----------------

    @property
    def samples(self) -> SampleContainer:
        return self._container

    @property
    def mckernel(self):
        return self._kernel

    def efficiency(self, discard=0, flat=True):
        return self._container.sampling_efficiency(discard=discard, flat=flat)

    # ---------------- running ----------------

    def _get_chain_fn(self, thin_by: int):
        if thin_by not in self._chain_fns:
            self._chain_fns[thin_by] = self._kernel.make_chain_fn(thin_by)
        return self._chain_fns[thin_by]

    def execution_path(self, thin_by: int = 1) -> str:
        """The path ``run(thin_by=...)`` dispatches, as one string.

        ``"cuda-chain[flip]"``, ``"cuda-chain[swap]"``,
        ``"cuda-chain[table]"``, ``"cuda-chain[wl-flip]"`` or
        ``"cuda-chain[wl-swap]"`` on a CUDA device (the hand-written
        kernel), ``"cpu-twin[...]"`` on the CPU (the plain
        torch chain), then ``ewald`` when the delta carries the Ewald term,
        the energy delta (``direct``: one table lookup per local cluster)
        and the proposal schedule.
        """
        self._get_chain_fn(int(thin_by))
        kern = self._kernel
        where = "cuda-chain" if kern.device.type == "cuda" else "cpu-twin"
        parts = [f"{where}[{kern.chain_name}]"]
        if kern.chain_tables().has_ewald:
            parts.append("ewald")
        parts.append("direct")
        if kern.proposal_mode == "sweep":
            parts.append("sweep-schedule+independent-walkers")
        else:
            parts.append("shared-proposals")
        if kern.rng == "hash":
            parts.append("hash-rng")
        return "+".join(parts)

    def _record(self, state, thin_by):
        """One sample: tensors that no later window modifies."""
        rec = {
            "occupancy": self._kernel.state_occupancy(state).clone(),
            "enthalpy": state["enthalpy"].clone(),
            "accepted": state["accepted"].clone(),
            "accept_rate": state["window_naccept"].to(torch.float64) / thin_by,
        }
        if self._kernel.track_features:
            rec["features"] = state["features"].clone()
        if "beta" in state:
            rec["temperature"] = 1.0 / (kB * state["beta"])
        for name in self._kernel.trace_names:
            rec[name] = state[name].clone()
        return rec

    def _aux_record(self, state):
        """One aux record: copies of the cumulative Wang-Landau planes (the
        chain goes on updating the state's own in place)."""
        return {name: state[key].clone()
                for key, name in self._kernel.aux_traces.items()}

    def setup_sample(self, initial_occupancies):
        """Initialize the walker state from initial occupancies [W, N]."""
        occupancies = np.atleast_2d(np.asarray(initial_occupancies, dtype=np.int32))
        if occupancies.shape[0] != self._nwalkers:
            if occupancies.shape[0] != 1:
                raise ValueError(
                    f"Initial occupancies have {occupancies.shape[0]} "
                    f"walkers; expected {self._nwalkers}."
                )
            occupancies = np.repeat(occupancies, self._nwalkers, axis=0)
        self._state = self._kernel.initial_state(occupancies)
        return self._state

    def run(self, nsteps, initial_occupancies=None, thin_by=1,
            stream_chunk=0, profile_dir=None, aux_every=None):
        """Run ``nsteps`` MC steps per walker, saving a sample every ``thin_by``.

        Args:
            nsteps: total MC steps per walker.
            initial_occupancies: [W, N] (or [N]) int array; when None the
                run continues from the current state or, in a fresh
                sampler, from the container's last sample, with the
                kernel's aux state (the Wang-Landau record) restored.
            thin_by: steps between saved samples.
            aux_every: cadence, in samples, of the aux records (the
                cumulative Wang-Landau planes, see
                ``SampleContainer.aux_traced_values``).  By default one
                record is saved at the end of the run: every record is
                cumulative, so the last one carries the result.
            stream_chunk, profile_dir: not ported yet; must be left at
                their defaults.
        """
        if stream_chunk or profile_dir is not None:
            raise NotImplementedError(
                "HDF5 streaming and profiling are not ported yet "
                "(ROADMAP.md Queue 1 item 8)"
            )
        if nsteps % thin_by != 0:
            warn(
                f"nsteps {nsteps} is not a multiple of thin_by {thin_by}; "
                f"the last {nsteps % thin_by} steps are ignored.",
                RuntimeWarning,
            )
        if initial_occupancies is not None:
            self.setup_sample(initial_occupancies)
        elif self._state is None:
            if self._container.num_samples == 0:
                raise RuntimeError(
                    "No saved samples to take initial occupancies from; "
                    "they must be provided."
                )
            occupancies = self._container.last_trace_value("occupancy")
            self.setup_sample(occupancies.cpu().numpy())
            self._state = self._kernel.restore_aux_state(self._state, self._container)
            # other proposals than those of the run that is resumed
            self._generator.manual_seed(
                self._kernel.seed + self._container.num_samples)
        chain_fn = self._get_chain_fn(int(thin_by))
        nsamples = nsteps // thin_by
        has_aux = bool(self._container.aux_traced_values)
        # aux records land between launches: cap the launch at the cadence
        per_launch = int(aux_every) if has_aux and aux_every is not None else nsamples
        done = since_aux = 0
        while done < nsamples:
            launch = min(per_launch, nsamples - done)
            self._state, traces = run_chain_fused(
                self._state, self._generator, chain_fn,
                lambda st: self._record(st, thin_by), launch,
            )
            self._container.save_sampled_traces(traces)
            done += launch
            since_aux += launch
            if has_aux and (done >= nsamples or since_aux >= per_launch):
                self._container.save_aux_record(self._aux_record(self._state))
                since_aux = 0
