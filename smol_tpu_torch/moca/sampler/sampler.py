"""Sampler: drives the chains or the per-step path and stores their traces.

Counterpart of ``smol_tpu/moca/sampler/sampler.py``.  ``run`` drives, on
the ensemble's device, either the kernel's hand-written chain, one call
per thinning window (:func:`smol_tpu_torch.ops.mc.run_chain_fused`; with
replica exchange, one call of thin_by / period segments with an exchange
sweep after each, the reference's ``sampler.py:252-273``), or, where the
kernel's configuration takes it (independent proposals, a bias, the
multi-step and composite ushers, a table-flip usher the table chain cannot
honour, the uniformly random kernel, Wang-Landau with any of these or with
table flips, systems the chain tables refuse, restricted and split
sublattices among them, and replica exchange with a ``thin_by`` the period
does not divide), the per-step path (:func:`smol_tpu_torch.ops.mc.
run_chain`), as the reference dispatches (:453-465, :505-509).  It runs
in launches of a bounded number of records (about 256 MB each, as the
reference's ``samples_per_launch``); the records stay on the device, in
the :class:`~smol_tpu_torch.moca.sampler.container.SampleContainer`,
until a reader asks for them or their bytes pass the container's cap.
The device is explicit: with ``device="cuda"`` the chain runs the CUDA
kernel or fails, and it runs on the CPU only when the caller asks for
``device="cpu"``.
"""

from __future__ import annotations

import re
import time
from warnings import warn

import numpy as np
import torch

from smol_tpu_torch.constants import kB
from smol_tpu_torch.moca.kernel.metropolis import mckernel_factory
from smol_tpu_torch.moca.sampler.container import SampleContainer
from smol_tpu_torch.moca.trace import Trace
from smol_tpu_torch.ops.mc import run_chain, run_chain_fused, step_window
from smol_tpu_torch.parallel.tempering import make_tempering_chain, make_tempering_step

__all__ = ["Sampler"]

TRACE_NAMES = ("occupancy", "features", "enthalpy", "accepted", "accept_rate")
LAUNCH_RECORD_BYTES = 256 << 20  # records of one launch (the reference's bound)


class Sampler:
    """Runs MCMC sampling of an ensemble on one device."""

    def __init__(self, kernel, container, nwalkers=1, replica_exchange_period=None):
        """Prefer :meth:`from_ensemble`."""
        if replica_exchange_period is not None:
            if not hasattr(kernel, "temperature"):
                raise ValueError("replica exchange needs a kernel with a temperature")
            if int(replica_exchange_period) < 1:
                raise ValueError("the replica exchange period must be positive")
            replica_exchange_period = int(replica_exchange_period)
        self._replica_exchange_period = replica_exchange_period
        self._kernel = kernel
        self._container = container
        self._nwalkers = int(nwalkers)
        self._state = None
        self._chain_fns = {}
        self._step_fn = None
        self._generator = torch.Generator(device=kernel.device)
        self._generator.manual_seed(kernel.seed)
        if not kernel.track_features:
            container.set_derived_value("features", kernel.full_features_fn())

    @classmethod
    def from_ensemble(cls, ensemble, temperature=None, nwalkers=1, seed=None,
                      device="cuda", step_type=None, kernel_type="Metropolis",
                      replica_exchange_period=None, seeds=None, **kwargs):
        """A Sampler of ``ensemble`` on ``device``.

        The default step type is ``"flip"`` for a semigrand ensemble and
        ``"swap"`` for a canonical one (no chemical potentials), as in the
        reference; ``"table-flip"`` takes the constrained (charge-neutral)
        moves of the system's flip table.  ``kwargs`` go to the kernel:
        :class:`~smol_tpu_torch.moca.kernel.metropolis.Metropolis`, which
        needs a ``temperature``, or, with ``kernel_type="wang-landau"``,
        :class:`~smol_tpu_torch.moca.kernel.wanglandau.WangLandau`, which
        takes none and needs ``min_enthalpy``, ``max_enthalpy`` and
        ``bin_size``.  A ``temperature`` ladder [nwalkers] with
        ``replica_exchange_period`` runs parallel tempering: every period
        steps adjacent walkers try to exchange their temperatures
        (:mod:`smol_tpu_torch.parallel.tempering`).  ``seeds``, the
        reference's seeds of several kernels, is not ported: one kernel runs
        every walker from ``seed``.
        """
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
        if seed is None and seeds:
            seed = seeds[0]
        # a thermal kernel takes its temperature first; Wang-Landau takes none
        args = () if temperature is None else (temperature,)
        kernel = mckernel_factory(
            kernel_type, ensemble, step_type, *args, seed=seed, **kwargs
        )
        names = TRACE_NAMES + (("temperature",) if hasattr(kernel, "temperature") else ())
        container = SampleContainer(
            ensemble, names + tuple(kernel.trace_names),
            aux_names=tuple(kernel.aux_traces.values()), nwalkers=nwalkers,
            sampling_metadata=ensemble.thermo_boundaries)
        return cls(kernel, container, nwalkers=nwalkers,
                   replica_exchange_period=replica_exchange_period)

    # ---------------- properties ----------------

    @property
    def samples(self) -> SampleContainer:
        return self._container

    @property
    def mckernel(self):
        return self._kernel

    @property
    def mckernels(self):
        """The one kernel that runs every walker, in a list (the reference's
        API)."""
        return [self._kernel]

    @property
    def seeds(self):
        return [self._kernel.seed]

    @property
    def nwalkers(self) -> int:
        return self._nwalkers

    def efficiency(self, discard=0, flat=True):
        return self._container.sampling_efficiency(discard=discard, flat=flat)

    def clear_samples(self):
        """Remove the container's samples (the walker state stays)."""
        self._container.clear()

    # ---------------- running ----------------

    def _get_chain_fn(self, thin_by: int):
        """The chain of one thinning window (with replica exchange, thin_by /
        period segments of the kernel's period chain with an exchange sweep
        after each, ``make_tempering_chain``), or None where the window
        takes the per-step path: a kernel that does not run on a chain, or
        a ``thin_by`` the exchange period does not divide."""
        if thin_by not in self._chain_fns:
            period, kernel = self._replica_exchange_period, self._kernel
            fn = None
            if kernel.runs_chain:
                if period is None:
                    fn = kernel.make_chain_fn(thin_by)
                elif thin_by % period == 0:
                    fn = make_tempering_chain(kernel.make_chain_fn(period), thin_by // period)
            self._chain_fns[thin_by] = fn
        return self._chain_fns[thin_by]

    def _get_step_fn(self):
        """One step of every walker on the per-step path (with replica
        exchange, an exchange sweep every period steps,
        ``make_tempering_step``)."""
        if self._step_fn is None:
            fn = self._kernel.make_step_fn()
            if self._replica_exchange_period is not None:
                fn = make_tempering_step(fn, self._replica_exchange_period)
            self._step_fn = fn
        return self._step_fn

    def execution_path(self, thin_by: int = 1) -> str:
        """The path ``run(thin_by=...)`` dispatches, as one string.

        On a chain: ``"cuda-chain[flip]"``, ``"cuda-chain[swap]"``,
        ``"cuda-chain[table]"``, ``"cuda-chain[wl-flip]"`` or
        ``"cuda-chain[wl-swap]"`` on a CUDA device (the hand-written
        kernel), ``"cpu-twin[...]"`` on the CPU (the plain
        torch chain), then ``ewald`` when the delta carries the Ewald term,
        the energy delta (``direct``: one table lookup per local cluster;
        ``qary2``, ``qary3`` or ``qary4``: the Z_q character rows of K3; ``ising``:
        the parity rows of K1-Ising) and the proposal schedule.  On the
        per-step path: ``"cuda-step[<usher>]"`` or ``"cpu-step[<usher>]"``
        (the usher's step type, ``flip``, ``swap``, ``table-flip``,
        ``multi-step`` or ``composite``), ``general`` and
        ``independent-proposals`` (the
        reference's ``"xla-step+general+independent-proposals"``).  With
        replica exchange, ``replica-exchange@<period>`` last.
        """
        kern = self._kernel
        cuda = kern.device.type == "cuda"
        if self._get_chain_fn(int(thin_by)) is None:
            self._get_step_fn()
            # the usher's step type: "MultiStep" -> "multi-step"
            usher = re.sub(r"(?<!^)(?=[A-Z])", "-", type(kern.mcusher).__name__).lower()
            parts = [f"{'cuda' if cuda else 'cpu'}-step[{usher}]", "general",
                     "independent-proposals"]
        else:
            parts = [f"{'cuda-chain' if cuda else 'cpu-twin'}[{kern.chain_name}]"]
            tables = kern.chain_tables()
            if tables.has_ewald:
                parts.append("ewald")
            parts.append(f"qary{tables.qary}" if tables.qary else tables.delta)
            if kern.proposal_mode == "sweep":
                parts.append("sweep-schedule+independent-walkers")
            else:
                parts.append("shared-proposals")
            if kern.rng == "hash":
                parts.append("hash-rng")
        if self._replica_exchange_period is not None:
            parts.append(f"replica-exchange@{self._replica_exchange_period}")
        return "+".join(parts)

    def _record(self, state, thin_by):
        """One sample, as views of the state where it can (the launch's
        stack copies them before the next window)."""
        rec = {
            "occupancy": self._kernel.state_occupancy(state),
            "enthalpy": state["enthalpy"],
            "accepted": state["accepted"],
            "accept_rate": state["window_naccept"].to(torch.float64) / thin_by,
        }
        if self._kernel.track_features:
            rec["features"] = state["features"]
        if "beta" in state:
            rec["temperature"] = 1.0 / (kB * state["beta"])
        for name in self._kernel.trace_names:
            rec[name] = state[name]
        return rec

    def _record_bytes(self, thin_by) -> int:
        """Bytes of one record of the current state."""
        state = {"window_naccept": torch.zeros_like(self._state["naccept"]),
                 **self._state}
        return sum(v.numel() * v.element_size()
                   for v in self._record(state, thin_by).values())

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
        if self._replica_exchange_period is not None:
            # a host int: the chain's segments, or the per-step path's steps
            self._state["pt_counter"] = 0
            # accepted exchanges, at each pair's left member
            self._state["pt_accepted"] = torch.zeros_like(self._state["naccept"])
        return self._state

    def run(self, nsteps, initial_occupancies=None, thin_by=1, progress=False,
            stream_chunk=0, stream_file=None, keep_last_chunk=False, swmr_mode=False,
            samples_per_launch=None, profile_dir=None, aux_every=None):
        """Run ``nsteps`` MC steps per walker, saving a sample every ``thin_by``.

        The reference's parameters, in its order (``smol_tpu/moca/sampler/
        sampler.py:348-361``).

        Args:
            nsteps: total MC steps per walker.
            initial_occupancies: [W, N] (or [N]) int array; when None the
                run continues from the current state or, in a fresh
                sampler, from the container's last sample, with the
                kernel's aux state (the Wang-Landau record) restored.
            thin_by: steps between saved samples.
            progress: print each launch's progress and its attempts per
                second on the host; the device is waited for at the end of
                each launch of windows, never inside one.
            samples_per_launch: records stacked per launch of windows; by
                default as many as fill about 256 MB (at least one), and at
                most ``aux_every`` where aux records are kept.
            aux_every: cadence, in samples, of the aux records (the
                cumulative Wang-Landau planes, see
                ``SampleContainer.aux_traced_values``).  By default one
                record is saved at the end of the run: every record is
                cumulative, so the last one carries the result.
            stream_chunk, stream_file, keep_last_chunk, swmr_mode,
            profile_dir: HDF5 streaming and profiling, not ported yet; must
                be left at their defaults.
        """
        if (stream_chunk or stream_file is not None or keep_last_chunk or swmr_mode
                or profile_dir is not None):
            raise NotImplementedError(
                "HDF5 streaming (stream_chunk, stream_file, keep_last_chunk, "
                "swmr_mode) and profiling (profile_dir) are not ported yet "
                "(ROADMAP.md Queue 1 item 6)"
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
        if chain_fn is None:  # the per-step path
            chain_fn = step_window(self._get_step_fn(), int(thin_by))
        nsamples = nsteps // thin_by
        if samples_per_launch is None:
            samples_per_launch = max(
                1, min(nsamples, LAUNCH_RECORD_BYTES // max(self._record_bytes(thin_by), 1)))
        per_launch = int(samples_per_launch)
        if per_launch < 1:
            raise ValueError(f"samples_per_launch must be positive, not {per_launch}")
        has_aux = bool(self._container.aux_traced_values)
        done = since_aux = 0
        while done < nsamples:
            launch = min(per_launch, nsamples - done)
            if has_aux and aux_every is not None:
                launch = min(launch, int(aux_every) - since_aux)
            t_launch = time.perf_counter()
            self._state, traces = run_chain_fused(
                self._state, self._generator, chain_fn,
                lambda st: self._record(st, thin_by), launch,
            )
            self._container.save_sampled_traces(traces, thinned_by=thin_by)
            done += launch
            since_aux += launch
            if has_aux and (done >= nsamples or (
                    aux_every is not None and since_aux >= int(aux_every))):
                self._container.save_aux_record(self._aux_record(self._state))
                since_aux = 0
            if progress:
                if self._kernel.device.type == "cuda":  # the launch's end
                    torch.cuda.synchronize(self._kernel.device)
                elapsed = time.perf_counter() - t_launch
                attempts = launch * thin_by * self._nwalkers
                print(f"sampled {done}/{nsamples} (x{thin_by} steps, "
                      f"{attempts / max(elapsed, 1e-9) / 1e6:.1f} M attempts/s)")

    def sample(self, nsteps, initial_occupancies, thin_by=1, progress=False):
        """A generator of a host :class:`~smol_tpu_torch.moca.trace.Trace`
        every ``thin_by`` steps, on the per-step path, as the reference's
        always is (``smol_tpu/moca/sampler/sampler.py:643-673``).

        Each trace holds the walkers' ``occupancy``, ``enthalpy``,
        ``accepted``, ``accept_rate`` (and ``temperature``) of the sample,
        and their exact ``features``; nothing goes to the container.  The
        reference's API: prefer :meth:`run`, which keeps its records on the
        device.  ``progress`` is accepted and ignored, as there.
        """
        self.setup_sample(initial_occupancies)
        step_fn = self._get_step_fn()
        features = self._kernel.full_features_fn()
        for _ in range(nsteps // thin_by):
            self._state, traces = run_chain(
                self._state, self._generator, step_fn,
                lambda st: self._record(st, thin_by), 1, thin_by)
            values = {name: value[0] for name, value in traces.items()}
            values.setdefault("features", features(values["occupancy"]))
            yield Trace(**{name: value.cpu().numpy() for name, value in values.items()})

    def anneal(self, temperatures, mcmc_steps, initial_occupancies=None, thin_by=1,
               progress=False, stream_chunk=0, stream_file=None, swmr_mode=True):
        """Simulated annealing: ``mcmc_steps`` at each temperature in turn,
        from the hottest down (``smol_tpu/moca/sampler/sampler.py:675-721``).

        Every walker takes each temperature before its run (the state's
        beta is reset), and the samples of all runs stay in the container,
        in order.  HDF5 streaming (``stream_chunk``, ``stream_file``) is not
        ported yet (ROADMAP.md Queue 1 item 6); ``swmr_mode`` only matters
        with it.
        """
        if temperatures[0] < temperatures[-1]:
            raise ValueError(
                "End temperature is greater than start temperature: "
                f"{temperatures[-1]:.2f} > {temperatures[0]:.2f}."
            )
        if stream_chunk or stream_file is not None:
            raise NotImplementedError(
                "HDF5 streaming (stream_chunk, stream_file) is not ported yet "
                "(ROADMAP.md Queue 1 item 6)")
        if not hasattr(self._kernel, "temperature"):
            raise ValueError("annealing needs a kernel with a temperature")
        for i, temperature in enumerate(temperatures):
            self._kernel.temperature = temperature
            if self._state is not None and "beta" in self._state:
                self._state["beta"] = torch.full_like(self._state["beta"],
                                                      self._kernel.beta)
            self.run(mcmc_steps, initial_occupancies=None if i else initial_occupancies,
                     thin_by=thin_by, progress=progress)
