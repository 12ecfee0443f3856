"""The Wang-Landau kernel, on the shared-proposal chain or the per-step path.

Counterpart of ``smol_tpu/moca/kernel/wanglandau.py`` (constructor :27-86,
``make_step_fn`` :189-201, ``_build_chain_tables`` :208-238,
``make_chain_fn`` :240-309, ``restore_aux_state`` :311-344,
``initial_state`` :346-363): flat-histogram sampling of the density of
states over enthalpy bins.  Every walker carries its own window state
(entropy, histogram, occurrences, modification factor).  With ``Flip`` or
``Swap`` moves, shared proposals and a system the chain tables take, the
chain (:class:`smol_tpu_torch.ops.chain.WLChain`) updates it at every step
and the per-bin cumulative mean features are updated here once per
thinning window, from the exact features at the window's end (the
reference's estimator on the thinned subchain).  Everything else the
reference sends to its per-step Wang-Landau (``_wl_step``), and so does the
port (:meth:`WangLandau.make_step_fn`, :func:`smol_tpu_torch.ops.mc.
make_wang_landau_step`): independent proposals, the ``TableFlip``,
``MultiStep`` and ``Composite`` ushers, and systems the chain tables
refuse, restricted sites among them; there the mean features are updated
at every step, with ``occurrences`` as their count, and the exponent
carries the usher's a-priori factor (the table flips' detailed balance),
which the reference's ``_wl_step`` leaves out (ROADMAP.md Queue 3, C10).
Both paths share the state's planes.  Like the reference's, the kernel takes no bias: a
``bias_type`` raises ``ValueError``.

The reference's host single-walker path (``_accept_step``,
``_do_post_step``, the ``dos``/``levels`` properties of one walker) is not
ported yet (ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

import numpy as np
import torch

from smol_tpu_torch.moca.kernel.base import ChainKernel
from smol_tpu_torch.moca.kernel.tableflip import TableFlip
from smol_tpu_torch.ops import chain
from smol_tpu_torch.ops import mc as devmc

__all__ = ["WangLandau"]

class WangLandau(ChainKernel):
    """Wang-Landau sampling kernel.

    Args:
        ensemble: the :class:`~smol_tpu_torch.moca.ensemble.Ensemble`.
        step_type: any usher's (``"flip"``, ``"swap"``, ``"table-flip"``,
            ``"multi-step"``, ``"composite"``); flips and swaps run on the
            chain where the configuration allows, the rest per step.
        min_enthalpy, max_enthalpy, bin_size: the window [min, max) and
            the width of its bins, in eV.
        flatness: a histogram is flat when its least count over the
            visited bins exceeds this fraction of their mean.
        mod_factor: the starting entropy increment.
        check_period: steps between flatness checks.
        update_period: in-window steps between entropy updates.
        mod_update: what a flat histogram divides the increment by
            (default 2).
        args, kwargs: the usher's (``sublattice_probabilities``), the seed,
            and ``shared_proposals``, ``chain_block_size``,
            ``proposal_mode``, ``rng``, ``chain_delta``: see
            :class:`~smol_tpu_torch.moca.kernel.base.ChainKernel`.
    """

    track_features = True
    trace_names = ("mod_factor",)
    aux_traces = {
        "histogram": "histogram",
        "occurrences": "occurrences",
        "entropy": "entropy",
        "mean_features": "cumulative_mean_features",
        "wl_mean_counts": "cumulative_mean_counts",
    }

    def __init__(self, ensemble, step_type, min_enthalpy, max_enthalpy,
                 bin_size, *args, flatness=0.8, mod_factor=1.0, check_period=1000,
                 update_period=1, mod_update=None, **kwargs):
        if min_enthalpy > max_enthalpy:
            raise ValueError("min_enthalpy cannot be larger than max_enthalpy.")
        if (max_enthalpy - min_enthalpy) / bin_size <= 1:
            raise ValueError("Window and bin size give a single bin!")
        if mod_factor <= 0:
            raise ValueError("mod_factor must be greater than 0.")
        self.flatness = flatness
        self.check_period = check_period
        self.update_period = update_period
        self._m = mod_factor
        self._window = (min_enthalpy, max_enthalpy, bin_size)
        self._mod_divisor = float(mod_update) if mod_update is not None else 2.0
        self._levels = np.arange(min_enthalpy, max_enthalpy, bin_size)
        # valid_bias is None: a bias_type raises ValueError, as the reference's
        super().__init__(ensemble, step_type, *args, **kwargs)

    def _chain_refusal(self):
        """The chain's refusals; besides, the Wang-Landau chain takes flips
        and swaps only (``smol_tpu/moca/kernel/wanglandau.py:222-223``)."""
        if type(self.mcusher) is TableFlip:
            return "a TableFlip usher"
        return super()._chain_refusal()

    @property
    def bin_size(self):
        return self._window[2]

    @property
    def chain_name(self) -> str:
        return f"wl-{self.move}"

    @property
    def mod_factor(self):
        """The starting entropy increment (each walker keeps its own)."""
        return self._m

    def wl_chain(self) -> chain.WLChain:
        """The chain's static Wang-Landau parameters."""
        return chain.WLChain(
            min_enthalpy=float(self._window[0]),
            bin_size=float(self._window[2]),
            num_levels=len(self._levels),
            flatness=float(self.flatness),
            check_period=int(self.check_period),
            update_period=int(self.update_period),
            mod_divisor=float(self._mod_divisor),
        )

    def initial_state(self, occupancies) -> dict:
        state = super().initial_state(occupancies)
        device = self.device
        nwalkers, nlev = state["occupancy"].shape[0], len(self._levels)
        nfeat = len(self.natural_params)

        def zeros(*shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        state["entropy"] = zeros(nwalkers, nlev, dtype=torch.float64)
        state["histogram"] = zeros(nwalkers, nlev, dtype=torch.int32)
        state["occurrences"] = zeros(nwalkers, nlev, dtype=torch.int32)
        state["mean_features"] = zeros(nwalkers, nlev, nfeat, dtype=torch.float64)
        state["mod_factor"] = torch.full(
            (nwalkers,), float(self._m), dtype=torch.float64, device=device)
        state["wl_counter"] = zeros(nwalkers, dtype=torch.int32)
        # how many window ends each bin's mean features average over
        state["wl_mean_counts"] = zeros(nwalkers, nlev, dtype=torch.int32)
        return state

    def make_step_fn(self):
        """One Wang-Landau step of every walker on the per-step path, each
        with its own proposal, the usher's a-priori factor in the exponent
        (:func:`~smol_tpu_torch.ops.mc.make_wang_landau_step`)."""
        propose_fn, _ = self.mcusher.device_proposal(self.device)
        return devmc.make_wang_landau_step(
            propose_fn, self._device_applier(),
            min_enthalpy=float(self._window[0]), bin_size=float(self._window[2]),
            flatness=float(self.flatness), check_period=int(self.check_period),
            update_period=int(self.update_period), mod_divisor=float(self._mod_divisor),
            log_priori_fn=self.mcusher.device_log_priori(self.device))

    def make_chain_fn(self, n_steps: int, seqs=None, seeds=None):
        """``fn(state, generator) -> state`` of one thinning window.

        The chain runs ``n_steps`` Wang-Landau steps; then the features
        and the enthalpy are recomputed exactly from the occupancies
        (``state["chain_enthalpy"]`` keeps what the chain accumulated, for
        checks), and the mean features of each walker's bin take in the
        window's last state, in place.  ``seqs`` and ``seeds`` replace the
        chain's draws, as in
        :func:`~smol_tpu_torch.ops.chain.make_shared_proposal_chain`.
        """
        wl = self.wl_chain()
        inner = chain.make_shared_proposal_chain(
            self.chain_tables(), n_steps, block_size=self.chain_block_size,
            proposal_mode=self.proposal_mode, rng=self.rng, move=self.move,
            wl=wl, seqs=seqs, seeds=seeds,
        )
        full_features = self.full_features_fn()
        params = torch.as_tensor(self.natural_params, device=self.device)
        min_e, bin_size, nlev = wl.min_enthalpy, wl.bin_size, wl.num_levels

        def fn(state, generator):
            state = inner(state, generator)
            feats = full_features(state["occupancy"])
            state["chain_enthalpy"] = state["enthalpy"]
            state["features"] = feats
            state["enthalpy"] = e = (feats @ params).contiguous()
            # a tensor divisor: IEEE division on every device, as the chain's
            bins = torch.floor((e - min_e) / e.new_tensor(bin_size))
            bins = bins.clamp(0, nlev - 1).long()
            valid = (e >= min_e) & (e < min_e + nlev * bin_size)
            walkers = torch.arange(len(e), device=e.device)[valid]
            bins = bins[valid]
            counts, mean = state["wl_mean_counts"], state["mean_features"]
            n = counts[walkers, bins].to(torch.float64)[:, None]
            mean[walkers, bins] = (feats[valid] + n * mean[walkers, bins]) / (n + 1)
            counts[walkers, bins] += 1
            return state

        return fn

    def restore_aux_state(self, state: dict, container) -> dict:
        """``state`` with the Wang-Landau record of the container's last
        sample: the planes of its last aux record and the last recorded
        ``mod_factor``.  The in-window step counter restarts at zero.
        """
        if container.num_samples == 0:
            return state
        state = dict(state)
        for key, name in {**self.aux_traces, "mod_factor": "mod_factor"}.items():
            value = container.last_trace_value(name)
            state[key] = value.to(device=state[key].device,
                                  dtype=state[key].dtype).clone()
        return state
