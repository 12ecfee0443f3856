"""Multicell kernels: MC that also hops among supercell shapes.

Counterpart of ``smol_tpu/moca/kernel/multicell.py`` (:29-279), whose code
it copies: a set of kernels over same-size supercells of different shapes;
every ``kernel_hop_period`` steps a hop to a random kernel's stored
occupancy is attempted with a step of that kernel's usher, accepted on the
full feature-vector difference.  It runs one walker on the host, through
the kernels' single-walker API (``single_step``), with the reference's
validation errors and its draws in its order;
:meth:`smol_tpu_torch.moca.sampler.sampler.Sampler.run` takes it down its
host loop.  The SQS search itself anneals a batch of walkers per shape on
the device instead (:mod:`smol_tpu_torch.capp.generate.special.sqs`).
"""

from __future__ import annotations

import secrets

import numpy as np

from smol_tpu_torch.constants import kB
from smol_tpu_torch.moca.kernel.base import MCKernelInterface
from smol_tpu_torch.moca.metadata import Metadata

__all__ = ["MulticellKernel", "MulticellMetropolis"]


class MulticellKernel(MCKernelInterface):
    """Hop among a list of same-size kernels (host implementation)."""

    valid_mcushers = None
    valid_bias = None
    track_features = True

    def __init__(
        self,
        mckernels,
        kernel_probabilities=None,
        kernel_hop_periods=5,
        kernel_hop_probabilities=None,
        seed=None,
    ):
        """Initialize a MulticellKernel.

        Args:
            mckernels: list of same-type kernels (one per supercell shape).
            kernel_probabilities: probability of hopping to each kernel.
            kernel_hop_periods: steps between hop attempts (int or sequence).
            kernel_hop_probabilities: probabilities over the hop periods.
            seed: PRNG seed.
        """
        if any(not isinstance(k, type(mckernels[0])) for k in mckernels):
            raise ValueError("All kernels must be of the same type.")
        if any(
            k.ensemble.num_sites != mckernels[0].ensemble.num_sites
            for k in mckernels
        ):
            raise ValueError("All ensembles must have the same number of sites.")
        if any(
            not np.allclose(k.natural_params, mckernels[0].natural_params)
            for k in mckernels
        ):
            raise ValueError("All ensembles must have the same natural parameters.")

        if kernel_probabilities is not None:
            if abs(sum(kernel_probabilities) - 1) > 1e-12:
                raise ValueError("kernel_probabilities do not sum to 1.")
            if len(kernel_probabilities) != len(mckernels):
                raise ValueError(
                    "kernel_probabilities length must equal the number of kernels."
                )
            self._kernel_p = np.asarray(kernel_probabilities)
        else:
            self._kernel_p = np.full(len(mckernels), 1 / len(mckernels))

        if isinstance(kernel_hop_periods, (int, np.integer)):
            self._hop_periods = np.array([kernel_hop_periods], dtype=int)
        else:
            self._hop_periods = np.array(kernel_hop_periods, dtype=int)
        if kernel_hop_probabilities is not None:
            if abs(sum(kernel_hop_probabilities) - 1) > 1e-12:
                raise ValueError("kernel_hop_probabilities do not sum to 1.")
            if len(kernel_hop_probabilities) != len(self._hop_periods):
                raise ValueError(
                    "hop periods and hop probabilities lengths do not match."
                )
            self._hop_p = np.asarray(kernel_hop_probabilities)
        else:
            self._hop_p = np.full(len(self._hop_periods), 1 / len(self._hop_periods))

        self._seed = seed if seed is not None else secrets.randbits(63)
        self._rng = np.random.default_rng(self._seed)
        self._kernels = mckernels
        self._current_hop_period = self._rng.choice(self._hop_periods, p=self._hop_p)
        self._kernel_hop_counter = 1
        self._current_kernel_index = 0
        self._new_features = None
        self._features = np.zeros(
            (len(mckernels), len(mckernels[0].natural_params))
        )
        self._spec = Metadata(
            type(self).__name__,
            seed=self._seed,
            kernel_probabilities=self._kernel_p.tolist(),
            kernel_hop_periods=self._hop_periods.tolist(),
            kernel_hop_probabilities=self._hop_p.tolist(),
            mckernels=[k.spec for k in mckernels],
        )
        for i, kernel in enumerate(self._kernels):
            kernel.trace.kernel_index = np.array(i, dtype=int)
            kernel.trace.occupancy = np.zeros(
                kernel.ensemble.num_sites, dtype=np.int32
            )
        self._trace = self._kernels[0].trace

    @property
    def trace(self):
        return self._trace

    @property
    def spec(self):
        return self._spec

    @property
    def mckernels(self):
        return self._kernels

    @property
    def current_kernel(self):
        return self._kernels[int(self._trace.kernel_index)]

    @property
    def ensemble(self):
        return self.current_kernel.ensemble

    @property
    def mcusher(self):
        return self.current_kernel.mcusher

    @property
    def natural_params(self):
        return self._kernels[0].natural_params

    @property
    def seed(self):
        return self._seed

    @property
    def device(self):
        """The current kernel's device (the sampler's generator lives there)."""
        return self.current_kernel.device

    @property
    def bias(self):
        return self.current_kernel.bias

    def _compute_hop_trace(self, occupancy, step):
        occupancy = occupancy.copy()
        for site, code in step:
            occupancy[site] = code
        self._new_features = self.ensemble.compute_feature_vector(occupancy)
        prev = self._features[self._current_kernel_index]
        self._trace.delta_trace.features = self._new_features - prev
        self._trace.delta_trace.enthalpy = np.array(
            np.dot(self._trace.delta_trace.features, self.natural_params)
        )

    def single_step(self, occupancy):
        """One step: within-kernel step, or a hop attempt on hop periods."""
        if self._kernel_hop_counter % self._current_hop_period == 0:
            new_index = self._rng.choice(len(self._kernels), p=self._kernel_p)
            self._trace = self._kernels[new_index].trace
            hop_occu = np.array(self._trace.occupancy, dtype=np.int32).copy()
            step = self.current_kernel.mcusher.propose_step(hop_occu)
            self._compute_hop_trace(hop_occu, step)
            if self._accept_hop(hop_occu, step):
                for site, code in step:
                    hop_occu[site] = code
                self._features[new_index] = self._new_features
                self._current_kernel_index = new_index
                occupancy[:] = hop_occu
                self._trace.occupancy = hop_occu
                self._trace.accepted = np.array(True)
            else:
                self._trace = self._kernels[self._current_kernel_index].trace
                self._trace.occupancy = occupancy
                self._trace.accepted = np.array(False)
            self._current_hop_period = self._rng.choice(
                self._hop_periods, p=self._hop_p
            )
            self._kernel_hop_counter = 1
        else:
            self._trace = self.current_kernel.single_step(occupancy)
            self._kernel_hop_counter += 1
            if self._trace.accepted:
                self._features[self._current_kernel_index] += np.asarray(
                    self._trace.delta_trace.features
                )
        return self._trace

    def _accept_hop(self, occupancy, step):
        raise NotImplementedError

    def set_aux_state(self, occupancies, *args, **kwargs):
        """Set per-kernel occupancies ([n_kernels, n_sites] or single)."""
        occupancies = np.asarray(occupancies, dtype=np.int32)
        if occupancies.ndim == 2 and occupancies.shape[0] == len(self._kernels):
            feats = []
            for kernel, occu in zip(self._kernels, occupancies):
                occu = np.ascontiguousarray(occu, dtype=np.int32)
                kernel.trace.occupancy = occu
                kernel.set_aux_state(occu, *args, **kwargs)
                feats.append(kernel.ensemble.compute_feature_vector(occu))
            self._features = np.vstack(feats)
        else:
            self._features[self._current_kernel_index] = (
                self.current_kernel.ensemble.compute_feature_vector(occupancies)
            )
            self.current_kernel.set_aux_state(occupancies, *args, **kwargs)

    def compute_initial_trace(self, occupancy):
        trace = self.current_kernel.compute_initial_trace(occupancy)
        trace.kernel_index = np.array([self._current_kernel_index], dtype=int)
        return trace


class MulticellMetropolis(MulticellKernel):
    """Metropolis acceptance for multicell hops (kB settable, e.g. 1.0)."""

    _kB: float = kB

    def __init__(
        self,
        mckernels,
        temperature,
        kernel_probabilities=None,
        kernel_hop_periods=5,
        kernel_hop_probabilities=None,
        seed=None,
        **kwargs,
    ):
        from smol_tpu_torch.moca.kernel.metropolis import Metropolis

        if not all(isinstance(k, Metropolis) for k in mckernels):
            raise ValueError("All kernels must be of type Metropolis")
        super().__init__(
            mckernels,
            kernel_probabilities=kernel_probabilities,
            kernel_hop_periods=kernel_hop_periods,
            kernel_hop_probabilities=kernel_hop_probabilities,
            seed=seed,
        )
        self.beta = 1.0 / (self.kB * temperature)
        self._temperature = temperature

    @property
    def kB(self):
        return self._kB

    @kB.setter
    def kB(self, value):
        self._kB = value
        self.beta = 1.0 / (self._kB * self._temperature)

    @property
    def temperature(self):
        """Hop temperature; setting it also retunes every sub-kernel
        (reference kernel/base.py:560-572)."""
        return self._temperature

    @temperature.setter
    def temperature(self, temperature):
        self._temperature = temperature
        self.beta = 1.0 / (self.kB * temperature)
        for kernel in self.mckernels:
            kernel.temperature = temperature

    def _accept_hop(self, occupancy, step):
        from math import log

        exponent = -self.beta * float(self._trace.delta_trace.enthalpy)
        accepted = True if exponent >= 0 else exponent > log(self._rng.random())
        return accepted
