"""MC bias terms.

Counterpart of ``smol_tpu/moca/kernel/bias.py``: a bias adds its change
to the Metropolis exponent.  Each bias has the host ``compute_bias`` and
``compute_bias_change`` of one occupancy (numpy, the reference's code),
and the per-step path's batched device functions:
:meth:`MCBias.device_bias_fn`, ``(occu [W, N]) -> [W]`` f64, and
:meth:`MCBias.device_delta_fn`, ``(occu, sites [W, S], codes [W, S],
valid [W, S]) -> [W]`` f64, the change of the step's valid flips applied
in order.  The fugacity bias looks its change up in its table; the others
evaluate the bias before and after the step.
"""

from __future__ import annotations

from functools import partial
from math import log

import numpy as np
import torch

from smol_tpu_torch.cofe.space.domain import get_species
from smol_tpu_torch.moca.metadata import Metadata
from smol_tpu_torch.moca.occu_utils import get_dim_ids_table, occu_to_counts
from smol_tpu_torch.ops.mc import apply_flips
from smol_tpu_torch.utils.class_utils import (
    class_name_from_str,
    derived_class_factory,
    get_subclasses_str,
)

__all__ = [
    "MCBias",
    "FugacityBias",
    "SquareChargeBias",
    "SquareHyperplaneBias",
    "mcbias_factory",
    "available_bias_types",
]


def _site_values(table, occu):
    """table[i, occu[w, i]] [W, N] of a [N, C] table."""
    return table.gather(1, occu.long().T).T


def _generic_delta(bias_fn, occu, sites, codes, valid):
    return bias_fn(apply_flips(occu, sites, codes, valid)) - bias_fn(occu)


def _fugacity_bias(log_table, occu):
    return _site_values(log_table, occu).sum(dim=1)


def _fugacity_delta(log_table, occu, sites, codes, valid):
    occu_next = apply_flips(occu, sites, codes, valid)
    old = log_table[sites, occu.gather(1, sites).long()]
    new = log_table[sites, occu_next.gather(1, sites).long()]
    return torch.where(valid, new - old, 0.0).sum(dim=1)


def _square_charge_bias(table, penalty, occu):
    return -penalty * _site_values(table, occu).sum(dim=1) ** 2


def _hyperplane_bias(table, A, b, penalty, occu):
    d = A.shape[1]
    dims = _site_values(table, occu)
    counts = torch.zeros((occu.shape[0], d + 1), dtype=torch.float64, device=occu.device)
    ones = torch.ones(dims.shape, dtype=torch.float64, device=occu.device)
    counts.scatter_add_(1, torch.where(dims >= 0, dims, d), ones)
    return -penalty * ((counts[:, :d] @ A.T - b) ** 2).sum(dim=1)


def get_oxi_state(sp) -> float:
    """Oxidation state of a species (0 for vacancies/elements without one)."""
    return float(sp.oxi_state or 0.0)


class MCBias:
    """Abstract bias term."""

    def __init__(self, sublattices, **kwargs):
        self.sublattices = sublattices
        self.active_sublattices = [s for s in sublattices if s.is_active]
        self.spec = Metadata(type(self).__name__)

    def compute_bias(self, occupancy) -> float:
        """Absolute bias value of an occupancy."""
        raise NotImplementedError

    def compute_bias_change(self, occupancy, step) -> float:
        occu_next = np.asarray(occupancy).copy()
        for site, code in step:
            occu_next[site] = code
        return self.compute_bias(occu_next) - self.compute_bias(occupancy)

    def device_bias_fn(self, device="cuda"):
        """``(occu [W, N]) -> [W]`` f64 bias values, on ``device``."""
        raise NotImplementedError

    def device_delta_fn(self, device="cuda"):
        """``(occu, sites, codes, valid) -> [W]`` f64 bias changes."""
        return partial(_generic_delta, self.device_bias_fn(device))


class FugacityBias(MCBias):
    """Per-site log-fugacity-fraction bias (``smol_tpu/moca/kernel/bias.py``
    ``FugacityBias``)."""

    def __init__(self, sublattices, fugacity_fractions=None, **kwargs):
        super().__init__(sublattices, **kwargs)
        self._fus = None
        self._fu_table = None
        self._species = [set(s.species) for s in self.active_sublattices]
        if fugacity_fractions is not None:
            fugacity_fractions = [
                {get_species(k): v for k, v in sub.items()}
                for sub in fugacity_fractions
            ]
        else:
            fugacity_fractions = [dict(s.site_space) for s in self.active_sublattices]
        self.fugacity_fractions = fugacity_fractions
        self.spec.fugacity_fractions = [
            {str(k): v for k, v in sub.items()} for sub in self._fus
        ]

    @property
    def fugacity_fractions(self):
        return self._fus

    @fugacity_fractions.setter
    def fugacity_fractions(self, value):
        value = [{get_species(k): v for k, v in sub.items()} for sub in value]
        if not all(abs(sum(f.values()) - 1) < 1e-12 for f in value):
            raise ValueError("Fugacity fractions must add to one.")
        for spec, vals in zip(self._species, value):
            if spec != set(vals.keys()):
                raise ValueError(
                    f"Fugacity fractions missing species; need all of {self._species}."
                )
        self._fus = value
        self._fu_table = self._build_fu_table(value)

    def _build_fu_table(self, fugacity_fractions) -> np.ndarray:
        num_cols = max(max(s.encoding) for s in self.sublattices) + 1
        num_rows = sum(len(s.sites) for s in self.sublattices)
        table = np.ones((num_rows, num_cols))
        for fus, sublatt in zip(fugacity_fractions, self.active_sublattices):
            ordered = np.array([fus[sp] for sp in sublatt.site_space])
            table[sublatt.sites[:, None], sublatt.encoding] = ordered[None, :]
        return table

    def compute_bias(self, occupancy) -> float:
        return float(
            np.log(self._fu_table[np.arange(len(occupancy)), occupancy]).sum()
        )

    def compute_bias_change(self, occupancy, step) -> float:
        steps = {site: code for site, code in step}
        return sum(
            log(self._fu_table[site, code] / self._fu_table[site, occupancy[site]])
            for site, code in steps.items()
        )

    def _log_table(self, device):
        return torch.as_tensor(np.log(self._fu_table), dtype=torch.float64, device=device)

    def device_bias_fn(self, device="cuda"):
        return partial(_fugacity_bias, self._log_table(device))

    def device_delta_fn(self, device="cuda"):
        """The table's change at the flipped sites (cheaper than two full
        evaluations)."""
        return partial(_fugacity_delta, self._log_table(device))


class SquareChargeBias(MCBias):
    """-penalty * (net charge)^2 bias."""

    def __init__(self, sublattices, penalty=0.5, **kwargs):
        super().__init__(sublattices, **kwargs)
        if penalty <= 0:
            raise ValueError("Penalty factor should be > 0!")
        self.penalty = penalty
        num_cols = max(max(s.encoding) for s in self.sublattices) + 1
        num_rows = sum(len(s.sites) for s in self.sublattices)
        table = np.zeros((num_rows, num_cols))
        for sublatt in self.sublattices:
            cs = np.array([get_oxi_state(sp) for sp in sublatt.species])
            table[sublatt.sites[:, None], sublatt.encoding] = cs[None, :]
        self._c_table = table
        self.spec.penalty = penalty

    def compute_bias(self, occupancy) -> float:
        c = np.sum(self._c_table[np.arange(len(occupancy)), occupancy])
        return float(-self.penalty * c**2)

    def device_bias_fn(self, device="cuda"):
        return partial(_square_charge_bias,
                       torch.as_tensor(self._c_table, dtype=torch.float64, device=device),
                       float(self.penalty))


class SquareHyperplaneBias(MCBias):
    """-penalty * ||A n - b||^2 composition-constraint bias over the species
    counts n."""

    def __init__(self, sublattices, hyperplane_normals, hyperplane_intercepts,
                 penalty=0.5, **kwargs):
        super().__init__(sublattices, **kwargs)
        if penalty <= 0:
            raise ValueError("Penalty factor should be > 0!")
        self.penalty = penalty
        self._A = np.array(hyperplane_normals, dtype=np.float64)
        self._b = np.array(hyperplane_intercepts, dtype=np.float64)
        self._dim_ids_table = get_dim_ids_table(self.sublattices)
        self.d = sum(len(s.encoding) for s in sublattices)
        self.spec.penalty = penalty
        self.spec.hyperplane_normals = self._A.tolist()
        self.spec.hyperplane_intercepts = self._b.tolist()

    def _counts(self, occupancy) -> np.ndarray:
        return occu_to_counts(occupancy, self.d, self._dim_ids_table)

    def compute_bias(self, occupancy) -> float:
        n = self._counts(occupancy)
        return float(-self.penalty * np.sum((self._A @ n - self._b) ** 2))

    def device_bias_fn(self, device="cuda"):
        def dev(x):
            return torch.as_tensor(x, device=device)

        return partial(_hyperplane_bias, dev(self._dim_ids_table), dev(self._A),
                       dev(self._b), float(self.penalty))


def mcbias_factory(bias_type, sublattices, *args, **kwargs):
    """The bias of ``bias_type`` by class name (``"fugacity-bias"``,
    ``"square-charge-bias"``, ``"square-hyperplane-bias"``)."""
    return derived_class_factory(
        class_name_from_str(bias_type), MCBias, sublattices, *args, **kwargs
    )


def available_bias_types() -> tuple:
    return get_subclasses_str(MCBias)
