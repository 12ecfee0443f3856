"""Trace objects: ndarray-only namespaces of sampled values.

Counterpart of ``smol_tpu/moca/trace.py``, whose code it copies: a
:class:`Trace` records absolute values (occupancy, features, enthalpy, ...),
a :class:`StepTrace` also carries a nested ``delta_trace`` of per-step
changes.  :meth:`smol_tpu_torch.moca.sampler.sampler.Sampler.sample`
yields them, and a kernel's ``compute_initial_trace`` returns one.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Trace", "StepTrace"]


class Trace:
    """A simple namespace whose attributes are ndarrays."""

    def __init__(self, **kwargs):
        for name, value in kwargs.items():
            setattr(self, name, value)

    @property
    def names(self) -> list:
        return [n for n in self.__dict__ if not n.startswith("_")]

    def items(self):
        return [(n, getattr(self, n)) for n in self.names]

    def __setattr__(self, name, value):
        if name != "delta_trace" and not isinstance(value, np.ndarray):
            value = np.asarray(value)
        super().__setattr__(name, value)

    def __repr__(self):
        entries = ", ".join(
            f"{n}={getattr(self, n).shape if hasattr(getattr(self, n), 'shape') else getattr(self, n)}"
            for n in self.names
        )
        return f"{type(self).__name__}({entries})"

    def as_dict(self) -> dict:
        return {
            n: v.tolist() if isinstance(v, np.ndarray) else v.as_dict()
            for n, v in self.items()
        }


class StepTrace(Trace):
    """A Trace with a nested delta_trace of changes."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        super(Trace, self).__setattr__("delta_trace", Trace())

    @property
    def names(self):
        return [n for n in self.__dict__ if not n.startswith("_") and n != "delta_trace"]
