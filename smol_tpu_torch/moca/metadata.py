"""Metadata: reproducibility specs of samplers, kernels, ushers and biases.

Counterpart of ``smol_tpu/moca/metadata.py``, whose code it copies: a
namespace of specification values that goes to JSON and back.
"""

from __future__ import annotations

from types import SimpleNamespace

from smol_tpu_torch.serial import MSONable, jsanitize

__all__ = ["Metadata"]


class Metadata(SimpleNamespace, MSONable):
    """A namespace recording specification values of MC components."""

    def __init__(self, cls_name=None, **kwargs):
        if cls_name is not None:
            kwargs["cls_name"] = cls_name
        super().__init__(**kwargs)

    def as_dict(self) -> dict:
        d = {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
        }
        d.update(jsanitize(vars(self)))
        return d

    @classmethod
    def from_dict(cls, d):
        return cls(**{k: v for k, v in d.items() if not k.startswith("@")})
