"""Lightweight JSON serialization protocol.

Counterpart of ``smol_tpu/serial.py``, whose code it copies, apart from the
decoder: a document that ``smol_tpu`` saved names its classes under
``smol_tpu.*``, and :func:`process_decoded` maps each such name onto the
port's class of the same module path and name, without importing
``smol_tpu``. A class the port does not have yet raises
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports it. In
the rest of this module, "the reference" is smol (CederGroupHub/smol).

The reference relies on ``monty.json.MSONable`` for every public object
(smol uses ``as_dict``/``from_dict`` with ``@module``/``@class`` tags).  monty
is not a dependency, so this module provides a self-contained equivalent:

- :class:`MSONable`: mixin providing the serialization contract.
- :func:`jsanitize`, :class:`SmolJSONEncoder`: numpy-aware JSON encoding.
- :func:`loads_obj` / :func:`dumps_obj`: round-trip helpers resolving the
  ``@module``/``@class`` tags back to classes.
"""

from __future__ import annotations

import importlib
import json

import numpy as np


class MSONable:
    """Mixin providing dict-based JSON serialization.

    Subclasses should override :meth:`as_dict` and :meth:`from_dict`.  The
    default implementation serializes ``__init__`` args found as identically
    named attributes (with or without a leading underscore).
    """

    def as_dict(self) -> dict:
        """Return a JSON-serializable dict representation."""
        d = {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
        }
        import inspect

        sig = inspect.signature(type(self).__init__)
        for name in list(sig.parameters)[1:]:
            for attr in (name, "_" + name):
                if hasattr(self, attr):
                    d[name] = jsanitize(getattr(self, attr))
                    break
        return d

    @classmethod
    def from_dict(cls, d: dict):
        """Reconstruct an instance from its dict representation."""
        kwargs = {
            k: process_decoded(v) for k, v in d.items() if not k.startswith("@")
        }
        return cls(**kwargs)

    def to_json(self) -> str:
        """Serialize to a JSON string."""
        return json.dumps(self.as_dict(), cls=SmolJSONEncoder)


def jsanitize(obj):
    """Recursively convert an object into JSON-serializable primitives."""
    if isinstance(obj, MSONable):
        return obj.as_dict()
    if isinstance(obj, dict):
        return {_key_str(k): jsanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsanitize(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    return obj


def _key_str(key):
    if isinstance(key, (str, int, float, bool)) or key is None:
        return key
    return str(key)


class SmolJSONEncoder(json.JSONEncoder):
    """JSON encoder handling numpy scalars/arrays and MSONable objects."""

    def default(self, o):  # noqa: D102
        if isinstance(o, MSONable):
            return o.as_dict()
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.bool_):
            return bool(o)
        return super().default(o)


_PORT = "smol_tpu_torch"
_REFERENCE = "smol_tpu"

# classes a saved document may name that the port does not have yet, by
# the ROADMAP.md item that ports them (others name Queue 1)
_WAITING = {
    "PottsSubspace": "Queue 1 item 5(b)",
    "StructureWrangler": "Queue 1 item 7",
    "ComputedStructureEntry": "Queue 1 item 7",
}


def _decodable_class(module: str, name: str):
    """The port's class of a ``smol_tpu`` (or port) module path and name.

    ``smol_tpu.a.b`` is read as ``smol_tpu_torch.a.b``; a class the port
    does not have, or cannot decode, raises ``NotImplementedError``
    naming its item.
    """
    if module == _REFERENCE or module.startswith(_REFERENCE + "."):
        module = _PORT + module[len(_REFERENCE):]
    try:
        cls = getattr(importlib.import_module(module), name, None)
    except ModuleNotFoundError:
        cls = None
    if not hasattr(cls, "from_dict"):
        raise NotImplementedError(f"{module}.{name} is not ported yet "
                                  f"(ROADMAP.md {_WAITING.get(name, 'Queue 1')})")
    return cls


def process_decoded(obj):
    """Recursively resolve ``@module``/``@class`` tagged dicts to objects.

    Documents tagged with pymatgen/numpy modules (as written by the
    reference through monty) are translated to the native crystal types
    via :mod:`smol_tpu_torch.crystal.pmg_compat`; ``smol_tpu`` tags resolve
    to the port's classes (:func:`_decodable_class`).
    """
    if isinstance(obj, dict):
        if "@class" in obj and "@module" in obj:
            from smol_tpu_torch.crystal import pmg_compat

            if pmg_compat.is_pmg_dict(obj):
                decoded = pmg_compat.decode_pmg(obj)
                if decoded is not None:
                    return decoded
            return _decodable_class(obj["@module"], obj["@class"]).from_dict(obj)
        return {k: process_decoded(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [process_decoded(v) for v in obj]
    return obj


def dumps_obj(obj) -> str:
    """Serialize any MSONable (or plain) object to JSON."""
    return json.dumps(jsanitize(obj), cls=SmolJSONEncoder)


def loads_obj(s: str):
    """Load an object serialized with :func:`dumps_obj`."""
    return process_decoded(json.loads(s))
