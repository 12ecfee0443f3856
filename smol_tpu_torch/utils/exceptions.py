"""Framework exceptions (mirrors smol/utils/exceptions.py).

Counterpart of ``smol_tpu/utils/exceptions.py``, whose code it copies. In
this module "the reference" is smol (CederGroupHub/smol).
"""

SYMMETRY_ERROR_MESSAGE = (
    "The symmetry operations of the structure do not map the orbit clusters "
    "onto themselves consistently. This usually means the symmetry of the "
    "input structure was not detected correctly (try adjusting tolerances) "
    "or the structure is not a valid periodic crystal."
)


class NotFittedError(RuntimeError):
    """Raised when using a model that has not been fitted."""


class SymmetryError(RuntimeError):
    """Raised for inconsistencies in symmetry-operation bookkeeping."""


class StructureMatchError(RuntimeError):
    """Raised when a structure cannot be matched to the prim."""
