"""Constrained composition spaces and constraint parsing.

Counterpart of ``smol_tpu/moca/composition/__init__.py``.
"""

from smol_tpu_torch.moca.composition.space import (
    CompositionSpace,
    flip_vec_to_reaction,
    get_oxi_state,
)

__all__ = ["CompositionSpace", "get_oxi_state", "flip_vec_to_reaction"]
