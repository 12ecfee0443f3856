"""External feature terms for cluster subspaces.

Counterpart of ``smol_tpu/cofe/extern/__init__.py``.
"""

from smol_tpu_torch.cofe.extern.ewald import EwaldTerm

__all__ = ["EwaldTerm"]
