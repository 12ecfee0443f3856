"""Cluster expansion definition and fitting layer.

Counterpart of ``smol_tpu/cofe/__init__.py``, without ``PottsSubspace``
(ROADMAP.md Queue 1 item 5(b)) and ``StructureWrangler`` (item 7).
"""

from smol_tpu_torch.cofe.expansion import ClusterExpansion, RegressionData
from smol_tpu_torch.cofe.space import ClusterSubspace, available_site_basis_sets

__all__ = [
    "ClusterSubspace",
    "ClusterExpansion",
    "RegressionData",
    "available_site_basis_sets",
]
