"""Configuration-space definitions: site spaces, bases, clusters, orbits.

Counterpart of ``smol_tpu/cofe/space/__init__.py``, without
``PottsSubspace`` (ROADMAP.md Queue 1 item 5(b)).
"""

from smol_tpu_torch.cofe.space.basis import (
    IndicatorBasis,
    StandardBasis,
    available_site_basis_sets,
    basis_factory,
)
from smol_tpu_torch.cofe.space.cluster import Cluster
from smol_tpu_torch.cofe.space.clusterspace import (
    ClusterSubspace,
    invert_mapping,
)
from smol_tpu_torch.cofe.space.domain import (
    SiteSpace,
    Vacancy,
    get_allowed_species,
    get_site_spaces,
    get_species,
)
from smol_tpu_torch.cofe.space.orbit import Orbit

__all__ = [
    "SiteSpace",
    "Vacancy",
    "get_site_spaces",
    "get_allowed_species",
    "get_species",
    "StandardBasis",
    "IndicatorBasis",
    "basis_factory",
    "available_site_basis_sets",
    "Cluster",
    "Orbit",
    "ClusterSubspace",
    "invert_mapping",
]
