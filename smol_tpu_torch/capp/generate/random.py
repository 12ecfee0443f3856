"""Random ordered occupancies of a fixed composition.

Counterpart of ``smol_tpu/capp/generate/random.py``, reduced to the
composition-exact occupancy (``_gen_composition_occu`` :105) at each
sublattice's own composition, the start of an SQS search.  It draws from a
numpy ``Generator`` exactly as the reference does, so the same generator
state gives the same occupancy.  The unconstrained and charge-neutral
occupancies, and compositions given by species, need the host layer
(ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

import numpy as np

__all__ = ["generate_random_ordered_occupancy"]


def generate_random_ordered_occupancy(processor, rng=None, tol=1e-6) -> np.ndarray:
    """A random encoded occupancy [N] int32 at the sublattices' compositions.

    Each sublattice of ``processor.get_sublattices()`` gets round(x * n)
    sites of each code of fraction x, drawn without replacement from its
    sites in code order (``rng.choice``, as the reference).  Raises
    ``ValueError`` where a code's count x * n is not within ``tol`` of an
    integer.
    """
    rng = np.random.default_rng(rng)
    sublattices = processor.get_sublattices()
    occu = np.zeros(sum(len(sl.sites) for sl in sublattices), dtype=np.int64)
    for sl in sublattices:
        if sl.composition is None:
            raise ValueError("the system carries no sublattice compositions")
        for fraction in sl.composition:
            count = len(sl.sites) * fraction
            if abs(round(count) - count) > tol:
                raise ValueError("composition is not compatible with supercell size.")
        remaining = list(sl.sites)
        for fraction, code in zip(sl.composition, sl.encoding):
            sites = rng.choice(remaining, size=round(fraction * len(sl.sites)),
                               replace=False)
            occu[sites] = code
            remaining = [i for i in remaining if i not in sites]
    return np.ascontiguousarray(occu, dtype=np.int32)
