"""Random ordered occupancy generation.

Counterpart of ``smol_tpu/capp/generate/random.py``, whose code it copies
(:19-150): unconstrained, charge-neutral (penalized random flips) and
fixed-composition occupancies, each drawn from a numpy ``Generator``
exactly as the reference draws, so the same generator state gives the same
occupancy.  The sublattices come from ``processor.get_sublattices()``; the
charge-neutral mode and a composition given by species need their species
(an ensemble built by ``Ensemble.from_cluster_expansion``).  In this
module "the reference" is smol (CederGroupHub/smol).
"""

from __future__ import annotations

import warnings

import numpy as np

from smol_tpu_torch.cofe.space.domain import SiteSpace, Vacancy
from smol_tpu_torch.crystal.species import Composition, Element

__all__ = ["generate_random_ordered_occupancy"]


def generate_random_ordered_occupancy(
    processor,
    composition=None,
    charge_neutral=False,
    tol=1e-6,
    encoded=True,
    rng=None,
    **kwargs,
):
    """Generate a random encoded occupancy for a processor's supercell.

    Args:
        processor: Processor defining the supercell space.
        composition: optional sequence of Composition per sublattice.
        charge_neutral: generate a charge-neutral occupancy (ignored when a
            composition is given).
        tol: composition compatibility tolerance.
        encoded: return int codes (True) or species objects.
        rng: seed or Generator.

    Returns:
        int32 ndarray occupancy (or list of species).
    """
    sublattices = processor.get_sublattices()
    if composition is None:
        if charge_neutral:
            occu = _gen_neutral_occu(sublattices, rng=rng, **kwargs)
        else:
            occu = _gen_unconstrained_occu(sublattices, rng=rng)
    else:
        occu = _gen_composition_occu(sublattices, composition, tol, rng=rng)
    if not encoded:
        occu = _decode(sublattices, occu)
    return occu


def _decode(sublattices, occu) -> list:
    """The species of each site of an encoded occupancy."""
    species = [None] * len(occu)
    for sl in sublattices:
        for site in sl.sites:
            species[site] = sl.species[int(occu[site])]
    return species


def _gen_unconstrained_occu(sublattices, rng=None) -> np.ndarray:
    num_sites = sum(len(sl.sites) for sl in sublattices)
    occu = np.zeros(num_sites, dtype=np.int64)
    rng = np.random.default_rng(rng)
    for sublatt in sublattices:
        occu[sublatt.sites] = rng.choice(
            sublatt.encoding, size=len(sublatt.sites), replace=True
        )
    return np.ascontiguousarray(occu, dtype=np.int32)


def _gen_neutral_occu(sublattices, lam=10, num_attempts=10000, rng=None):
    """Anneal random flips with a charge^2 penalty until neutral."""
    rng = np.random.default_rng(rng)

    def get_charge(sp):
        if isinstance(sp, (Element, Vacancy)):
            return 0
        return sp.oxi_state or 0

    charge_table = {}
    for sl in sublattices:
        for code, sp in zip(sl.encoding, sl.species):
            for site in sl.sites:
                charge_table[(site, int(code))] = get_charge(sp)

    def total_charge(occu):
        return sum(charge_table[(site, int(occu[site]))] for site in range(len(occu)))

    occu = _gen_unconstrained_occu(sublattices, rng=rng)
    current = total_charge(occu)
    actives = [s for s in sublattices if s.is_active]
    for _ in range(num_attempts):
        if current == 0:
            return np.ascontiguousarray(occu, dtype=np.int32)
        sl = rng.choice(actives)
        site = rng.choice(sl.sites)
        code = rng.choice(sorted(set(sl.encoding.tolist()) - {int(occu[site])}))
        delta = charge_table[(site, int(code))] - charge_table[(site, int(occu[site]))]
        new = current + delta
        if np.log(rng.random()) < -lam * (new**2 - current**2):
            occu[site] = code
            current = new
    if current == 0:
        return np.ascontiguousarray(occu, dtype=np.int32)
    raise TimeoutError(
        f"Can not generate a neutral occupancy in {num_attempts} attempts!"
    )


def _gen_composition_occu(sublattices, composition, tol, rng=None) -> np.ndarray:
    rng = np.random.default_rng(rng)
    compositions = _composition_compatibility(sublattices, composition, tol)
    occu = np.zeros(sum(len(sl.sites) for sl in sublattices), dtype=np.int64)
    for comp, sublattice in zip(compositions, sublattices):
        comp = SiteSpace(comp)
        remaining = list(sublattice.sites)
        for sp, code in zip(sublattice.species, sublattice.encoding):
            num_sp = round(comp[sp] * len(sublattice.sites)) if sp in comp else 0
            sites = rng.choice(remaining, size=num_sp, replace=False)
            occu[sites] = code
            remaining = [i for i in remaining if i not in sites]
    return np.ascontiguousarray(occu, dtype=np.int32)


def _composition_compatibility(sublattices, composition, tol) -> list:
    if isinstance(composition, Composition):
        compositions = [composition]
    else:
        compositions = list(composition)
    for i, (comp, sl) in enumerate(zip(compositions, sublattices)):
        if any(sp not in sl.site_space for sp in comp):
            raise ValueError(
                "species are present in composition that are not in sublattices."
            )
        if comp.num_atoms > 1 + tol:
            warnings.warn(
                "A given sublattice composition is not normalized; converting "
                "to a fractional composition."
            )
            total = comp.num_atoms
            compositions[i] = Composition(
                {sp: amt / total for sp, amt in comp.items()}
            )
    for comp, sublattice in zip(compositions, sublattices):
        total = 0
        for concentration in comp.values():
            num_sites = len(sublattice.sites) * concentration
            if abs(round(num_sites) - num_sites) > tol:
                raise ValueError(
                    "composition is not compatible with supercell size."
                )
            total += round(num_sites)
        if total > len(sublattice.sites) + tol:
            raise ValueError("composition is not compatible with supercell size.")
    return compositions
