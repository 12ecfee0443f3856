"""Occupancy <-> species-count ("counts" format) conversion utilities.

Counterpart of ``smol_tpu/moca/occu_utils.py``, whose code it copies. In
this module "the reference" is smol (CederGroupHub/smol).

Mirrors the reference (smol/moca/occu_utils.py): the "counts" vector n
concatenates per-sublattice species counts; dim-id tables map (site, code)
to the corresponding component of n (-1 for inactive/invalid).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "get_dim_ids_by_sublattice",
    "get_dim_ids_table",
    "occu_to_species_list",
    "occu_to_counts",
    "delta_counts_from_step",
]


def get_dim_ids_by_sublattice(bits) -> list:
    """Component index ranges of each sublattice's species in n."""
    dim_ids, dim_id = [], 0
    for species in bits:
        dim_ids.append(list(range(dim_id, dim_id + len(species))))
        dim_id += len(species)
    return dim_ids


def get_dim_ids_table(sublattices, active_only: bool = False) -> np.ndarray:
    """Table [n_sites, max_code+1] of n-components per (site, code); -1 invalid."""
    n_row = sum(len(s.sites) for s in sublattices)
    n_col = max(max(s.encoding) for s in sublattices) + 1
    table = np.full((n_row, n_col), -1, dtype=np.int64)
    dim_id = 0
    for sublatt in sublattices:
        for code in sublatt.encoding:
            sites = (sublatt.active_sites if active_only else sublatt.sites).astype(int)
            table[sites, code] = dim_id
            dim_id += 1
    return table


def occu_to_species_list(occupancy, n_dims, dim_ids_table) -> list:
    """Site indices occupied by each species (concatenated by sublattice)."""
    occu = np.asarray(occupancy, dtype=int)
    if len(occu) != len(dim_ids_table):
        raise ValueError(
            f"Occupancy size {len(occu)} does not match table size "
            f"{len(dim_ids_table)}!"
        )
    dim_ids = dim_ids_table[np.arange(len(occu)), occu]
    all_sites = np.arange(len(occu))
    return [all_sites[dim_ids == i].tolist() for i in range(n_dims)]


def occu_to_counts(occupancy, n_dims, dim_ids_table) -> np.ndarray:
    """Species counts n from an encoded occupancy."""
    occu = np.asarray(occupancy, dtype=int)
    if len(occu) != len(dim_ids_table):
        raise ValueError(
            f"Occupancy size {len(occu)} does not match table size "
            f"{len(dim_ids_table)}!"
        )
    dim_ids = dim_ids_table[np.arange(len(occu)), occu]
    n = np.zeros(n_dims, dtype=int)
    dims, counts = np.unique(dim_ids, return_counts=True)
    n[dims[dims >= 0]] = counts[dims >= 0]
    return n


def delta_counts_from_step(occu, step, n_dims, dim_ids_table) -> np.ndarray:
    """Change of n from an MC step (sites may repeat within a step)."""
    occu_now = np.asarray(occu, dtype=int).copy()
    table = np.asarray(dim_ids_table, dtype=int)
    delta_n = np.zeros(n_dims, dtype=int)
    for site, code in step:
        if not 0 <= code < table.shape[1]:
            raise ValueError(
                f"Impossible code {code} at site {site} in step {step}!"
            )
        dim_ori = table[site, occu_now[site]]
        dim_nex = table[site, code]
        if dim_ori < 0 or dim_nex < 0:
            raise ValueError(
                f"Inactive sites or impossible codes involved in step {step}!"
            )
        delta_n[dim_ori] -= 1
        delta_n[dim_nex] += 1
        occu_now[site] = code
    return delta_n
