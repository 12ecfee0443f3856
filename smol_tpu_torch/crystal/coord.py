"""Fractional-coordinate comparison utilities.

Counterpart of ``smol_tpu/crystal/coord.py``, whose code it copies, without
its native mapping. In this module "the reference" is smol
(CederGroupHub/smol).

Replaces pymatgen.util.coord functions used by the reference:
``is_coord_subset``, ``coord_list_mapping``, ``is_coord_subset_pbc``,
``coord_list_mapping_pbc``, ``lattice_points_in_supercell``.
"""

from __future__ import annotations

import numpy as np


def pbc_diff(fcoords1, fcoords2) -> np.ndarray:
    """Minimum-image difference of fractional coordinates (in [-0.5, 0.5))."""
    diff = np.asarray(fcoords1, dtype=np.float64) - np.asarray(
        fcoords2, dtype=np.float64
    )
    return diff - np.round(diff)


def is_coord_subset(subset, superset, atol=1e-8) -> bool:
    """True if every row of subset matches some row of superset (no pbc)."""
    sub = np.atleast_2d(np.asarray(subset, dtype=np.float64))
    sup = np.atleast_2d(np.asarray(superset, dtype=np.float64))
    diff = np.abs(sub[:, None, :] - sup[None, :, :])
    return bool(np.all(np.any(np.all(diff < atol, axis=-1), axis=-1)))


def coord_list_mapping(subset, superset, atol=1e-8) -> np.ndarray:
    """Index of each subset row in superset (exact, no pbc).

    Raises ValueError if a row is missing or matched more than once.
    """
    sub = np.atleast_2d(np.asarray(subset, dtype=np.float64))
    sup = np.atleast_2d(np.asarray(superset, dtype=np.float64))
    matches = np.all(np.abs(sub[:, None, :] - sup[None, :, :]) < atol, axis=-1)
    counts = matches.sum(axis=1)
    if np.any(counts == 0):
        raise ValueError("Some coordinates in subset are not in superset.")
    if np.any(counts > 1):
        raise ValueError("Some coordinates in subset match multiple rows.")
    return np.argmax(matches, axis=1)


def is_coord_subset_pbc(subset, superset, atol=1e-8) -> bool:
    """True if every row of subset matches some row of superset modulo 1."""
    sub = np.atleast_2d(np.asarray(subset, dtype=np.float64))
    sup = np.atleast_2d(np.asarray(superset, dtype=np.float64))
    diff = pbc_diff(sub[:, None, :], sup[None, :, :])
    return bool(np.all(np.any(np.all(np.abs(diff) < atol, axis=-1), axis=-1)))


def coord_list_mapping_pbc(subset, superset, atol=1e-8) -> np.ndarray:
    """Index of each subset row in superset under periodic boundary conditions.

    Each subset row must match exactly one superset row modulo lattice
    translations. Mirrors pymatgen.util.coord.coord_list_mapping_pbc as used
    by the reference's supercell orbit-index generation
    (smol/cofe/space/clusterspace.py:1350).  ``smol_tpu`` maps more than
    200 000 pairs through its native library, to the same indices; the port
    has no native library and maps every size here.
    """
    sub = np.atleast_2d(np.asarray(subset, dtype=np.float64))
    sup = np.atleast_2d(np.asarray(superset, dtype=np.float64))
    # chunk over subset rows to bound memory for very large inputs
    out = np.empty(len(sub), dtype=np.int64)
    chunk = max(1, int(4e7) // max(1, len(sup)))
    for start in range(0, len(sub), chunk):
        block = sub[start : start + chunk]
        diff = pbc_diff(block[:, None, :], sup[None, :, :])
        matches = np.all(np.abs(diff) < atol, axis=-1)
        counts = matches.sum(axis=1)
        if np.any(counts == 0):
            raise ValueError("Some coordinates in subset are not in superset.")
        if np.any(counts > 1):
            raise ValueError("Some coordinates in subset match multiple rows.")
        out[start : start + len(block)] = np.argmax(matches, axis=1)
    return out


def lattice_points_in_supercell(supercell_matrix) -> np.ndarray:
    """Fractional coords (w.r.t. the supercell) of all prim lattice points.

    Returns an array of shape (det(supercell_matrix), 3) with values in
    [0, 1). Mirrors pymatgen.util.coord.lattice_points_in_supercell.
    """
    scm = np.asarray(supercell_matrix, dtype=np.int64).reshape(3, 3)
    n = int(round(abs(np.linalg.det(scm))))
    if n == 0:
        raise ValueError("Supercell matrix is singular.")
    # enumerate integer prim-lattice points inside the supercell parallelepiped
    corners = np.array(
        [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)]
    )
    cell_corners = corners @ scm
    mins = cell_corners.min(axis=0)
    maxs = cell_corners.max(axis=0)
    ranges = [np.arange(mins[i], maxs[i] + 1) for i in range(3)]
    grid = np.stack(np.meshgrid(*ranges, indexing="ij"), axis=-1).reshape(-1, 3)
    frac = grid @ np.linalg.inv(scm)
    tol = 1e-10
    inside = np.all((frac >= -tol) & (frac < 1 - tol), axis=1)
    pts = frac[inside]
    pts = np.mod(pts, 1.0)
    pts[pts > 1 - tol] = 0.0
    if len(pts) != n:
        raise RuntimeError(
            f"Found {len(pts)} lattice points, expected {n}: numerical issue."
        )
    # ORDER CONTRACT: keep the prim-integer-grid enumeration order
    # (lexicographic in the prim integer coordinates), matching pymatgen's
    # lattice_points_in_supercell — supercell site ordering is observable
    # through occupancy encodings and the reference's stored site mappings
    # (validated against reference-generated golden correlation vectors in
    # tests/test_integration/test_golden_parity.py).
    return pts
