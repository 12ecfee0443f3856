"""Ewald energy of a batch of occupancies.

Counterpart of ``smol_tpu/ops/ewald.py`` (:18-63), batched over walkers
in float64.  The full energy is the quadratic form b . M . b over the
occupied Ewald rows b; the single-flip delta takes two rows of M against
the occupied rows of all other sites.  Neither is a Pallas kernel in the
reference, so both stay plain torch (``torch.matmul`` for the form).
"""

from __future__ import annotations

import torch

__all__ = ["ewald_occupancy_vector", "ewald_energy", "delta_ewald_single_flip"]


def ewald_occupancy_vector(occu, ewald_inds, num_ewald_sites: int):
    """0/1 occupied-row vectors [W, n_ew] f64 of occupancies [W, N].

    ``ewald_inds[site, code]`` is the Ewald row of that species, or -1 for
    a vacancy.
    """
    occu = torch.atleast_2d(occu).long()
    sites = torch.arange(occu.shape[1], device=occu.device)
    rows = ewald_inds.long()[sites, occu]  # [W, N]
    rows = torch.where(rows >= 0, rows, num_ewald_sites)
    b = torch.zeros((occu.shape[0], num_ewald_sites + 1), dtype=torch.float64,
                    device=occu.device)
    b.scatter_(1, rows, 1.0)
    return b[:, :-1]


def ewald_energy(occu, ewald_matrix, ewald_inds):
    """Total Ewald energies [W] of occupancies [W, N]: b . M . b."""
    b = ewald_occupancy_vector(occu, ewald_inds, ewald_matrix.shape[0])
    return ((b @ ewald_matrix) * b).sum(dim=1)


def delta_ewald_single_flip(occu, site, new_code, ewald_matrix, ewald_inds):
    """Energy changes [W] of flipping ``site`` [W] to ``new_code`` [W].

    With b_c the occupied rows of all OTHER sites (the flipped site's row
    zeroed), removing row r and adding row a gives
    dE = 2 (M[a] . b_c - M[r] . b_c) + M[a, a] - M[r, r], each term left
    out when its row is a vacancy (-1).  The removed row never enters the
    dots: the rows of one site's species share a position, and the matrix
    entries between them are not physical.
    """
    occu = torch.atleast_2d(occu).long()
    walkers = torch.arange(occu.shape[0], device=occu.device)
    site, new_code = site.long(), new_code.long()
    inds = ewald_inds.long()
    b = ewald_occupancy_vector(occu, inds, ewald_matrix.shape[0])
    a = inds[site, new_code]
    r = inds[site, occu[walkers, site]]
    a_valid, r_valid = a >= 0, r >= 0
    a_safe, r_safe = a.clamp(min=0), r.clamp(min=0)
    b[walkers[r_valid], r_safe[r_valid]] = 0.0
    zero = torch.zeros((), dtype=torch.float64, device=occu.device)
    ma_b = torch.where(a_valid, (ewald_matrix[a_safe] * b).sum(dim=1), zero)
    mr_b = torch.where(r_valid, (ewald_matrix[r_safe] * b).sum(dim=1), zero)
    maa = torch.where(a_valid, ewald_matrix[a_safe, a_safe], zero)
    mrr = torch.where(r_valid, ewald_matrix[r_safe, r_safe], zero)
    return 2 * (ma_b - mr_b) + maa - mrr
