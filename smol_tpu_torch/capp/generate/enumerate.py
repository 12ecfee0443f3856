"""Enumeration of symmetrically distinct supercell matrices.

Mirrors the reference (smol/capp/generate/enumerate.py): Hermite normal
forms filtered by symmetry-operation unimodular equivalence
(PhysRevB.77.224115, PhysRevB.80.014120).

Counterpart of ``smol_tpu/capp/generate/enumerate.py``, whose code it
copies. In this module "the reference" is smol (CederGroupHub/smol).
"""

from __future__ import annotations

import numpy as np

from smol_tpu_torch.utils.math import yield_hermite_normal_forms

__all__ = ["enumerate_supercell_matrices"]


def enumerate_supercell_matrices(size: int, symops, tol: float = 1e-5) -> list:
    """All symmetrically distinct supercell matrices of a given size.

    Args:
        size: determinant (number of prims) of the supercells.
        symops: symmetry operations of the prim structure.
        tol: tolerance for unimodular-equivalence detection.

    Returns:
        list of int ndarray supercell matrices.
    """
    matrices = []
    for hnf in yield_hermite_normal_forms(size):
        distinct = True
        for symop in symops:
            hnf_rot = np.linalg.inv(hnf) @ symop.rotation
            for scm in matrices:
                unimod = hnf_rot @ scm.T
                if np.all(np.abs(unimod - np.round(unimod)) < tol):
                    distinct = False
                    break
            if not distinct:
                break
        if distinct:
            matrices.append(hnf.T)  # supercell convention: transpose of HNF
    return matrices
