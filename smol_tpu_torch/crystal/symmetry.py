"""Crystal symmetry: SymmOp and a spacegroup-operation finder.

Counterpart of ``smol_tpu/crystal/symmetry.py``, whose code it copies. In
this module "the reference" is smol (CederGroupHub/smol).

Replaces pymatgen's SymmOp + SpacegroupAnalyzer.get_symmetry_operations for
the reference's usage (smol/cofe/space/clusterspace.py:295).  The finder
implements the standard lattice-metric algorithm (as in spglib):

1. candidate rotations R (integer matrices in fractional coordinates) are all
   integer matrices satisfying R G R^T = G with G the lattice metric tensor,
2. for each R, candidate translations t map one reference site onto each
   same-species site; (R, t) is kept if it maps every site onto a site with
   an identical species composition (within tolerance, modulo 1).
"""

from __future__ import annotations

import itertools

import numpy as np

from smol_tpu_torch.crystal.coord import pbc_diff
from smol_tpu_torch.serial import MSONable


class SymmOp(MSONable):
    """A symmetry operation in fractional coordinates: f -> f @ R.T + t."""

    def __init__(self, rotation, translation):
        self.rotation = np.array(rotation, dtype=np.float64).reshape(3, 3)
        self.translation = np.array(translation, dtype=np.float64).reshape(3)

    @classmethod
    def identity(cls) -> "SymmOp":
        return cls(np.eye(3), np.zeros(3))

    def operate(self, frac_coords) -> np.ndarray:
        return np.asarray(frac_coords) @ self.rotation.T + self.translation

    def operate_multi(self, frac_coords) -> np.ndarray:
        return np.atleast_2d(np.asarray(frac_coords)) @ self.rotation.T + self.translation

    def __mul__(self, other: "SymmOp") -> "SymmOp":
        """Compose: (self * other)(x) = self(other(x))."""
        return SymmOp(
            self.rotation @ other.rotation,
            self.rotation @ other.translation + self.translation,
        )

    def __eq__(self, other):
        if not isinstance(other, SymmOp):
            return False
        return np.allclose(self.rotation, other.rotation, atol=1e-8) and np.allclose(
            pbc_diff(self.translation, other.translation), 0, atol=1e-6
        )

    def __hash__(self):
        key = np.concatenate(
            [self.rotation.ravel(), np.mod(self.translation, 1.0)]
        ).round(6)
        return hash(key.tobytes())

    def __repr__(self):
        return f"SymmOp(R={self.rotation.astype(int).tolist()}, t={np.round(self.translation, 6).tolist()})"

    def as_dict(self) -> dict:
        return {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
            "rotation": self.rotation.tolist(),
            "translation": self.translation.tolist(),
        }

    @classmethod
    def from_dict(cls, d):
        return cls(d["rotation"], d["translation"])


def _site_signature(site, decimals=5):
    """Hashable species-composition signature for symmetry comparisons."""
    return frozenset(
        (str(sp), round(amt, decimals)) for sp, amt in site.species.items()
    )


def _candidate_rotations(metric: np.ndarray, tol: float) -> list[np.ndarray]:
    """All integer matrices R with R G R^T = G (lattice point group)."""
    ginv = np.linalg.inv(metric)
    rows_by_axis = []
    for i in range(3):
        target = metric[i, i]
        # any integer row r with r G r^T = target satisfies
        # |r_j| <= sqrt(target * Ginv_jj)
        bounds = np.floor(np.sqrt(np.abs(target * np.diag(ginv))) + tol).astype(int)
        cands = []
        ranges = [range(-b, b + 1) for b in bounds]
        for r in itertools.product(*ranges):
            r = np.array(r)
            if abs(r @ metric @ r - target) < tol:
                cands.append(r)
        rows_by_axis.append(cands)

    rotations = []
    for r0 in rows_by_axis[0]:
        for r1 in rows_by_axis[1]:
            if abs(r0 @ metric @ r1 - metric[0, 1]) > tol:
                continue
            for r2 in rows_by_axis[2]:
                if abs(r0 @ metric @ r2 - metric[0, 2]) > tol:
                    continue
                if abs(r1 @ metric @ r2 - metric[1, 2]) > tol:
                    continue
                rot = np.array([r0, r1, r2])
                if abs(abs(round(np.linalg.det(rot))) - 1) < 0.5:
                    rotations.append(rot)
    return rotations


def get_symmetry_operations(structure, symprec: float = 1e-5) -> list[SymmOp]:
    """Find all spacegroup operations of a (possibly disordered) structure.

    Site species compositions must match exactly between mapped sites (the
    reference uses disordered prim cells; symmetry respects partial
    occupancies).

    Args:
        structure: Structure to analyze.
        symprec: fractional-coordinate tolerance for site matching.

    Returns:
        list of SymmOp (always includes the identity).
    """
    frac = structure.frac_coords
    sigs = [_site_signature(s) for s in structure]
    metric = structure.lattice.metric_tensor
    # normalize tolerance to metric scale
    mtol = symprec * float(np.trace(metric))

    rotations = _candidate_rotations(metric, mtol)

    # use sites of the rarest signature as translation anchors
    unique_sigs = {}
    for i, s in enumerate(sigs):
        unique_sigs.setdefault(s, []).append(i)
    anchor_sig = min(unique_sigs, key=lambda s: len(unique_sigs[s]))
    anchor = unique_sigs[anchor_sig][0]
    anchor_targets = unique_sigs[anchor_sig]

    sig_ids = {s: k for k, s in enumerate(unique_sigs)}
    site_sig_ids = np.array([sig_ids[s] for s in sigs])

    ops = []
    # _candidate_rotations yields W with W G W^T = G, the row-action form
    # (f' = f @ W); SymmOp stores the column-action rotation R = W^T.
    for w in rotations:
        rot = w.T
        rot_frac = frac @ w
        for j in anchor_targets:
            t = frac[j] - rot_frac[anchor]
            mapped = rot_frac + t
            # match each mapped site to an original site modulo 1
            diff = pbc_diff(mapped[:, None, :], frac[None, :, :])
            matches = np.all(np.abs(diff) < symprec * 10, axis=-1)
            # require a bijective, species-preserving mapping
            ok = True
            perm = np.full(len(frac), -1)
            for i in range(len(frac)):
                hits = np.nonzero(matches[i])[0]
                hits = [h for h in hits if site_sig_ids[h] == site_sig_ids[i]]
                if len(hits) != 1:
                    ok = False
                    break
                perm[i] = hits[0]
            if ok and len(np.unique(perm)) == len(frac):
                ops.append(SymmOp(rot, np.mod(t, 1.0)))
    # dedupe (possible if multiple anchors give the same translation)
    unique_ops = []
    for op in ops:
        if op not in unique_ops:
            unique_ops.append(op)
    return unique_ops
