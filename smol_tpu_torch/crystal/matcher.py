"""Structure matching: supercell-matrix detection and site mapping.

A native replacement for the two uses the reference makes of pymatgen's
StructureMatcher (smol/cofe/space/clusterspace.py:175-202,
smol/cofe/wrangling/wrangler.py:670-797):

- :meth:`StructureMatcher.get_supercell_matrix`: the integer matrix
  relating a (possibly relaxed: rotated, strained, rattled) structure's
  lattice to the prim lattice,
- :meth:`StructureMatcher.get_mapping`: the site correspondence between a
  structure and the same-size ideal supercell of the prim,
- :meth:`StructureMatcher.fit`: equivalence of two structures.

Robustness model (mirroring pymatgen's semantics):

- ``ltol``: fractional tolerance on lattice-vector lengths.  A rotated
  and/or strained cell is detected by searching integer combinations of
  prim vectors whose lengths and mutual angles match the structure's
  lattice vectors (rotation-invariant Gram matching), not by requiring
  the raw ``L_s @ inv(L_p)`` to be integer.
- ``angle_tol``: degrees of tolerance on lattice-vector angles.
- ``stol``: site tolerance, normalized as in pymatgen — the cartesian
  displacement divided by ``(V / nsites)^(1/3)`` must not exceed it.

Site mapping works in fractional coordinates (which removes the rigid
rotation and the homogeneous strain exactly), tries candidate rigid
translations anchored on compatible site pairs, refines each candidate to
the rms-minimizing translation, and solves the assignment with the
Hungarian algorithm (scipy), never greedily.

Counterpart of ``smol_tpu/crystal/matcher.py``, whose code it copies. In
this module "the reference" is smol (CederGroupHub/smol), and pymatgen's
``StructureMatcher`` the matcher whose semantics it keeps.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

from smol_tpu_torch.crystal.coord import pbc_diff
from smol_tpu_torch.utils.exceptions import StructureMatchError

__all__ = ["StructureMatcher"]


def _species_compatible(site_species, allowed) -> bool:
    """True if every species at `site_species` is allowed at the target site."""
    return all(sp in allowed for sp in site_species)


def _norms(matrix):
    return np.linalg.norm(matrix, axis=1)


MAX_SHELL_BOUND = 36  # one-shot cube enumeration up to (2*36+1)^3 ~ 389k
MAX_SHELL_BOUND_HARD = 512  # beyond this, raise instead of searching forever


def _lll_reduce(basis, delta=0.75):
    """LLL-reduce a 3x3 row-vector lattice basis.

    Returns ``(reduced, T)`` with ``reduced == T @ basis`` and T a
    unimodular integer matrix.  Serves the same role as the Niggli/LLL
    reduction pymatgen applies before supercell searches (relied on by
    the reference at smol/cofe/space/clusterspace.py:175-202): a reduced
    basis minimizes ``sigma_max(inv(basis))``, which bounds the integer
    shell enumeration in :func:`_shell_points` by the physical ratio
    (target length / shortest lattice vector) instead of blowing up on
    skewed input bases.
    """
    b = np.asarray(basis, dtype=np.float64).copy()
    t_mat = np.eye(3, dtype=np.int64)

    def gs(b):
        bstar = b.astype(np.float64).copy()
        mu = np.zeros((3, 3))
        for i in range(3):
            for j in range(i):
                denom = np.dot(bstar[j], bstar[j])
                mu[i, j] = np.dot(b[i], bstar[j]) / denom
                bstar[i] = bstar[i] - mu[i, j] * bstar[j]
        return bstar, mu

    k, iters = 1, 0
    while k < 3 and iters < 200:
        iters += 1
        bstar, mu = gs(b)
        for j in range(k - 1, -1, -1):
            q = int(round(mu[k, j]))
            if q != 0:
                b[k] -= q * b[j]
                t_mat[k] -= q * t_mat[j]
                bstar, mu = gs(b)
        if np.dot(bstar[k], bstar[k]) >= (
            delta - mu[k, k - 1] ** 2
        ) * np.dot(bstar[k - 1], bstar[k - 1]):
            k += 1
        else:
            b[[k, k - 1]] = b[[k - 1, k]]
            t_mat[[k, k - 1]] = t_mat[[k - 1, k]]
            k = max(k - 1, 1)
    return b, t_mat


def _shell_points(lp, target, rtol):
    """Integer combinations c with | c @ lp | within rtol of target.

    ``lp`` must be (close to) reduced — the caller LLL-reduces first so
    the enumeration bound tracks target/|shortest vector|.  Bounded by
    MAX_SHELL_BOUND (returns empty beyond it: no match at sane cost).
    """
    # |c| <= |c @ lp| * sigma_max(inv(lp))
    smax = np.linalg.norm(np.linalg.inv(lp), ord=2)
    b = int(np.ceil(target * (1 + rtol) * smax)) + 1
    if b > MAX_SHELL_BOUND_HARD:
        from smol_tpu_torch.utils.exceptions import StructureMatchError

        raise StructureMatchError(
            f"Supercell lattice-vector search needs a +-{b} integer shell "
            f"(> hard bound {MAX_SHELL_BOUND_HARD}); the supercell is "
            "implausibly long relative to the primitive cell, or the "
            "primitive lattice is degenerate."
        )
    lo, hi = target * (1 - rtol), target * (1 + rtol)
    rng = np.arange(-b, b + 1)
    if b <= MAX_SHELL_BOUND:
        cand = (
            np.array(np.meshgrid(rng, rng, rng, indexing="ij")).reshape(3, -1).T
        )
        vecs = cand @ lp
        norms = np.linalg.norm(vecs, axis=1)
        sel = (norms >= lo) & (norms <= hi)
        return cand[sel], vecs[sel], norms[sel]
    # large shells (long thin supercells): filter slab-by-slab along the
    # first axis so peak memory stays O(b^2) while keeping the exact result
    plane = np.array(np.meshgrid(rng, rng, indexing="ij")).reshape(2, -1).T
    cands, vlist, nlist = [], [], []
    for c0 in rng:
        cand = np.concatenate(
            [np.full((len(plane), 1), c0, dtype=np.int64), plane], axis=1
        )
        vecs = cand @ lp
        norms = np.linalg.norm(vecs, axis=1)
        sel = (norms >= lo) & (norms <= hi)
        if np.any(sel):
            cands.append(cand[sel])
            vlist.append(vecs[sel])
            nlist.append(norms[sel])
    if not cands:
        empty = np.empty((0, 3))
        return empty.astype(np.int64), empty, np.empty(0)
    return np.concatenate(cands), np.concatenate(vlist), np.concatenate(nlist)


def _size_from_spec(structure, prim, spec):
    """Supercell size from a pymatgen-style ``supercell_size`` spec.

    ``'num_sites'``, ``'volume'`` (= None: geometric), or species/element
    name(s) whose total amounts set the size ratio — the knob the
    reference passes through to pymatgen (reference clusterspace.py:146,
    e.g. ``supercell_size=('O2-', 'F-')`` in its LMOF workflows).
    Returns None when the spec does not determine an integer size.
    """
    if spec is None or spec == "volume":
        return None
    if spec == "num_sites":
        num, denom = float(len(structure)), float(len(prim))
    else:
        names = (spec,) if isinstance(spec, str) else tuple(spec)

        def amount(struct):
            total = 0.0
            for site in struct:
                for sp, occ in site.species.items():
                    if str(sp) in names or getattr(sp, "symbol", None) in names:
                        total += occ
            return total

        num, denom = amount(structure), amount(prim)
    if denom <= 0:
        return None
    size = num / denom
    return int(round(size)) if abs(size - round(size)) < 1e-6 else None


def _size_constraints_from_sites(structure, prim):
    """Supercell-size constraints implied by atom counts.

    Returns ``(det_lo, det_exact)``: a lower bound on the supercell
    determinant, and the exact determinant when one is implied.  Volume
    ratios mislead after relaxation (pymatgen instead sizes supercells by
    composition, which the reference relies on at
    smol/cofe/space/clusterspace.py:908); atom counts are exact:

    - every structure atom compatible with exactly one prim site-space
      class must fit in that class's ``slots_per_prim * size`` sites,
    - a class with no vacancy (site occupancies summing to 1) is fully
      occupied, so when all its candidate atoms are unambiguous its count
      pins the size exactly.
    """
    classes = {}  # frozenset(species) -> [slots_per_prim, has_vacancy]
    for site in prim:
        key = frozenset(site.species.keys())
        occ = float(sum(site.species.values()))
        entry = classes.setdefault(key, [0, False])
        entry[0] += 1
        entry[1] = entry[1] or occ < 1 - 1e-6
    only_counts = dict.fromkeys(classes, 0)
    any_counts = dict.fromkeys(classes, 0)
    for site in structure:
        species = set(site.species.keys())
        compatible = [key for key in classes if species <= key]
        if len(compatible) == 1:
            only_counts[compatible[0]] += 1
        for key in compatible:
            any_counts[key] += 1
    det_lo, det_exact = 1, None
    for key, (slots, has_vacancy) in classes.items():
        det_lo = max(det_lo, -(-only_counts[key] // slots))
        if (
            not has_vacancy
            and only_counts[key] == any_counts[key]
            and only_counts[key] > 0
            and only_counts[key] % slots == 0
        ):
            exact = only_counts[key] // slots
            if det_exact is not None and exact != det_exact:
                return det_lo, None  # inconsistent counts: trust neither
            det_exact = exact
    return det_lo, det_exact


class StructureMatcher:
    """Match structures to supercells of a primitive cell.

    Handles relaxed DFT structures: rigid rotations, homogeneous strain up
    to ``ltol``/``angle_tol``, and site rattling up to ``stol`` (pymatgen
    normalization).
    """

    def __init__(
        self,
        ltol: float = 0.2,
        stol: float = 0.3,
        angle_tol: float = 5,
        supercell_size=None,
        **_,
    ):
        self.ltol = ltol
        self.stol = stol
        self.angle_tol = angle_tol
        self.supercell_size = supercell_size

    # ------------------------------------------------------------------
    # lattice matching
    # ------------------------------------------------------------------

    def get_supercell_matrix(self, structure, prim):
        """Integer M with structure.lattice ~ R @ (M @ prim.lattice).

        R is an arbitrary rigid rotation; lengths may deviate by ``ltol``
        (fractional) and angles by ``angle_tol`` (degrees).  Returns None
        when no integer relation holds within tolerance.  On point-group
        degeneracies (distinct sublattices with identical Gram matrices —
        common for cubic prims) this returns the lowest-error candidate;
        use :meth:`get_supercell_matrix_candidates` when the caller can
        disambiguate with site information.
        """
        cands = self.get_supercell_matrix_candidates(structure, prim)
        return cands[0] if cands else None

    def get_supercell_matrix_candidates(
        self, structure, prim, max_candidates: int = 4
    ):
        """Distinct-sublattice supercell-matrix candidates, best first.

        Lattice geometry alone cannot always pick the supercell: a cubic
        lattice has several det-n sublattices with the SAME vector
        lengths and angles, and only site positions distinguish them
        (pymatgen resolves this inside its full-structure fit; the
        reference relies on that at smol/cofe/space/clusterspace.py:908).
        This returns up to ``max_candidates`` sublattice-inequivalent
        matrices ordered by lattice mismatch so callers (e.g.
        ``ClusterSubspace.scmatrix_from_structure``) can try the site
        mapping against each.
        """
        lp = np.asarray(prim.lattice.matrix, dtype=np.float64)
        ls = np.asarray(structure.lattice.matrix, dtype=np.float64)
        vol_p = abs(np.linalg.det(lp))
        vol_s = abs(np.linalg.det(ls))
        n = int(round(vol_s / vol_p))
        if n < 1 or abs(vol_s / vol_p - n) > max(0.1, 3 * self.ltol * n):
            return []
        det_lo, det_exact = _size_constraints_from_sites(structure, prim)
        spec_exact = _size_from_spec(structure, prim, self.supercell_size)
        if spec_exact is not None:
            det_exact = spec_exact

        # fast path: same orientation, integer relation directly
        m_float = ls @ np.linalg.inv(lp)
        m_int = np.round(m_float).astype(np.int64)
        d_int = abs(np.linalg.det(m_int))
        if (
            abs(d_int - n) < 0.5
            and np.max(np.abs(m_float - m_int)) <= self.ltol
            and d_int >= det_lo
            and (det_exact is None or abs(d_int - det_exact) < 0.5)
        ):
            return [m_int]

        # general path: rotation-invariant search over integer combinations
        # of prim vectors matching the structure vectors' lengths + angles.
        # LLL-reduce the prim basis first: shell enumeration cost then
        # scales with (target length / shortest prim vector)^3 regardless
        # of how skewed the input basis is.
        lp_red, t_red = _lll_reduce(lp)
        # under strain the volume ratio is biased by up to ~(1 + ltol)^3:
        # accept any determinant in the tolerance window and let the
        # length/angle error score pick the best relation (an exact match
        # scores ~0; wrong-det imposters carry the full strain error)
        n_c = vol_s / vol_p
        n_min = max(1.0, n_c * (1 - 2 * self.ltol) - 0.5)
        n_max = n_c * (1 + 2 * self.ltol) + 0.5
        # site counts are exact where the volume is not (relaxation changes
        # cell volume but never the atom count): tighten the determinant
        # window with them, and widen it when a count-implied size falls
        # outside the strain window
        n_min = max(n_min, det_lo - 0.5)
        if det_exact is not None:
            n_min, n_max = det_exact - 0.5, det_exact + 0.5
        # volume normalization (pymatgen scale=True, which the reference
        # always passes, clusterspace.py:183): rescale the structure's
        # vectors to the ideal supercell volume so ltol measures only the
        # ANISOTROPIC part of the relaxation, not the uniform dilation
        size_for_scale = det_exact if det_exact is not None else n
        scale = (size_for_scale * vol_p / vol_s) ** (1.0 / 3.0)
        ls = ls * scale
        s_norms = _norms(ls)
        cos_tol = np.deg2rad(self.angle_tol)
        s_unit = ls / s_norms[:, None]
        s_ang = np.array(
            [
                np.arccos(np.clip(np.dot(s_unit[i], s_unit[j]), -1, 1))
                for i, j in ((0, 1), (0, 2), (1, 2))
            ]
        )

        shells = [_shell_points(lp_red, t, self.ltol) for t in s_norms]
        if any(len(s[0]) == 0 for s in shells):
            return []

        c1s, v1s, n1s = shells[0]
        c2s, v2s, n2s = shells[1]
        c3s, v3s, n3s = shells[2]
        found = []  # (err, m) pairs in the reduced basis
        for i1 in range(len(c1s)):
            v1, nn1 = v1s[i1], n1s[i1]
            ang12 = np.arccos(
                np.clip(v2s @ v1 / (n2s * nn1), -1, 1)
            )
            ok2 = np.abs(ang12 - s_ang[0]) <= cos_tol
            if not ok2.any():
                continue
            for i2 in np.nonzero(ok2)[0]:
                v2, nn2 = v2s[i2], n2s[i2]
                ang13 = np.arccos(np.clip(v3s @ v1 / (n3s * nn1), -1, 1))
                ang23 = np.arccos(np.clip(v3s @ v2 / (n3s * nn2), -1, 1))
                ok3 = (np.abs(ang13 - s_ang[1]) <= cos_tol) & (
                    np.abs(ang23 - s_ang[2]) <= cos_tol
                )
                for i3 in np.nonzero(ok3)[0]:
                    m = np.stack([c1s[i1], c2s[i2], c3s[i3]])
                    d = abs(np.linalg.det(m))
                    if d < n_min or d > n_max:
                        continue
                    err = (
                        abs(nn1 - s_norms[0]) / s_norms[0]
                        + abs(nn2 - s_norms[1]) / s_norms[1]
                        + abs(n3s[i3] - s_norms[2]) / s_norms[2]
                        + abs(ang12[i2] - s_ang[0])
                        + abs(ang13[i3] - s_ang[1])
                        + abs(ang23[i3] - s_ang[2])
                    )
                    found.append((err, m.astype(np.int64)))
        if not found:
            return []
        found.sort(key=lambda em: em[0])
        # Keep several row-variants per DISTINCT sublattice (m1 and m2 span
        # the same sublattice iff m1 @ inv(m2) is integer unimodular).  One
        # representative is not enough: the site mapping works in fractional
        # coordinates, which requires the structure's lattice vectors to
        # correspond ROW-BY-ROW to the candidate's — and under large
        # anisotropic relaxation the lowest-lattice-error variant of the
        # right sublattice can still be a permuted/reflected basis whose
        # fractional frames disagree.  The caller disambiguates by mapping.
        # Rows map back to prim rows through t_red.
        variants_per_sublattice = 4
        sublattices = []  # list of [representative mp, count]
        out = []
        for err, m in found:
            mp = m @ t_red
            if any(np.array_equal(mp, prev) for prev in out):
                continue
            group = None
            for entry in sublattices:
                u = mp @ np.linalg.inv(entry[0])
                if np.allclose(u, np.round(u), atol=1e-9) and (
                    abs(abs(np.linalg.det(u)) - 1) < 1e-9
                ):
                    group = entry
                    break
            if group is None:
                if sum(1 for _ in sublattices) >= max_candidates:
                    continue
                sublattices.append([mp, 1])
                out.append(mp)
            elif group[1] < variants_per_sublattice:
                group[1] += 1
                out.append(mp)
        return out

    # ------------------------------------------------------------------
    # site mapping
    # ------------------------------------------------------------------

    @staticmethod
    def _min_image_cart(frac_diff, lat_red):
        """True minimal-image cartesian vectors for reduced-frame frac diffs.

        Per-axis wrapping of fractional differences is NOT the minimal
        image under a skewed metric (pymatgen instead searches
        neighboring images, pymatgen.util.coord.pbc_shortest_vectors);
        with an LLL-reduced basis the true image is always within one
        cell of the wrapped one, so a {-1,0,1}^3 shift search is exact.
        Returns (cart_vectors, squared_norms) of shape [..., 3] / [...].
        """
        wrapped = frac_diff - np.round(frac_diff)
        shifts = np.array(
            np.meshgrid((-1, 0, 1), (-1, 0, 1), (-1, 0, 1), indexing="ij")
        ).reshape(3, -1).T  # [27, 3]
        cand = wrapped[..., None, :] + shifts  # [..., 27, 3]
        cart = cand @ lat_red
        d2 = np.sum(cart * cart, axis=-1)
        best = np.argmin(d2, axis=-1)
        cart_best = np.take_along_axis(
            cart, best[..., None, None], axis=-2
        )[..., 0, :]
        return cart_best, np.take_along_axis(d2, best[..., None], axis=-1)[
            ..., 0
        ]

    def _assignment(self, sup_red, str_red, lat_red, t_inv, lat_inv, compat, t):
        """Hungarian assignment of shifted structure sites to supercell sites.

        Works in the LLL-reduced lattice frame with true minimal-image
        distances.  ``t`` is a translation in the ORIGINAL fractional
        frame; ``t_inv = inv(T)`` maps original-frame frac coords into
        the reduced frame (``lat_red = T @ lat``), ``lat_inv = inv(lat)``.
        Matching pymatgen's _cart_dists semantics, the max distance is
        measured AFTER removing the mean displacement of the matched
        pairs (the rigid-translation freedom is not charged against
        stol).  Returns (mapping, max centered distance, mean pbc
        displacement in the original fractional frame).
        """
        diff = (str_red + t @ t_inv)[:, None, :] - sup_red[None, :, :]
        cart, d2 = self._min_image_cart(diff, lat_red)
        big = 1e12
        cost = np.where(compat, d2, big)
        row, col = linear_sum_assignment(cost)
        if (cost[row, col] >= big).any():
            return None, np.inf, None
        vecs = cart[row, col]  # [ns, 3] minimal-image cartesian
        mean_cart = vecs.mean(axis=0)
        d = np.linalg.norm(vecs - mean_cart, axis=1)
        mapping = np.empty(len(str_red), dtype=np.int64)
        mapping[row] = col
        return mapping, d.max(), mean_cart @ lat_inv

    def get_mapping(self, supercell, structure):
        """Map structure sites onto supercell sites.

        Returns an int array ``mapping`` of length ``len(structure)`` where
        ``supercell[mapping[k]]`` is the site hosting ``structure[k]`` (the
        contract of pymatgen StructureMatcher.get_mapping used by the
        reference at clusterspace.py:1183), or None when no mapping exists
        within ``stol``.  Rotation and homogeneous strain are removed by
        working in fractional coordinates; the rigid translation is refined
        to the rms minimizer; assignment is Hungarian.
        """
        if len(structure) > len(supercell):
            return None
        sup_frac = np.asarray(supercell.frac_coords, dtype=np.float64)
        str_frac = np.asarray(structure.frac_coords, dtype=np.float64)
        allowed = [list(site.species.keys()) for site in supercell]
        str_species = [list(site.species.keys()) for site in structure]

        compat = np.array(
            [
                [_species_compatible(sp, al) for al in allowed]
                for sp in str_species
            ],
            dtype=bool,
        )
        if not compat.any(axis=1).all():
            return None

        # pymatgen _preprocess + _cart_dists metric semantics (scale=True,
        # which the reference always passes, clusterspace.py:183): rescale
        # both lattices to their geometric-mean volume, then measure
        # displacements in the AVERAGE of the two.  For relaxed DFT cells
        # this measures each site's displacement halfway between the ideal
        # and relaxed metrics — materially looser than the ideal metric
        # when the displacement field follows the relaxation strain
        # (structures pymatgen maps can sit a few percent outside stol in
        # the ideal metric).
        l1 = np.asarray(supercell.lattice.matrix, dtype=np.float64)
        l2 = np.asarray(structure.lattice.matrix, dtype=np.float64)
        ratio = (abs(np.linalg.det(l2)) / abs(np.linalg.det(l1))) ** (1 / 6)
        # pymatgen averages the six lattice PARAMETERS of the two
        # volume-rescaled cells (StructureMatcher._get_lattices /
        # _strict_match "av_lat"), which is rotation- and reflection-
        # independent — a matrix average would shrink (or degenerate)
        # under basis misalignment and change accept decisions relative
        # to the upstream pipeline.
        len1 = _norms(l1 * ratio)
        len2 = _norms(l2 / ratio)
        ang1 = supercell.lattice.angles
        ang2 = structure.lattice.angles
        from smol_tpu_torch.crystal.lattice import Lattice as _Lattice

        lat = _Lattice.from_parameters(
            *((len1 + len2) / 2), *((np.asarray(ang1) + np.asarray(ang2)) / 2)
        ).matrix
        if not np.all(np.isfinite(lat)):
            return None  # unphysical averaged parameters: no match
        vol = abs(np.linalg.det(lat))
        norm_len = (vol / len(supercell)) ** (1 / 3)
        max_d = self.stol * norm_len

        # LLL-reduce the supercell lattice once: minimal-image searches in
        # the reduced frame only need {-1,0,1} shifts (see _min_image_cart)
        lat_red, t_red = _lll_reduce(lat)
        t_inv = np.linalg.inv(t_red.astype(np.float64))
        lat_inv = np.linalg.inv(lat)
        sup_red = sup_frac @ t_inv
        str_red = str_frac @ t_inv

        # candidate rigid translations: structure site 0 onto each
        # compatible supercell site (null translation first)
        cands = [np.zeros(3)]
        for j in np.nonzero(compat[0])[0]:
            cands.append(sup_frac[j] - str_frac[0])

        best_mapping = None
        best_d = np.inf
        for t in cands:
            mapping, dmax, mean_disp = self._assignment(
                sup_red, str_red, lat_red, t_inv, lat_inv, compat, t
            )
            if mapping is None:
                continue
            # refine to the rms-minimizing translation and redo once
            t2 = t - mean_disp
            mapping2, dmax2, _ = self._assignment(
                sup_red, str_red, lat_red, t_inv, lat_inv, compat, t2
            )
            if mapping2 is not None and dmax2 < dmax:
                mapping, dmax = mapping2, dmax2
            if dmax < best_d:
                best_d = dmax
                best_mapping = mapping
                if dmax <= 0.1 * max_d:
                    break  # essentially exact; stop searching
        if best_mapping is None or best_d > max_d:
            return None
        return best_mapping

    def fit(self, s1, s2) -> bool:
        """True if two structures are equivalent (same sites and species)."""
        if len(s1) != len(s2):
            return False
        m = self.get_supercell_matrix(s1, s2)
        if m is None or abs(abs(np.linalg.det(m)) - 1) > 0.1:
            return False
        mapping = self.get_mapping(s1, s2)
        if mapping is None:
            return False
        # also require species equality (not just compatibility)
        return all(
            s2[k].species == s1[mapping[k]].species for k in range(len(s2))
        )


def get_supercell_matrix_or_raise(structure, prim, matcher=None):
    """Convenience wrapper raising StructureMatchError on failure."""
    matcher = matcher or StructureMatcher()
    scm = matcher.get_supercell_matrix(structure, prim)
    if scm is None:
        raise StructureMatchError(
            "Supercell matrix could not be determined from structure."
        )
    if np.linalg.det(scm) < 0:
        scm = -scm
    return scm
