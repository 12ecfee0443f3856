"""Integer/lattice math: HNF, SNF, Diophantine solvers, flip-table tools.

Counterpart of ``smol_tpu/utils/math.py``, whose code it copies, the part
that ``moca/composition/space.py`` and the supercell enumeration
(``capp/generate/enumerate.py``) need: without ``flip_weights_mask`` and
``choose_section_from_partition``, which only the host single-walker
``TableFlip`` takes (ROADMAP.md Queue 1 item 6). In
this module "the reference" is smol (CederGroupHub/smol).

Covers the reference's math utilities (smol/utils/math.py) with the optional
cvxpy/polytope dependencies replaced by scipy.optimize (linprog/milp):

- Hermite normal form enumeration (supercell matrices),
- Smith normal form and integer Diophantine systems A n = b,
- enumeration of natural-number solutions of bounded integer polytopes,
- flip-table basis optimization and ergodicity augmentation.
"""

from __future__ import annotations

from fractions import Fraction
from itertools import combinations, product

import numpy as np
from scipy.optimize import LinearConstraint, linprog, milp
from scipy.spatial import KDTree

NUM_TOL = 1e-6

__all__ = [
    "NUM_TOL",
    "yield_hermite_normal_forms",
    "gcdex",
    "rationalize_number",
    "integerize_vector",
    "integerize_multiple",
    "compute_snf",
    "solve_diophantines",
    "get_nonneg_float_vertices",
    "get_natural_centroid",
    "get_natural_solutions",
    "get_one_dim_solutions",
    "get_first_dim_extremes",
    "flip_size",
    "connectivity",
    "is_connected",
    "count_row_matches",
    "get_optimal_basis",
    "get_ergodic_vectors",
]




def yield_hermite_normal_forms(determinant: int):
    """Yield all 3x3 lower-triangular HNF matrices of a given determinant."""
    for a in (x for x in range(1, determinant + 1) if determinant % x == 0):
        quotient = determinant // a
        for c in (x for x in range(1, quotient + 1) if quotient % x == 0):
            f = quotient // c
            for b, d, e in product(range(c), range(f), range(f)):
                yield np.array([[a, 0, 0], [b, c, 0], [d, e, f]], dtype=int)


def gcdex(a: int, b: int):
    """Extended Euclid: returns (x, y, g) with a*x + b*y = g = gcd(a, b)."""
    if a == 0:
        return 0, 1, b
    x1, y1, g = gcdex(b % a, a)
    return y1 - (b // a) * x1, x1, g


def rationalize_number(a: float, max_denominator: int = 1000, dtol: float = NUM_TOL):
    """Nearest rational p/q with q <= max_denominator, within dtol."""
    frac = Fraction(float(a)).limit_denominator(max_denominator)
    if abs(frac.numerator / frac.denominator - a) > dtol:
        raise ValueError(f"Can't find a rational number near {a} within tolerance!")
    return frac.numerator, frac.denominator


def integerize_vector(v, max_denominator: int = 1000, dtol: float = NUM_TOL):
    """Scale a rational vector to integers; returns (int vector, multiplier)."""
    v = np.asarray(v, dtype=np.float64)
    denominators = [
        rationalize_number(c, max_denominator=max_denominator, dtol=dtol)[1]
        for c in v
    ]
    lcm = int(np.lcm.reduce(denominators)) if denominators else 1
    return np.array(np.round(v * lcm), dtype=np.int64), lcm


def integerize_multiple(vs, max_denominator: int = 1000, dtol: float = NUM_TOL):
    """Integerize a whole matrix with one common multiplier."""
    vs = np.asarray(vs, dtype=np.float64)
    flat, mul = integerize_vector(
        vs.ravel(), max_denominator=max_denominator, dtol=dtol
    )
    return flat.reshape(vs.shape), mul


def compute_snf(a):
    """Smith normal form over Z: returns (s, m, t) with m = s @ a @ t.

    Minimal-pivot reduction: each stage moves the smallest-magnitude
    nonzero entry of the trailing submatrix to the pivot, then divides
    its column and row with remainder (elementary unimodular row/column
    additions).  Any nonzero remainder is strictly smaller in magnitude
    and becomes the next pivot pick, so each stage terminates.  Once the
    pivot's row and column are clear, a trailing entry it does not
    divide folds its row into the pivot row and reduction resumes —
    producing the divisibility chain d1 | d2 | ... directly, with zero
    diagonal entries trailing.  (Same contract as the reference
    smol/utils/math.py:149; independent algorithm and structure.)
    """
    # exact Python-int arithmetic: transform coefficients can exceed
    # int64 on large-determinant inputs (growth is inherent to SNF
    # transforms); results are cast back to int64 when they fit
    m = np.round(np.asarray(a)).astype(np.int64).astype(object)
    nr, nc = m.shape
    s = np.eye(nr, dtype=np.int64).astype(object)
    t = np.eye(nc, dtype=np.int64).astype(object)

    def _fit64(x):
        lim = np.iinfo(np.int64).max
        if all(-lim <= int(v) <= lim for v in x.flat):
            return x.astype(np.int64)
        return x

    for p in range(min(nr, nc)):
        while True:
            sub = m[p:, p:]
            nzi, nzj = np.nonzero(sub)
            if len(nzi) == 0:
                return _fit64(s), _fit64(m), _fit64(t)  # trailing zero: done
            k = int(np.argmin(np.abs(sub[nzi, nzj])))
            i, j = p + int(nzi[k]), p + int(nzj[k])
            if i != p:
                m[[p, i]] = m[[i, p]]
                s[[p, i]] = s[[i, p]]
            if j != p:
                m[:, [p, j]] = m[:, [j, p]]
                t[:, [p, j]] = t[:, [j, p]]
            if m[p, p] < 0:
                m[p] = -m[p]
                s[p] = -s[p]
            piv = int(m[p, p])
            # divide-with-remainder down the column and across the row;
            # floor division leaves remainders in [0, piv)
            clear = True
            for i in range(p + 1, nr):
                q = m[i, p] // piv
                if q:
                    m[i] -= q * m[p]
                    s[i] -= q * s[p]
                if m[i, p]:
                    clear = False
            for j in range(p + 1, nc):
                q = m[p, j] // piv
                if q:
                    m[:, j] -= q * m[:, p]
                    t[:, j] -= q * t[:, p]
                if m[p, j]:
                    clear = False
            if not clear:
                continue  # a smaller remainder exists: re-pick the pivot
            rem = m[p + 1:, p + 1:] % piv
            if rem.size and rem.any():
                # divisibility repair: fold one offending row into row p
                i = p + 1 + int(np.nonzero(rem.any(axis=1))[0][0])
                m[p] += m[i]
                s[p] += s[i]
                continue
            break
    return _fit64(s), _fit64(m), _fit64(t)


def _size_reduce_rows(vs):
    """Greedy pairwise (Lagrange-style) size reduction of lattice rows.

    Repeatedly replaces v_i by v_i - round(<v_i, v_j>/<v_j, v_j>) v_j
    whenever that strictly shrinks v_i: the spanned lattice is unchanged
    and every row's norm is non-increasing, so the loop terminates.
    Short basis vectors matter downstream — they become composition flip
    vectors, and small flips keep the composition grid well connected.
    """
    if len(vs) == 0:
        return np.zeros(np.shape(vs), dtype=np.int64)
    vs = np.asarray(vs, dtype=object).copy()  # exact until reduced
    changed = True
    while changed:
        changed = False
        for i in range(len(vs)):
            for j in range(len(vs)):
                if i == j:
                    continue
                denom = int(vs[j] @ vs[j])
                if denom == 0:
                    continue
                mu = round(int(vs[i] @ vs[j]) / denom)
                if mu == 0:
                    continue
                cand = vs[i] - mu * vs[j]
                if cand @ cand < vs[i] @ vs[i]:
                    vs[i] = cand
                    changed = True
    return np.array([[int(x) for x in row] for row in vs], dtype=np.int64)


def solve_diophantines(a, b=None):
    """Solve the integer system A n = b via Smith normal form.

    Returns (n0, vs): a base solution and the lattice basis (rows) such
    that every integer solution is n0 + x @ vs.  The kernel basis is
    size-reduced and the base solution is pulled toward the origin
    modulo the kernel lattice, keeping both small regardless of the SNF
    transform's coefficient growth.
    """
    a = np.asarray(a, dtype=np.int64)
    n, d = a.shape
    b = np.asarray(b, dtype=np.int64) if b is not None else np.zeros(n, dtype=np.int64)
    s, m, t = compute_snf(a)
    c = s @ b
    k = None
    for i in range(min(n, d)):
        if m[i, i] == 0:
            k = i
    k = min(n, d) if k is None else k
    for i in range(k):
        if c[i] % m[i, i] != 0:
            raise ValueError("Diophantine equations A n = b are not feasible!")
    diag = np.array([int(m[i, i]) for i in range(k)], dtype=object)
    n0 = np.asarray(t[:, :k], dtype=object) @ (
        np.asarray(c[:k], dtype=object) // diag
    )
    vs = _size_reduce_rows(t[:, k:].T)
    # reduce the base solution modulo the kernel lattice (exact big-int
    # arithmetic until after the reduction: the raw SNF-transform image
    # of b can exceed int64 even when the reduced solution is tiny)
    changed = True
    while changed:
        changed = False
        for v in vs:
            vo = np.asarray(v, dtype=object)
            denom = int(vo @ vo)
            if denom == 0:
                continue
            mu = round(int(n0 @ vo) / denom)
            cand = n0 - mu * vo
            if mu and cand @ cand < n0 @ n0:
                n0 = cand
                changed = True
    return np.asarray([int(x) for x in n0], dtype=np.int64), vs


def get_nonneg_float_vertices(a, b):
    """Vertices of the polytope {n : A n = b, n >= 0} (float).

    Implemented by enumerating basic feasible solutions of the standard-form
    LP (all d-choose-rank support sets), which is adequate for the small
    composition systems this is used for.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n_rows, d = a.shape
    rank = np.linalg.matrix_rank(a)
    vertices = []
    for cols in combinations(range(d), rank):
        sub = a[:, cols]
        if np.linalg.matrix_rank(sub) < rank:
            continue
        sol, *_ = np.linalg.lstsq(sub, b, rcond=None)
        if np.max(np.abs(sub @ sol - b)) > NUM_TOL:
            continue
        if np.any(sol < -NUM_TOL):
            continue
        vertex = np.zeros(d)
        vertex[list(cols)] = sol
        if not any(np.allclose(vertex, v, atol=NUM_TOL) for v in vertices):
            vertices.append(vertex)
    if not vertices:
        raise ValueError("Provided equation An=b is not feasible under n>=0.")
    return np.array(vertices)


def get_first_dim_extremes(a, b):
    """(min x0, max x0) subject to a x <= b, via scipy linprog."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    d = a.shape[1]
    cost = np.zeros(d)
    cost[0] = 1.0
    lo = linprog(cost, A_ub=a, b_ub=b, bounds=[(None, None)] * d, method="highs")
    hi = linprog(-cost, A_ub=a, b_ub=b, bounds=[(None, None)] * d, method="highs")
    if not lo.success or not hi.success:
        raise ValueError("Polytope a x <= b is empty or not bounded!")
    return lo.fun, -hi.fun


def get_natural_centroid(n0, vs, sc_size, a_leq=None, b_leq=None):
    """Integer point x minimizing L1 distance to the polytope centroid.

    Subject to n0 + x @ vs >= 0 (and optional extra inequalities
    a_leq @ (n0 + x @ vs) <= b_leq * sc_size).  MILP via scipy/HiGHS
    replaces the reference's cvxpy dependency (math.py:339-393).
    """
    n0 = np.asarray(n0, dtype=np.int64)
    vs = np.asarray(vs, dtype=np.int64)
    n, d = vs.shape
    # centroid of the feasible x-polytope from its vertices via LP extremes
    a_ub = [-vs.T]  # -(x @ vs) <= n0
    b_ub = [n0.astype(np.float64)]
    if a_leq is not None and b_leq is not None:
        a_leq = np.asarray(a_leq, dtype=np.float64)
        b_leq = np.asarray(b_leq, dtype=np.float64)
        a_ub.append(a_leq @ vs.T)
        b_ub.append(b_leq * sc_size - a_leq @ n0)
    a_ub = np.concatenate(a_ub, axis=0)
    b_ub = np.concatenate(b_ub)

    # approximate centroid: average of per-axis LP extremes
    centroid = np.zeros(n)
    for i in range(n):
        cost = np.zeros(n)
        cost[i] = 1.0
        lo = linprog(cost, A_ub=a_ub, b_ub=b_ub, bounds=[(None, None)] * n,
                     method="highs")
        hi = linprog(-cost, A_ub=a_ub, b_ub=b_ub, bounds=[(None, None)] * n,
                     method="highs")
        if not lo.success or not hi.success:
            raise ValueError("No feasible natural number composition found!")
        centroid[i] = 0.5 * (lo.fun - hi.fun)

    # MILP: minimize sum_i t_i, t_i >= +-(x_i - centroid_i)
    # variables [x (int), t (cont)]
    ncols = 2 * n
    cost = np.concatenate([np.zeros(n), np.ones(n)])
    cons = [
        LinearConstraint(
            np.concatenate([a_ub, np.zeros((len(a_ub), n))], axis=1),
            -np.inf,
            b_ub,
        ),
        LinearConstraint(
            np.concatenate([np.eye(n), -np.eye(n)], axis=1), -np.inf, centroid
        ),
        LinearConstraint(
            np.concatenate([-np.eye(n), -np.eye(n)], axis=1), -np.inf, -centroid
        ),
    ]
    integrality = np.concatenate([np.ones(n), np.zeros(n)])
    res = milp(c=cost, constraints=cons, integrality=integrality)
    if not res.success:
        raise ValueError("No feasible natural number composition found!")
    return np.array(np.round(res.x[:n]), dtype=np.int64)


def get_one_dim_solutions(n0, v, integer_tol=NUM_TOL, step=1):
    """All integers x with n0 + v * x >= 0 (bounded)."""
    x_min, x_max = -np.inf, np.inf
    for n_i, v_i in zip(n0, v):
        if v_i > 0:
            x_min = max(x_min, -n_i / v_i)
        elif v_i < 0:
            x_max = min(x_max, -n_i / v_i)
        elif n_i < 0:
            return np.array([], dtype=int)
    if x_min <= -np.inf or x_max >= np.inf:
        raise ValueError("Inequalities are not bounded!")
    x_min = round(x_min) if abs(x_min - round(x_min)) <= integer_tol else x_min
    x_max = round(x_max) if abs(x_max - round(x_max)) <= integer_tol else x_max
    n_min, n_max = np.ceil(x_min), np.floor(x_max)
    if n_min > n_max:
        return np.array([], dtype=int)
    return np.arange(n_min, n_max + 1, step, dtype=int)


def get_natural_solutions(n0, vs, integer_tol=NUM_TOL, step=1):
    """Enumerate all x with n0 + x @ vs >= 0 (recursive branch on x0).

    Costly; only use for small supercell sizes (reference math.py:484).
    """
    n0 = np.asarray(n0, dtype=np.int64)
    vs = np.asarray(vs, dtype=np.int64)
    n, d = vs.shape
    if n == 1:
        return get_one_dim_solutions(
            n0, vs[0], integer_tol=integer_tol, step=step
        ).reshape(-1, 1)
    x_min, x_max = get_first_dim_extremes(-vs.T.astype(np.float64), n0)
    x_min = round(x_min) if abs(x_min - round(x_min)) <= integer_tol else x_min
    x_max = round(x_max) if abs(x_max - round(x_max)) <= integer_tol else x_max
    n_min, n_max = np.ceil(x_min), np.floor(x_max)
    if n_min > n_max:
        return np.array([], dtype=int).reshape(-1, n)
    sols = []
    for m in np.arange(n_min, n_max + 1, step, dtype=int):
        sub = get_natural_solutions(
            m * vs[0] + n0, vs[1:], integer_tol=integer_tol, step=step
        )
        if len(sub) > 0:
            sub = np.concatenate(
                [np.full((len(sub), 1), m, dtype=int), sub], axis=1
            )
        else:
            sub = np.array([], dtype=int).reshape(-1, n)
        sols.append(sub)
    return np.concatenate(sols, axis=0)


# ---------------------------------------------------------------------------
# flip-table utilities
# ---------------------------------------------------------------------------


def flip_size(u) -> int:
    """Number of species moved by a site-conserving flip direction."""
    u = np.asarray(u, dtype=np.int64)
    if np.sum(u) != 0:
        raise ValueError(f"Flip vector {u} does not conserve number of sites!")
    return int(np.sum(u[u > 0]))


def count_row_matches(a1, a2) -> int:
    """Number of common rows between two integer arrays."""
    s1 = {tuple(r) for r in np.asarray(a1, dtype=np.int64)}
    s2 = {tuple(r) for r in np.asarray(a2, dtype=np.int64)}
    return len(s1 & s2)


def connectivity(u, ns) -> int:
    """Number of composition-grid edges parallel to direction u."""
    ns = np.asarray(ns, dtype=np.int64)
    return count_row_matches(ns, ns + np.asarray(u, dtype=np.int64))


def is_connected(n, vs, ns) -> bool:
    """True if grid point n connects to the grid via +-vs."""
    n = np.asarray(n, dtype=np.int64)
    vs = np.asarray(vs, dtype=np.int64)
    ns = np.asarray(ns, dtype=np.int64)
    images = np.concatenate([vs, -vs], axis=0) + n
    return bool(np.any(np.all(images[:, None, :] == ns[None, :, :], axis=-1)))


def get_optimal_basis(n0, vs, xs, max_loops: int = 100):
    """Greedy flip-basis optimization: minimal sizes, maximal connectivity.

    Reference math.py:659-747.
    """
    n0 = np.asarray(n0, dtype=np.int64)
    vs_opt = np.asarray(vs, dtype=np.int64).copy()
    xs = np.asarray(xs, dtype=np.int64)
    ns = xs @ vs_opt + n0 if len(xs) else np.zeros((0, len(n0)), dtype=np.int64)
    n, d = vs_opt.shape

    def key_func(u):
        return flip_size(u), -connectivity(u, ns)

    def standardize(v):
        sign = (v[:, 0] >= 0).astype(int)
        return v * np.round((sign - 0.5) * 2).astype(int)[:, None]

    def tables_match(v1, v2):
        if v1.shape != v2.shape:
            return False
        return count_row_matches(standardize(v1), standardize(v2)) == v1.shape[0]

    for _ in range(max_loops):
        candidates = vs_opt.copy()
        for i1, i2 in combinations(range(n), 2):
            candidates = np.concatenate(
                [candidates, [candidates[i1] + candidates[i2],
                              candidates[i1] - candidates[i2]]],
                axis=0,
            )
        candidates = np.array(sorted(candidates, key=key_func), dtype=np.int64)
        vs_new = np.zeros((0, d), dtype=np.int64)
        for cand in candidates:
            if len(vs_new) == n:
                break
            trial = np.concatenate([vs_new, [cand]], axis=0)
            if np.linalg.matrix_rank(trial) == min(trial.shape):
                vs_new = trial
        if tables_match(vs_new, vs_opt):
            break
        vs_opt = vs_new
    return vs_opt


def get_ergodic_vectors(n0, vs, xs, k: int = 3):
    """Augment a flip basis so every composition grid point is connected.

    Reference math.py:750-829.
    """
    n0 = np.asarray(n0, dtype=np.int64)
    vs = np.asarray(vs, dtype=np.int64)
    xs = np.asarray(xs, dtype=np.int64)
    ns = xs @ vs + n0

    def test_connected(vecs, points):
        return np.array([is_connected(p, vecs, ns) for p in points], dtype=bool)

    connected = test_connected(vs, ns)
    disconnected = ns[~connected]
    if len(disconnected) == 0:
        return vs

    tree = KDTree(ns)
    candidates = []
    for point in disconnected:
        dists, ids = tree.query(point, k=min(k, len(ns)))
        dists, ids = np.atleast_1d(dists), np.atleast_1d(ids)
        if dists[0] == 0:
            ids = ids[1:]
        for other in ns[ids]:
            u = tuple((other - point).tolist())
            if u not in candidates and tuple(-np.array(u)) not in candidates:
                candidates.append(u)
    candidates = sorted(candidates, key=lambda u: flip_size(u))
    selected = vs.copy()
    remaining = disconnected.copy()
    for u in candidates:
        selected = np.concatenate([selected, [u]], axis=0)
        still = test_connected(selected, remaining)
        remaining = remaining[~still]
        if len(remaining) == 0:
            break
    return selected

