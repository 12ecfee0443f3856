"""Standard benchmark systems (BASELINE.md configs).

Counterpart of ``smol_tpu/benchmarks/systems.py``, whose code it copies.

Builders for the prim structures + cluster expansions used by the benchmark
and driver configs:

1. binary FCC Au-Cu CE (pair+triplet),
2. ternary FCC alloy CE,
3. LiMn2O4-type spinel CE (Li+/vacancy on 8a, Mn3+/Mn4+ on 16d, fixed O)
   with optional Ewald electrostatics.
"""

from __future__ import annotations

import numpy as np

from smol_tpu_torch.cofe import ClusterSubspace
from smol_tpu_torch.cofe.expansion import ClusterExpansion
from smol_tpu_torch.cofe.extern import EwaldTerm
from smol_tpu_torch.crystal import Lattice, Structure

__all__ = [
    "fcc_binary_prim",
    "fcc_ternary_prim",
    "spinel_prim",
    "random_expansion",
]


def fcc_binary_prim(a: float = 3.8, species=("Au", "Cu")) -> Structure:
    """Primitive FCC cell with a 50/50 binary site."""
    lat = Lattice(np.array([[0, 0.5, 0.5], [0.5, 0, 0.5], [0.5, 0.5, 0]]) * a)
    return Structure(lat, [{species[0]: 0.5, species[1]: 0.5}], [[0, 0, 0]])


def fcc_ternary_prim(a: float = 3.9, species=("Au", "Ag", "Cu")) -> Structure:
    """Primitive FCC cell with a ternary site."""
    lat = Lattice(np.array([[0, 0.5, 0.5], [0.5, 0, 0.5], [0.5, 0.5, 0]]) * a)
    return Structure(lat, [{sp: 1 / 3 for sp in species}], [[0, 0, 0]])


def spinel_prim(a: float = 8.2) -> Structure:
    """LiMn2O4-type spinel primitive cell (14 sites, Fd-3m).

    Li+/vacancy on the 8a tetrahedral sites, Mn3+/Mn4+ on the 16d octahedral
    sites, fixed O2- on ideal 32e (u = 1/4) positions.
    """
    conv = Lattice.cubic(a)
    prim_lat = Lattice(np.array([[0, 0.5, 0.5], [0.5, 0, 0.5], [0.5, 0.5, 0]]) * a)
    f_centers = np.array([[0, 0, 0], [0, 0.5, 0.5], [0.5, 0, 0.5], [0.5, 0.5, 0]])

    li8a = (
        np.array([[1, 1, 1], [7, 7, 7]]) / 8.0
    )[:, None, :] + f_centers[None, :, :]
    mn16d = (
        np.array([[2, 2, 2], [2, 1, 1], [1, 2, 1], [1, 1, 2]]) / 4.0
    )[:, None, :] + f_centers[None, :, :]
    # ideal O sublattice: fcc lattice of spacing a/2 shifted by (1/4,1/4,1/4)
    pts = []
    for i in range(4):
        for j in range(4):
            for k in range(4):
                base = np.array([i, j, k]) / 2.0
                for off in ((0, 0, 0), (0, 0.25, 0.25), (0.25, 0, 0.25), (0.25, 0.25, 0)):
                    pts.append(np.round((base + off + 0.25) % 1, 6))
    o32 = np.unique(np.array(pts), axis=0)

    def to_prim(frac_conv):
        frac_conv = np.asarray(frac_conv).reshape(-1, 3) % 1
        cart = frac_conv @ conv.matrix
        fp = np.round((cart @ prim_lat.inv_matrix) % 1, 6) % 1
        return np.unique(fp, axis=0)

    li_p, mn_p, o_p = to_prim(li8a), to_prim(mn16d), to_prim(o32)
    species = (
        [{"Li+": 0.5}] * len(li_p)
        + [{"Mn3+": 0.5, "Mn4+": 0.5}] * len(mn_p)
        + ["O2-"] * len(o_p)
    )
    return Structure(prim_lat, species, np.vstack([li_p, mn_p, o_p]))


def random_expansion(
    prim,
    cutoffs,
    scale: float = 0.05,
    seed: int = 42,
    ewald: bool = False,
    ewald_coef: float = 0.1,
    basis: str = "sinusoid",
) -> ClusterExpansion:
    """A ClusterExpansion with random ECIs (synthetic fit) on a prim."""
    subspace = ClusterSubspace.from_cutoffs(prim, cutoffs, basis=basis)
    if ewald:
        subspace.add_external_term(EwaldTerm())
    rng = np.random.default_rng(seed)
    coefs = rng.normal(scale=scale, size=len(subspace))
    coefs[0] = -1.0
    if ewald:
        coefs[-1] = ewald_coef
    return ClusterExpansion(subspace, coefs)
