"""Ewald summation for periodic point-charge electrostatics.

Counterpart of ``smol_tpu/crystal/ewald.py``, whose code it copies, but for
the real-space pair sums: they go through the port's own host library
(``csrc/host_ewald.cpp``, the port's copy of ``native/smol_host.cpp``
``ewald_real_sums``, built by :func:`smol_tpu_torch.ops._build.host_ewald_real_sums`),
and raise where it cannot build or load; there is no numpy fallback.  In
this module "the reference" is smol (CederGroupHub/smol).

Replaces pymatgen.analysis.ewald.EwaldSummation for the subset the reference
uses (smol/cofe/extern/ewald.py:152-177): the pairwise energy matrices whose
occupied-row submatrix sums give configuration electrostatic energies.

Conventions (standard Ewald with screening parameter eta):

- ``total_energy_matrix = real + reciprocal``, with the point (self) energy
  and real-space self-image terms on the diagonal.
- The total electrostatic energy of the configuration is the plain sum of
  all matrix elements over occupied rows/cols (diagonal counted once),
  i.e. ``b @ M @ b`` for the 0/1 occupation vector ``b``.
- The charged-cell correction is NOT included (matching the reference's
  documented behavior, smol ewald.py:137-140).
"""

from __future__ import annotations

import numpy as np

__all__ = ["EwaldSummation"]

# e^2 / (4 pi eps0) in eV * Angstrom
CONV_FACT = 14.399645478425668


class EwaldSummation:
    """Computes Ewald energy matrices for a structure with oxidation states."""

    def __init__(
        self,
        structure,
        real_space_cut=None,
        recip_space_cut=None,
        eta=None,
        acc_factor=12.0,
    ):
        """Initialize and compute the Ewald matrices.

        Args:
            structure: Structure with oxidation-state-bearing species.
            real_space_cut: real-space cutoff radius (auto if None).
            recip_space_cut: reciprocal-space cutoff (auto if None).
            eta: screening parameter (auto if None).
            acc_factor: accuracy factor; error ~ 10^(-acc_factor).
        """
        self._structure = structure
        vol = structure.lattice.volume
        n = len(structure)
        w = 1 / 2**0.5
        self._eta = eta if eta else float((n * w / vol**2) ** (1 / 3) * np.pi)
        self._sqrt_eta = np.sqrt(self._eta)
        accf = np.sqrt(np.log(10**acc_factor))
        self._rmax = real_space_cut if real_space_cut else accf / self._sqrt_eta
        self._gmax = recip_space_cut if recip_space_cut else 2 * self._sqrt_eta * accf

        self._charges = np.array(
            [site.specie.oxi_state or 0.0 for site in structure], dtype=np.float64
        )
        self._coords = structure.cart_coords

        self._recip = self._calc_recip()
        self._real, self._point = self._calc_real_and_point()

    @property
    def eta(self):
        return self._eta

    @property
    def reciprocal_space_energy_matrix(self) -> np.ndarray:
        return self._recip

    @property
    def real_space_energy_matrix(self) -> np.ndarray:
        """Real-space matrix (diagonal holds self-image terms)."""
        return self._real

    @property
    def point_energy_matrix(self) -> np.ndarray:
        """Self-energy per site (1D)."""
        return self._point

    @property
    def total_energy_matrix(self) -> np.ndarray:
        """real + recip with point energy added to the diagonal."""
        total = self._recip + self._real
        total[np.diag_indices_from(total)] += self._point
        return total

    @property
    def total_energy(self) -> float:
        return float(self.total_energy_matrix.sum())

    def _calc_recip(self) -> np.ndarray:
        """Reciprocal-space pair matrix via one complex structure-factor matmul.

        M[i,j] = CONV * (2 pi / V) * sum_{0<|g|<gmax}
                 exp(-g^2/(4 eta)) / g^2 * q_i q_j cos(g.(r_i - r_j))
        so that sum_ij M[i,j] is the standard reciprocal-space energy.
        """
        lattice = self._structure.lattice
        vol = lattice.volume
        recip = lattice.reciprocal_lattice.matrix  # rows b1,b2,b3 (2pi included)
        ginv = np.linalg.inv(recip @ recip.T)
        bounds = np.ceil(self._gmax * np.sqrt(np.diag(ginv))).astype(int)
        ranges = [np.arange(-b, b + 1) for b in bounds]
        hkl = np.stack(np.meshgrid(*ranges, indexing="ij"), axis=-1).reshape(-1, 3)
        gs = hkl @ recip
        g2 = np.sum(gs * gs, axis=1)
        mask = (g2 > 1e-12) & (g2 < self._gmax**2)
        gs, g2 = gs[mask], g2[mask]
        weights = np.exp(-g2 / (4 * self._eta)) / g2  # [ng]
        phases = np.exp(1j * (gs @ self._coords.T))  # [ng, n]
        m = np.real(phases.T.conj() @ (weights[:, None] * phases))  # [n, n]
        qq = np.outer(self._charges, self._charges)
        return CONV_FACT * (2 * np.pi / vol) * m * qq

    def _calc_real_and_point(self) -> tuple[np.ndarray, np.ndarray]:
        """Real-space pair matrix and point self energies.

        real[i,j] = CONV/2 * q_i q_j * sum_images erfc(sqrt(eta) r)/r
        (both (i,j) and (j,i) present so the full sum gives the energy);
        diagonal collects self-image terms. point[i] = -CONV q_i^2
        sqrt(eta/pi).
        """
        lattice = self._structure.lattice
        ginv = np.linalg.inv(lattice.metric_tensor)
        spans = np.ceil(self._rmax * np.sqrt(np.diag(ginv))).astype(int) + 1
        ranges = [np.arange(-s, s + 1) for s in spans]
        images = np.stack(np.meshgrid(*ranges, indexing="ij"), axis=-1).reshape(-1, 3)
        img_cart = images @ lattice.matrix  # [m, 3]

        from smol_tpu_torch.ops._build import host_ewald_real_sums

        # the library skips coincident (zero-distance) pairs entirely;
        # those entries are never read by physical kernels
        sums = host_ewald_real_sums(self._coords, img_cart, self._sqrt_eta, self._rmax)
        qq = np.outer(self._charges, self._charges)
        real = 0.5 * CONV_FACT * qq * sums
        point = -CONV_FACT * self._charges**2 * np.sqrt(self._eta / np.pi)
        return real, point
