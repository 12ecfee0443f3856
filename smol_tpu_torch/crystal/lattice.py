"""Lattice: a 3x3 matrix of row lattice vectors (pymatgen row convention).

Counterpart of ``smol_tpu/crystal/lattice.py``, whose code it copies. In
this module "the reference" is smol (CederGroupHub/smol).

Cartesian coords = frac @ matrix.  Replaces pymatgen.core.Lattice for the
subset of functionality the reference uses.
"""

from __future__ import annotations

import numpy as np

from smol_tpu_torch.serial import MSONable


class Lattice(MSONable):
    """A 3D periodic lattice defined by three row vectors."""

    def __init__(self, matrix):
        m = np.array(matrix, dtype=np.float64).reshape(3, 3)
        m.setflags(write=False)
        self._matrix = m
        self._inv = np.linalg.inv(m)

    @classmethod
    def cubic(cls, a: float) -> "Lattice":
        return cls(np.eye(3) * a)

    @classmethod
    def from_parameters(cls, a, b, c, alpha, beta, gamma) -> "Lattice":
        """Build from lengths (Angstrom) and angles (degrees)."""
        alpha_r, beta_r, gamma_r = np.radians([alpha, beta, gamma])
        val = (np.cos(alpha_r) * np.cos(beta_r) - np.cos(gamma_r)) / (
            np.sin(alpha_r) * np.sin(beta_r)
        )
        val = np.clip(val, -1.0, 1.0)
        gamma_star = np.arccos(val)
        vec_a = [a * np.sin(beta_r), 0.0, a * np.cos(beta_r)]
        vec_b = [
            -b * np.sin(alpha_r) * np.cos(gamma_star),
            b * np.sin(alpha_r) * np.sin(gamma_star),
            b * np.cos(alpha_r),
        ]
        vec_c = [0.0, 0.0, float(c)]
        return cls([vec_a, vec_b, vec_c])

    @property
    def matrix(self) -> np.ndarray:
        """3x3 array, rows are lattice vectors a, b, c."""
        return self._matrix

    @property
    def inv_matrix(self) -> np.ndarray:
        return self._inv

    @property
    def metric_tensor(self) -> np.ndarray:
        """G = M M^T so that |f M|^2 = f G f^T."""
        return self._matrix @ self._matrix.T

    @property
    def volume(self) -> float:
        return float(abs(np.linalg.det(self._matrix)))

    @property
    def lengths(self) -> np.ndarray:
        return np.linalg.norm(self._matrix, axis=1)

    @property
    def angles(self) -> np.ndarray:
        m = self._matrix
        lengths = self.lengths
        angles = np.zeros(3)
        for i in range(3):
            j, k = (i + 1) % 3, (i + 2) % 3
            cos = np.dot(m[j], m[k]) / (lengths[j] * lengths[k])
            angles[i] = np.degrees(np.arccos(np.clip(cos, -1, 1)))
        return angles

    @property
    def reciprocal_lattice(self) -> "Lattice":
        """Reciprocal lattice including the 2*pi factor."""
        return Lattice(2 * np.pi * np.linalg.inv(self._matrix).T)

    def get_cartesian_coords(self, frac_coords) -> np.ndarray:
        return np.asarray(frac_coords, dtype=np.float64) @ self._matrix

    def get_fractional_coords(self, cart_coords) -> np.ndarray:
        return np.asarray(cart_coords, dtype=np.float64) @ self._inv

    def copy(self) -> "Lattice":
        return Lattice(self._matrix.copy())

    def __eq__(self, other):
        if not isinstance(other, Lattice):
            return False
        return np.allclose(self._matrix, other._matrix)

    def __hash__(self):
        return hash(self._matrix.round(8).tobytes())

    def __repr__(self):
        return f"Lattice({self._matrix.tolist()})"

    def as_dict(self) -> dict:
        return {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
            "matrix": self._matrix.tolist(),
        }

    @classmethod
    def from_dict(cls, d):
        return cls(d["matrix"])
