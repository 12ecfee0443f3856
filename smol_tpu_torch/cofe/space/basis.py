"""Site basis sets over discrete site spaces.

Counterpart of ``smol_tpu/cofe/space/basis.py``, whose code it copies. In
this module "the reference" is smol (CederGroupHub/smol).

A site basis is an array ``[n_functions, n_species]`` whose rows evaluate the
site functions at each allowed species (by encoding order).  Function 0 is
always the constant function 1.  Mirrors the reference's basis module
(smol/cofe/space/basis.py): flavors indicator, sinusoid (van de Walle 2009),
polynomial, chebyshev, legendre; measure-weighted Gram-Schmidt (QR)
orthonormalization; basis rotations.

Two construction paths exist:

- the array-first fast path (``StandardBasis(space, "sinusoid")``) used
  throughout this package, which builds the whole ``[n, n]`` function array
  in one vectorized shot; and
- the reference-compatible iterator path (``StandardBasis(space,
  SinusoidIterator(species))``), where a :class:`BasisIterator` yields one
  callable per non-constant function (reference basis.py:419-558).  Users
  migrating custom bases subclass :class:`BasisIterator`; the subclass is
  then discoverable by name through :func:`basis_factory` exactly as in the
  reference (basis.py:607-633).
"""

from __future__ import annotations

import warnings
from abc import ABCMeta, abstractmethod
from collections.abc import Iterator
from functools import partial, wraps

import numpy as np
from numpy.polynomial.chebyshev import chebval
from numpy.polynomial.legendre import legval
from numpy.polynomial.polynomial import polyval

from smol_tpu_torch.cofe.space.domain import SiteSpace
from smol_tpu_torch.serial import MSONable, process_decoded
from smol_tpu_torch.utils.class_utils import derived_class_factory, get_subclasses

__all__ = [
    "DiscreteBasis",
    "StandardBasis",
    "IndicatorBasis",
    "BasisIterator",
    "IndicatorIterator",
    "SinusoidIterator",
    "NumpyPolyIterator",
    "PolynomialIterator",
    "ChebyshevIterator",
    "LegendreIterator",
    "indicator",
    "sinusoid_factory",
    "sin_f",
    "cos_f",
    "encode_domain",
    "basis_factory",
    "available_site_basis_sets",
]

EPS = 10 * np.finfo(np.float64).eps

BASIS_FLAVORS = ("indicator", "sinusoid", "polynomial", "chebyshev", "legendre")


# --- basis function definitions (reference basis.py:560-604) ---------------
# Plain module-level functions so partials of them pickle.


def indicator(s, sp):
    """Indicator of the elementary event ``s == sp``."""
    return float(s == sp)


def sin_f(s, a, m):
    """Even-index van de Walle sinusoid function at encoded species s."""
    return -np.sin(2 * np.pi * a * s / m)


def cos_f(s, a, m):
    """Odd-index van de Walle sinusoid function at encoded species s."""
    return -np.cos(2 * np.pi * a * s / m)


def sinusoid_factory(n, m):
    """Sine or cosine sinusoid site function of (1-indexed) index n over m species."""
    a = -(-n // 2)  # ceiling division
    return partial(sin_f, a=a, m=m) if n % 2 == 0 else partial(cos_f, a=a, m=m)


def encode_domain(encoding):
    """Decorate a species-valued function with an integer domain encoding."""

    def decorate_func(func):
        @wraps(func)
        def encoded(s, *args, **kwargs):
            return func(encoding[s], *args, **kwargs)

        return encoded

    return decorate_func


# --- basis iterators (reference basis.py:419-558) ---------------------------


class BasisIterator(Iterator, metaclass=ABCMeta):
    r"""Iterate the non-constant site functions :math:`\phi_1..\phi_{n-1}`.

    Each ``__next__`` yields a callable mapping a species to a float.  The
    user-extension point: subclass with a unique ``flavor`` and a
    ``__next__``, then ``basis_factory("<flavor>", site_space)`` finds it by
    name (reference basis.py:419-447, 607-622).
    """

    flavor = "abstract"

    def __init__(self, species):
        self.species = tuple(species)
        self.species_iter = iter(self.species)

    def __len__(self):
        return len(self.species)


class IndicatorIterator(BasisIterator):
    """Cluster-indicator site functions (non-orthogonal)."""

    flavor = "indicator"

    def __next__(self):
        return partial(indicator, sp=next(self.species_iter))


class SinusoidIterator(BasisIterator):
    """Van de Walle sinusoid site functions (Calphad 33, 266 (2009)).

    Orthogonal for any number of species; orthonormal only for binaries.
    """

    flavor = "sinusoid"

    def __init__(self, species):
        super().__init__(species)
        self.encoding = {s: i for i, s in enumerate(self.species)}

    def __next__(self):
        next_ind = self.encoding[next(self.species_iter)] + 1
        return encode_domain(self.encoding)(
            sinusoid_factory(next_ind, len(self.species))
        )


class NumpyPolyIterator(BasisIterator, metaclass=ABCMeta):
    """Base iterator for numpy polynomial families over [low, high]."""

    flavor = "numpy-poly"

    def __init__(self, species, low=-1, high=1):
        super().__init__(species)
        enc = np.linspace(low, high, len(self.species))
        self.encoding = dict(zip(self.species, enc))

    @property
    @abstractmethod
    def polyval(self):
        """Return the numpy polyval function of the family."""

    def __next__(self):
        next_ind = self.species.index(next(self.species_iter)) + 1
        coefs = [0] * next_ind + [1]
        return encode_domain(self.encoding)(partial(self.polyval, c=coefs))


class PolynomialIterator(NumpyPolyIterator):
    """Standard polynomial site functions."""

    flavor = "polynomial"

    @property
    def polyval(self):
        return polyval


class ChebyshevIterator(NumpyPolyIterator):
    """Chebyshev polynomial site functions."""

    flavor = "chebyshev"

    @property
    def polyval(self):
        return chebval


class LegendreIterator(NumpyPolyIterator):
    """Legendre polynomial site functions."""

    flavor = "legendre"

    @property
    def polyval(self):
        return legval


def _raw_function_array(flavor: str, n: int) -> np.ndarray:
    """Build the raw (pre-orthonormalization) function array for n species.

    Returns [n, n] float64: row 0 constant 1, rows 1..n-1 the non-constant
    functions evaluated at integer species codes 0..n-1.  Vectorized fast
    path equivalent to iterating the flavor's BasisIterator (parity asserted
    in tests/test_cofe/test_basis.py).
    """
    codes = np.arange(n, dtype=np.float64)
    rows = [np.ones(n)]
    if flavor == "indicator":
        # indicator of species j for j = 0..n-2 (last replaced by constant,
        # matching reference StandardBasis._construct_function_array)
        for j in range(n - 1):
            rows.append((codes == j).astype(np.float64))
    elif flavor == "sinusoid":
        # van de Walle: function k (1-indexed) with a = ceil(k/2):
        # even k -> -sin(2 pi a s / n), odd k -> -cos(2 pi a s / n)
        for k in range(1, n):
            a = -(-k // 2)
            arg = 2 * np.pi * a * codes / n
            rows.append(-np.sin(arg) if k % 2 == 0 else -np.cos(arg))
    elif flavor in ("polynomial", "chebyshev", "legendre"):
        enc = np.linspace(-1, 1, n)
        val = {"polynomial": polyval, "chebyshev": chebval, "legendre": legval}[flavor]
        for k in range(1, n):
            coefs = np.zeros(k + 1)
            coefs[k] = 1.0
            rows.append(val(enc, coefs))
    else:
        raise ValueError(
            f"Unknown basis flavor {flavor!r}; options are {BASIS_FLAVORS}."
        )
    return np.array(rows, dtype=np.float64)


def _function_array_from_iterator(basis_functions: BasisIterator, species) -> np.ndarray:
    """Evaluate a BasisIterator into the stored [n, n] array layout.

    As in the reference (basis.py:257-264): the iterator yields one function
    per species; the last is dropped in favor of the implicit constant
    phi_0 = 1, which is stacked as row 0.
    """
    nconst = list(basis_functions)[:-1]
    func_arr = np.array(
        [[function(sp) for sp in species] for function in nconst], dtype=np.float64
    )
    const = np.ones(len(tuple(species)), dtype=np.float64)
    if func_arr.size == 0:
        return const[None, :]
    return np.vstack((const, func_arr))


# --- basis classes -----------------------------------------------------------


class DiscreteBasis(MSONable, metaclass=ABCMeta):
    """A basis set over a discrete finite domain (a site space).

    Shared behavior of StandardBasis and IndicatorBasis; polymorphic
    ``from_dict`` dispatches on the stored ``@class`` (reference
    basis.py:37-168).
    """

    @property
    def site_space(self) -> SiteSpace:
        return self._domain

    @property
    def species(self) -> list:
        return list(self._domain.keys())

    @property
    def function_array(self) -> np.ndarray:
        """Site functions as rows (subclasses refine which rows count)."""
        return self._f_array

    @property
    def measure_vector(self) -> np.ndarray:
        return np.array(list(self._domain.values()), dtype=np.float64)

    @property
    def measure_array(self) -> np.ndarray:
        """Diagonal matrix of site species measures."""
        return np.diag(self.measure_vector)

    @property
    def full_function_array(self) -> np.ndarray:
        """All stored function rows (including any implicit constant)."""
        return self._f_array

    @property
    def is_orthogonal(self) -> bool:
        prods = (self.measure_vector * self._f_array) @ self._f_array.T
        prods = prods / np.diag(prods)
        return np.allclose(prods, np.eye(len(prods)))

    @property
    def is_orthonormal(self) -> bool:
        prods = (self.measure_vector * self._f_array) @ self._f_array.T
        return np.allclose(prods, np.eye(len(prods)))

    @classmethod
    def from_dict(cls, d):
        """Polymorphic decode: dispatch to the stored subclass."""
        if cls is DiscreteBasis:
            subclass = get_subclasses(cls).get(d["@class"])
            if subclass is None:
                raise NameError(
                    f"{d['@class']} is not implemented or is not a subclass "
                    f"of DiscreteBasis."
                )
            return subclass.from_dict(d)
        raise NotImplementedError(f"{cls.__name__} must define from_dict.")


class StandardBasis(DiscreteBasis):
    """A site basis: function array over a site space.

    The stored array ``_f_array`` has shape [n_species, n_species]; row 0 is
    the constant function.  ``function_array`` exposes the non-constant rows,
    as in the reference (basis.py:219-222).

    ``flavor`` may be a flavor name (array-first fast path) or a
    :class:`BasisIterator` instance (reference-compatible path; the
    iterator's species must match the site space).
    """

    def __init__(self, site_space: SiteSpace, flavor="sinusoid", f_array=None):
        self._domain = site_space
        n = len(site_space)
        if isinstance(flavor, BasisIterator):
            basis_functions = flavor
            if set(site_space) != set(basis_functions.species):
                raise ValueError(
                    "Basis function iterator provided does not contain all "
                    f"species {list(site_space)} in the site space provided."
                )
            self.flavor = basis_functions.flavor
            self._f_array = (
                np.array(f_array, dtype=np.float64)
                if f_array is not None
                else _function_array_from_iterator(
                    basis_functions, list(site_space.keys())
                )
            )
        else:
            self.flavor = flavor
            self._f_array = (
                np.array(f_array, dtype=np.float64)
                if f_array is not None
                else _raw_function_array(flavor, n)
            )
        self._r_array = None  # R from QR orthonormalization
        self._rot_array = np.eye(n, dtype=np.float64)

    @property
    def function_array(self) -> np.ndarray:
        """Non-constant site functions as rows: [n_species - 1, n_species]."""
        return self._f_array[1:]

    @property
    def orthonormalization_array(self):
        return self._r_array

    @property
    def rotation_array(self) -> np.ndarray:
        return self._rot_array

    def orthonormalize(self):
        """Measure-weighted QR orthonormalization keeping row 0 constant.

        Mirrors reference basis.py:234-258.  Column signs are fixed so the
        diagonal of R is positive — QR then coincides with classical
        Gram-Schmidt, which PRESERVES each function's direction (an
        already-orthonormal basis passes through unchanged).  The sign
        convention is observable: the reference's sinusoid point
        functions keep their -cos leading sign after orthonormalization
        (validated against reference-generated golden correlation
        vectors in tests/test_integration/test_golden_parity.py).
        """
        q_mat, r_mat = np.linalg.qr(
            (np.sqrt(self.measure_vector) * self._f_array).T, mode="complete"
        )
        k = min(q_mat.shape[1], r_mat.shape[0])
        signs = np.sign(np.diag(r_mat)[:k])
        signs[signs == 0] = 1.0
        q_mat[:, :k] *= signs
        r_mat[:k] *= signs[:, None]
        r_mat[np.abs(r_mat) < EPS] = 0.0
        q_mat[np.abs(q_mat) < EPS] = 0.0
        self._r_array = (q_mat[:, 0] / np.sqrt(self.measure_vector) * r_mat.T).astype(
            np.float64
        )
        self._f_array = (q_mat.T / q_mat[:, 0]).astype(np.float64)

    def rotate(self, angle: float, index1: int = 0, index2: int = 1):
        """Rotate two non-constant basis functions within their span.

        For binary spaces this flips the sign of the single function
        (reference basis.py:260-338).
        """
        if not np.allclose(self.measure_vector, self.measure_vector[0]):
            warnings.warn(
                "Non-uniform measure: rotations are not adapted; consider "
                "re-orthonormalizing afterwards.",
                UserWarning,
            )
        elif not self.is_orthogonal:
            raise RuntimeError("Non-orthogonal site basis rotations are not allowed!")

        n = len(self._domain)
        if n == 2:
            self._f_array[1] *= -1
            rotation = -1 * self._rot_array
        else:
            if index1 == index2:
                raise ValueError("Basis function indices cannot be the same!")
            for idx in (index1, index2):
                if abs(idx) > n - 2:
                    raise ValueError(
                        f"Basis index {idx} out of bounds for {n - 1} functions!"
                    )
            v1 = self.function_array[index1] / np.linalg.norm(self.function_array[index1])
            v2 = self.function_array[index2] / np.linalg.norm(self.function_array[index2])
            rotation = (
                np.eye(len(v1))
                + (np.outer(v1, v2) - np.outer(v2, v1)) * np.sin(angle)
                + (np.outer(v1, v1) + np.outer(v2, v2)) * (np.cos(angle) - 1)
            )
            self._f_array[1:] = self._f_array[1:] @ rotation.T
            self._f_array[np.abs(self._f_array) < EPS] = 0.0
        self._rot_array = rotation @ self._rot_array

    def __eq__(self, other):
        if not isinstance(other, StandardBasis):
            return False
        return (
            self._domain == other._domain
            and self.flavor == other.flavor
            and np.allclose(self._f_array, other._f_array)
        )

    def __repr__(self):
        return f"StandardBasis({self.flavor}, {self._domain})"

    def as_dict(self) -> dict:
        return {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
            "site_space": self._domain.as_dict(),
            "flavor": self.flavor,
            "func_array": self._f_array.tolist(),
            "orthonorm_array": None if self._r_array is None else self._r_array.tolist(),
            "rot_array": self._rot_array.tolist(),
        }

    @classmethod
    def from_dict(cls, d):
        basis = cls(
            process_decoded(d["site_space"]), d["flavor"], f_array=d["func_array"]
        )
        if d.get("orthonorm_array") is not None:
            basis._r_array = np.array(d["orthonorm_array"], dtype=np.float64)
        if d.get("rot_array") is not None:
            basis._rot_array = np.array(d["rot_array"], dtype=np.float64)
        return basis


class IndicatorBasis(DiscreteBasis):
    """Full (over-complete) indicator basis used by PottsSubspace.

    One indicator function per species, no constant function
    (reference basis.py:376-416).
    """

    def __init__(self, site_space: SiteSpace):
        self.flavor = "indicator"
        self._domain = site_space
        n = len(site_space)
        self._f_array = np.eye(n, dtype=np.float64)

    @property
    def function_array(self) -> np.ndarray:
        return self._f_array

    @property
    def is_orthogonal(self) -> bool:
        return True

    def __eq__(self, other):
        return isinstance(other, IndicatorBasis) and self._domain == other._domain

    def as_dict(self) -> dict:
        return {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
            "site_space": self._domain.as_dict(),
        }

    @classmethod
    def from_dict(cls, d):
        return cls(process_decoded(d["site_space"]))


def basis_factory(basis_name: str, site_space: SiteSpace) -> StandardBasis:
    """Create a StandardBasis of the given flavor over a site space.

    Built-in flavors take the vectorized array path; any other name is
    resolved to a registered ``<Name>Iterator`` subclass of
    :class:`BasisIterator` (reference basis.py:607-622), so user-defined
    iterator subclasses are constructible by name.
    """
    if basis_name in BASIS_FLAVORS:
        return StandardBasis(site_space, basis_name)
    iterator_name = basis_name.capitalize() + "Iterator"
    species = tuple(site_space)
    basis_funcs = derived_class_factory(iterator_name, BasisIterator, species)
    return StandardBasis(site_space, basis_funcs)


def available_site_basis_sets() -> tuple:
    """Names of available site basis flavors (built-in + registered iterators)."""
    extra = tuple(
        sub.flavor
        for sub in get_subclasses(BasisIterator).values()
        if sub.flavor not in BASIS_FLAVORS + ("abstract", "numpy-poly")
    )
    return BASIS_FLAVORS + extra
