"""Processor base: the host API of a fixed-supercell processor.

Counterpart of ``smol_tpu/moca/processor/base.py`` (``Processor`` :27-225),
whose host API it copies: a processor is built from a cluster subspace, a
supercell matrix and its coefficients, and evaluates on its ``device``
(``"cuda"`` by default; the CPU only when the caller asks for it).  Where
the reference calls its JAX device functions, a processor calls the port's
torch ops on its device (:meth:`Processor.compute_features`, batched over
walkers, and :meth:`Processor._feature_change` for one flip); host results
come back as numpy f64.

A processor loaded from a system dict (``from_system``, the subclasses'
classmethod) evaluates the same features from the dict's arrays, and has
no cluster subspace, structure or species: the host methods that need
them raise ``ValueError`` there.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from smol_tpu_torch.cofe.space.domain import Vacancy, get_allowed_species, get_site_spaces
from smol_tpu_torch.crystal import PeriodicSite, Structure
from smol_tpu_torch.moca.sublattice import sublattices_from_site_spaces, sublattices_from_system
from smol_tpu_torch.serial import MSONable
from smol_tpu_torch.utils.class_utils import get_subclasses

__all__ = ["Processor", "check_device"]


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch sees no CUDA device; pass "
            "device='cpu' to evaluate on the CPU"
        )
    return device


class Processor(MSONable):
    """Base class of the fixed-supercell processors.

    Args:
        cluster_subspace: the port's ``ClusterSubspace``.
        supercell_matrix: [3, 3] integer supercell matrix.
        coefficients: the processor's coefficients, one a feature.
        use_concentration: whether the site spaces carry the prim's
            concentrations (the default sublattices then do too).
        device: where the tables and the evaluations live.
    """

    def __init__(self, cluster_subspace, supercell_matrix, coefficients,
                 use_concentration=False, device="cuda"):
        self.device = check_device(device)
        self._subspace = cluster_subspace
        self._structure = cluster_subspace.structure.copy().make_supercell(
            supercell_matrix
        )
        self._scmatrix = np.array(supercell_matrix, dtype=np.int64)
        self.coefs = np.atleast_1d(np.asarray(coefficients, dtype=np.float64))

        site_spaces = set(
            get_site_spaces(self._structure, include_measure=use_concentration)
        )
        self.unique_site_spaces = tuple(sorted(site_spaces))
        self.active_site_spaces = tuple(
            space for space in self.unique_site_spaces if len(space) > 1
        )
        self.allowed_species = get_allowed_species(self._structure)
        self.size = self._subspace.num_prims_from_matrix(supercell_matrix)
        self._num_sites = len(self._structure)
        self._sublattices = None

    def _init_from_system(self, system, device, coefficients, sublattices=None):
        """The state of a processor loaded from a system dict: its sizes,
        coefficients and sublattices, and no subspace, structure or
        species."""
        self.device = check_device(device)
        self._subspace = self._structure = None
        matrix = system.get("supercell_matrix")
        self._scmatrix = None if matrix is None else np.asarray(matrix, dtype=np.int64)
        self.coefs = np.atleast_1d(np.asarray(coefficients, dtype=np.float64))
        self.unique_site_spaces = self.active_site_spaces = self.allowed_species = None
        self.size = int(system["size"])
        self._num_sites = int(system["num_sites"])
        self._sublattices = (sublattices_from_system(system) if sublattices is None
                             else sublattices)

    def _require_subspace(self, what):
        if self._subspace is None:
            raise ValueError(
                f"{what} needs the processor's cluster subspace; this processor was "
                "loaded from a system dict, which carries none: build it from "
                "(cluster_subspace, supercell_matrix, ...)")

    # ---------------- host API ----------------

    @property
    def cluster_subspace(self):
        return self._subspace

    @property
    def structure(self):
        """The disordered supercell structure."""
        return self._structure

    @property
    def supercell_matrix(self) -> np.ndarray:
        return self._scmatrix

    @property
    def num_sites(self) -> int:
        return self._num_sites

    @property
    def num_energy_coefs(self) -> int:
        """The number of coefficients, one a feature."""
        return len(self.coefs)

    @property
    def num_features(self) -> int:
        """Length of the feature vector (the reference's abstract property,
        ``base.py:178-181``; each processor gives its own)."""
        raise NotImplementedError

    def compute_features(self, occupancies: torch.Tensor) -> torch.Tensor:
        """Feature vectors [W, F] f64 of occupancies [W, N], on the device."""
        raise NotImplementedError

    def _feature_change(self, occupancy: torch.Tensor, site: torch.Tensor,
                        code: torch.Tensor) -> torch.Tensor:
        """Feature changes [1, F] of one flip of one occupancy [1, N] (``site``
        and ``code`` [1]) on the device, before any scaling the processor
        applies to a flip list's sum."""
        raise NotImplementedError

    def _change_scale(self) -> float:
        """The factor a summed flip list's change is scaled by (the
        supercell size for the intensive device deltas)."""
        return 1.0

    def prepare_deltas(self):
        """Build the tables of :meth:`delta_features` and
        :meth:`delta_energy` now (at their first call otherwise), so that
        the first step of a chain copies nothing to the device."""

    def delta_features(self, occupancies: torch.Tensor, sites: torch.Tensor,
                       codes: torch.Tensor) -> torch.Tensor:
        """Feature changes [W, F] f64 of one flip a walker: ``sites`` [W] of
        occupancies [W, N] take ``codes`` [W], on the device (the
        reference's ``delta_features_fn``)."""
        return self._feature_change(occupancies, sites, codes) * self._change_scale()

    def delta_energy(self, occupancies: torch.Tensor, sites: torch.Tensor,
                     codes: torch.Tensor) -> torch.Tensor:
        """Energy changes [W] f64 of one flip a walker, on the device (the
        reference's ``delta_energy_fn``)."""
        raise NotImplementedError

    def compute_feature_vector(self, occupancy) -> np.ndarray:
        """Extensive feature vector of an encoded occupancy [N], as host f64."""
        occu = torch.as_tensor(np.asarray(occupancy, dtype=np.int64), device=self.device)
        return self.compute_features(occu[None, :])[0].cpu().numpy()

    def compute_feature_vector_change(self, occupancy, flips) -> np.ndarray:
        """Feature-vector change from a list of (site, new_code) flips,
        applied in order on a copy (the reference's ``expansion.py:229-240``)."""
        occu = torch.as_tensor(np.asarray(occupancy, dtype=np.int64),
                               device=self.device)[None, :].clone()
        delta = np.zeros(self.num_energy_coefs)  # an empty step changes nothing
        for site, code in flips:
            site_code = torch.tensor([[int(site)], [int(code)]], device=self.device)
            delta = delta + self._feature_change(occu, *site_code)[0].cpu().numpy()
            occu[0, int(site)] = int(code)
        return delta * self._change_scale()

    def compute_feature_vector_distance_change(self, feature_vector, occupancy, flips):
        """Change in |f - feature_vector| from a flip list: only the distance
        processors compute it (the reference's ``base.py:143-165``)."""
        raise NotImplementedError(
            "This processor can not be used to compute feature vector distances."
        )

    def compute_property(self, occupancy) -> float:
        return float(np.dot(self.coefs, self.compute_feature_vector(occupancy)))

    def compute_property_change(self, occupancy, flips) -> float:
        return float(
            np.dot(self.coefs, self.compute_feature_vector_change(occupancy, flips))
        )

    def occupancy_from_structure(self, structure) -> np.ndarray:
        """The encoded occupancy of an ordered structure on this supercell."""
        self._require_subspace("occupancy_from_structure")
        occu = self._subspace.occupancy_from_structure(
            structure, scmatrix=self._scmatrix
        )
        return self.encode_occupancy(occu)

    def structure_from_occupancy(self, occupancy):
        """The ordered structure of an encoded occupancy (vacancies left out)."""
        self._require_subspace("structure_from_occupancy")
        occupancy = self.decode_occupancy(occupancy)
        sites = [
            PeriodicSite(spec, site.frac_coords, self._structure.lattice)
            for spec, site in zip(occupancy, self._structure)
            if not isinstance(spec, Vacancy)
        ]
        return Structure.from_sites(sites)

    def encode_occupancy(self, occupancy) -> np.ndarray:
        self._require_subspace("encode_occupancy")
        return np.array(
            [
                species.index(spec)
                for species, spec in zip(self.allowed_species, occupancy)
            ],
            dtype=np.int32,
        )

    def decode_occupancy(self, encoded_occupancy) -> list:
        self._require_subspace("decode_occupancy")
        return [
            species[i] for i, species in zip(encoded_occupancy, self.allowed_species)
        ]

    def get_sublattices(self):
        """Default sublattices: groups of sites with identical site spaces,
        built anew each call (a loaded processor's: copies of its system's)."""
        if self._subspace is None:
            return copy.deepcopy(self._sublattices)
        return sublattices_from_site_spaces(self.unique_site_spaces, self.allowed_species)

    def compute_average_drift(self, iterations: int = 1000):
        """Average difference between delta updates and full recomputation,
        forward and reverse (the reference's ``base.py:270-312``); about
        machine epsilon."""
        self._require_subspace("compute_average_drift")
        rng = np.random.default_rng()
        forward_drift = 0.0
        trajectory = []
        occu = self.encode_occupancy(
            [rng.choice(species) for species in self.allowed_species]
        )
        for _ in range(iterations):
            site = rng.integers(self.num_sites)
            options = list(set(range(len(self.allowed_species[site]))) - {occu[site]})
            if not options:
                continue
            species = rng.choice(options)
            delta_prop = self.compute_property_change(occu, [(site, species)])
            new_occu = occu.copy()
            new_occu[site] = species
            prop = self.compute_property(occu)
            new_prop = self.compute_property(new_occu)
            forward_drift += (new_prop - prop) - delta_prop
            trajectory.append((prop - new_prop, new_occu, [(site, occu[site])]))
            occu = new_occu
        forward_drift /= iterations
        reverse_drift = (
            sum(dp - self.compute_property_change(o, f) for dp, o, f in trajectory)
            / iterations
        )
        return forward_drift, reverse_drift

    def __len__(self):
        return self.num_sites

    def as_dict(self) -> dict:
        self._require_subspace("as_dict")
        return {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
            "cluster_subspace": self._subspace.as_dict(),
            "supercell_matrix": self._scmatrix.tolist(),
            "coefficients": self.coefs.tolist(),
        }

    @classmethod
    def from_dict(cls, d, device="cuda"):
        """The processor of an ``as_dict`` record (the port's or the
        reference's), by its ``@class``, on ``device``."""
        try:
            subclass = get_subclasses(Processor)[d["@class"]]
        except KeyError as err:
            raise NameError(f"{d['@class']} is not a Processor subclass.") from err
        return subclass.from_dict(d, device=device)
