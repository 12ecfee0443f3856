"""ClusterExpansion: a fitted cluster expansion (subspace + coefficients).

Counterpart of ``smol_tpu/cofe/expansion.py``, whose code it copies,
evaluating through the port's packed correlations. In this module "the
reference" is smol (CederGroupHub/smol).

Mirrors the reference (smol/cofe/expansion.py): coefficients are the raw fit
coefficients over correlation functions (+ external terms); ECI divide out
total multiplicities; cluster interaction tensors recombine ECI into one
tensor per orbit — the basis of the decomposition processor and the MC
energy tables.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import torch

from smol_tpu_torch.cofe.space.clusterspace import ClusterSubspace
from smol_tpu_torch.ops import correlations as corr_ops
from smol_tpu_torch.ops.packing import pack_interactions, pack_supercell
from smol_tpu_torch.serial import MSONable, jsanitize, process_decoded
from smol_tpu_torch.system import _decomposition_fields, _packed_fields

__all__ = ["ClusterExpansion", "RegressionData"]


@dataclass
class RegressionData(MSONable):
    """Records the regression model/inputs used for a fit (provenance)."""

    module: str = None
    estimator_name: str = None
    feature_matrix: np.ndarray = None
    property_vector: np.ndarray = None
    parameters: dict = None

    @classmethod
    def from_sklearn(cls, estimator, feature_matrix, property_vector):
        """Create from an sklearn-style estimator instance."""
        return cls(
            module=type(estimator).__module__,
            estimator_name=type(estimator).__name__,
            feature_matrix=np.asarray(feature_matrix),
            property_vector=np.asarray(property_vector),
            parameters=getattr(estimator, "get_params", dict)(),
        )

    @classmethod
    def from_object(cls, estimator, feature_matrix, property_vector, parameters=None):
        """Create from any estimator class, instance, or function.

        Like from_sklearn but for arbitrary fitting objects; parameters are
        passed explicitly (reference expansion.py:43-72).
        """
        estimator_name = getattr(estimator, "__name__", type(estimator).__name__)
        return cls(
            module=estimator.__module__,
            estimator_name=estimator_name,
            feature_matrix=np.asarray(feature_matrix),
            property_vector=np.asarray(property_vector),
            parameters=parameters,
        )

    def as_dict(self) -> dict:
        return {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
            "module": self.module,
            "estimator_name": self.estimator_name,
            "feature_matrix": jsanitize(self.feature_matrix),
            "property_vector": jsanitize(self.property_vector),
            "parameters": jsanitize(self.parameters),
        }

    @classmethod
    def from_dict(cls, d):
        return cls(
            module=d["module"],
            estimator_name=d["estimator_name"],
            feature_matrix=(
                None if d["feature_matrix"] is None else np.array(d["feature_matrix"])
            ),
            property_vector=(
                None if d["property_vector"] is None else np.array(d["property_vector"])
            ),
            parameters=d["parameters"],
        )


class ClusterExpansion(MSONable):
    """A fitted cluster expansion."""

    def __init__(self, cluster_subspace, coefficients, regression_data=None):
        """Initialize a ClusterExpansion.

        Args:
            cluster_subspace: the ClusterSubspace the fit was done over.
            coefficients: fit coefficients, length = len(cluster_subspace)
                (correlation functions + external terms).
            regression_data: optional RegressionData provenance.
        """
        coefficients = np.asarray(coefficients, dtype=np.float64)
        if regression_data is not None and regression_data.feature_matrix is not None:
            if regression_data.feature_matrix.shape[1] != len(coefficients):
                raise AttributeError(
                    "Feature matrix shape does not match number of coefficients."
                )
        if len(coefficients) != len(cluster_subspace):
            raise AttributeError(
                f"Subspace size {len(cluster_subspace)} does not match "
                f"number of coefficients {len(coefficients)}."
            )
        self.coefs = coefficients
        self.regression_data = regression_data
        self._subspace = cluster_subspace
        self._eci = None
        self._interaction_tensors = None

    @property
    def cluster_subspace(self) -> ClusterSubspace:
        return self._subspace

    @property
    def structure(self):
        return self._subspace.structure

    @property
    def expansion_structure(self):
        return self._subspace.expansion_structure

    @property
    def eci(self) -> np.ndarray:
        """Effective cluster interactions: coefs / total multiplicities."""
        if self._eci is None:
            n_ext = len(self._subspace.external_terms)
            coefs = self.coefs[:-n_ext] if n_ext else self.coefs
            self._eci = coefs / self._subspace.function_total_multiplicities
        return self._eci

    @property
    def eci_orbit_ids(self) -> np.ndarray:
        return self._subspace.function_orbit_ids

    @property
    def cluster_interaction_tensors(self) -> tuple:
        """Per-orbit interaction tensors: sum of multiplicity*eci*corr tensor.

        Entry 0 is the scalar empty-orbit coefficient
        (reference expansion.py:185-201).
        """
        if self._interaction_tensors is None:
            self._interaction_tensors = (np.float64(self.coefs[0]),) + tuple(
                sum(
                    m * self.eci[orbit.bit_id + i] * tensor
                    for i, (m, tensor) in enumerate(
                        zip(orbit.bit_combo_multiplicities, orbit.correlation_tensors)
                    )
                )
                for orbit in self._subspace.orbits
            )
        return self._interaction_tensors

    @property
    def effective_cluster_weights(self) -> np.ndarray:
        """Ordering-multiplicity-weighted sums of squared ECI per orbit."""
        fom = self._subspace.function_ordering_multiplicities
        foi = self._subspace.function_orbit_ids
        return np.array(
            [
                np.sum(fom[foi == i] * self.eci[self.eci_orbit_ids == i] ** 2)
                for i in range(len(self._subspace.orbits) + 1)
            ]
        )

    @property
    def feature_matrix(self):
        if self.regression_data is None:
            return None
        return self.regression_data.feature_matrix

    def predict(self, structure, normalized=False, scmatrix=None, site_mapping=None):
        """Predict the property of a structure from its correlations."""
        corrs = self._subspace.corr_from_structure(
            structure, normalized=normalized, scmatrix=scmatrix,
            site_mapping=site_mapping,
        )
        return float(np.dot(corrs, self.coefs))

    def cluster_interactions_from_structure(
        self, structure, normalized=True, scmatrix=None, site_mapping=None
    ) -> np.ndarray:
        """Per-orbit cluster-interaction values for a structure.

        A cluster interaction sums all expansion terms over one orbit
        (reference expansion.py:290; evaluator.pyx:170).  Entry 0 is the
        empty-orbit coefficient.  Evaluated through the port's packed
        cluster interactions on the CPU.
        """
        cs = self._subspace
        if scmatrix is None:
            scmatrix = cs.scmatrix_from_structure(structure)
        occu = cs.occupancy_from_structure(
            structure, scmatrix=scmatrix, site_mapping=site_mapping,
            encode=True,
        )
        packed = pack_supercell(cs, scmatrix)
        fields = {**_packed_fields(packed, packed.size),
                  **_decomposition_fields(packed, *pack_interactions(
                      cs, self.cluster_interaction_tensors))}
        occu = torch.as_tensor(np.asarray(occu, dtype=np.int64))[None]
        interactions = corr_ops.interactions_from_occupancy(
            occu, corr_ops.to_device(fields, "cpu"),
            corr_ops.interactions_to_device(fields, "cpu"))[0].numpy()
        if not normalized:
            interactions = interactions * cs.num_prims_from_matrix(scmatrix)
        return interactions

    def prune(self, threshold=0.0, with_multiplicity=False):
        """Remove correlation functions with |coefficient| <= threshold."""
        coefs = self.eci if with_multiplicity else self.coefs
        bit_ids = [i for i, coef in enumerate(coefs) if abs(coef) < threshold]
        self._subspace.remove_corr_functions(bit_ids)
        # keep the dropped-column-adjusted coefficients (and external terms)
        self.coefs = np.array(
            [c for i, c in enumerate(self.coefs) if i not in bit_ids]
        )
        if self.regression_data is not None and self.feature_matrix is not None:
            self.regression_data.feature_matrix = np.delete(
                self.regression_data.feature_matrix, bit_ids, axis=1
            )
        self._eci = None
        self._interaction_tensors = None

    def copy(self):
        return ClusterExpansion.from_dict(self.as_dict())

    def __len__(self):
        return len(self.coefs)

    def __repr__(self):
        return (
            f"ClusterExpansion({self._subspace!r}, "
            f"n_coefs={len(self.coefs)})"
        )

    def as_dict(self) -> dict:
        return {
            "@module": type(self).__module__,
            "@class": type(self).__name__,
            "cluster_subspace": self._subspace.as_dict(),
            "coefs": self.coefs.tolist(),
            "regression_data": (
                None if self.regression_data is None else self.regression_data.as_dict()
            ),
        }

    @classmethod
    def from_dict(cls, d):
        return cls(
            process_decoded(d["cluster_subspace"]),
            np.array(d["coefs"]),
            regression_data=(
                None
                if d.get("regression_data") is None
                else process_decoded(d["regression_data"])
            ),
        )
