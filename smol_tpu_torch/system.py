"""A cluster-expansion system carried from smol_tpu into the port as data.

The JAX package builds a system on the host (crystal symmetry, cluster
subspace, supercell packing, coefficient folding); the port does not
repeat that work yet.  :func:`export_system` reads a built ``smol_tpu``
ensemble and returns plain numpy arrays, which :func:`save_system` writes
to a compressed ``.npz`` file and :func:`load_system` reads back.  These
arrays are the port's "weights": the port loads them and runs on the card.

The exporter is duck-typed: it reads attributes of the objects it is given
and imports neither ``smol_tpu`` nor ``jax``.

Keys of a system dict (N sites, C clusters of at most K sites, P
(function, cluster) pairs, L local clusters per site, TM largest tensor):

- ``num_sites``, ``size`` (prims in the supercell), ``num_corr``,
  ``num_energy_coefs``: 0-d int64;
- ``cluster_sites``, ``cluster_strides`` [C, K] int32; ``corr_flat`` f64;
  ``pair_fn``, ``pair_cluster``, ``pair_offset`` [P] int32;
  ``fn_cluster_count`` [num_corr] f64 — the packed supercell fields that
  ``smol_tpu.ops.correlations.to_device`` moves to the device;
- ``local_sites``, ``local_strides`` [N, L, K] int32, ``local_d2`` [N, L]
  int32, ``local_g`` [N, L, TM] f64 — the per-site local-cluster arrays of
  ``smol_tpu.ops.fastmc.site_local_arrays`` (coefficient-folded energy
  tables);
- ``sublattice_sites``, ``sublattice_active_sites``,
  ``sublattice_encoding`` with ``*_offsets`` [S + 1]: each sublattice's
  arrays concatenated in sublattice order;
- ``natural_parameters`` [F] f64 and, for a semigrand ensemble,
  ``chemical_potential_table`` [N, max code + 1] f64;
- for a cluster expansion with an Ewald term (the reference's
  ``CompositeProcessor`` of a cluster-expansion and an ``EwaldProcessor``):
  ``ewald_matrix`` [n_ew, n_ew] f64, ``ewald_inds`` [N, max codes] int32
  (the Ewald row of each (site, code), -1 for a vacancy) and
  ``ewald_coef`` 0-d f64.  ``num_energy_coefs`` and
  ``natural_parameters`` then hold the expansion's coefficients followed
  by the Ewald coefficient;
- for table flips (``export_system(ensemble, usher=...)`` with the
  reference's ``TableFlip`` usher): ``flip_table`` [F, D] int64, the flip
  vectors over the D (sublattice, species) dimensions of the composition
  space; ``usher_dim_ids`` with ``usher_dim_ids_offsets`` [S + 1], each
  sublattice's dimension ids (one per code, in code order) concatenated
  in sublattice order; and ``site_charges`` [N, max codes] f64, the
  oxidation state of each (site, code), 0 for a vacancy, a neutral
  species or a code the site does not take;
- optionally, added by the exporting script and not by
  :func:`export_system`: ``initial_occupancy`` [N] int32, a starting
  occupancy the system's user runs from; ``wl_min_enthalpy``,
  ``wl_max_enthalpy`` and ``wl_bin_size`` 0-d f64, a Wang-Landau window
  for the system and the width of its bins; ``exact_enthalpies`` f64,
  the enthalpy of every state of a system small enough to enumerate, in
  the order of ``itertools.product`` over the sites' codes.

A distance system (:func:`export_distance_system`, one supercell shape of
an SQS search) has the packed fields, the sublattices and the local
``local_sites``, ``local_strides``, ``local_d2`` above (no energy tables,
no natural parameters), and:

- ``local_orbit`` [N, L] int32, the orbit of each local cluster (-1 for
  padding); ``orbit_bit_id``, ``orbit_num_combos``,
  ``orbit_tensor_size`` [orbits] int32: each orbit's first correlation
  function, its function count and its tensor size;
- ``target_vector`` [num_corr] f64; ``distance_coefs`` [num_corr] f64,
  ``[-match_weight, *target_weights]``; ``match_tol`` 0-d f64;
- ``diameter_group_features`` with ``diameter_group_features_offsets``
  [G + 1] and ``diameter_group_diameters`` [G] f64: the feature ids of
  each diameter group, in the processor's (ascending) order;
- ``supercell_matrix`` [3, 3] int64;
- ``sublattice_composition`` (with the offsets of
  ``sublattice_encoding``): the fraction of each code on its sublattice.

:func:`save_systems` writes several such dicts into one file, each key
prefixed with its shape (``s00_``, ``s01_``, ...), and
:func:`load_systems` reads them back in order.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "export_system",
    "export_distance_system",
    "save_system",
    "load_system",
    "save_systems",
    "load_systems",
]


def local_arrays(packed, energy_flat, energy_weights):
    """Per-site local-cluster arrays of a packed supercell.

    Computes what ``smol_tpu.ops.fastmc.site_local_arrays`` computes, with
    the same element-wise arithmetic: ``(sites [N, L, K], strides
    [N, L, K], d2 [N, L], g [N, L, TM], tmax)``.  ``d2`` is the summed
    stride of the site's own slots in each local cluster, and ``g`` the
    coefficient-folded energy tensor of that cluster's orbit.
    """
    lc = np.asarray(packed.local_clusters)
    n = lc.shape[0]
    tsize = np.asarray(packed.orbit_tensor_size)
    tmax = int(tsize.max())
    valid = lc >= 0
    lc_safe = np.where(valid, lc, 0)
    sites = np.asarray(packed.cluster_sites)[lc_safe] * valid[:, :, None]
    strides = np.asarray(packed.cluster_strides)[lc_safe] * valid[:, :, None]
    orb = np.asarray(packed.cluster_orbit)[lc_safe]
    own = (sites == np.arange(n)[:, None, None]) & (strides > 0)
    d2 = np.where(own, strides, 0).sum(axis=2)
    flat = np.asarray(energy_flat, dtype=np.float64)
    t = np.arange(tmax)
    idx = np.asarray(packed.orbit_offset)[orb][:, :, None] + t
    in_tensor = (t < tsize[orb][:, :, None]) & valid[:, :, None]
    weights = np.asarray(energy_weights, dtype=np.float64)[orb][:, :, None]
    g = np.where(
        in_tensor, weights * flat[np.minimum(idx, len(flat) - 1)], 0.0
    )
    return (
        sites.astype(np.int32),
        strides.astype(np.int32),
        d2.astype(np.int32),
        g,
        tmax,
    )


def _ragged(arrays, dtype):
    flat = np.concatenate([np.asarray(a, dtype=dtype) for a in arrays])
    offsets = np.cumsum([0] + [len(a) for a in arrays]).astype(np.int64)
    return flat, offsets


def site_charges(allowed_species) -> np.ndarray:
    """[N, max codes] f64 oxidation state of each (site, code), else 0."""
    width = max(len(species) for species in allowed_species)
    charges = np.zeros((len(allowed_species), width), dtype=np.float64)
    for site, species in enumerate(allowed_species):
        for code, sp in enumerate(species):
            charges[site, code] = float(getattr(sp, "oxi_state", 0) or 0)
    return charges


def export_system(ensemble, usher=None) -> dict:
    """Numpy arrays of a ``smol_tpu`` semigrand or canonical ensemble.

    The ensemble's processor must be a cluster-expansion processor (its
    features are the extensive correlation vector), the form the port's
    :class:`~smol_tpu_torch.moca.processor.expansion.ClusterExpansionProcessor`
    evaluates, or a composite of one such and an Ewald processor (what
    ``from_cluster_expansion`` builds for a subspace with an Ewald term).
    Build it with ``Ensemble.from_cluster_expansion(...,
    processor_type="expansion")``.  With ``usher``, a ``TableFlip`` usher
    of the ensemble's sublattices, the system also carries its flip table,
    its dimension ids and the site charges (see the module docstring).
    """
    processor = ensemble.processor
    parts = getattr(processor, "processors", [processor])
    names = [type(p).__name__ for p in parts]
    if names not in (["ClusterExpansionProcessor"],
                     ["ClusterExpansionProcessor", "EwaldProcessor"]):
        raise ValueError(
            "export_system needs a ClusterExpansionProcessor, alone or "
            "followed by an EwaldProcessor in a composite (build the "
            "ensemble with processor_type='expansion'); got "
            f"{type(processor).__name__} of {names}"
        )
    ewald = parts[1] if len(parts) == 2 else None
    processor = parts[0]
    packed = processor.packed
    sites, strides, d2, g, _ = local_arrays(
        packed, processor._energy_flat, processor._energy_weights
    )
    system = {
        **_packed_fields(packed, processor.size),
        "num_energy_coefs": np.int64(len(ensemble.processor.coefs)),
        "local_sites": sites,
        "local_strides": strides,
        "local_d2": d2,
        "local_g": g,
        **_sublattice_fields(ensemble.sublattices),
        "natural_parameters": np.asarray(
            ensemble.natural_parameters, dtype=np.float64
        ),
    }
    mu_table = ensemble.chemical_potential_table
    if mu_table is not None:
        system["chemical_potential_table"] = np.asarray(
            mu_table, dtype=np.float64
        )
    if ewald is not None:
        system["ewald_matrix"] = np.asarray(ewald.ewald_matrix, dtype=np.float64)
        system["ewald_inds"] = np.asarray(ewald._ewald_inds, dtype=np.int32)
        system["ewald_coef"] = np.float64(np.atleast_1d(ewald.coefs)[0])
    if usher is not None:
        system["flip_table"] = np.asarray(usher.flip_table, dtype=np.int64)
        system["usher_dim_ids"], system["usher_dim_ids_offsets"] = _ragged(
            usher.dim_ids, np.int64
        )
        system["site_charges"] = site_charges(ensemble.processor.allowed_species)
    return system


def _packed_fields(packed, size) -> dict:
    """The packed-supercell fields that the correlation evaluation reads."""
    return {
        "num_sites": np.int64(packed.num_sites),
        "size": np.int64(size),
        "num_corr": np.int64(packed.num_corr),
        "cluster_sites": np.asarray(packed.cluster_sites, dtype=np.int32),
        "cluster_strides": np.asarray(packed.cluster_strides, dtype=np.int32),
        "corr_flat": np.asarray(packed.corr_flat, dtype=np.float64),
        "pair_fn": np.asarray(packed.pair_fn, dtype=np.int32),
        "pair_cluster": np.asarray(packed.pair_cluster, dtype=np.int32),
        "pair_offset": np.asarray(packed.pair_offset, dtype=np.int32),
        "fn_cluster_count": np.asarray(packed.fn_cluster_count, dtype=np.float64),
    }


def _sublattice_fields(subs) -> dict:
    sub_sites, sub_off = _ragged([s.sites for s in subs], np.int64)
    act_sites, act_off = _ragged([s.active_sites for s in subs], np.int64)
    enc, enc_off = _ragged([s.encoding for s in subs], np.int32)
    return {
        "sublattice_sites": sub_sites,
        "sublattice_sites_offsets": sub_off,
        "sublattice_active_sites": act_sites,
        "sublattice_active_sites_offsets": act_off,
        "sublattice_encoding": enc,
        "sublattice_encoding_offsets": enc_off,
    }


def export_distance_system(processor) -> dict:
    """Numpy arrays of a ``smol_tpu`` ``CorrelationDistanceProcessor``.

    One supercell shape of an SQS search, as the generator holds it (after
    its ``repad_local_tables``); see the module docstring for the keys.  A
    distance processor has no ensemble: the sublattices are its own
    (``processor.get_sublattices()``).
    """
    if type(processor).__name__ != "CorrelationDistanceProcessor":
        raise ValueError(
            "export_distance_system needs a CorrelationDistanceProcessor, got "
            f"{type(processor).__name__}"
        )
    packed = processor.packed
    sites, strides, d2, _, _ = local_arrays(
        packed, np.zeros(len(packed.corr_flat)), np.zeros(len(packed.orbit_tensor_size))
    )
    lc = np.asarray(packed.local_clusters)
    orbit = np.asarray(packed.cluster_orbit)[np.where(lc >= 0, lc, 0)]
    subs = processor.get_sublattices()
    groups = processor._diameter_groups
    features, feature_off = _ragged([indices for _, indices in groups], np.int64)
    composition, _ = _ragged(
        [[sl.site_space[sp] for sp in sl.species] for sl in subs], np.float64
    )
    return {
        **_packed_fields(packed, processor.size),
        "local_sites": sites,
        "local_strides": strides,
        "local_d2": d2,
        "local_orbit": np.where(lc >= 0, orbit, -1).astype(np.int32),
        "orbit_bit_id": np.asarray(packed.orbit_bit_id, dtype=np.int32),
        "orbit_num_combos": np.asarray(packed.orbit_num_combos, dtype=np.int32),
        "orbit_tensor_size": np.asarray(packed.orbit_tensor_size, dtype=np.int32),
        **_sublattice_fields(subs),
        "sublattice_composition": composition,
        "target_vector": np.asarray(processor.target_vector, dtype=np.float64),
        "distance_coefs": np.asarray(processor.coefs, dtype=np.float64),
        "match_tol": np.float64(processor.match_tol),
        "diameter_group_features": features,
        "diameter_group_features_offsets": feature_off,
        "diameter_group_diameters": np.array([d for d, _ in groups], dtype=np.float64),
        "supercell_matrix": np.asarray(processor.supercell_matrix, dtype=np.int64),
    }


def save_system(system: dict, path) -> None:
    """Write a system dict to a compressed ``.npz`` file."""
    np.savez_compressed(path, **system)


def load_system(path) -> dict:
    """Read a system dict written by :func:`save_system`."""
    with np.load(path, allow_pickle=False) as data:
        return {key: data[key] for key in data.files}


def _shape_prefix(i: int) -> str:
    return f"s{i:02d}_"


def save_systems(systems, path) -> None:
    """Write several system dicts (the shapes of one search) to one file."""
    merged = {"num_shapes": np.int64(len(systems))}
    for i, system in enumerate(systems):
        merged.update({_shape_prefix(i) + key: value for key, value in system.items()})
    np.savez_compressed(path, **merged)


def load_systems(path) -> list[dict]:
    """Read the system dicts written by :func:`save_systems`, in order (or
    the one of a file written by :func:`save_system`)."""
    merged = load_system(path)
    if "num_shapes" not in merged:
        return [merged]
    systems = []
    for i in range(int(merged["num_shapes"])):
        prefix = _shape_prefix(i)
        systems.append({key[len(prefix):]: value for key, value in merged.items()
                        if key.startswith(prefix)})
    return systems
