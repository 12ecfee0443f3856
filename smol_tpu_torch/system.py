"""A cluster-expansion system as data: built by the port, or carried over.

A system is built on the host (crystal symmetry, cluster subspace,
supercell packing, coefficient folding, the Ewald matrix).
:func:`build_system` builds one from the port's own ``ClusterExpansion``;
:func:`export_system` reads a built ``smol_tpu`` ensemble.  Both return the same plain numpy arrays, through the same
helpers, which :func:`save_system` writes to a compressed ``.npz`` file and
:func:`load_system` reads back.  These arrays are the port's "weights":
the port loads them and runs on the card.

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
- for the reference's ``ClusterDecompositionProcessor`` (the default
  processor of ``Ensemble.from_cluster_expansion``): ``processor_type``
  0-d str ``"decomposition"`` (a file without the key holds an
  expansion), ``inter_flat`` f64 (every orbit's interaction tensor),
  ``offset`` 0-d f64 (the empty cluster's interaction), ``orbit_offset``
  [orbits] int32, ``cluster_orbit`` [C] int32 and ``orbit_cluster_count``
  [orbits] f64; ``num_energy_coefs`` is then the orbit count and
  ``natural_parameters`` starts with the decomposition's coefficients;
- for a cluster expansion or decomposition with an Ewald term (the
  reference's ``CompositeProcessor`` of a cluster-expansion or
  cluster-decomposition processor and an ``EwaldProcessor``):
  ``ewald_matrix`` [n_ew, n_ew] f64, ``ewald_inds`` [N, max codes] int32
  (the Ewald row of each (site, code), -1 for a vacancy) and
  ``ewald_coef`` 0-d f64.  ``num_energy_coefs`` and
  ``natural_parameters`` then hold the expansion's (or decomposition's)
  coefficients followed by the Ewald coefficient;
- for table flips (``export_system(ensemble, usher=...)`` with the
  reference's ``TableFlip`` usher, or ``build_system(...,
  table_flip=True)`` with the port's): ``flip_table`` [F, D] int64, the flip
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
    "build_system",
    "export_system",
    "export_distance_system",
    "build_distance_system",
    "pad_local_tables",
    "expansion_fields",
    "decomposition_fields",
    "ewald_summation",
    "ewald_fields",
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
    evaluates (``from_cluster_expansion(..., processor_type="expansion")``),
    or a cluster-decomposition processor (``from_cluster_expansion``'s
    default), whose features the port's
    :class:`~smol_tpu_torch.moca.processor.expansion.ClusterDecompositionProcessor`
    evaluates, either alone or in a composite followed by an Ewald
    processor.  With ``usher``, a ``TableFlip`` usher of the ensemble's
    sublattices, the system also carries its flip table, its dimension ids
    and the site charges (see the module docstring).
    """
    processor = ensemble.processor
    parts = getattr(processor, "processors", [processor])
    names = [type(p).__name__ for p in parts]
    if names[0] not in ("ClusterExpansionProcessor", "ClusterDecompositionProcessor") \
            or names[1:] not in ([], ["EwaldProcessor"]):
        raise ValueError(
            "export_system needs a ClusterExpansionProcessor or a "
            "ClusterDecompositionProcessor, alone or followed by an "
            f"EwaldProcessor in a composite; got {type(processor).__name__} of {names}"
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
    if names[0] == "ClusterDecompositionProcessor":
        system.update(_decomposition_fields(
            packed, processor._inter_flat, processor._offset))
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
        system.update(_usher_fields(usher, ensemble.processor.allowed_species))
    return system


def _usher_fields(usher, allowed_species) -> dict:
    """The fields of a ``TableFlip`` usher: its flip table, its dimension
    ids and the site charges."""
    dim_ids, dim_ids_offsets = _ragged(usher.dim_ids, np.int64)
    return {
        "flip_table": np.asarray(usher.flip_table, dtype=np.int64),
        "usher_dim_ids": dim_ids,
        "usher_dim_ids_offsets": dim_ids_offsets,
        "site_charges": site_charges(allowed_species),
    }


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


def _decomposition_fields(packed, inter_flat, offset) -> dict:
    """The fields of a cluster-decomposition processor."""
    return {
        "processor_type": np.str_("decomposition"),
        "inter_flat": np.asarray(inter_flat, dtype=np.float64),
        "offset": np.float64(offset),
        "orbit_offset": np.asarray(packed.orbit_offset, dtype=np.int32),
        "cluster_orbit": np.asarray(packed.cluster_orbit, dtype=np.int32),
        "orbit_cluster_count": np.asarray(packed.orbit_cluster_count,
                                          dtype=np.float64),
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


def energy_fields(subspace, supercell_matrix, energy_tensors) -> tuple[dict, object]:
    """(fields, packed supercell) of a processor's coefficient-folded energy
    tensors on a supercell: the packed fields and the per-site local arrays
    (``local_sites``, ``local_strides``, ``local_d2``, ``local_g``) of the
    reference's ``_energy_tables`` (``moca/processor/expansion.py:118-128``),
    with the same arithmetic."""
    from smol_tpu_torch.ops.packing import pack_interactions, pack_supercell

    packed = pack_supercell(subspace, np.array(supercell_matrix, dtype=np.int64))
    energy_flat, _ = pack_interactions(subspace, energy_tensors)
    energy_weights = packed.size / np.maximum(packed.orbit_cluster_count, 1)
    energy_weights[0] = 0.0
    sites, strides, d2, g, _ = local_arrays(packed, energy_flat, energy_weights)
    return {
        **_packed_fields(packed, packed.size),
        "local_sites": sites,
        "local_strides": strides,
        "local_d2": d2,
        "local_g": g,
    }, packed


def expansion_fields(subspace, supercell_matrix, coefficients) -> dict:
    """The fields of a cluster-expansion processor (``coefficients``, one a
    correlation function) on a supercell: its energy tensors are, per orbit,
    the coefficients times the correlation tensors (the reference's
    ``expansion.py:207-216``)."""
    coefs = np.atleast_1d(np.asarray(coefficients, dtype=np.float64))
    energy = [np.float64(coefs[0])] + [
        sum(coefs[o.bit_id + k] * o.correlation_tensors[k] for k in range(len(o)))
        for o in subspace.orbits]
    return energy_fields(subspace, supercell_matrix, energy)[0]


def decomposition_fields(subspace, supercell_matrix, interaction_tensors,
                         coefficients) -> dict:
    """The fields of a cluster-decomposition processor (``coefficients``, one
    an orbit) on a supercell: its energy tensors are, per orbit, the
    coefficient times the interaction tensor (the reference's
    ``expansion.py:285-292``), and the interaction keys of the module
    docstring."""
    from smol_tpu_torch.ops.packing import pack_interactions

    coefs = np.atleast_1d(np.asarray(coefficients, dtype=np.float64))
    tensors = tuple(np.asarray(t, dtype=np.float64) for t in interaction_tensors)
    inter_flat, offset = pack_interactions(subspace, tensors)
    energy = [np.float64(coefs[0] * offset)] + [
        coefs[o.id] * t for o, t in zip(subspace.orbits, tensors[1:])]
    fields, packed = energy_fields(subspace, supercell_matrix, energy)
    return {**fields, **_decomposition_fields(packed, inter_flat, offset)}


def ewald_summation(ewald_term, supercell):
    """(the ``EwaldSummation`` of a supercell's Ewald structure, its
    ``ewald_inds``), as the reference's ``EwaldProcessor`` builds them
    (``moca/processor/ewald.py:52-70``)."""
    from smol_tpu_torch.crystal.ewald import EwaldSummation

    structure, inds = ewald_term.get_ewald_structure(supercell)
    summation = EwaldSummation(
        structure, real_space_cut=ewald_term.real_space_cut,
        recip_space_cut=ewald_term.recip_space_cut, eta=ewald_term.eta)
    return summation, inds


def ewald_fields(ewald_term, summation, ewald_inds, coefficient) -> dict:
    """The Ewald keys of the module docstring."""
    return {
        "ewald_matrix": np.ascontiguousarray(ewald_term.get_ewald_matrix(summation),
                                             dtype=np.float64),
        "ewald_inds": np.ascontiguousarray(ewald_inds, dtype=np.int32),
        "ewald_coef": np.float64(np.atleast_1d(coefficient)[0]),
    }


def build_system(cluster_expansion, supercell_matrix, processor_type="decomposition",
                 chemical_potentials=None, use_concentration=False,
                 table_flip=False) -> dict:
    """The system dict of a cluster expansion on a supercell.

    Builds what ``smol_tpu``'s ``Ensemble.from_cluster_expansion`` builds
    (``smol_tpu/moca/ensemble.py:104-161``; the processors' host
    construction, ``moca/processor/expansion.py:99-303`` and
    ``moca/processor/ewald.py:40-80``, and their default sublattices,
    ``moca/processor/base.py:30-52, 127-140``) and returns the keys that
    :func:`export_system` writes for such an ensemble: the fields of the
    processors that
    :func:`smol_tpu_torch.moca.ensemble.cluster_expansion_processor`
    builds on the CPU (:func:`expansion_fields`,
    :func:`decomposition_fields`, :func:`ewald_fields`) and their
    sublattices.  ``processor_type`` is ``"decomposition"``
    (natural parameters the orbit multiplicities) or ``"expansion"`` (the
    coefficients); an ``EwaldTerm`` of the subspace adds the Ewald keys,
    and the expansion's last coefficient to the natural parameters, as the
    reference's composite processor; ``chemical_potentials``, a dict of
    species (or names) to values, makes the system semigrand.
    ``table_flip=True`` adds the keys of a
    :class:`~smol_tpu_torch.moca.kernel.tableflip.TableFlip` usher with
    its defaults: the flip table it derives, its dimension ids and the
    site charges.
    """
    from smol_tpu_torch.moca.ensemble import (
        chemical_potential_table,
        cluster_expansion_processor,
    )
    from smol_tpu_torch.moca.kernel.tableflip import TableFlip

    processor = cluster_expansion_processor(cluster_expansion, supercell_matrix,
                                            processor_type, use_concentration, device="cpu")
    fields = {}
    for part in getattr(processor, "processors", [processor]):
        fields.update(part.fields)
    sublattices = processor.get_sublattices()
    params = processor.coefs
    fields["num_energy_coefs"] = np.int64(len(params))
    if chemical_potentials is not None:
        fields["chemical_potential_table"] = chemical_potential_table(
            sublattices, processor.num_sites, chemical_potentials)
        params = np.append(params, -1.0)
    if table_flip:
        fields.update(_usher_fields(TableFlip(sublattices), processor.allowed_species))
    return {**fields, **_sublattice_fields(sublattices),
            "natural_parameters": np.asarray(params, dtype=np.float64)}


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
    return _distance_fields(
        processor.packed, processor.size, processor.get_sublattices(),
        processor._diameter_groups, processor.target_vector, processor.coefs,
        processor.match_tol, processor.supercell_matrix)


def build_distance_system(subspace, supercell_matrix, target_vector, match_weight,
                          match_tol, target_weights, use_concentration=False) -> dict:
    """The distance system of one supercell shape, built from the port's own
    subspace: the keys :func:`export_distance_system` writes for the
    reference's ``CorrelationDistanceProcessor(subspace, supercell_matrix,
    use_concentration, target_vector, match_weight, target_weights,
    match_tol)`` (``smol_tpu/moca/processor/distance.py:70-92, 233-255``),
    before any re-padding of its local tables (:func:`pad_local_tables`)."""
    from smol_tpu_torch.cofe.space.domain import get_allowed_species, get_site_spaces
    from smol_tpu_torch.moca.sublattice import sublattices_from_site_spaces
    from smol_tpu_torch.ops.packing import pack_supercell

    if len(subspace.external_terms) > 0:
        raise ValueError("The cluster subspace cannot have external terms.")
    if match_weight < 0:
        raise ValueError("The match weight must be a positive number.")
    if len(target_weights) != len(target_vector) - 1:
        raise ValueError("target_weights must have length len(target_vector) - 1.")
    scmatrix = np.array(supercell_matrix, dtype=np.int64)
    packed = pack_supercell(subspace, scmatrix)
    supercell = subspace.structure.copy().make_supercell(scmatrix)
    spaces = tuple(sorted(set(get_site_spaces(supercell, include_measure=use_concentration))))
    sublattices = sublattices_from_site_spaces(spaces, get_allowed_species(supercell))
    groups = [(float(diameter), [i for orbit in orbits
                                 for i in range(orbit.bit_id, orbit.bit_id + len(orbit))])
              for diameter, orbits in subspace.orbits_by_diameter.items()]
    coefs = np.concatenate([[-match_weight], target_weights])
    return _distance_fields(packed, subspace.num_prims_from_matrix(scmatrix), sublattices,
                            groups, target_vector, coefs, match_tol, scmatrix)


def _distance_fields(packed, size, sublattices, groups, target_vector, coefs, match_tol,
                     supercell_matrix) -> dict:
    sites, strides, d2, _, _ = local_arrays(
        packed, np.zeros(len(packed.corr_flat)), np.zeros(len(packed.orbit_tensor_size))
    )
    lc = np.asarray(packed.local_clusters)
    orbit = np.asarray(packed.cluster_orbit)[np.where(lc >= 0, lc, 0)]
    features, feature_off = _ragged([indices for _, indices in groups], np.int64)
    composition, _ = _ragged(
        [[sl.site_space[sp] for sp in sl.species] for sl in sublattices], np.float64
    )
    return {
        **_packed_fields(packed, size),
        "local_sites": sites,
        "local_strides": strides,
        "local_d2": d2,
        "local_orbit": np.where(lc >= 0, orbit, -1).astype(np.int32),
        "orbit_bit_id": np.asarray(packed.orbit_bit_id, dtype=np.int32),
        "orbit_num_combos": np.asarray(packed.orbit_num_combos, dtype=np.int32),
        "orbit_tensor_size": np.asarray(packed.orbit_tensor_size, dtype=np.int32),
        **_sublattice_fields(sublattices),
        "sublattice_composition": composition,
        "target_vector": np.asarray(target_vector, dtype=np.float64),
        "distance_coefs": np.asarray(coefs, dtype=np.float64),
        "match_tol": np.float64(match_tol),
        "diameter_group_features": features,
        "diameter_group_features_offsets": feature_off,
        "diameter_group_diameters": np.array([d for d, _ in groups], dtype=np.float64),
        "supercell_matrix": np.asarray(supercell_matrix, dtype=np.int64),
    }


def pad_local_tables(system: dict, width: int) -> dict:
    """A distance system with its local tables padded to ``width`` local
    clusters a site, as the reference's ``repad_local_tables`` pads the
    shapes of one search to their widest (``capp/generate/special/sqs.py:
    142-147``): each added cluster is padding (sites, strides and d2 0,
    orbit -1)."""
    extra = int(width) - system["local_orbit"].shape[1]
    if extra <= 0:
        return system
    padded = dict(system)
    for key in ("local_sites", "local_strides", "local_d2"):
        pad = [(0, 0)] * system[key].ndim
        pad[1] = (0, extra)
        padded[key] = np.pad(system[key], pad)
    padded["local_orbit"] = np.pad(system["local_orbit"], [(0, 0), (0, extra)],
                                   constant_values=-1)
    return padded


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
