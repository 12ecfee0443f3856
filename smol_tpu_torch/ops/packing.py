"""Pack a (ClusterSubspace, supercell) pair into fixed-shape device arrays.

Counterpart of ``smol_tpu/ops/packing.py``, whose code it copies. In this
module "the reference" is smol (CederGroupHub/smol).

This is the TPU-native replacement for the reference's C-struct orbit
containers (smol/utils/cluster/container.pyx, struct.pxd): instead of
malloc'ed arrays of pointers, all orbits' cluster data is concatenated into
dense padded arrays that XLA/Pallas kernels consume directly.

Layout (C = total clusters in the supercell, K = max cluster size,
P = total (function, cluster) pairs, F = num correlation functions,
O = num orbits including the empty orbit):

- ``cluster_sites   [C, K] int32``: supercell site indices of each cluster,
  padded columns point at site 0 with stride 0 so they contribute nothing.
- ``cluster_strides [C, K] int32``: per-orbit C-order strides such that the
  flattened tensor index of a cluster is ``sum_k strides*occu[sites]``
  (mirrors Orbit.flat_tensor_indices, reference orbit.py:269).
- ``cluster_orbit   [C] int32``: 1-based orbit id per cluster.
- ``orbit_offset    [O] int32``: offset of each orbit's flat interaction
  tensor in a concatenated buffer (orbit 0 = empty -> size-1 slot).
- ``orbit_cluster_count [O] f64``: clusters per orbit in this supercell.
- ``corr_flat [sum_f tensor_size(orbit_f)] f64`` + ``pair_*`` arrays: one
  entry per (correlation function, cluster) pair for the full correlation
  evaluation as a gather + segment-sum.
- ``local_clusters [n_sites, L] int32`` / ``local_pairs [n_sites, LP] int32``:
  per-site cluster/pair id lists (padded -1) for O(local) delta updates —
  the analog of the reference's per-site LocalEvalData
  (smol/moca/processor/expansion.py:24-156).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class PackedSupercell:
    """Dense device-ready orbit data for one supercell of a subspace."""

    num_corr: int
    num_orbits: int
    num_sites: int
    size: int  # number of prims
    max_cluster_size: int

    cluster_sites: np.ndarray  # [C, K] int32
    cluster_strides: np.ndarray  # [C, K] int32
    cluster_orbit: np.ndarray  # [C] int32
    orbit_offset: np.ndarray  # [O] int32 (interaction tensor offsets)
    orbit_tensor_size: np.ndarray  # [O] int32
    orbit_cluster_count: np.ndarray  # [O] f64
    orbit_bit_id: np.ndarray  # [O] int32 (first function id; 0 for empty)
    orbit_num_combos: np.ndarray  # [O] int32

    corr_flat: np.ndarray  # [sum tensor sizes per function] f64
    pair_fn: np.ndarray  # [P] int32 function id per (fn, cluster) pair
    pair_cluster: np.ndarray  # [P] int32
    pair_offset: np.ndarray  # [P] int32 offset into corr_flat
    fn_cluster_count: np.ndarray  # [F] f64 (1 for the empty function)
    fn_orbit: np.ndarray  # [F] int32 orbit of each function

    local_clusters: np.ndarray  # [n_sites, L] int32, padded -1
    local_pairs: np.ndarray  # [n_sites, LP] int32, padded -1

    # total interaction buffer length (sum of orbit tensor sizes + 1)
    interaction_len: int = field(default=0)


def pack_supercell(subspace, scmatrix) -> PackedSupercell:
    """Build the packed representation for a subspace on a supercell."""
    scmatrix = np.asarray(scmatrix, dtype=np.int64)
    orbits = subspace.orbits
    indices = subspace.get_orbit_indices(scmatrix).arrays
    num_corr = subspace.num_corr_functions
    num_orbits = subspace.num_orbits
    size = subspace.num_prims_from_matrix(scmatrix)
    num_sites = len(subspace.structure) * size

    max_k = max((len(o.base_cluster) for o in orbits), default=1)

    # ---- cluster tables ----
    cl_sites, cl_strides, cl_orbit = [], [], []
    orbit_tensor_size = np.zeros(num_orbits, dtype=np.int32)
    orbit_cluster_count = np.zeros(num_orbits, dtype=np.float64)
    orbit_bit_id = np.zeros(num_orbits, dtype=np.int32)
    orbit_num_combos = np.zeros(num_orbits, dtype=np.int32)
    orbit_tensor_size[0] = 1
    orbit_cluster_count[0] = 1.0
    for orbit, inds in zip(orbits, indices):
        strides = orbit.flat_tensor_indices  # [k]
        k = inds.shape[1]
        pad = max_k - k
        s = np.pad(inds, ((0, 0), (0, pad)))
        st = np.pad(np.broadcast_to(strides, (len(inds), k)), ((0, 0), (0, pad)))
        cl_sites.append(s)
        cl_strides.append(st)
        cl_orbit.append(np.full(len(inds), orbit.id, dtype=np.int32))
        orbit_tensor_size[orbit.id] = orbit.flat_correlation_tensors.shape[1]
        orbit_cluster_count[orbit.id] = len(inds)
        orbit_bit_id[orbit.id] = orbit.bit_id
        orbit_num_combos[orbit.id] = len(orbit)

    cluster_sites = np.concatenate(cl_sites).astype(np.int32)
    cluster_strides = np.concatenate(cl_strides).astype(np.int32)
    cluster_orbit = np.concatenate(cl_orbit).astype(np.int32)

    # interaction tensor offsets: slot 0 (size 1) is the empty-orbit offset
    orbit_offset = np.zeros(num_orbits, dtype=np.int64)
    orbit_offset[1:] = np.cumsum(orbit_tensor_size)[:-1]
    interaction_len = int(orbit_tensor_size.sum())

    # ---- correlation pair tables ----
    fn_orbit = subspace.function_orbit_ids.astype(np.int32)
    fn_cluster_count = np.ones(num_corr, dtype=np.float64)
    fn_offset = np.zeros(num_corr, dtype=np.int64)
    corr_chunks = [np.zeros(1)]  # slot for the empty function
    offset = 1
    pair_fn, pair_cluster, pair_offset = [], [], []
    cluster_start = np.zeros(num_orbits, dtype=np.int64)
    start = 0
    for orbit, inds in zip(orbits, indices):
        cluster_start[orbit.id] = start
        start += len(inds)
    for orbit, inds in zip(orbits, indices):
        tensors = orbit.flat_correlation_tensors  # [n_combos, tsize]
        n_cl = len(inds)
        for k in range(tensors.shape[0]):
            f = orbit.bit_id + k
            corr_chunks.append(tensors[k])
            fn_offset[f] = offset
            fn_cluster_count[f] = n_cl
            offset += tensors.shape[1]
            pair_fn.append(np.full(n_cl, f, dtype=np.int32))
            pair_cluster.append(
                np.arange(cluster_start[orbit.id], cluster_start[orbit.id] + n_cl,
                          dtype=np.int32)
            )
            pair_offset.append(np.full(n_cl, fn_offset[f], dtype=np.int32))
    corr_flat = np.concatenate(corr_chunks).astype(np.float64)
    pair_fn = np.concatenate(pair_fn) if pair_fn else np.zeros(0, np.int32)
    pair_cluster = (
        np.concatenate(pair_cluster) if len(pair_cluster) else np.zeros(0, np.int32)
    )
    pair_offset = (
        np.concatenate(pair_offset) if len(pair_offset) else np.zeros(0, np.int32)
    )

    # ---- per-site local tables ----
    site_clusters = [[] for _ in range(num_sites)]
    for c in range(len(cluster_sites)):
        k = int(np.count_nonzero(cluster_strides[c])) or 1
        for s in np.unique(cluster_sites[c, :k]):
            site_clusters[int(s)].append(c)
    lmax = max((len(v) for v in site_clusters), default=1)
    # round padded widths up to a multiple of 8 so supercells of equal size
    # but different shape usually share table dims (and so XLA compilations)
    lmax = -(-max(lmax, 1) // 8) * 8
    local_clusters = np.full((num_sites, max(lmax, 1)), -1, dtype=np.int32)
    for s, v in enumerate(site_clusters):
        local_clusters[s, : len(v)] = v

    # local pair table: (function, cluster) pairs touching each site
    n_combos_of_cluster = orbit_num_combos[cluster_orbit]
    pair_start_of_cluster = np.zeros(len(cluster_sites), dtype=np.int64)
    # pairs are laid out function-major per orbit; build an index from
    # (cluster, combo) -> pair id
    pair_id_lookup = {}
    for pid in range(len(pair_fn)):
        pair_id_lookup[(int(pair_cluster[pid]), int(pair_fn[pid]))] = pid
    site_pairs = [[] for _ in range(num_sites)]
    for s, v in enumerate(site_clusters):
        for c in v:
            oid = int(cluster_orbit[c])
            bid = int(orbit_bit_id[oid])
            for k in range(int(orbit_num_combos[oid])):
                site_pairs[s].append(pair_id_lookup[(c, bid + k)])
    lpmax = max((len(v) for v in site_pairs), default=1)
    lpmax = -(-max(lpmax, 1) // 8) * 8
    local_pairs = np.full((num_sites, max(lpmax, 1)), -1, dtype=np.int32)
    for s, v in enumerate(site_pairs):
        local_pairs[s, : len(v)] = v

    del pair_start_of_cluster, n_combos_of_cluster

    return PackedSupercell(
        num_corr=num_corr,
        num_orbits=num_orbits,
        num_sites=num_sites,
        size=size,
        max_cluster_size=max_k,
        cluster_sites=cluster_sites,
        cluster_strides=cluster_strides,
        cluster_orbit=cluster_orbit,
        orbit_offset=orbit_offset.astype(np.int32),
        orbit_tensor_size=orbit_tensor_size,
        orbit_cluster_count=orbit_cluster_count,
        orbit_bit_id=orbit_bit_id,
        orbit_num_combos=orbit_num_combos,
        corr_flat=corr_flat,
        pair_fn=pair_fn,
        pair_cluster=pair_cluster,
        pair_offset=pair_offset,
        fn_cluster_count=fn_cluster_count,
        fn_orbit=fn_orbit,
        local_clusters=local_clusters,
        local_pairs=local_pairs,
        interaction_len=interaction_len,
    )


def pack_interactions(subspace, interaction_tensors) -> tuple[np.ndarray, float]:
    """Concatenate per-orbit flat interaction tensors into one buffer.

    Args:
        subspace: the ClusterSubspace (fixes orbit order and tensor sizes).
        interaction_tensors: sequence of ndarray, entry 0 the scalar empty
            offset, then one tensor per orbit (as produced by
            ClusterExpansion.cluster_interaction_tensors).

    Returns:
        (flat f64 buffer aligned with PackedSupercell.orbit_offset, offset)
    """
    offset = float(np.asarray(interaction_tensors[0]).ravel()[0])
    chunks = [np.array([offset])]
    for orbit, tensor in zip(subspace.orbits, interaction_tensors[1:]):
        flat = np.ravel(np.asarray(tensor, dtype=np.float64), order="C")
        expected = orbit.flat_correlation_tensors.shape[1]
        if flat.shape[0] != expected:
            raise ValueError(
                f"Interaction tensor for orbit {orbit.id} has size "
                f"{flat.shape[0]}, expected {expected}."
            )
        chunks.append(flat)
    return np.concatenate(chunks), offset
