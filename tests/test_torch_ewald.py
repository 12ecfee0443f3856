"""The port's Ewald term against smol_tpu's, on the spinel CE + Ewald.

- (a) the composite features (extensive correlations, then the Ewald
  energy b . M . b) equal ``Ensemble.compute_feature_vector`` of the
  reference to 1e-12 relative (|diff| <= 1e-12 * max(1, max |feature|)),
  on the 1x1x1 and 2x2x2 spinel; the natural parameters are the
  reference's;
- the single-flip Ewald delta equals the reference's
  ``delta_ewald_single_flip`` and the change of the full energy, to
  1e-12 of the energy scale;
- the chain tables' Ewald fold (``ew_v``, ``ew_c``, f64) equals the
  reference fold, whose f64 values it stores as f32 hi + lo words
  (recombined here: the split keeps about 2**-48 of each value), to
  1e-12 of the fold's scale;
- the flip delta with the Ewald term equals a full recompute of
  features . theta for every rank, to 1e-12 of the energy scale (the
  total energies are hundreds of eV; a full recompute sums the Ewald
  form over all rows, so its roundoff is relative to that scale);
- the fold is refused on non-binary active sites.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smol_tpu.benchmarks.systems import random_expansion, spinel_prim
from smol_tpu.moca import Ensemble
from smol_tpu.ops import ewald as ref_ewald
from smol_tpu.ops import pallas_chain
from smol_tpu_torch.moca.ensemble import Ensemble as TorchEnsemble
from smol_tpu_torch.moca.ensemble import random_occupancies
from smol_tpu_torch.moca.processor.composite import CompositeProcessor
from smol_tpu_torch.ops import chain
from smol_tpu_torch.ops import ewald as ewald_ops
from smol_tpu_torch.system import export_system

REL_TOL = 1e-12


def _spinel_ewald(n):
    ce = random_expansion(spinel_prim(), {2: 5.3, 3: 3.7}, seed=11, ewald=True)
    return Ensemble.from_cluster_expansion(
        ce, np.diag([n, n, n]), processor_type="expansion"
    )


@pytest.fixture(scope="module", params=[1, 2], ids=["1x1x1", "2x2x2"])
def spinel(request):
    ref = _spinel_ewald(request.param)
    return ref, TorchEnsemble.from_system(export_system(ref), "cpu")


def test_composite_features_match_reference(spinel):
    """(a) on the spinel CE + Ewald."""
    ref, port = spinel
    assert isinstance(port.processor, CompositeProcessor)
    np.testing.assert_array_equal(port.natural_parameters, ref.natural_parameters)
    assert port.num_energy_coefs == len(ref.processor.coefs) == len(ref.natural_parameters)
    occ = random_occupancies(ref, 16, seed=3)
    want = np.array([ref.compute_feature_vector(o) for o in occ])
    got = port.compute_features(torch.as_tensor(occ)).numpy()
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= REL_TOL * scale
    # the Ewald column is the energy b . M . b
    ew = ref.processor.processors[1]
    energy = [float(ref_ewald.ewald_energy(o, ew.ewald_matrix, ew._ewald_inds)) for o in occ]
    np.testing.assert_allclose(got[:, -1], energy, rtol=0, atol=REL_TOL * scale)


def test_single_flip_delta_matches_reference(spinel):
    ref, port = spinel
    ew = ref.processor.processors[1]
    M = torch.as_tensor(ew.ewald_matrix)
    inds = torch.as_tensor(np.asarray(ew._ewald_inds))
    occ = random_occupancies(ref, 24, seed=4)
    rng = np.random.default_rng(5)
    active = np.concatenate([s.active_sites for s in ref.sublattices])
    sites = rng.choice(active, len(occ))
    codes = 1 - occ[np.arange(len(occ)), sites]  # binary: the other code
    got = ewald_ops.delta_ewald_single_flip(
        torch.as_tensor(occ), torch.as_tensor(sites), torch.as_tensor(codes), M, inds
    ).numpy()
    want = np.array([
        float(ref_ewald.delta_ewald_single_flip(
            jnp.asarray(o), int(s), int(c), jnp.asarray(ew.ewald_matrix),
            jnp.asarray(ew._ewald_inds)))
        for o, s, c in zip(occ, sites, codes)
    ])
    new = occ.copy()
    new[np.arange(len(occ)), sites] = codes
    e_old = ewald_ops.ewald_energy(torch.as_tensor(occ), M, inds).numpy()
    e_new = ewald_ops.ewald_energy(torch.as_tensor(new), M, inds).numpy()
    scale = max(1.0, float(np.abs(e_old).max()))
    assert np.abs(got - want).max() <= REL_TOL * scale
    assert np.abs(got - (e_new - e_old)).max() <= REL_TOL * scale


def test_fold_matches_reference(spinel):
    ref, port = spinel
    ref_tables = pallas_chain.build_chain_tables(ref.processor, ref.sublattices)
    assert ref_tables.has_ewald
    tables = chain.build_chain_tables(port.processor, port.sublattices)
    assert tables.has_ewald
    R = tables.num_ranks
    ew_v = np.asarray(ref_tables.ew_v, dtype=np.float64)  # [R, 2, rpad] hi, lo
    ew_c = np.asarray(ref_tables.ew_c, dtype=np.float64)[0]  # [2R] hi, lo
    V = ew_v[:, 0, :R] + ew_v[:, 1, :R]
    C = ew_c[:R] + ew_c[R:]
    v, c = tables.ew_v.numpy(), tables.ew_c.numpy()
    assert v.dtype == np.float64 and v.shape == (R, R)
    assert np.all(np.diag(v) == 0.0)
    scale = max(np.abs(V).max(), np.abs(C).max())
    np.testing.assert_allclose(v, V, rtol=REL_TOL, atol=REL_TOL * scale)
    np.testing.assert_allclose(c, C, rtol=REL_TOL, atol=REL_TOL * scale)


def test_flip_delta_with_ewald_equals_full_recompute(spinel):
    """(b) for flips on the composite: every rank, both directions."""
    ref, port = spinel
    tables = chain.build_chain_tables(port.processor, port.sublattices)
    theta = torch.as_tensor(port.natural_parameters)
    W = 12
    occu = torch.as_tensor(random_occupancies(ref, W, seed=6))
    occ = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
    e_old = port.compute_features(occu) @ theta
    scale = max(1.0, float(e_old.abs().max()))
    beta32 = torch.full((W,), 10.0, dtype=torch.float32)
    zeros = torch.zeros(W, dtype=torch.int64)
    worst = 0.0
    for r in range(tables.num_ranks):
        u = torch.full((W,), r, dtype=torch.int64)
        _, b, dE, _, _ = chain.flip_step_reference(tables, occ, u, zeros, zeros, beta32)
        new = occu.clone()
        new[:, tables.rank_sites[r]] = b.to(new.dtype)
        exact = port.compute_features(new) @ theta - e_old
        worst = max(worst, float((dE - exact).abs().max()))
    assert worst <= REL_TOL * scale, (worst, scale)


def test_fold_refuses_non_binary_sites(spinel):
    _, port = spinel
    subs = [
        dataclasses.replace(s, encoding=np.arange(3, dtype=np.int32))
        if s.is_active and i == 0 else s
        for i, s in enumerate(port.sublattices)
    ]
    with pytest.raises(NotImplementedError, match="binary"):
        chain.build_chain_tables(port.processor, subs)
