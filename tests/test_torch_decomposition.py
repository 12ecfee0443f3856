"""The port's cluster-decomposition processor against smol_tpu's.

- (a) on bench ``sgc`` 3x3x3 and on the bench spinel 2x2x2 in the
  decomposition form ``bench.py`` builds (the committed
  ``tests/data/torch_{sgc_3x3x3,spinel_cd_2x2x2}.npz``), the port's
  features (the extensive cluster-interaction vector, chemical work last)
  equal ``smol_tpu``'s ``compute_feature_vector`` to <= 1e-12 relative on
  random occupancies, and the natural parameters (the orbit
  multiplicities, then -1) are the same numbers exactly; the energy part
  of the features . theta equals the expansion form's (the same
  Hamiltonian, two feature vectors);
- (c) a flip chain on a decomposition system, the direct body, fed the
  reference wrapper's site sequences and seeds, reproduces the
  interpret-mode Pallas chain occupancy for occupancy (the spinel; the
  reference takes its Ising delta there), excusing only walkers with a
  decision within 4 f32 ulps of log U;
- (e) ``Sampler.run`` on ``sgc`` 3x3x3 (CPU) records enthalpies equal to
  the lazily derived decomposition features . theta to < 1e-9, with
  either site body.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smol_tpu.moca import Sampler
from smol_tpu.ops import pallas_chain
from smol_tpu_torch.moca.ensemble import Ensemble as TorchEnsemble
from smol_tpu_torch.moca.ensemble import random_occupancies
from smol_tpu_torch.moca.processor.expansion import ClusterDecompositionProcessor
from smol_tpu_torch.moca.sampler.sampler import Sampler as TorchSampler
from smol_tpu_torch.ops import chain
from smol_tpu_torch.system import load_system

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from export_torch_systems import (  # noqa: E402
    data_path,
    sgc_ensemble,
    spinel_cd_ensemble,
    spinel_ensemble,
)

ULP_SLACK = 4
CELLS = {"sgc_3x3x3": lambda: sgc_ensemble(3), "spinel_cd_2x2x2": lambda: spinel_cd_ensemble(2)}
_CACHE = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors, so that parallel test
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(stem):
    """(reference ensemble, port ensemble on the CPU from the committed file)."""
    if stem not in _CACHE:
        _CACHE[stem] = (CELLS[stem](),
                        TorchEnsemble.from_system(load_system(data_path(stem)), "cpu"))
    return _CACHE[stem]


@pytest.mark.parametrize("stem", sorted(CELLS))
def test_features_and_parameters_equal_reference(stem):
    """(a)."""
    ref, port = _pair(stem)
    assert isinstance(port.processor, ClusterDecompositionProcessor)
    assert type(ref.processor).__name__ == "ClusterDecompositionProcessor"
    assert port.natural_parameters.tobytes() == np.asarray(
        ref.natural_parameters, dtype=np.float64).tobytes()
    np.testing.assert_array_equal(port.natural_parameters[:-1], ref.processor.coefs)
    assert port.num_energy_coefs == ref.processor.packed.num_orbits
    occ = random_occupancies(ref, 16, seed=4)
    mine = port.compute_features(torch.as_tensor(occ)).numpy()
    theirs = np.array([ref.compute_feature_vector(o) for o in occ])
    assert mine.shape == theirs.shape == (16, len(port.natural_parameters))
    assert np.abs(mine - theirs).max() <= 1e-12 * np.abs(theirs).max()
    if stem == "spinel_cd_2x2x2":  # the expansion form: another vector, one energy
        expansion = spinel_ensemble(2)
        energy = np.array([expansion.compute_feature_vector(o) @ expansion.natural_parameters
                           for o in occ[:4]])
        np.testing.assert_allclose(mine[:4] @ port.natural_parameters, energy,
                                   rtol=0, atol=1e-9)


def test_flip_chain_on_decomposition_system_matches_reference():
    """(c) with the direct body on the decomposition spinel."""
    ref, port = _pair("spinel_cd_2x2x2")
    W, n_steps, block = 64, 200, 64
    occ0 = random_occupancies(ref, W, 0)
    sampler = Sampler.from_ensemble(ref, temperature=1000.0, nwalkers=W, seed=3)
    state = dict(sampler.setup_sample(occ0))
    state.pop("words", None)
    state["occupancy"] = jnp.asarray(occ0)
    ref_tables = pallas_chain.build_chain_tables(
        ref.processor, ref.sublattices, mu_table=ref.chemical_potential_table)
    key = jax.random.key(0)
    k_seed, k_seq = jax.random.split(jax.random.fold_in(key, 13))
    seed0 = int(jax.random.randint(k_seed, (), 0, np.int32(2**30 - 1), dtype=jnp.int32))
    seq = np.asarray(pallas_chain.rank_sequence(ref_tables, k_seq, (1, 1, n_steps)),
                     dtype=np.int32)[0]
    out = pallas_chain.make_shared_proposal_chain(
        ref_tables, n_steps, block_size=block, interpret=True)(state, key)

    tables = chain.build_chain_tables(port.processor, port.sublattices,
                                      mu_table=port.chemical_potential_table)
    occu = torch.as_tensor(occ0)
    occ = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
    enth = torch.tensor(np.array(state["enthalpy"]))
    nacc = torch.zeros(W, dtype=torch.int32)
    margin = torch.full((W,), float("inf"))
    chain.flip_chain_reference(occ, enth, nacc, torch.tensor(np.array(state["beta"])).float(),
                               torch.as_tensor(seq), torch.tensor([seed0]), tables, n_steps,
                               block, "hash", margin=margin)
    occu[:, tables.rank_sites] = occ.T.to(occu.dtype)
    same = np.all(occu.numpy() == np.asarray(out["occupancy"]), axis=1)
    for w in np.flatnonzero(~same):
        assert margin[w] <= ULP_SLACK, (w, float(margin[w]))
    assert same.mean() >= 0.9
    np.testing.assert_array_equal(nacc.numpy()[same], np.asarray(out["naccept"])[same])
    np.testing.assert_allclose(enth.numpy()[same], np.asarray(out["enthalpy"])[same],
                               rtol=0, atol=1e-9)
    assert 0 < nacc.double().mean() < n_steps


@pytest.mark.parametrize("delta", ["direct", "qary"])
def test_sampler_parity_e_on_sgc(delta):
    """(e) on the CPU: recorded enthalpy == decomposition features . theta."""
    _, port = _pair("sgc_3x3x3")
    W = 16
    sampler = TorchSampler.from_ensemble(port, 800.0, nwalkers=W, seed=3, device="cpu",
                                         chain_block_size=8, chain_delta=delta)
    sampler.run(300, random_occupancies(port, W, 0), thin_by=50)
    feats = sampler.samples.get_feature_vectors()
    enth = sampler.samples.get_enthalpies()
    assert feats.shape == (6 * W, len(port.natural_parameters))
    assert np.abs(feats @ port.natural_parameters - enth).max() < 1e-9
    assert 0 < float(sampler.efficiency()) < 1
    body = "qary3" if delta == "qary" else "direct"
    assert sampler.execution_path(50) == f"cpu-twin[flip]+{body}+shared-proposals"
