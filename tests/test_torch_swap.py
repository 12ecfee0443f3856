"""The port's canonical swap chain against smol_tpu and exact results.

- (b) the twin's swap delta equals a full recompute of features . theta
  for every ordered rank pair, to 1e-12 of the energy scale, and a null
  pair (equal codes, or u == v) has dE = 0 and is never accepted;
- (c) trajectories: fed the reference wrapper's own pair sequences and
  seeds, the port's hash-mode swap chain reproduces the interpret-mode
  Pallas swap chain occupancy for occupancy, with the same accept and
  non-null move counts (Au-Cu FCC 2x2x2: two walker blocks; spinel
  CE + Ewald 1x1x1 and 2x1x1: in the 1x1x1 cell every swap within a
  sublattice leads to a symmetric image, dE = 0 up to roundoff, so every
  non-null swap is accepted; the 2x1x1 cell decides on real Ewald
  deltas).  A walker may differ only where the port shows one
  of its decisions within 4 f32 ulps of log U beyond beta * slack, where
  slack bounds the reference's f32 Ewald error on one swap delta (see
  :func:`_ewald_f32_slack`); enthalpies of equal walkers agree to
  1e-9 + naccept * slack;
- compositions are conserved on every walker and sample of a sampler run
  from the committed canonical systems, whose recorded enthalpies equal
  features . theta to < 1e-9 (parity e, absolute; the spinel's energies
  are about -385 eV, so this is 3e-12 of the energy scale);
- (d) canonical averages match brute-force Boltzmann enumeration of an
  8-site binary cell at the fixed composition 4/4 (70 states) within 5
  standard errors;
- the sampler's default step type is ``"swap"`` without chemical
  potentials, sweeps are refused for swaps, and the wrapper runs the
  twin for CPU tensors, checks its operands and counts only launches.
"""

import functools
import sys
from itertools import combinations
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smol_tpu.benchmarks.systems import fcc_binary_prim, random_expansion, spinel_prim
from smol_tpu.moca import Ensemble, Sampler
from smol_tpu.ops import pallas_chain
from smol_tpu_torch.constants import kB
from smol_tpu_torch.moca.ensemble import Ensemble as TorchEnsemble
from smol_tpu_torch.moca.ensemble import random_occupancies
from smol_tpu_torch.moca.sampler.sampler import Sampler as TorchSampler
from smol_tpu_torch.ops import chain
from smol_tpu_torch.system import export_system, load_system

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from export_torch_systems import data_path  # noqa: E402

ULP_SLACK = 4
F32_EPS = 2.0**-24  # unit roundoff of f32


def _aucu(cell):
    ce = random_expansion(fcc_binary_prim(), {2: 6.0, 3: 4.0}, seed=7)
    return Ensemble.from_cluster_expansion(ce, np.diag(cell), processor_type="expansion")


def _spinel_ewald(cell):
    ce = random_expansion(spinel_prim(), {2: 5.3, 3: 3.7}, seed=11, ewald=True)
    return Ensemble.from_cluster_expansion(ce, np.diag(cell), processor_type="expansion")


@functools.lru_cache(maxsize=None)
def _systems(kind, cell):
    """(reference ensemble, port ensemble on the CPU), built once per module."""
    ref = {"aucu": _aucu, "spinel_ewald": _spinel_ewald}[kind](cell)
    return ref, TorchEnsemble.from_system(export_system(ref), "cpu")


AUCU = ("aucu", (2, 2, 2))
SPINEL_EWALD = [("spinel_ewald", (1, 1, 1)), ("spinel_ewald", (2, 1, 1))]
CELL_IDS = ["aucu-2x2x2", "spinel_ewald-1x1x1", "spinel_ewald-2x1x1"]


def _tables(port):
    return chain.build_chain_tables(port.processor, port.sublattices)


@pytest.mark.parametrize("kind,cell", [AUCU, *SPINEL_EWALD], ids=CELL_IDS)
def test_swap_delta_equals_full_recompute(kind, cell):
    """(b): every ordered rank pair, each on its own walker."""
    ref, port = _systems(kind, cell)
    tables = _tables(port)
    theta = torch.as_tensor(port.natural_parameters)
    R = tables.num_ranks
    u, v = (x.reshape(-1) for x in torch.meshgrid(torch.arange(R), torch.arange(R),
                                                   indexing="ij"))
    occu = torch.as_tensor(random_occupancies(ref, R * R, seed=8))
    occ = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
    before = occ.clone()
    beta32 = torch.full((R * R,), 10.0, dtype=torch.float32)
    accept, is_move, a, b, dE, _, _ = chain.swap_step_reference(
        tables, occ, u, v, torch.zeros(R * R, dtype=torch.int64), beta32
    )
    assert torch.equal(occ, before)  # the step leaves the occupancy alone
    walkers = torch.arange(R * R)
    new = occu.clone()
    new[walkers, tables.rank_sites[u]] = b.to(new.dtype)
    new[walkers, tables.rank_sites[v]] = a.to(new.dtype)
    e_old = port.compute_features(occu) @ theta
    exact = port.compute_features(new) @ theta - e_old
    scale = max(1.0, float(e_old.abs().max()))
    assert float((dE - exact).abs().max()) <= 1e-12 * scale
    assert torch.equal(is_move, a != b) and bool(is_move.any())
    assert bool((dE[~is_move] == 0).all()) and not bool(accept[~is_move].any())


def _reference_pair_draws(ref_tables, key, n_steps, W, block_size):
    """The reference wrapper's pair seqs and chunk seeds (pallas_chain :2040-2091)."""
    wb = min(block_size, -(-W // 128) * 128)
    grid = -(-W // wb)
    chunk = min(n_steps, pallas_chain.MAX_CHUNK_STEPS)
    n_chunks = -(-n_steps // chunk)
    k_seed, k_seq = jax.random.split(jax.random.fold_in(key, 13))
    seed0 = jax.random.randint(k_seed, (), 0, np.int32(2**30 - 1), dtype=jnp.int32)
    useqs, vseqs = pallas_chain.rank_pair_sequence(ref_tables, k_seq, (n_chunks, grid, chunk))
    seeds = seed0 + jnp.arange(n_chunks, dtype=jnp.int32) * jnp.int32(999983)
    return (np.asarray(useqs, dtype=np.int32), np.asarray(vseqs, dtype=np.int32),
            np.asarray(seeds, dtype=np.int64))


def _ewald_f32_slack(tables):
    """Bound (eV) of the reference's f32 Ewald error on one swap delta.

    The reference stores each f64 value x of the fold as f32 words
    hi + lo (|hi + lo - x| <= eps**2 |x|, eps = 2**-24) and takes the
    term of rank r as two f32 dots of R exact products (codes are 0/1),
    hi . occ and lo . occ, added to C_r in double-float.  A sum of R f32
    terms in any order is off by at most gamma_R = R eps / (1 - R eps) of
    the sum of their magnitudes, so one term is off by at most
    (gamma_R (1 + 2 eps) + 8 eps**2) (|C_r| + sum_t |V[r, t]|); a swap
    adds two such terms.  The port's terms are f64, off by about 1e-16
    of that.
    """
    if not tables.has_ewald:
        return 0.0
    R = tables.num_ranks
    gamma = R * F32_EPS / (1 - R * F32_EPS)
    row = tables.ew_c.abs() + tables.ew_v.abs().sum(dim=1)
    return 2 * (gamma * (1 + 2 * F32_EPS) + 8 * F32_EPS**2) * float(row.max())


def _trajectory_parity(ref, port, W, n_steps, block_size, temperature, seed):
    occ0 = random_occupancies(ref, W, seed)
    sampler = Sampler.from_ensemble(ref, temperature=temperature, nwalkers=W, seed=3)
    state = dict(sampler.setup_sample(occ0))
    state.pop("words", None)
    state["occupancy"] = jnp.asarray(occ0)
    assert "nmove" in state  # the reference seeds it for its Swap usher
    ref_tables = pallas_chain.build_chain_tables(ref.processor, ref.sublattices)
    key = jax.random.key(seed)
    useqs, vseqs, seeds = _reference_pair_draws(ref_tables, key, n_steps, W, block_size)
    fn = pallas_chain.make_shared_proposal_chain(
        ref_tables, n_steps, block_size=block_size, interpret=True, move="swap"
    )
    out = fn(state, key)
    ref_occ = np.asarray(out["occupancy"])
    ref_enth = np.asarray(out["enthalpy"])
    ref_nacc = np.asarray(out["naccept"])
    ref_nmove = np.asarray(out["nmove"])

    tables = _tables(port)
    slack = _ewald_f32_slack(tables)
    enthalpy = torch.tensor(np.array(state["enthalpy"]))
    beta = torch.tensor(np.array(state["beta"]))
    occu = torch.as_tensor(occ0)
    occ = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
    enth = enthalpy.clone()
    nacc = torch.zeros(W, dtype=torch.int32)
    nmove = torch.zeros(W, dtype=torch.int32)
    margin = torch.full((W,), float("inf"))
    chunk = useqs.shape[2]
    for c, chunk_seed in enumerate(seeds):
        chain.swap_chain_reference(
            occ, enth, nacc, nmove, beta.to(torch.float32),
            torch.as_tensor(useqs[c]), torch.as_tensor(vseqs[c]),
            torch.tensor([chunk_seed]), tables, min(chunk, n_steps - c * chunk),
            block_size, "hash", margin=margin, slack=slack,
        )
    port_occ = occu.clone()
    port_occ[:, tables.rank_sites] = occ.T.to(port_occ.dtype)

    # the chain factory, fed the same draws, is the twin loop exactly
    port_state = {
        "occupancy": occu.clone(), "enthalpy": enthalpy.clone(), "beta": beta,
        "naccept": torch.zeros(W, dtype=torch.int32),
        "accepted": torch.ones(W, dtype=torch.bool),
        "nmove": torch.zeros(W, dtype=torch.int32),
    }
    run = chain.make_shared_proposal_chain(
        tables, n_steps, block_size=block_size, rng="hash", seqs=(useqs, vseqs),
        seeds=seeds, move="swap",
    )
    port_state = run(port_state, None)
    assert torch.equal(port_state["occupancy"], port_occ)
    assert torch.equal(port_state["enthalpy"], enth)
    assert torch.equal(port_state["naccept"], nacc)
    assert torch.equal(port_state["nmove"], nmove)

    np.testing.assert_array_equal(nmove.numpy(), ref_nmove)  # no decision involved
    same = np.all(port_occ.numpy() == ref_occ, axis=1)
    for w in np.flatnonzero(~same):
        assert margin[w] <= ULP_SLACK, (w, float(margin[w]))
    assert same.mean() >= 0.9, same.mean()
    np.testing.assert_array_equal(nacc.numpy()[same], ref_nacc[same])
    tol = 1e-9 + nacc.numpy()[same] * slack
    assert np.all(np.abs(enth.numpy()[same] - ref_enth[same]) <= tol)
    assert 0 < ref_nacc.mean() <= ref_nmove.mean() < n_steps
    # composition is conserved walker by walker
    np.testing.assert_array_equal(np.sort(port_occ.numpy(), axis=1), np.sort(occ0, axis=1))
    return slack, ref_nacc.sum() / ref_nmove.sum()


def test_trajectory_parity_aucu():
    """(c) on Au-Cu FCC 2x2x2 (no Ewald), two walker blocks."""
    ref, port = _systems(*AUCU)
    slack, accepted = _trajectory_parity(ref, port, W=32, n_steps=120, block_size=16,
                                         temperature=300.0, seed=1)
    assert slack == 0.0 and accepted < 1


@pytest.mark.parametrize("kind,cell", SPINEL_EWALD, ids=CELL_IDS[1:])
def test_trajectory_parity_spinel_ewald(kind, cell):
    """(c) on the spinel CE + Ewald."""
    ref, port = _systems(kind, cell)
    slack, accepted = _trajectory_parity(ref, port, W=64, n_steps=200, block_size=64,
                                         temperature=1000.0, seed=0)
    assert 0.0 < slack < 1e-4
    assert accepted < 1 or ref.num_sites == 14  # the 1x1x1 cell accepts all


@pytest.mark.parametrize("stem", ["spinel_ewald_2x2x2", "aucu_4x4x4"])
def test_sampler_conserves_composition(stem):
    system = load_system(data_path(stem))
    port = TorchEnsemble.from_system(system, "cpu")
    W, nsteps, thin = 16, 400, 100
    sampler = TorchSampler.from_ensemble(port, 1000.0, W, seed=3, device="cpu",
                                         chain_block_size=8)
    sampler.run(nsteps, system["initial_occupancy"], thin_by=thin)
    occ = sampler.samples.get_occupancies(flat=False)  # [S, W, N]
    assert occ.shape == (nsteps // thin, W, port.num_sites)
    for sl in port.sublattices:
        for code in sl.encoding:
            start = int((system["initial_occupancy"][sl.sites] == code).sum())
            assert np.all((occ[:, :, sl.sites] == code).sum(axis=-1) == start)
    assert not np.all(occ[-1] == system["initial_occupancy"])  # it moved
    feats = sampler.samples.get_feature_vectors()
    enth = sampler.samples.get_enthalpies()
    assert np.abs(feats @ port.natural_parameters - enth).max() < 1e-9
    state = sampler._state
    assert torch.all(state["nmove"] >= state["naccept"])
    assert 0 < int(state["naccept"].sum()) < int(state["nmove"].sum()) < W * nsteps


def _binary_fcc_8():
    from smol_tpu.cofe import ClusterSubspace
    from smol_tpu.cofe.expansion import ClusterExpansion
    from smol_tpu.crystal import Lattice, Structure

    lat = Lattice(np.array([[0, 0.5, 0.5], [0.5, 0, 0.5], [0.5, 0.5, 0]]) * 3.8)
    prim = Structure(lat, [{"Au": 0.5, "Cu": 0.5}], [[0, 0, 0]])
    cs = ClusterSubspace.from_cutoffs(prim, {2: 3.0})
    coefs = np.random.default_rng(5).normal(scale=0.02, size=cs.num_corr_functions)
    coefs[0] = -0.5
    return Ensemble.from_cluster_expansion(
        ClusterExpansion(cs, coefs), np.diag([2, 2, 2]), processor_type="expansion"
    )


def test_canonical_averages_match_enumeration():
    """(d): 8 active sites at composition 4/4, 70 states, T = 2000 K."""
    ref = _binary_fcc_8()
    temperature = 2000.0
    beta = 1.0 / (kB * temperature)
    n = ref.num_sites
    states = np.zeros((70, n), dtype=np.int32)
    for i, ones in enumerate(combinations(range(n), n // 2)):
        states[i, list(ones)] = 1
    port = TorchEnsemble.from_system(export_system(ref), "cpu")
    h = (port.compute_features(torch.as_tensor(states)) @ torch.as_tensor(
        port.natural_parameters)).numpy()
    ref_h = np.array([ref.compute_feature_vector(s) @ ref.natural_parameters
                      for s in states[::9]])
    np.testing.assert_allclose(h[::9], ref_h, rtol=0, atol=1e-12)
    weights = np.exp(-beta * (h - h.min()))
    exact = float(h @ weights / weights.sum())

    W = 64
    sampler = TorchSampler.from_ensemble(port, temperature, W, seed=23, device="cpu",
                                         chain_block_size=1)
    occ0 = states[np.random.default_rng(4).integers(0, 70, W)]
    sampler.run(3000, occ0, thin_by=20)
    enth = sampler.samples.get_enthalpies(discard=30, flat=False)  # [S, W]
    walker_means = enth.mean(axis=0)
    sem = walker_means.std(ddof=1) / np.sqrt(W)
    mc_mean = float(sampler.samples.mean_enthalpy(discard=30))
    assert abs(mc_mean - exact) < 5 * sem, (mc_mean, exact, sem)
    assert np.all(sampler.samples.get_occupancies().sum(axis=1) == n // 2)


def test_sampler_default_step_type_and_refusals():
    _, port = _systems(*AUCU)
    ewald = TorchEnsemble.from_system(load_system(data_path("spinel_ewald_2x2x2")), "cpu")
    for ens, path in ((port, "cpu-twin[swap]+direct+shared-proposals"),
                      (ewald, "cpu-twin[swap]+ewald+direct+shared-proposals")):
        sampler = TorchSampler.from_ensemble(ens, 1000.0, 4, seed=1, device="cpu")
        assert sampler.execution_path(10) == path
        if torch.cuda.is_available():
            continue
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchSampler.from_ensemble(ens, 1000.0, 4, seed=1)
    sweep = TorchSampler.from_ensemble(port, 1000.0, 4, seed=1, device="cpu",
                                       proposal_mode="sweep")
    with pytest.raises(ValueError, match="sweep"):
        sweep.run(10, random_occupancies(port, 4, 0), thin_by=10)
    tables = _tables(port)
    with pytest.raises(ValueError, match="move"):
        chain.make_shared_proposal_chain(tables, 10, move="wang-landau")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchSampler.from_ensemble(port, 1000.0, 4, seed=1, device="cpu",
                                   shared_proposals=False)


def test_swap_wrapper_runs_twin_on_cpu_and_checks_operands():
    _, port = _systems(*AUCU)
    tables = _tables(port)
    W = 8
    occu = torch.as_tensor(random_occupancies(port, W, 2))
    gen = torch.Generator().manual_seed(0)
    useq, vseq = chain.rank_pair_sequence(tables, gen, (1, 10))
    ops = dict(
        occ=occu[:, tables.rank_sites].T.to(torch.int8).contiguous(),
        enthalpy=torch.zeros(W, dtype=torch.float64),
        naccept=torch.zeros(W, dtype=torch.int32),
        nmove=torch.zeros(W, dtype=torch.int32),
        beta32=torch.full((W,), 5.0, dtype=torch.float32),
        useq=useq, vseq=vseq, seed=torch.zeros(1, dtype=torch.int64),
        tables=tables, n_steps=10, block_size=8,
    )
    before = chain.swap_chain.launches
    chain.swap_chain(**ops)
    assert chain.swap_chain.launches == before  # the twin is not a launch
    assert int(ops["nmove"].sum()) > 0
    assert useq.dtype == vseq.dtype == torch.int32
    for name, bad in (
        ("nmove", ops["nmove"].to(torch.int64)),
        ("vseq", ops["vseq"][:, :5].contiguous()),
        ("occ", ops["occ"].to(torch.int32)),
    ):
        with pytest.raises(ValueError):
            chain.swap_chain(**{**ops, name: bad})
