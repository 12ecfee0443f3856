"""The port's table-move chain (charge-neutral table flips) against smol_tpu.

- ``build_table_move`` gives the reference's arrays, array for array, on
  the spinel CE + Ewald 1x1x1, on a Li+/Mn3+/vacancy, O2-/F- rocksalt at
  2x1x1 and 2x2x2 (four directions of up to three recolorings: the
  multi-slot system) and on a ternary FCC; where the reference returns
  None (and falls back to its per-step path) the port raises;
- ``table_sequences``: a collision goes to the null row, every slot's rank
  lies in its sublattice, the swap row's share is ``swap_weight`` within
  sampling error;
- (b) the twin's dH of a valid move equals a full recompute of
  features . theta to 1e-9 absolute, with and without Ewald, multi-slot
  moves included;
- (c) trajectories: fed the reference wrapper's own draws and seeds, the
  port's hash-mode table chain reproduces the interpret-mode Pallas chain
  occupancy for occupancy and accept count for accept count, on the spinel
  CE + Ewald 1x1x1 and 2x2x2, on the multi-slot system and across a
  ``2048 // k_max`` chunk boundary.  A walker may differ only where the
  port shows one of its decisions within 4 f32 ulps of log U beyond
  beta * slack, where slack bounds the reference's f32 Ewald error on a
  move of two recolorings (``2 gamma_R (|C_r| + sum |V_r|)``, see
  ``_ewald_f32_slack``).  Enthalpies are held to features . theta, never
  to the reference's recorded enthalpy, which drifts on this path.
  The reference chain cannot run an odd ``k_max`` (its partner lookup
  ``a0[j ^ 1]`` leaves the list) and lets an unused slot whose rank repeats
  an earlier valid slot's undo that slot's recoloring; the multi-slot case
  therefore pads both tables to four slots and gives unused slots ranks
  that no valid slot holds.  The port needs neither;
- (d) the sampler's table-flip averages on a tiny {Li+, vacancy} x
  {Mn3+, Mn4+} cell match enumeration over the charge-neutral manifold,
  and every sample is neutral;
- (e) through ``Sampler.run`` on the committed spinel CE + Ewald system
  the recorded enthalpy equals features . theta to < 1e-9 and every
  walker of every sample keeps the start's net charge.
"""

import dataclasses
import functools
import sys
from itertools import product
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smol_tpu.benchmarks.systems import fcc_ternary_prim, random_expansion, spinel_prim
from smol_tpu.moca import Ensemble, Sampler
from smol_tpu.moca.kernel.tableflip import TableFlip
from smol_tpu.ops import pallas_chain
from smol_tpu_torch.constants import kB
from smol_tpu_torch.moca.ensemble import Ensemble as TorchEnsemble
from smol_tpu_torch.moca.ensemble import random_occupancies
from smol_tpu_torch.moca.kernel.tableflip import TableFlip as TorchTableFlip
from smol_tpu_torch.moca.sampler.sampler import Sampler as TorchSampler
from smol_tpu_torch.ops import chain
from smol_tpu_torch.system import export_system, load_system

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from export_torch_systems import (  # noqa: E402
    BENCH_MUS,
    data_path,
    limn_tiny_ensemble,
    lmof_ensemble,
)

ULP_SLACK = 4
F32_EPS = 2.0**-24  # unit roundoff of f32


def _spinel(cell, ewald):
    ce = random_expansion(spinel_prim(), {2: 5.3, 3: 3.7}, seed=11, ewald=ewald)
    return Ensemble.from_cluster_expansion(
        ce, np.diag(cell), processor_type="expansion", chemical_potentials=BENCH_MUS
    )


def _ternary(cell):
    ce = random_expansion(fcc_ternary_prim(), {2: 5.5, 3: 4.0}, seed=7)
    return Ensemble.from_cluster_expansion(
        ce, np.diag(cell), processor_type="expansion",
        chemical_potentials={"Au": 0.05, "Ag": 0.0, "Cu": -0.05},
    )


ENSEMBLES = {
    "spinel_ewald": lambda cell: _spinel(cell, True),
    "spinel": lambda cell: _spinel(cell, False),
    "lmof": lmof_ensemble,
    "ternary": _ternary,
    "limn_tiny": lambda cell: limn_tiny_ensemble(),
}


@functools.lru_cache(maxsize=None)
def _systems(kind, cell):
    """(reference ensemble, its usher, port ensemble on the CPU), built once."""
    ref = ENSEMBLES[kind](cell)
    usher = TableFlip(ref.sublattices)
    return ref, usher, TorchEnsemble.from_system(export_system(ref, usher=usher), "cpu")


def _port_kernel(port, **kwargs):
    sampler = TorchSampler.from_ensemble(port, 1000.0, 4, seed=1, device="cpu",
                                         step_type="table-flip", **kwargs)
    return sampler._kernel


def _reference_chain_tables(ref, usher):
    tables = pallas_chain.build_chain_tables(
        ref.processor, ref.sublattices, mu_table=ref.chemical_potential_table,
        sublattice_probabilities=usher._swapper.sublattice_probabilities,
    )
    return tables, pallas_chain.build_table_move(tables, usher)


MOVE_ARRAYS = ("from_code", "to_code", "slot_valid", "slot_sub", "dir_cum_probs")
MOVE_CASES = [("spinel_ewald", (1, 1, 1)), ("lmof", (2, 1, 1)), ("lmof", (2, 2, 2)),
              ("ternary", (2, 2, 2))]
MOVE_IDS = ["spinel_ewald-1x1x1", "lmof-2x1x1", "lmof-2x2x2", "ternary-2x2x2"]


@pytest.mark.parametrize("kind,cell", MOVE_CASES, ids=MOVE_IDS)
def test_table_move_equals_reference(kind, cell):
    ref, usher, port = _systems(kind, cell)
    _, ref_tm = _reference_chain_tables(ref, usher)
    assert ref_tm is not None
    kernel = _port_kernel(port)
    np.testing.assert_array_equal(kernel.mcusher.flip_table, usher.flip_table)
    np.testing.assert_array_equal(kernel.mcusher.flip_weights, usher.flip_weights)
    assert kernel.mcusher.d == usher.d and kernel.mcusher.swap_weight == usher.swap_weight
    tm = kernel.table_move()
    assert (tm.n_dirs, tm.k_max, tm.swap_weight) == (
        ref_tm.n_dirs, ref_tm.k_max, ref_tm.swap_weight)
    assert tm.k_max == (3 if kind == "lmof" else 2)
    for name in MOVE_ARRAYS:
        mine, theirs = getattr(tm, name), getattr(ref_tm, name)
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape, name
        np.testing.assert_array_equal(mine, theirs, err_msg=name)
    np.testing.assert_array_equal(
        tm.dev["rows"].numpy(),
        np.stack([ref_tm.from_code, ref_tm.to_code, ref_tm.slot_valid]),
    )
    # the embedded swaps follow the swapper's (uniform) sublattice probabilities
    np.testing.assert_allclose(tm.dev["sub_cum"].numpy(),
                               np.cumsum(usher._swapper.sublattice_probabilities))


GUARDS = {  # usher arguments the chain cannot honour: the reference gives None
    "asymmetric-weights": dict(flip_weights=[1.0, 2.0]),
    "inactive-sublattice": dict(flip_table=[[-1, 1, 0, 0, 1]]),
    "site-count": dict(flip_table=[[-1, 0, 0, 1, 0]]),
    "too-many-slots": dict(flip_table=[[-9, 9, 0, 0, 0]]),
}


@pytest.mark.parametrize("guard", sorted(GUARDS))
def test_table_move_guards_raise_where_reference_falls_back(guard):
    ref, usher, port = _systems("spinel_ewald", (1, 1, 1))
    ref_tables, _ = _reference_chain_tables(ref, usher)
    assert pallas_chain.build_table_move(
        ref_tables, TableFlip(ref.sublattices, **GUARDS[guard])) is None
    kernel = _port_kernel(port)
    mine = TorchTableFlip(port.sublattices, **{**port.table_data, **GUARDS[guard]})
    with pytest.raises(NotImplementedError, match="item 8"):
        chain.build_table_move(kernel.chain_tables(), mine)
    with pytest.raises(ValueError, match="weights"):
        TorchTableFlip(port.sublattices, **port.table_data, flip_weights=[1.0] * 3)


@pytest.mark.parametrize("kind,cell", [("spinel_ewald", (1, 1, 1)), ("lmof", (2, 2, 2))],
                         ids=["spinel_ewald-1x1x1", "lmof-2x2x2"])
def test_table_sequences(kind, cell):
    _, _, port = _systems(kind, cell)
    kernel = _port_kernel(port)
    tables, tm = kernel.chain_tables(), kernel.table_move()
    shape = (4, 5000)
    dirs, ranks = chain.table_sequences(tables, tm, torch.Generator().manual_seed(5), shape)
    assert dirs.dtype == ranks.dtype == torch.int32
    assert dirs.shape == shape and ranks.shape == (*shape, tm.k_max)
    dirs, ranks = dirs.numpy(), ranks.numpy()
    assert dirs.min() >= 0 and dirs.max() == tm.n_dirs + 1  # some collide
    assert set(np.unique(dirs)) == set(range(tm.n_dirs + 2))
    valid = tm.slot_valid[dirs] > 0
    for j in range(tm.k_max):  # no row keeps a collision among its valid slots
        for k in range(j + 1, tm.k_max):
            assert not np.any(valid[..., j] & valid[..., k] & (ranks[..., j] == ranks[..., k]))
    first, size = tables.sub_offset, tables.n_active
    sub = tm.slot_sub[dirs]
    for s in range(len(first)):  # a slot's rank lies in the slot's sublattice
        mine = ranks[valid & (sub == s)]
        assert mine.min() >= first[s] and mine.max() < first[s] + size[s]
    swap_ranks = ranks[dirs == tm.n_dirs][:, :2]
    swap_sub = np.searchsorted(first, swap_ranks, side="right") - 1
    assert np.all(swap_sub[:, 0] == swap_sub[:, 1])  # a swap stays in one sublattice
    assert set(np.unique(swap_sub)) == set(range(len(first)))
    # the swap row's share: swap_weight, less the pairs with u == v
    probs = np.diff(tables.cum_probs, prepend=0.0)
    expect = tm.swap_weight * (1 - np.sum(probs / size))
    n = dirs.size
    share = np.mean(dirs == tm.n_dirs)
    assert abs(share - expect) < 5 * np.sqrt(expect * (1 - expect) / n), (share, expect)
    # the flip directions are equally likely before the collisions
    counts = np.array([(dirs == d).sum() for d in range(tm.n_dirs)])
    assert counts.min() > 0.5 * counts.max()


@pytest.mark.parametrize(
    "kind,cell", [("spinel_ewald", (1, 1, 1)), ("spinel", (1, 1, 1)), ("lmof", (2, 2, 2))],
    ids=["spinel_ewald-1x1x1", "spinel-1x1x1", "lmof-2x2x2"])
def test_table_delta_equals_full_recompute(kind, cell):
    """(b): one proposal per walker; beta = 0 accepts every valid one."""
    ref, _, port = _systems(kind, cell)
    kernel = _port_kernel(port)
    tables, tm = kernel.chain_tables(), kernel.table_move()
    assert tables.has_ewald == (kind == "spinel_ewald")
    W = 3000
    theta = torch.as_tensor(port.natural_parameters)
    occu = torch.as_tensor(random_occupancies(ref, W, seed=8))
    occ = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
    before = occ.clone()
    dirs, ranks = chain.table_sequences(tables, tm, torch.Generator().manual_seed(2), (W,))
    accept, valid, a0, b, dE, _, _ = chain.table_step_reference(
        tables, tm, occ, dirs, ranks, torch.zeros(W, dtype=torch.int64),
        torch.zeros(W, dtype=torch.float32),
    )
    assert torch.equal(occ, before)  # the step leaves the occupancy alone
    assert torch.equal(accept, valid)
    slot_on = torch.as_tensor(tm.slot_valid)[dirs.long()] > 0
    assert torch.equal(b[~slot_on], a0[~slot_on])
    new = occu.clone()
    walkers = torch.arange(W)
    for j in range(tm.k_max):
        on = valid & slot_on[:, j]
        new[walkers[on], tables.rank_sites[ranks[on, j].long()]] = b[on, j].to(new.dtype)
    exact = (port.compute_features(new) - port.compute_features(occu)) @ theta
    assert float((dE - exact)[valid].abs().max()) <= 1e-9
    assert torch.equal(new[~valid], occu[~valid])
    # every row was taken by a valid walker, the widest ones included
    taken = set(dirs[valid].tolist())
    assert taken == set(range(tm.n_dirs + 1)), taken
    assert int((slot_on.sum(dim=1)[valid]).max()) == tm.slot_valid.sum(axis=1).max()
    # a valid move keeps the walker's net charge
    charges = port.site_charges[np.arange(port.num_sites)]
    net = [charges[np.arange(port.num_sites), o.numpy()].sum(axis=1) for o in (occu, new)]
    np.testing.assert_array_equal(*net)


def _reference_table_draws(ref_tables, ref_tm, key, n_steps, W, block_size):
    """The reference wrapper's table draws and chunk seeds (pallas_chain :2040-2091)."""
    wb = min(block_size, -(-W // 128) * 128)
    grid = -(-W // wb)
    chunk = min(n_steps, pallas_chain.MAX_CHUNK_STEPS // ref_tm.k_max)
    n_chunks = -(-n_steps // chunk)
    k_seed, k_seq = jax.random.split(jax.random.fold_in(key, 13))
    seed0 = jax.random.randint(k_seed, (), 0, np.int32(2**30 - 1), dtype=jnp.int32)
    dirs, ranks = pallas_chain.table_sequences(ref_tables, ref_tm, k_seq,
                                               (n_chunks, grid, chunk))
    seeds = seed0 + jnp.arange(n_chunks, dtype=jnp.int32) * jnp.int32(999983)
    return (np.array(dirs, dtype=np.int32), np.array(ranks, dtype=np.int32),
            np.array(seeds, dtype=np.int64))


def _ewald_f32_slack(tables):
    """Bound (eV) of the reference's f32 Ewald error on a move of two
    recolorings: each Ewald term of rank r, two f32 dots of R exact
    products added to C_r in double-float, is off by at most
    (gamma_R (1 + 2 eps) + 8 eps**2) (|C_r| + sum_t |V[r, t]|) with
    gamma_R = R eps / (1 - R eps), eps = 2**-24 (as for the swap chain)."""
    if not tables.has_ewald:
        return 0.0
    R = tables.num_ranks
    gamma = R * F32_EPS / (1 - R * F32_EPS)
    row = tables.ew_c.abs() + tables.ew_v.abs().sum(dim=1)
    return 2 * (gamma * (1 + 2 * F32_EPS) + 8 * F32_EPS**2) * float(row.max())


def _pad_slots(tm_arrays, k_max):
    """The move's per-row arrays with unused slots appended up to ``k_max``."""
    fills = {"from_code": -1, "to_code": -1, "slot_valid": 0, "slot_sub": 0}
    return {name: np.pad(tm_arrays[name], ((0, 0), (0, k_max - tm_arrays[name].shape[1])),
                         constant_values=fill) for name, fill in fills.items()}


def _unused_slots_off_valid_ranks(dirs, ranks, slot_valid, num_ranks):
    """``ranks`` with every unused slot on the lowest rank no valid slot of
    its step holds (the reference would otherwise undo a valid slot)."""
    ranks = ranks.copy()
    valid = slot_valid[dirs] > 0
    for idx in np.ndindex(dirs.shape):
        held = set(ranks[idx][valid[idx]].tolist())
        free = next(r for r in range(num_ranks) if r not in held)
        ranks[idx][~valid[idx]] = free
    return ranks


def _trajectory_parity(kind, cell, W, n_steps, temperature, seed, monkeypatch,
                       pad_to=None):
    ref, usher, port = _systems(kind, cell)
    occ0 = random_occupancies(ref, W, seed)
    sampler = Sampler.from_ensemble(ref, temperature=temperature, nwalkers=W, seed=3,
                                    step_type="table-flip")
    state = dict(sampler.setup_sample(occ0))
    state.pop("words", None)
    state["occupancy"] = jnp.asarray(occ0)
    built = sampler.mckernel._get_chain_tables()
    assert built is not None and built[1] == "table"
    ref_tables, _, ref_tm = built

    kernel = _port_kernel(port)
    tables, tm = kernel.chain_tables(), kernel.table_move()
    if pad_to is not None:
        arrays = _pad_slots({n: getattr(ref_tm, n) for n in MOVE_ARRAYS[:4]}, pad_to)
        ref_tm = dataclasses.replace(ref_tm, k_max=pad_to, **arrays)
        tm = chain.make_table_move(tables, tm.n_dirs, pad_to, tm.swap_weight,
                                   *(arrays[n] for n in MOVE_ARRAYS[:4]), tm.dir_cum_probs)
    key = jax.random.key(seed)
    dirs, ranks, seeds = _reference_table_draws(ref_tables, ref_tm, key, n_steps, W, W)
    if pad_to is not None:
        ranks = _unused_slots_off_valid_ranks(dirs, ranks, ref_tm.slot_valid,
                                              tables.num_ranks)
        monkeypatch.setattr(
            pallas_chain, "table_sequences",
            lambda *args: (jnp.asarray(dirs), jnp.asarray(ranks)))
    fn = pallas_chain.make_shared_proposal_chain(
        ref_tables, n_steps, block_size=W, interpret=True, move="table",
        table_move=ref_tm,
    )
    out = fn(state, key)
    ref_occ = np.asarray(out["occupancy"])
    ref_nacc = np.asarray(out["naccept"])

    slack = _ewald_f32_slack(tables)
    enthalpy = torch.tensor(np.array(state["enthalpy"]))
    beta = torch.tensor(np.array(state["beta"]))
    occu = torch.as_tensor(occ0)
    occ = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
    enth = enthalpy.clone()
    nacc = torch.zeros(W, dtype=torch.int32)
    margin = torch.full((W,), float("inf"))
    chunk = dirs.shape[2]
    assert chunk == min(n_steps, chain.MAX_CHUNK_STEPS // tm.k_max)
    for c, chunk_seed in enumerate(seeds):
        chain.table_chain_reference(
            occ, enth, nacc, beta.to(torch.float32), torch.as_tensor(dirs[c]),
            torch.as_tensor(ranks[c]), torch.tensor([chunk_seed]), tables, tm,
            min(chunk, n_steps - c * chunk), W, "hash", margin=margin, slack=slack,
        )
    port_occ = occu.clone()
    port_occ[:, tables.rank_sites] = occ.T.to(port_occ.dtype)

    # the chain factory, fed the same draws, is the twin loop exactly
    port_state = {
        "occupancy": occu.clone(), "enthalpy": enthalpy.clone(), "beta": beta,
        "naccept": torch.zeros(W, dtype=torch.int32),
        "accepted": torch.ones(W, dtype=torch.bool),
    }
    run = chain.make_shared_proposal_chain(
        tables, n_steps, block_size=W, rng="hash", seqs=(dirs, ranks), seeds=seeds,
        move="table", table_move=tm,
    )
    port_state = run(port_state, None)
    assert torch.equal(port_state["occupancy"], port_occ)
    assert torch.equal(port_state["enthalpy"], enth)
    assert torch.equal(port_state["naccept"], nacc)

    same = np.all(port_occ.numpy() == ref_occ, axis=1)
    for w in np.flatnonzero(~same):
        assert margin[w] <= ULP_SLACK, (w, float(margin[w]))
    assert same.mean() >= 0.9, same.mean()
    np.testing.assert_array_equal(nacc.numpy()[same], ref_nacc[same])
    assert 0 < ref_nacc.mean() < n_steps
    assert not np.array_equal(port_occ.numpy(), occ0)
    # parity (e) and the net charge, on the port's own trajectory
    theta = torch.as_tensor(port.natural_parameters)
    exact = port.compute_features(port_occ) @ theta
    assert float((enth - exact).abs().max()) < 1e-9
    sites = np.arange(port.num_sites)
    np.testing.assert_array_equal(port.site_charges[sites, port_occ.numpy()].sum(axis=1),
                                  port.site_charges[sites, occ0].sum(axis=1))
    return slack, len(seeds), ref_nacc


@pytest.mark.parametrize("cell,W,n_steps", [((1, 1, 1), 64, 400), ((2, 2, 2), 8, 150)],
                         ids=["1x1x1", "2x2x2"])
def test_trajectory_parity_spinel_ewald(cell, W, n_steps, monkeypatch):
    """(c) on the spinel CE + Ewald: two recolorings, the Ewald term on each."""
    slack, n_chunks, _ = _trajectory_parity("spinel_ewald", cell, W, n_steps, 1000.0, 0,
                                            monkeypatch)
    assert 0.0 < slack < 1e-4 and n_chunks == 1


def test_trajectory_parity_multi_slot(monkeypatch):
    """(c) on the rocksalt whose moves recolor up to three sites."""
    slack, n_chunks, _ = _trajectory_parity("lmof", (2, 2, 2), 32, 400, 1000.0, 1,
                                            monkeypatch, pad_to=4)
    assert slack == 0.0 and n_chunks == 1


def test_trajectory_parity_across_chunk_boundary(monkeypatch):
    """(c) over 1100 steps of a two-slot table: chunks of 2048 // 2 steps, the
    step index counted within the chunk and the next chunk's seed."""
    _, n_chunks, nacc = _trajectory_parity("limn_tiny", None, 8, 1100, 2000.0, 2,
                                           monkeypatch)
    assert n_chunks == 2 and np.median(nacc) > 100  # (a stuck start never moves)


def test_multi_slot_reference_faults():
    """Why the multi-slot parity case pads to four slots: the reference's
    chain refuses an odd slot count."""
    ref, usher, _ = _systems("lmof", (2, 2, 2))
    sampler = Sampler.from_ensemble(ref, temperature=1000.0, nwalkers=8, seed=3,
                                    step_type="table-flip")
    ref_tables, _, ref_tm = sampler.mckernel._get_chain_tables()
    assert ref_tm.k_max == 3
    state = dict(sampler.setup_sample(random_occupancies(ref, 8, 0)))
    state.pop("words", None)
    state["occupancy"] = jnp.asarray(random_occupancies(ref, 8, 0))
    fn = pallas_chain.make_shared_proposal_chain(
        ref_tables, 20, block_size=8, interpret=True, move="table", table_move=ref_tm)
    with pytest.raises(IndexError):
        fn(state, jax.random.key(0))


def test_tableflip_averages_match_enumeration():
    """(d): the tiny cell's neutral manifold, T = 2000 K."""
    system = load_system(data_path("limn_tiny_2x1x1"))
    port = TorchEnsemble.from_system(system, "cpu")
    temperature = 2000.0
    beta = 1.0 / (kB * temperature)
    n = port.num_sites
    charges, sites = port.site_charges, np.arange(n)
    active = sorted(s for sl in port.sublattices if sl.is_active for s in sl.sites)
    n_codes = {s: len(sl.encoding) for sl in port.sublattices for s in sl.sites}
    states = []
    for bits in product(*(range(n_codes[s]) for s in active)):
        occu = np.zeros(n, dtype=np.int32)
        occu[active] = bits
        if charges[sites, occu].sum() == 0:
            states.append(occu)
    states = np.array(states)
    assert len(states) >= 4, "manifold too small to be a meaningful test"
    h = (port.compute_features(torch.as_tensor(states))
         @ torch.as_tensor(port.natural_parameters)).numpy()
    weights = np.exp(-beta * (h - h.min()))
    exact = float(h @ weights / weights.sum())

    W = 32
    sampler = TorchSampler.from_ensemble(port, temperature, W, seed=23, device="cpu",
                                         step_type="table-flip", chain_block_size=4)
    sampler.run(4000, states[0], thin_by=20)
    occs = sampler.samples.get_occupancies(flat=True)
    assert np.all(charges[sites, occs].sum(axis=1) == 0)
    assert len(np.unique(occs, axis=0)) > 4
    mc_mean = float(sampler.samples.mean_enthalpy(discard=50))
    enth = sampler.samples.get_enthalpies(discard=50)
    sem = np.sqrt(sampler.samples.enthalpy_variance(discard=50) / enth.shape[0])
    assert abs(mc_mean - exact) < max(30 * sem, 2e-2), (mc_mean, exact, sem)


def test_sampler_keeps_charge_and_parity_e():
    """(e) and neutrality through ``Sampler.run`` on the committed system."""
    system = load_system(data_path("spinel_ewald_sgc_2x2x2"))
    port = TorchEnsemble.from_system(system, "cpu")
    W, nsteps, thin = 16, 400, 100
    sampler = TorchSampler.from_ensemble(port, 1000.0, W, seed=3, device="cpu",
                                         step_type="table-flip", chain_block_size=8)
    assert sampler.execution_path(thin) == "cpu-twin[table]+ewald+direct+shared-proposals"
    sampler.run(nsteps, system["initial_occupancy"], thin_by=thin)
    occ = sampler.samples.get_occupancies(flat=False)  # [S, W, N]
    assert occ.shape == (nsteps // thin, W, port.num_sites)
    net = port.site_charges[np.arange(port.num_sites), occ].sum(axis=-1)
    assert np.all(net == 0)
    assert np.all((occ[-1] != system["initial_occupancy"]).any(axis=1))  # all moved
    feats = sampler.samples.get_feature_vectors()
    enth = sampler.samples.get_enthalpies()
    assert np.abs(feats @ port.natural_parameters - enth).max() < 1e-9
    assert 0 < sampler.efficiency() < 0.5  # most proposals are identities
    assert "nmove" not in sampler._state


def test_table_flip_device_and_refusals():
    system = load_system(data_path("spinel_ewald_sgc_2x2x2"))
    port = TorchEnsemble.from_system(system, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchSampler.from_ensemble(port, 1000.0, 4, seed=1, step_type="table-flip")
    # the default step type stays the single flip
    default = TorchSampler.from_ensemble(port, 1000.0, 4, seed=1, device="cpu")
    assert default.execution_path(10).startswith("cpu-twin[flip]+ewald")
    # a system without a flip table cannot take table flips yet
    bare = TorchEnsemble.from_system(load_system(data_path("spinel_ewald_2x2x2")), "cpu")
    with pytest.raises(NotImplementedError, match="item 1"):
        TorchSampler.from_ensemble(bare, 1000.0, 4, seed=1, device="cpu",
                                   step_type="table-flip")
    sweep = TorchSampler.from_ensemble(port, 1000.0, 4, seed=1, device="cpu",
                                       step_type="table-flip", proposal_mode="sweep")
    with pytest.raises(ValueError, match="sweep"):
        sweep.run(10, system["initial_occupancy"], thin_by=10)
    kernel = _port_kernel(port)
    with pytest.raises(ValueError, match="table_move"):
        chain.make_shared_proposal_chain(kernel.chain_tables(), 10, move="table")
    with pytest.raises(ValueError, match="table_move"):
        chain.make_shared_proposal_chain(kernel.chain_tables(), 10, move="flip",
                                         table_move=kernel.table_move())


def test_table_wrapper_runs_twin_on_cpu_and_checks_operands():
    _, _, port = _systems("lmof", (2, 2, 2))
    kernel = _port_kernel(port)
    tables, tm = kernel.chain_tables(), kernel.table_move()
    W = 8
    occu = torch.as_tensor(random_occupancies(port, W, 2))
    dirs, ranks = chain.table_sequences(tables, tm, torch.Generator().manual_seed(0), (1, 60))
    ops = dict(
        occ=occu[:, tables.rank_sites].T.to(torch.int8).contiguous(),
        enthalpy=torch.zeros(W, dtype=torch.float64),
        naccept=torch.zeros(W, dtype=torch.int32),
        beta32=torch.full((W,), 5.0, dtype=torch.float32),
        dirs=dirs, ranks=ranks, seed=torch.zeros(1, dtype=torch.int64),
        tables=tables, table_move=tm, n_steps=60, block_size=8,
    )
    before = chain.table_chain.launches
    chain.table_chain(**ops)
    assert chain.table_chain.launches == before  # the twin is not a launch
    assert int(ops["naccept"].sum()) > 0
    for name, bad in (
        ("ranks", ops["ranks"][..., :2].contiguous()),
        ("ranks", ops["ranks"].to(torch.int64)),
        ("dirs", ops["dirs"][:, :5].contiguous()),
        ("occ", ops["occ"].to(torch.int32)),
    ):
        with pytest.raises(ValueError):
            chain.table_chain(**{**ops, name: bad})
    # shared memory: two buffers of k_max row sets and the block's codes
    L, K = tables.nbr.shape[1:]
    row_set = -(-(L * tables.g.shape[2] * 8 + L * (2 * K + 1) * 4) // 16) * 16
    assert chain.table_chain_shared_bytes(tables, tm.k_max, W, 8) == (
        2 * tm.k_max * row_set + tables.num_ranks * 64)
