"""The port's per-step TableFlip against smol_tpu's, and against enumeration.

Where the reference's kernels leave the table chain they take the usher's
per-step proposal (``TableFlip.device_proposal``) and its a-priori factor
(``device_log_priori``, the detailed balance of every charge-neutral run on
that path).  Here, on the CPU, with inputs from numpy seeds:

- ``device_log_priori`` equals the reference's on the same (occupancy,
  sites, codes, valid) batch within 1e-12 absolute, on the rocksalt of up
  to three recolorings (``torch_lmof_2x2x2.npz``) and on the tiny
  {Li+, vacancy} x {Mn3+, Mn4+} cell (``torch_limn_tiny_2x1x1.npz``), for
  the port's own proposals and for the reversed ones;
- every proposal from a neutral occupancy keeps the charge neutral and the
  species counts within the active sites (``max_n``);
- each signed direction's share of 20000 proposals from one occupancy (and
  the share of swaps) is within 5 standard errors of the reference's
  ``device_proposal`` from the same occupancy, and so is each active
  site's share of the removed sites;
- per-step table flips (``shared_proposals=False``), then with 2
  restricted sites, match the exact Boltzmann average over the reachable
  neutral states of the tiny cell at the tolerance of the reference's
  ``test_tableflip_sgc_matches_enumeration`` (``max(10 se, 2e-3)`` eV).
"""

import functools
import sys
from itertools import product
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smol_tpu.capp.generate.random import generate_random_ordered_occupancy
from smol_tpu.moca.kernel.tableflip import TableFlip
from smol_tpu_torch.constants import kB
from smol_tpu_torch.moca.ensemble import Ensemble as TorchEnsemble
from smol_tpu_torch.moca.kernel.tableflip import TableFlip as TorchTableFlip
from smol_tpu_torch.moca.occu_utils import get_dim_ids_table
from smol_tpu_torch.moca.sampler.sampler import Sampler as TorchSampler
from smol_tpu_torch.system import load_system

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from export_torch_systems import data_path, limn_tiny_ensemble, lmof_ensemble  # noqa: E402

SYSTEMS = {"lmof_2x2x2": lmof_ensemble, "limn_tiny_2x1x1": limn_tiny_ensemble}
PRIORI_TOL = 1e-12  # absolute, on the log a-priori factor
SE_LIMIT = 5.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module's runs: the per-step path's small
    operations run no faster on more, and far slower when the test
    workers' threads oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _pair(stem):
    """(reference ensemble, its usher, port ensemble, its usher), the port's
    from the committed file."""
    ref = SYSTEMS[stem]()
    port = TorchEnsemble.from_system(load_system(data_path(stem)), "cpu")
    mine = TorchTableFlip(port.sublattices, **port.table_data)
    theirs = TableFlip(ref.sublattices)
    np.testing.assert_array_equal(mine.flip_table, theirs.flip_table)
    np.testing.assert_array_equal(mine.max_n, theirs.max_n)
    np.testing.assert_array_equal(mine._dim_ids_table, theirs._dim_ids_table)
    np.testing.assert_array_equal(mine._dim_ids_full, theirs._dim_ids_full)
    return ref, theirs, port, mine


def _neutral(ref, count, seed):
    rng = np.random.default_rng(seed)
    return np.stack([generate_random_ordered_occupancy(ref.processor, charge_neutral=True,
                                                       rng=rng) for _ in range(count)])


def _net_charge(port, occ):
    return port.site_charges[np.arange(port.num_sites), occ].sum(axis=-1)


def _applied(occ, sites, codes, valid):
    out = occ.copy()
    for w in range(len(out)):
        for s, c, v in zip(sites[w], codes[w], valid[w]):
            if v:
                out[w, s] = c
    return out


@pytest.mark.parametrize("stem", sorted(SYSTEMS))
def test_log_priori_equals_reference(stem):
    ref, theirs, port, mine = _pair(stem)
    occ = _neutral(ref, 64, seed=1)
    propose, width = mine.device_proposal("cpu")
    generator = torch.Generator().manual_seed(2)
    sites, codes, valid, _ = (t if isinstance(t, float) else t.numpy() for t in
                              propose(torch.as_tensor(occ), generator))
    assert sites.shape == (64, width)
    after = _applied(occ, sites, codes, valid)
    # the reverse of each step, from the occupancy it leaves
    back_codes = np.take_along_axis(occ, sites, axis=1)
    occs = np.concatenate([occ, after])
    batch = (np.concatenate([sites, sites]), np.concatenate([codes, back_codes]),
             np.concatenate([valid, valid]))
    port_lp = mine.device_log_priori("cpu")(*(torch.as_tensor(a) for a in (occs, *batch)))
    ref_lp = jax.jit(jax.vmap(theirs.device_log_priori()))(*(jnp.asarray(a) for a in (occs, *batch)))
    ref_lp = np.asarray(ref_lp)
    assert np.isfinite(ref_lp).all()
    np.testing.assert_allclose(port_lp.numpy(), ref_lp, rtol=0, atol=PRIORI_TOL)
    moved = valid.any(axis=1) & (after != occ).any(axis=1)
    flips = np.abs(ref_lp[:64]) > 0
    assert flips.sum() >= 8 and moved.sum() >= 16  # flips and swaps both present
    # detailed balance: the reverse step's factor is minus the forward one's
    np.testing.assert_allclose(ref_lp[64:][moved], -ref_lp[:64][moved], atol=1e-12)


@pytest.mark.parametrize("stem", sorted(SYSTEMS))
def test_proposals_keep_charge_and_counts(stem):
    ref, _, port, mine = _pair(stem)
    occ = _neutral(ref, 256, seed=3)
    propose, _ = mine.device_proposal("cpu")
    generator = torch.Generator().manual_seed(4)
    table = get_dim_ids_table(port.sublattices, active_only=True)
    max_n = np.asarray(mine.max_n)
    work = torch.as_tensor(occ)
    for _ in range(20):
        sites, codes, valid, _ = propose(work, generator)
        for w in range(len(work)):
            used = sites[w][valid[w]]
            assert len(torch.unique(used)) == len(used)  # no site twice
        work = torch.as_tensor(_applied(work.numpy(), sites.numpy(), codes.numpy(),
                                        valid.numpy()))
        now = work.numpy()
        assert np.all(_net_charge(port, now) == 0)
        dims = table[np.arange(port.num_sites), now]
        counts = np.stack([(dims == d).sum(axis=1) for d in range(mine.d)], axis=1)
        assert np.all(counts <= max_n) and np.all(counts >= 0)


def _direction_of(mine, occ, sites, codes, valid):
    """Per proposal: the signed direction index, 2F for a swap (no count
    change)."""
    table = mine._dim_ids_table
    directions = np.concatenate([(u, -u) for u in mine.flip_table])
    dims = np.arange(mine.d)
    gained = (table[sites, codes][..., None] == dims) & valid[..., None]
    lost = (table[sites, occ[sites]][..., None] == dims) & valid[..., None]
    dn = gained.sum(axis=1) - lost.sum(axis=1)  # [n, D]
    hits = (directions[None] == dn[:, None, :]).all(axis=2)  # [n, 2F]
    return np.where(hits.any(axis=1), hits.argmax(axis=1), len(directions))


def _within(mine_counts, their_counts, n, what):
    p1, p2 = mine_counts / n, their_counts / n
    pooled = (mine_counts + their_counts) / (2 * n)
    se = np.sqrt(np.maximum(pooled * (1 - pooled), 1.0 / n) * 2 / n)
    worst = float(np.max(np.abs(p1 - p2) / se))
    assert worst < SE_LIMIT, (what, p1, p2, worst)


@pytest.mark.parametrize("stem", sorted(SYSTEMS))
def test_direction_frequencies_match_reference(stem):
    ref, theirs, port, mine = _pair(stem)
    occ = _neutral(ref, 1, seed=5)[0]
    n = 20000
    propose, _ = mine.device_proposal("cpu")
    out = propose(torch.as_tensor(np.tile(occ, (n, 1))), torch.Generator().manual_seed(6))
    p_sites, p_codes, p_valid = (t.numpy() for t in out[:3])
    ref_propose, _ = theirs.device_proposal()
    keys = jax.random.split(jax.random.key(7), n)
    r_sites, r_codes, r_valid, _ = (np.asarray(a) for a in jax.jit(jax.vmap(
        lambda k: ref_propose(k, jnp.asarray(occ))))(keys))
    n_dirs = 2 * len(mine.flip_table) + 1
    mine_dirs = np.bincount(_direction_of(mine, occ, p_sites, p_codes, p_valid),
                            minlength=n_dirs)
    their_dirs = np.bincount(_direction_of(mine, occ, r_sites, r_codes, r_valid),
                             minlength=n_dirs)
    assert their_dirs[:-1].sum() > n // 2  # most proposals flip
    _within(mine_dirs, their_dirs, n, "directions")
    # which sites a flip removes: uniform within each dimension in both
    flip_p = _direction_of(mine, occ, p_sites, p_codes, p_valid) < n_dirs - 1
    flip_r = _direction_of(mine, occ, r_sites, r_codes, r_valid) < n_dirs - 1
    mine_sites = np.bincount(p_sites[flip_p][p_valid[flip_p]], minlength=port.num_sites)
    their_sites = np.bincount(r_sites[flip_r][r_valid[flip_r]], minlength=port.num_sites)
    _within(mine_sites, their_sites, n, "sites")


def _reachable_states(port, usher, start, pinned):
    """The neutral occupancies whose active counts the flip table reaches
    from ``start``'s, with the pinned sites at their start codes."""
    n = port.num_sites
    table = get_dim_ids_table(port.sublattices, active_only=True)
    codes = {s: sl.encoding for sl in port.sublattices for s in sl.sites}
    states = []
    for bits in product(*(codes[s] for s in range(n))):
        occ = np.array(bits, dtype=np.int32)
        if _net_charge(port, occ) == 0 and np.all(occ[pinned] == start[pinned]):
            states.append(occ)

    def count(occ):
        dims = table[np.arange(n), occ]
        return tuple(int((dims == d).sum()) for d in range(usher.d))

    reach, frontier = {count(start)}, [np.array(count(start))]
    while frontier:
        cur = frontier.pop()
        for u in usher.flip_table:
            for sign in (1, -1):
                nxt = cur + sign * u
                if np.all(nxt >= 0) and np.all(nxt <= usher.max_n) and tuple(nxt) not in reach:
                    reach.add(tuple(nxt))
                    frontier.append(nxt)
    return np.array([s for s in states if count(s) in reach])


@pytest.mark.parametrize("pinned", [(), (0, 2)], ids=["all-active", "two-restricted"])
def test_per_step_table_flips_match_enumeration(pinned):
    port = TorchEnsemble.from_system(load_system(data_path("limn_tiny_2x1x1")), "cpu")
    temperature = 3000.0
    beta = 1.0 / (kB * temperature)
    start = np.array([0, 1, 0, 1, 0, 0, 0, 0], dtype=np.int32)  # Li, vac; Mn3+, Mn4+
    assert _net_charge(port, start) == 0
    port.restrict_sites(list(pinned))
    sampler = TorchSampler.from_ensemble(port, temperature, 48, seed=5, device="cpu",
                                         step_type="table-flip", shared_proposals=False)
    usher = sampler.mckernel.mcusher
    assert sampler.execution_path(10) == "cpu-step[table-flip]+general+independent-proposals"
    states = _reachable_states(port, usher, start, list(pinned))
    assert len(states) >= 2
    h = (port.compute_features(torch.as_tensor(states))
         @ torch.as_tensor(port.natural_parameters)).numpy()
    w = np.exp(-beta * (h - h.min()))
    exact = float(h @ w / w.sum())
    sampler.run(2000, start, thin_by=10)
    occs = sampler.samples.get_occupancies()
    assert np.all(_net_charge(port, occs) == 0)
    assert np.all(occs[:, list(pinned)] == start[list(pinned)])
    assert len(np.unique(occs, axis=0)) == len(states)  # every reachable state visited
    enth = sampler.samples.get_enthalpies(discard=20)
    mc_mean = float(sampler.samples.mean_enthalpy(discard=20))
    sem = np.sqrt(sampler.samples.enthalpy_variance(discard=20) / enth.shape[0])
    assert abs(mc_mean - exact) < max(10 * sem, 2e-3), (mc_mean, exact, sem)
    feats = sampler.samples.get_feature_vectors()
    assert np.abs(feats @ port.natural_parameters - sampler.samples.get_enthalpies()).max() < 1e-9
