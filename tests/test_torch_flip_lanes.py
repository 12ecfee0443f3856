"""The flip kernel's lanes (K1), through its twin, on the CPU.

The kernel splits each walker's step over G threads (lanes): lane j sums
rows j, j + G, ... of the proposal rank's rows and the lanes' partials
meet in a butterfly, so G sets the order of the delta's sums; the twin
(``ops/chain.py:flip_chain_reference``) takes the same G for the same
launch (``flip_lanes``) and repeats that order.

- (a) At G = 2, 4, 8 and 16 the twin, and the chain factory that the
  sampler runs fed the same draws, meets the interpret-mode Pallas
  reference under the rule of ``test_torch_chain.py``
  (``_trajectory_parity``): a walker may differ only where the twin shows
  one of its decisions within ``ULP_SLACK = 4`` f32 ulps of log U, at
  least 90 % of the walkers are equal, and the equal walkers' accept
  counts agree exactly and their enthalpies to 1e-9 absolute.  The bench
  spinel 2x2x2 with K1-Ising (64 walkers, 300 steps, blocks of 64) and
  bench ``sgc`` 3x3x3 with K3 (q = 3) and with the direct body (64
  walkers, 200 steps, blocks of 32); the factory equals the twin loop bit
  for bit.
- (b) At one lane the twin equals the twin recorded before lanes existed,
  bit for bit (``torch_flip_twin_one_lane.npz``): K1-Ising on both
  spinels and with the Ewald term, K3 with q = 2 (Ewald), 3 and 4, the
  direct body with the Ewald term, on ``sgc`` and on Au-Cu 3x3x3, in both
  RNG modes.
- (c) The launch plan from shapes: the lanes for a walker count and a
  site body, a block inside one sequence group, every rank's rows
  resident where they fit beside the codes and the launch runs a step a
  rank, and a raise where a forced plan does not fit; the CPU wrapper sums
  at the plan's lanes.
- (d) K3's flip delta at G lanes equals a full recompute of features .
  theta on ``sgc`` 3x3x3, for every rank and two proposals, to 1e-12 of
  the energy scale (f64 roundoff), as at one lane.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from smol_tpu.moca import Sampler
from smol_tpu.ops import pallas_chain
from smol_tpu_torch.moca.ensemble import Ensemble as TorchEnsemble
from smol_tpu_torch.moca.ensemble import random_occupancies
from smol_tpu_torch.ops import chain
from smol_tpu_torch.system import export_system, load_system

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from export_torch_systems import data_path, sgc_ensemble, spinel_ensemble  # noqa: E402
from test_torch_chain import _port_with_margins, _reference_draws  # noqa: E402

ULP_SLACK = 4
ONE_LANE_FILE = Path(__file__).resolve().parent / "data" / "torch_flip_twin_one_lane.npz"
# record key -> (system file stem, site body); 24 walkers in sequence blocks
# of 8, 120 steps
RECORDED = {
    "spinel2_ising": ("spinel_2x2x2", "ising"),
    "spinel3_ising": ("spinel_3x3x3", "ising"),
    "ewald_ising": ("spinel_ewald_2x2x2", "ising"),
    "ewald_direct": ("spinel_ewald_2x2x2", "direct"),
    "ewald_qary": ("spinel_ewald_2x2x2", "qary"),
    "sgc_direct": ("sgc_3x3x3", "direct"),
    "sgc_qary": ("sgc_3x3x3", "qary"),
    "q4_qary": ("rocksalt_q4_2x2x2", "qary"),
    "pt_direct": ("aucu_pt_3x3x3", "direct"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors, so that parallel test
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tables(port, delta):
    tables = chain.build_chain_tables(port.processor, port.sublattices,
                                      mu_table=port.chemical_potential_table, delta=delta)
    assert tables.delta == delta
    return tables


def _file_tables(stem, delta):
    return _tables(TorchEnsemble.from_system(load_system(data_path(stem)), "cpu"), delta)


@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize("case", sorted(RECORDED))
def test_one_lane_twin_equals_recorded_twin(case, rng):
    """At one lane the twin sums every row in order, as it did before the
    kernel had lanes: from the recorded start, the end equals the recorded
    end on every walker, bit for bit.

    ``torch_flip_twin_one_lane.npz`` holds, per case and RNG mode, the
    operands (``random_occupancies(ensemble, 24, 5)`` on the system file's
    ensemble, their exact enthalpies, f32 betas of a geometric ladder over
    300-3000 K, a ``rank_sequence`` from a generator seeded 9 in sequence
    blocks of 8, the launch seed 987654321 (hash) or 0x2545F4914F6CDD1D
    (philox)) and the end that ``flip_chain_reference`` of commit 7c1a268
    (the twin before lanes, which takes no ``lanes``) reached from them in
    120 steps.  It is that twin's record: written anew by this twin, the
    test would compare the twin with itself."""
    stem, delta = RECORDED[case]
    data = np.load(ONE_LANE_FILE)
    key = f"{case}_{rng}"
    occ = torch.as_tensor(data[f"{key}_in_occ"]).clone()
    enthalpy = torch.as_tensor(data[f"{key}_in_enthalpy"]).clone()
    naccept = torch.zeros(occ.shape[1], dtype=torch.int32)
    chain.flip_chain_reference(occ, enthalpy, naccept,
                               torch.as_tensor(data[f"{key}_in_beta32"]),
                               torch.as_tensor(data[f"{key}_in_seq"]),
                               torch.as_tensor(data[f"{key}_in_seed"]),
                               _file_tables(stem, delta), 120, 8, rng, lanes=1)
    assert torch.equal(occ, torch.as_tensor(data[f"{key}_out_occ"]))
    assert torch.equal(enthalpy, torch.as_tensor(data[f"{key}_out_enthalpy"]))
    assert torch.equal(naccept, torch.as_tensor(data[f"{key}_out_naccept"]))
    assert 0 < int(naccept.sum()) < naccept.numel() * 120


# (a): the reference runs once per cell; the port's twin at each G

CELLS = {  # cell -> (reference ensemble factory, walkers, steps, block, temperature, seed)
    "spinel": (lambda: spinel_ensemble(2), 64, 300, 64, 1000.0, 0),
    "sgc": (lambda: sgc_ensemble(3), 64, 200, 32, 800.0, 2),
}
_REFERENCE = {}


def _reference(cell):
    """The interpret-mode reference chain on ``cell`` from random starts,
    with the wrapper's own draws (pallas_chain :2040-2091)."""
    if cell not in _REFERENCE:
        factory, W, n_steps, block, temperature, seed = CELLS[cell]
        ref = factory()
        sampler = Sampler.from_ensemble(ref, temperature=temperature, nwalkers=W, seed=3)
        occ0 = random_occupancies(ref, W, seed)
        state = dict(sampler.setup_sample(occ0))
        state.pop("words", None)
        state["occupancy"] = jax.numpy.asarray(occ0)
        ref_tables = pallas_chain.build_chain_tables(
            ref.processor, ref.sublattices, mu_table=ref.chemical_potential_table)
        key = jax.random.key(seed)
        seqs, seeds = _reference_draws(ref_tables, key, n_steps, W, block)
        out = pallas_chain.make_shared_proposal_chain(
            ref_tables, n_steps, block_size=block, interpret=True)(state, key)
        _REFERENCE[cell] = dict(
            port=TorchEnsemble.from_system(export_system(ref), "cpu"), occ0=occ0,
            enthalpy=torch.tensor(np.array(state["enthalpy"])),
            beta=torch.tensor(np.array(state["beta"])), seqs=seqs, seeds=seeds,
            out={k: np.asarray(out[k]) for k in ("occupancy", "enthalpy", "naccept")})
    return _REFERENCE[cell]


@pytest.mark.parametrize("lanes", [2, 4, 8, 16])
@pytest.mark.parametrize("cell,delta", [("spinel", "ising"), ("sgc", "qary"),
                                        ("sgc", "direct")])
def test_lanes_match_interpret_reference(monkeypatch, cell, delta, lanes):
    """(a): the twin and the chain factory at G lanes against the reference."""
    monkeypatch.setattr(chain, "_FLIP_DESIGN", chain._FlipDesign(lanes=lanes))
    r = _reference(cell)
    _, W, n_steps, block, _, _ = CELLS[cell]
    tables = _tables(r["port"], delta)
    assert chain.flip_lanes(tables, W) == lanes
    occ, enth, nacc, margin = _port_with_margins(
        tables, torch.as_tensor(r["occ0"]), r["enthalpy"], r["beta"], r["seqs"],
        r["seeds"], n_steps, block)

    # the chain factory, fed the same draws, is the twin loop exactly
    state = {"occupancy": torch.as_tensor(r["occ0"]).clone(),
             "enthalpy": r["enthalpy"].clone(), "beta": r["beta"],
             "naccept": torch.zeros(W, dtype=torch.int32),
             "accepted": torch.ones(W, dtype=torch.bool)}
    state = chain.make_shared_proposal_chain(
        tables, n_steps, block_size=block, rng="hash", seqs=r["seqs"],
        seeds=r["seeds"])(state, None)
    assert torch.equal(state["occupancy"], occ)
    assert torch.equal(state["enthalpy"], enth)
    assert torch.equal(state["naccept"], nacc)

    out = r["out"]
    same = np.all(occ.numpy() == out["occupancy"], axis=1)
    for w in np.flatnonzero(~same):
        assert margin[w] <= ULP_SLACK, (w, float(margin[w]))
    assert same.mean() >= 0.9, same.mean()
    np.testing.assert_array_equal(nacc.numpy()[same], out["naccept"][same])
    np.testing.assert_allclose(enth.numpy()[same], out["enthalpy"][same], rtol=0, atol=1e-9)
    assert 0 < out["naccept"].mean() < n_steps


# (c): the launch plan

@pytest.mark.parametrize("walkers,lanes", [(1, 16), (64, 16), (2048, 16), (2049, 16),
                                           (4096, 8), (8192, 4), (16384, 2), (32768, 1),
                                           (40960, 1)])
def test_lane_rule(walkers, lanes):
    """The fewest lanes (at most 16) that give the launch 32768 threads
    with the direct body and 65536 with K3 and K1-Ising; a design's lanes
    where it names them."""
    direct = _file_tables("spinel_2x2x2", "direct")
    assert chain.flip_lanes(direct, walkers) == lanes
    for delta in ("ising", "qary"):
        other = _file_tables("spinel_2x2x2", delta)
        assert chain.flip_lanes(other, walkers) == min(16, 2 * lanes)
    assert chain.flip_lanes(direct, walkers, chain._FlipDesign(lanes=2)) == 2
    plan = chain.flip_launch_plan(direct, walkers, 1024, 100)
    assert plan.lanes == lanes
    assert plan.walkers_per_block * lanes <= chain.LANE_BLOCK_THREADS


@pytest.mark.parametrize("walkers,block_size", [(200, 8), (1000, 96), (1000, 100),
                                                (300, 3), (8192, 1024), (8192, 40),
                                                (600, 1000)])
@pytest.mark.parametrize("lanes", [1, 4, 16])
def test_block_lies_in_one_sequence_group(walkers, block_size, lanes):
    """Every CUDA block's walkers share one sequence group (walker //
    block_size), also for sequence blocks that do not divide 256."""
    tables = _file_tables("spinel_2x2x2", "ising")
    design = chain._FlipDesign(lanes=lanes)
    plan = chain.flip_launch_plan(tables, walkers, block_size, 100, design)
    wpb = plan.walkers_per_block
    assert wpb * plan.lanes <= chain.LANE_BLOCK_THREADS
    first = np.arange(0, walkers, wpb)
    last = np.minimum(first + wpb, walkers) - 1
    assert ((first // block_size) == (last // block_size)).all()
    assert plan.blocks(walkers) == len(first)


def test_launch_plan_from_shapes():
    """Every rank's rows resident where they fit beside the codes and the
    launch runs at least one step a rank: the K1-Ising rows of the spinel
    2x2x2 (48 ranks of 944 B), also with the Ewald row (48 x 1328 B), of
    Au-Cu 3x3x3 (27 x 1840 B) on a 100-step window but not on bench
    tempering's 10-step segments, and K3's rows of the q = 4 rocksalt;
    streamed for the spinel 3x3x3's three-word rows (162 ranks) and
    ``sgc`` 6x6x6's K3 and direct rows (216 ranks of 12096 and 25376 B); a
    design that asks for rows that do not fit raises."""
    W, block = 8192, 1024
    spinel = _file_tables("spinel_2x2x2", "ising")
    assert chain._row_set_bytes(spinel) == 944
    plan = chain.flip_launch_plan(spinel, W, block, 100)
    assert (plan.lanes, plan.walkers_per_block, plan.resident) == (8, 32, True)
    assert plan.blocks(W) == 256
    assert plan.shared_bytes == 48 * 944 + 48 * 36  # 48 code rows of 36 B
    assert not chain.flip_launch_plan(spinel, W, block, 47).resident
    ewald = _file_tables("spinel_ewald_2x2x2", "ising")
    assert chain._row_set_bytes(ewald) == 1328
    assert chain.flip_launch_plan(ewald, W, block, 100).resident
    aucu = _file_tables("aucu_pt_3x3x3", "ising")
    assert chain.flip_launch_plan(aucu, W, block, 100).resident
    assert not chain.flip_launch_plan(aucu, W, block, 10).resident
    assert chain.flip_launch_plan(aucu, W, block, 10, chain._FlipDesign(resident=True)).resident
    assert chain.flip_launch_plan(_file_tables("rocksalt_q4_2x2x2", "qary"), W, block,
                                  100).resident
    assert not chain.flip_launch_plan(_file_tables("spinel_3x3x3", "ising"), W, block,
                                      100).resident
    sgc = TorchEnsemble.from_system(load_system(data_path("sgc_6x6x6")), "cpu")
    for delta, row_bytes, lanes, pitch in (("qary", 12096, 8, 36), ("direct", 25376, 4, 68)):
        tables = _tables(sgc, delta)
        assert chain._row_set_bytes(tables) == row_bytes
        streamed = chain.flip_launch_plan(tables, W, block, 100)
        assert (streamed.lanes, streamed.resident) == (lanes, False)
        assert streamed.shared_bytes == 2 * row_bytes + 216 * pitch
        with pytest.raises(ValueError, match="shared memory"):
            chain.flip_launch_plan(tables, W, block, 100, chain._FlipDesign(resident=True))
    streamed = chain.flip_launch_plan(spinel, W, block, 100, chain._FlipDesign(resident=False))
    assert not streamed.resident and streamed.shared_bytes == 2 * 944 + 48 * 36


def test_cpu_wrapper_sums_at_the_plan_lanes():
    """The CPU wrapper runs the twin at the lanes the kernel would take for
    the same launch: bit for bit the twin at ``flip_lanes``, for the
    default and for a design."""
    tables = _file_tables("sgc_3x3x3", "qary")
    port = TorchEnsemble.from_system(load_system(data_path("sgc_3x3x3")), "cpu")
    W, block, n_steps = 48, 16, 60
    occu = torch.as_tensor(random_occupancies(port, W, 4))
    gen = torch.Generator().manual_seed(3)
    ops = dict(occ=occu[:, tables.rank_sites].T.to(torch.int8).contiguous(),
               enthalpy=torch.zeros(W, dtype=torch.float64),
               naccept=torch.zeros(W, dtype=torch.int32),
               beta32=torch.full((W,), 5.0, dtype=torch.float32),
               seq=chain.rank_sequence(tables, gen, (W // block, n_steps)),
               seed=torch.tensor([77], dtype=torch.int64), tables=tables,
               n_steps=n_steps, block_size=block)
    for design, lanes in ((None, chain.flip_lanes(tables, W)),
                          (chain._FlipDesign(lanes=2), 2)):
        wrapper = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in ops.items()}
        twin = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in ops.items()}
        chain.flip_chain(**wrapper, _design=design)
        chain.flip_chain_reference(**twin, lanes=lanes)
        for key in ("occ", "enthalpy", "naccept"):
            assert torch.equal(wrapper[key], twin[key]), key
        assert int(wrapper["naccept"].sum()) > 0


# (d): K3's delta at G lanes against a full recompute

@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16])
def test_qary_delta_at_lanes_equals_full_recompute(lanes):
    port = TorchEnsemble.from_system(load_system(data_path("sgc_3x3x3")), "cpu")
    tables = _tables(port, "qary")
    theta = torch.as_tensor(port.natural_parameters)
    W = 8
    occu = torch.as_tensor(random_occupancies(port, W, 6))
    occ = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
    e_old = port.compute_features(occu) @ theta
    beta32 = torch.full((W,), 10.0, dtype=torch.float32)
    scale = max(1.0, float(e_old.abs().max()))
    for r in range(tables.num_ranks):
        for draw in range(2):
            u = torch.full((W,), r, dtype=torch.int64)
            r_j = torch.arange(W, dtype=torch.int64) + draw
            _, b, dE, _, _ = chain.flip_step_reference(
                tables, occ, u, torch.zeros(W, dtype=torch.int64), r_j, beta32, lanes)
            new = occu.clone()
            new[:, tables.rank_sites[r]] = b.to(new.dtype)
            exact = port.compute_features(new) @ theta - e_old
            assert float((dE - exact).abs().max()) <= 1e-12 * scale, (r, draw)
