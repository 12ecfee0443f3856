"""The swap kernel's lanes (K2), through its twin, on the CPU.

The kernel splits each walker's swap over G threads (lanes): lane j sums
rows j, j + G, ... of u's rows and then of v's, the lanes' partials
meeting in a butterfly, and the Ewald dots are split over the lanes the
same way; so G sets the order of the delta's sums, and the twin
(``ops/chain.py:swap_chain_reference``) takes the same for the same launch
(``twin_order``).

- (a) At one lane the twin equals the twin recorded before the kernel had
  lanes, bit for bit (``torch_swap_twin_one_lane.npz``): K1-Ising and the
  direct body on Au-Cu 4x4x4, K1-Ising, the direct body and K3 (q = 2)
  with the Ewald term on the spinel CE + Ewald 2x2x2, K3 (q = 3) and the
  direct body on the ternary 3x3x3, in both RNG modes.
- (b) At G = 2, 4, 8 and 16 the twin, and the chain factory that the
  sampler runs fed the same draws, meet the interpret-mode Pallas reference under the rule of
  ``test_torch_swap.py`` (``_trajectory_parity``): a walker may differ only
  where the twin shows one of its decisions within ``ULP_SLACK = 4`` f32
  ulps of log U beyond beta times the reference's f32 Ewald error, at
  least 90 % of the walkers are equal, the equal walkers' accept counts
  agree exactly and their enthalpies to 1e-9 + naccept * slack, and the
  move counts and compositions exactly.  K1-Ising and the direct body on
  the spinel CE + Ewald 2x1x1 (64 walkers, 200 steps, blocks of 64; the
  reference takes K1-Ising) and K3 on the ternary 3x3x3 (64 walkers, 200
  steps, blocks of 32).
- (c) The launch plan from shapes: lanes and walkers a block, every rank's
  rows resident where they fit beside the codes (the K1-Ising rows of
  Au-Cu 4x4x4 and of the spinel CE + Ewald 2x2x2, K3's of the latter;
  streamed elsewhere), a raise where a forced plan does not fit; the CPU
  wrapper sums at the plan's lanes.
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
from smol_tpu_torch.ops import chain
from smol_tpu_torch.system import load_system

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from export_torch_systems import data_path  # noqa: E402
from test_torch_qary import _system as _qary_system  # noqa: E402
from test_torch_swap import (  # noqa: E402
    _ewald_f32_slack,
    _reference_pair_draws,
    _systems,
)

ULP_SLACK = 4
ONE_LANE_FILE = Path(__file__).resolve().parent / "data" / "torch_swap_twin_one_lane.npz"
# record key -> (system file stem, site body); 24 walkers in sequence blocks
# of 8, 120 steps
RECORDED = {
    "aucu_ising": ("aucu_4x4x4", "ising"),
    "aucu_direct": ("aucu_4x4x4", "direct"),
    "ewald_ising": ("spinel_ewald_2x2x2", "ising"),
    "ewald_direct": ("spinel_ewald_2x2x2", "direct"),
    "ewald_qary": ("spinel_ewald_2x2x2", "qary"),
    "ternary_qary": ("sgc_3x3x3", "qary"),
    "ternary_direct": ("sgc_3x3x3", "direct"),
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
    tables = chain.build_chain_tables(port.processor, port.sublattices, delta=delta)
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

    ``torch_swap_twin_one_lane.npz`` holds, per case and RNG mode, the
    operands (``random_occupancies(ensemble, 24, 5)`` on the system file's
    ensemble, their features . theta, f32 betas of a geometric ladder over
    300-3000 K, a ``rank_pair_sequence`` from a generator seeded 9 in
    sequence blocks of 8, the launch seed 987654321 (hash) or
    0x2545F4914F6CDD1D (philox)) and the end that ``swap_chain_reference``
    of commit 8418ce7 (the twin before lanes, which takes no ``lanes``)
    reached from them in 120 steps.  It is that twin's record: written
    anew by this twin, the test would compare the twin with itself."""
    stem, delta = RECORDED[case]
    data = np.load(ONE_LANE_FILE)
    key = f"{case}_{rng}"
    occ = torch.as_tensor(data[f"{key}_in_occ"]).clone()
    enthalpy = torch.as_tensor(data[f"{key}_in_enthalpy"]).clone()
    naccept = torch.zeros(occ.shape[1], dtype=torch.int32)
    nmove = torch.zeros(occ.shape[1], dtype=torch.int32)
    chain.swap_chain_reference(occ, enthalpy, naccept, nmove,
                               torch.as_tensor(data[f"{key}_in_beta32"]),
                               torch.as_tensor(data[f"{key}_in_useq"]),
                               torch.as_tensor(data[f"{key}_in_vseq"]),
                               torch.as_tensor(data[f"{key}_in_seed"]),
                               _file_tables(stem, delta), 120, 8, rng, lanes=1)
    assert torch.equal(occ, torch.as_tensor(data[f"{key}_out_occ"]))
    assert torch.equal(enthalpy, torch.as_tensor(data[f"{key}_out_enthalpy"]))
    assert torch.equal(naccept, torch.as_tensor(data[f"{key}_out_naccept"]))
    assert torch.equal(nmove, torch.as_tensor(data[f"{key}_out_nmove"]))
    assert 0 < int(naccept.sum()) < int(nmove.sum())


# (b): the reference runs once per cell; the port's twin at each G

CELLS = {  # cell -> (reference and port ensembles, walkers, steps, block, temperature, seed)
    "spinel_ewald": (lambda: _systems("spinel_ewald", (2, 1, 1)), 64, 200, 64, 1000.0, 0),
    "ternary": (lambda: _qary_system("ternary"), 64, 200, 32, 800.0, 2),
}
_REFERENCE = {}


def _reference(cell):
    """The interpret-mode reference swap chain on ``cell`` from random
    starts, with the wrapper's own draws (pallas_chain :2040-2091)."""
    if cell not in _REFERENCE:
        systems, W, n_steps, block, temperature, seed = CELLS[cell]
        ref, port = systems()
        occ0 = random_occupancies(ref, W, seed)
        sampler = Sampler.from_ensemble(ref, temperature=temperature, nwalkers=W, seed=3)
        state = dict(sampler.setup_sample(occ0))
        state.pop("words", None)
        state["occupancy"] = jnp.asarray(occ0)
        ref_tables = pallas_chain.build_chain_tables(ref.processor, ref.sublattices)
        key = jax.random.key(seed)
        useqs, vseqs, seeds = _reference_pair_draws(ref_tables, key, n_steps, W, block)
        out = pallas_chain.make_shared_proposal_chain(
            ref_tables, n_steps, block_size=block, interpret=True, move="swap")(state, key)
        _REFERENCE[cell] = dict(
            port=port, occ0=occ0, enthalpy=torch.tensor(np.array(state["enthalpy"])),
            beta=torch.tensor(np.array(state["beta"])), useqs=useqs, vseqs=vseqs,
            seeds=seeds,
            out={k: np.asarray(out[k]) for k in ("occupancy", "enthalpy", "naccept",
                                                 "nmove")})
    return _REFERENCE[cell]


@pytest.mark.parametrize("lanes", [2, 4, 8, 16])
@pytest.mark.parametrize("cell,delta", [("spinel_ewald", "ising"), ("spinel_ewald", "direct"),
                                        ("ternary", "qary")])
def test_lanes_match_interpret_reference(monkeypatch, cell, delta, lanes):
    """(b): the twin and the chain factory at G lanes against the reference."""
    r = _reference(cell)
    _, W, n_steps, block, _, _ = CELLS[cell]
    tables = _tables(r["port"], delta)
    slack = _ewald_f32_slack(tables)
    assert (slack > 0) == (cell == "spinel_ewald")
    occu = torch.as_tensor(r["occ0"])
    monkeypatch.setattr(chain, "_SWAP_DESIGN", chain._LaneDesign(lanes=lanes))
    order = chain.twin_order("swap", tables, W)
    assert order == {"lanes": lanes}
    occ = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
    enth = r["enthalpy"].clone()
    nacc = torch.zeros(W, dtype=torch.int32)
    nmove = torch.zeros(W, dtype=torch.int32)
    margin = torch.full((W,), float("inf"))
    chain.swap_chain_reference(
        occ, enth, nacc, nmove, r["beta"].to(torch.float32),
        torch.as_tensor(r["useqs"][0]), torch.as_tensor(r["vseqs"][0]),
        torch.tensor([int(r["seeds"][0])]), tables, n_steps, block, "hash",
        margin=margin, slack=slack, **order)
    port_occ = occu.clone()
    port_occ[:, tables.rank_sites] = occ.T.to(port_occ.dtype)

    # the chain factory, fed the same draws, is the twin loop exactly
    state = {"occupancy": occu.clone(), "enthalpy": r["enthalpy"].clone(),
             "beta": r["beta"], "naccept": torch.zeros(W, dtype=torch.int32),
             "accepted": torch.ones(W, dtype=torch.bool),
             "nmove": torch.zeros(W, dtype=torch.int32)}
    state = chain.make_shared_proposal_chain(
        tables, n_steps, block_size=block, rng="hash", move="swap",
        seqs=(r["useqs"], r["vseqs"]), seeds=r["seeds"])(state, None)
    assert torch.equal(state["occupancy"], port_occ)
    assert torch.equal(state["enthalpy"], enth)
    assert torch.equal(state["naccept"], nacc)
    assert torch.equal(state["nmove"], nmove)

    out = r["out"]
    np.testing.assert_array_equal(nmove.numpy(), out["nmove"])
    same = np.all(port_occ.numpy() == out["occupancy"], axis=1)
    for w in np.flatnonzero(~same):
        assert margin[w] <= ULP_SLACK, (w, float(margin[w]))
    assert same.mean() >= 0.9, same.mean()
    np.testing.assert_array_equal(nacc.numpy()[same], out["naccept"][same])
    tol = 1e-9 + nacc.numpy()[same] * slack
    assert np.all(np.abs(enth.numpy()[same] - out["enthalpy"][same]) <= tol)
    assert 0 < out["naccept"].mean() < n_steps
    np.testing.assert_array_equal(np.sort(port_occ.numpy(), axis=1),
                                  np.sort(r["occ0"], axis=1))


# (c): the launch plan

@pytest.mark.parametrize("stem,delta,row_bytes,resident", [
    ("spinel_ewald_2x2x2", "ising", 1328, True),  # 64 KB: three blocks an SM
    ("spinel_ewald_2x2x2", "qary", 2688, False),  # 130 KB: one block an SM, two waves
    ("spinel_ewald_2x2x2", "direct", 6272, False),  # 301 KB: does not fit
    ("spinel_ewald_3x3x3", "ising", 3184, False),
    ("spinel_ewald_3x3x3", "direct", 7184, False),
    ("aucu_4x4x4", "ising", 1840, False),  # 120 KB: two waves
    ("aucu_4x4x4", "qary", 4032, False),
    ("aucu_4x4x4", "direct", 11040, False),
    ("sgc_3x3x3", "qary", 10944, False),
])
def test_launch_plan_from_shapes(stem, delta, row_bytes, resident):
    """Every rank's rows resident where they fit beside the codes, the
    launch runs at least a step a rank (a 100-step window, not a 10-step
    one) and the rows add no wave of blocks over the card's SMs, else two
    buffers of u's and v's rows; 8 lanes at 8192 walkers (``LANE_THREADS``),
    256 threads a block; a design that asks for rows that do not fit raises.  At 4
    lanes (64 walkers a block, 128 blocks: one wave at one block an SM)
    Au-Cu's and the spinel's K3 rows are resident."""
    W, block = 8192, 1024
    tables = _file_tables(stem, delta)
    R = tables.num_ranks
    assert chain._row_set_bytes(tables) == row_bytes
    plan = chain.launch_plan("swap", tables, W, block, 100)
    assert (plan.lanes, plan.walkers_per_block, plan.resident) == (8, 32, resident)
    assert plan.blocks(W) == 256
    codes = -(-R * 36 // 16) * 16
    assert plan.shared_bytes == (R if resident else 4) * row_bytes + codes
    assert not chain.launch_plan("swap", tables, W, block, R - 1).resident
    fits = R * row_bytes + codes <= chain.MAX_SHARED_BYTES
    if not fits:
        with pytest.raises(ValueError, match="shared memory"):
            chain.launch_plan("swap", tables, W, block, 100,
                              design=chain._LaneDesign(resident=True))
    four = chain.launch_plan("swap", tables, W, block, 100,
                             design=chain._LaneDesign(lanes=4))
    assert four.walkers_per_block == 64
    assert four.resident == (fits and R * row_bytes + -(-R * 68 // 16) * 16
                             <= chain.MAX_SHARED_BYTES)
    forced = chain.launch_plan("swap", tables, W, block, 100,
                               design=chain._LaneDesign(lanes=2, resident=False))
    assert (forced.lanes, forced.resident) == (2, False)
    assert forced.walkers_per_block == 64


def test_cpu_wrapper_sums_at_the_plan_lanes():
    """The CPU wrapper runs the twin in the order the kernel would take
    for the same launch: bit for bit the twin at ``twin_order``, for the
    default and for a design."""
    port = TorchEnsemble.from_system(load_system(data_path("spinel_ewald_2x2x2")), "cpu")
    tables = _tables(port, "direct")
    W, block, n_steps = 48, 16, 60
    occu = torch.as_tensor(random_occupancies(port, W, 4))
    gen = torch.Generator().manual_seed(3)
    useq, vseq = chain.rank_pair_sequence(tables, gen, (W // block, n_steps))
    ops = dict(occ=occu[:, tables.rank_sites].T.to(torch.int8).contiguous(),
               enthalpy=torch.zeros(W, dtype=torch.float64),
               naccept=torch.zeros(W, dtype=torch.int32),
               nmove=torch.zeros(W, dtype=torch.int32),
               beta32=torch.full((W,), 5.0, dtype=torch.float32),
               useq=useq, vseq=vseq, seed=torch.tensor([77], dtype=torch.int64),
               tables=tables, n_steps=n_steps, block_size=block)
    for design in (None, chain._LaneDesign(lanes=2), chain._LaneDesign(lanes=8)):
        order = chain.twin_order("swap", tables, W, design)
        wrapper = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in ops.items()}
        twin = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in ops.items()}
        chain.swap_chain(**wrapper, _design=design)
        chain.swap_chain_reference(**twin, **order)
        for key in ("occ", "enthalpy", "naccept", "nmove"):
            assert torch.equal(wrapper[key], twin[key]), key
        assert int(wrapper["naccept"].sum()) > 0
    assert chain.twin_order("swap", tables, W) == {"lanes": 16}
