"""The Wang-Landau kernel's lanes (K6), through its twin, on the CPU.

The kernel splits each walker's step over G threads (lanes): lane j sums
rows j, j + G, ... of each rank's rows and the lanes' partials meet in a
butterfly, so G sets the order of the delta's sums; the twin
(``ops/chain.py:wl_chain_reference``) takes the same G for the same
walkers and repeats that order.

- At one lane the twin equals the twin recorded before lanes existed,
  bit for bit (``torch_wl_twin_one_lane.npz``): the direct and K1-Ising
  bodies, flips and swaps, on the 8-site cell, and K3 (q = 3) on the
  ternary ``sgc`` window, in both RNG modes.
- At G = 2, 4, 8 and 16 the twin (and the chain factory that the sampler
  runs, fed the same draws) meets the interpret-mode Pallas reference under
  the rule of ``test_torch_wanglandau.py``: every walker equal but those
  the twin shows within ``ULP_SLACK = 4`` f32 ulps of a bin edge or of
  log U, at most ``EXCUSED_SHARE = 0.05`` of them, enthalpies to 1e-9;
  on the 8-site cell, whose levels sit mid-bin, nothing is excused.
  K1-Ising flips and swaps and the direct body on the 8-site cell at each
  G; K1-Ising flips in the bench's window at G = 4; K3 on the ternary
  window at G = 2.
- The lane rule gives the G the kernel takes for a walker count, a block
  lies inside one sequence group also for sequence blocks that do not
  divide 256, and the launch plan keeps rows and the entropy in shared
  memory where they fit.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from smol_tpu_torch.moca.ensemble import Ensemble as TorchEnsemble
from smol_tpu_torch.moca.ensemble import random_occupancies
from smol_tpu_torch.ops import chain
from smol_tpu_torch.system import load_system

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from export_torch_systems import data_path, half_occupancies, sgc_ensemble  # noqa: E402
from test_torch_wanglandau import (  # noqa: E402, F401 (fixtures)
    _chain_parity,
    _wl_params,
    bench,
    nn,
)

ONE_LANE_FILE = Path(__file__).resolve().parent / "data" / "torch_wl_twin_one_lane.npz"
STATE = ("occ", "enthalpy", "naccept", "entropy", "histogram", "occurrences",
         "mod_factor", "wl_counter")
# record key -> (system file stem, move, site body, walkers, steps, sequence block)
RECORDED = {
    "nn_flip_direct": ("aucu_nn_2x2x2", "flip", "direct", 24, 160, 8),
    "nn_flip_ising": ("aucu_nn_2x2x2", "flip", "ising", 24, 160, 8),
    "nn_swap_direct": ("aucu_nn_2x2x2", "swap", "direct", 24, 160, 8),
    "nn_swap_ising": ("aucu_nn_2x2x2", "swap", "ising", 24, 160, 8),
    "sgc_flip_qary": ("sgc_wl_3x3x3", "flip", "qary", 16, 60, 8),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors, so that parallel test
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tables(stem, move, delta):
    port = TorchEnsemble.from_system(load_system(data_path(stem)), "cpu")
    tables = chain.build_chain_tables(
        port.processor, port.sublattices,
        mu_table=None if move == "swap" else port.chemical_potential_table, delta=delta)
    assert tables.delta == delta
    return tables


@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize("case", sorted(RECORDED))
def test_one_lane_twin_equals_recorded_twin(case, rng):
    """At one lane the twin sums every row in order, as it did before the
    kernel had lanes: from the recorded start, the end equals the recorded
    end on every walker and plane, bit for bit.

    ``torch_wl_twin_one_lane.npz`` holds, per case and RNG mode, the
    operands of ``wl_launch_operands`` for the case's walkers (flips:
    ``random_occupancies(ensemble, W, 5)``; swaps: permutations of a
    half-and-half occupancy from ``default_rng(5)``), planes of zeros, a
    generator seeded 9 and the launch seed 987654321 (hash) or
    0x2545F4914F6CDD1D (philox); the window (``_window``: min_enthalpy,
    bin_size, bins; the 8-site levels mid-bin, the ternary file's own
    window), flatness 0.5 with a check every 20 steps; and the end that
    ``wl_chain_reference`` of commit ada4259 (the twin before lanes, which
    takes no ``lanes``) reached from them.  It is that twin's record:
    written anew by this twin, the test would compare the twin with
    itself."""
    stem, move, delta, W, steps, block = RECORDED[case]
    data = np.load(ONE_LANE_FILE)
    key = f"{case}_{rng}"
    lo, bin_size, bins = data[f"{key}_window"]
    wl = chain.WLChain(min_enthalpy=float(lo), bin_size=float(bin_size),
                       num_levels=int(bins), flatness=0.5, check_period=20,
                       update_period=1, mod_divisor=2.0)
    B = int(bins)
    ops = dict(occ=torch.as_tensor(data[f"{key}_in_occ"]).clone(),
               enthalpy=torch.as_tensor(data[f"{key}_in_enthalpy"]).clone(),
               naccept=torch.zeros(W, dtype=torch.int32),
               entropy=torch.zeros((B, W), dtype=torch.float64),
               histogram=torch.zeros((B, W), dtype=torch.int32),
               occurrences=torch.zeros((B, W), dtype=torch.int32),
               mod_factor=torch.ones(W, dtype=torch.float64),
               wl_counter=torch.zeros(W, dtype=torch.int32))
    seqs = [torch.as_tensor(data[f"{key}_in_seq{i}"])
            for i in range(2 if move == "swap" else 1)]
    chain.wl_chain_reference(**ops, seqs=seqs, seed=torch.as_tensor(data[f"{key}_in_seed"]),
                             tables=_tables(stem, move, delta), wl=wl, n_steps=steps,
                             block_size=block, move=move, rng=rng, lanes=1)
    for name in STATE:
        assert torch.equal(ops[name], torch.as_tensor(data[f"{key}_out_{name}"])), name
    assert 0 < int(ops["naccept"].sum()) < W * steps
    assert bool((ops["mod_factor"] < 1).any())  # a flatness reset happened


def _at_lanes(monkeypatch, lanes):
    """Every launch (the wrapper, the chain factory, the twin) at ``lanes``."""
    monkeypatch.setattr(chain, "_WL_DESIGN", chain._WLDesign(lanes=lanes))
    assert chain.wl_lanes(2048) == lanes


@pytest.mark.parametrize("lanes", [2, 4, 8, 16])
@pytest.mark.parametrize("move,delta", [("flip", "ising"), ("swap", "ising"),
                                        ("flip", "direct")])
def test_lanes_match_interpret_reference_8_sites(monkeypatch, nn, lanes, move, delta):
    """The 8-site cell, levels mid-bin: every walker equal to the
    reference's at every G, nothing excused."""
    _at_lanes(monkeypatch, lanes)
    ref, port, window = nn
    if move == "swap":
        occ0 = half_occupancies(port.num_sites, 64, seed=lanes)
    else:
        occ0 = np.random.default_rng(lanes).integers(0, 2, (64, 8)).astype(np.int32)
    _chain_parity(ref, port, _wl_params(window, flatness=0.7, check_period=50), move,
                  occ0, 300, 32, seed=lanes, excuses=False, delta=delta)


def test_lanes_match_interpret_reference_bench_window(monkeypatch, bench):
    """K1-Ising flips on Au-Cu 3x3x3 in the bench's ~250 bins at G = 4."""
    _at_lanes(monkeypatch, 4)
    ref, port, window = bench
    occ0 = np.random.default_rng(7).integers(0, 2, (64, 27)).astype(np.int32)
    _chain_parity(ref, port, _wl_params(window, flatness=0.3, check_period=20), "flip",
                  occ0, 300, 32, seed=7, delta="ising")


def test_lanes_match_interpret_reference_qary(monkeypatch):
    """K3 (q = 3) flips on the ternary ``sgc`` 3x3x3 window at G = 2."""
    _at_lanes(monkeypatch, 2)
    system = load_system(data_path("sgc_wl_3x3x3"))
    window = dict(min_enthalpy=float(system["wl_min_enthalpy"]),
                  max_enthalpy=float(system["wl_max_enthalpy"]),
                  bin_size=float(system["wl_bin_size"]))
    port = TorchEnsemble.from_system(system, "cpu")
    occ0 = random_occupancies(port, 64, 8)
    _chain_parity(sgc_ensemble(3), port, _wl_params(window, flatness=0.3, check_period=20),
                  "flip", occ0, 200, 32, seed=8, delta="qary")


@pytest.mark.parametrize("walkers,lanes", [(1, 16), (64, 16), (2048, 16), (2049, 16),
                                           (4096, 8), (8192, 4), (16384, 2), (32768, 1),
                                           (40960, 1)])
def test_lane_rule(walkers, lanes):
    """The fewest lanes (at most 16) that give the launch 32768 threads;
    the old design takes one."""
    assert chain.wl_lanes(walkers) == lanes
    assert chain.wl_lanes(walkers, chain._WL_OLD_DESIGN) == 1
    assert chain.wl_block_walkers(walkers, 1024) * lanes <= chain.WL_THREADS


@pytest.mark.parametrize("walkers,block_size", [(200, 8), (1000, 96), (1000, 100),
                                                (300, 3), (2048, 1024), (2048, 24),
                                                (8192, 40), (600, 1000)])
def test_block_lies_in_one_sequence_group(walkers, block_size):
    """Every CUDA block's walkers share one sequence group (walker //
    block_size), also for sequence blocks that do not divide 256."""
    for design in (chain._WL_DESIGN, chain._WL_OLD_DESIGN):
        wpb = chain.wl_block_walkers(walkers, block_size, design)
        assert wpb * chain.wl_lanes(walkers, design) <= chain.WL_THREADS
        first = np.arange(0, walkers, wpb)
        last = np.minimum(first + wpb, walkers) - 1
        assert ((first // block_size) == (last // block_size)).all()


def test_launch_plan_from_shapes():
    """Rows and the entropy stay in shared memory where they fit: the
    Ising rows of Au-Cu 3x3x3 (27 x 1840 B) and 4x4x4 (64 x 1840 B)
    resident, the direct rows (11040 B a rank) streamed; at 2048 walkers
    the entropy beside either, at 8192 (64 walkers a block) beside the
    3x3x3 rows but not beside the 4x4x4 rows; the old design
    streams and keeps the planes global; a design that asks for more than
    fits raises."""
    W, bins = 2048, 250
    flip = _tables("aucu_wl_3x3x3", "flip", "ising")
    swap = _tables("aucu_4x4x4", "swap", "ising")
    direct = _tables("aucu_wl_3x3x3", "flip", "direct")
    assert chain._row_set_bytes(flip) == 1840 and chain._row_set_bytes(direct) == 11040
    plan = chain.wl_launch_plan(flip, W, 1024, "flip", bins)
    assert (plan.lanes, plan.walkers_per_block, plan.resident, plan.planes) == (16, 16, True, 1)
    assert plan.blocks(W) == 128
    assert 27 * 1840 < plan.shared_bytes <= chain.MAX_SHARED_BYTES
    assert chain.wl_launch_plan(swap, W, 512, "swap", bins).resident
    assert chain.wl_launch_plan(swap, W, 512, "swap", bins).planes == 1
    assert chain.wl_launch_plan(swap, 8192, 512, "swap", bins).planes == 0
    assert chain.wl_launch_plan(flip, 8192, 1024, "flip", bins).planes == 1
    streamed = chain.wl_launch_plan(direct, W, 1024, "flip", bins)
    assert not streamed.resident and streamed.planes == 1
    assert chain.wl_launch_plan(direct, W, 1024, "flip", bins,
                                chain._WLDesign(planes=0)).planes == 0
    old = chain.wl_launch_plan(direct, W, 1024, "flip", bins, chain._WL_OLD_DESIGN)
    assert (old.lanes, old.walkers_per_block, old.resident, old.planes) == (1, 64, False, 0)
    assert old.shared_bytes == 2 * 11040 + 1840  # 27 code rows of 68 B, to 16 B
    assert chain.wl_launch_plan(flip, W, 1024, "flip", bins, chain._WLDesign(planes=1)).planes == 1
    with pytest.raises(ValueError, match="shared memory"):
        chain.wl_launch_plan(direct, W, 1024, "flip", bins, chain._WLDesign(resident=True))
    with pytest.raises(ValueError, match="shared memory"):
        chain.wl_launch_plan(flip, 8192, 1024, "flip", 2000, chain._WLDesign(planes=1))
