"""The table-move kernel's lanes (K5), through its twin, on the CPU.

The kernel splits each walker's table move over G threads (lanes): for
each valid slot in order, lane j sums rows j, j + G, ... of the slot's
rank (lane 0 onto the running dE, the others from +0.0; K1-Ising's parity
sum from +0.0, scaled after the lanes meet), the lanes' partials meeting
in a butterfly, and the Ewald dot is split over the lanes the same way;
so G sets the order of the delta's sums, and the twin
(``ops/chain.py:table_chain_reference``) takes the same for the same
launch (``twin_order``).

- (a) At one lane the twin equals the twin recorded before the kernel had
  lanes, bit for bit (``torch_table_twin_one_lane.npz``): K1-Ising, the
  direct body and K3 (q = 2) with the Ewald term on the semigrand spinel
  CE + Ewald 2x2x2, K1-Ising on its 3x3x3 (three words of rank bits), and
  the direct body on the Li/Mn/vacancy, O/F rocksalt whose moves recolor
  up to three sites (the runtime slot count), in both RNG modes.
- (b) At G = 2, 4, 8 and 16 the twin, and the chain factory that the
  sampler runs fed the same draws, meet the interpret-mode Pallas
  reference under the rule of ``test_torch_tableflip.py``
  (``_trajectory_parity``): a walker may differ only where the twin shows one of its decisions within ``ULP_SLACK = 4``
  f32 ulps of log U beyond beta times the reference's f32 Ewald error, at
  least 90 % of the walkers are equal and their accept counts agree
  exactly; every walker keeps its net charge and parity (e) holds below
  1e-9.  K1-Ising and the direct body on the spinel CE + Ewald 1x1x1 (64
  walkers, 400 steps; the reference takes K1-Ising), and the direct body on
  ``torch_lmof_2x2x2.npz`` (32 walkers, 400 steps), padded to four slots
  as the reference needs (``test_multi_slot_reference_faults``).
- (c) The launch plan from shapes: lanes and walkers a block, every rank's
  rows resident where they fit beside the codes (the K1-Ising and K3 rows
  of the spinel CE + Ewald sgc 2x2x2; streamed elsewhere, in two buffers
  of k_max row sets), a raise where a forced plan does not fit; the CPU
  wrapper sums at the plan's lanes.
"""

import dataclasses
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
from smol_tpu_torch.moca.kernel.tableflip import TableFlip
from smol_tpu_torch.ops import chain
from smol_tpu_torch.system import load_system

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from export_torch_systems import data_path  # noqa: E402
from test_torch_tableflip import (  # noqa: E402
    MOVE_ARRAYS,
    _ewald_f32_slack,
    _pad_slots,
    _reference_table_draws,
    _systems,
    _unused_slots_off_valid_ranks,
)

ULP_SLACK = 4
ONE_LANE_FILE = Path(__file__).resolve().parent / "data" / "torch_table_twin_one_lane.npz"
# record key -> (system file stem, site body); 24 walkers in sequence blocks
# of 8, 120 steps
RECORDED = {
    "sgc2_ising": ("spinel_ewald_sgc_2x2x2", "ising"),
    "sgc2_direct": ("spinel_ewald_sgc_2x2x2", "direct"),
    "sgc2_qary": ("spinel_ewald_sgc_2x2x2", "qary"),
    "sgc3_ising": ("spinel_ewald_sgc_3x3x3", "ising"),
    "lmof_direct": ("lmof_2x2x2", "direct"),
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


def _table_move(port, tables):
    return chain.build_table_move(tables, TableFlip(port.sublattices, **port.table_data))


def _file_port(stem):
    return TorchEnsemble.from_system(load_system(data_path(stem)), "cpu")


@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize("case", sorted(RECORDED))
def test_one_lane_twin_equals_recorded_twin(case, rng):
    """At one lane the twin sums every row in order onto the running dE, as
    it did before the kernel had lanes: from the recorded start, the end
    equals the recorded end on every walker, bit for bit.

    ``torch_table_twin_one_lane.npz`` holds, per case and RNG mode, the
    operands (``random_occupancies(ensemble, 24, 5)`` on the system file's
    ensemble, their features . theta, f32 betas of a geometric ladder over
    300-3000 K, ``table_sequences`` from a generator seeded 9 in sequence
    blocks of 8, the launch seed 987654321 (hash) or 0x2545F4914F6CDD1D
    (philox)) and the end that ``table_chain_reference`` of commit 8418ce7
    (the twin before lanes, which takes no ``lanes``) reached from them in
    120 steps.  It is that twin's record: written anew by this twin, the
    test would compare the twin with itself."""
    stem, delta = RECORDED[case]
    port = _file_port(stem)
    tables = _tables(port, delta)
    data = np.load(ONE_LANE_FILE)
    key = f"{case}_{rng}"
    occ = torch.as_tensor(data[f"{key}_in_occ"]).clone()
    enthalpy = torch.as_tensor(data[f"{key}_in_enthalpy"]).clone()
    naccept = torch.zeros(occ.shape[1], dtype=torch.int32)
    chain.table_chain_reference(occ, enthalpy, naccept,
                                torch.as_tensor(data[f"{key}_in_beta32"]),
                                torch.as_tensor(data[f"{key}_in_dirs"]),
                                torch.as_tensor(data[f"{key}_in_ranks"]),
                                torch.as_tensor(data[f"{key}_in_seed"]), tables,
                                _table_move(port, tables), 120, 8, rng, lanes=1)
    assert torch.equal(occ, torch.as_tensor(data[f"{key}_out_occ"]))
    assert torch.equal(enthalpy, torch.as_tensor(data[f"{key}_out_enthalpy"]))
    assert torch.equal(naccept, torch.as_tensor(data[f"{key}_out_naccept"]))
    assert 0 < int(naccept.sum()) < naccept.numel() * 120


# (b): the reference runs once per cell; the port's twin at each G

CELLS = {  # cell -> (reference system, port file (None: its export), walkers,
    # steps, temperature, seed, slots padded to)
    "spinel_ewald": (("spinel_ewald", (1, 1, 1)), None, 64, 400, 1000.0, 0, None),
    "lmof": (("lmof", (2, 2, 2)), "lmof_2x2x2", 32, 400, 1000.0, 1, 4),
}
_REFERENCE = {}


def _reference(cell):
    """The interpret-mode reference table chain on ``cell`` from random
    starts, with the wrapper's own draws (pallas_chain :2040-2091), one
    sequence block of all walkers; the multi-slot table padded to an even
    slot count, its unused slots off the valid slots' ranks."""
    if cell not in _REFERENCE:
        system, stem, W, n_steps, temperature, seed, pad_to = CELLS[cell]
        ref, _, exported = _systems(*system)
        port = exported if stem is None else _file_port(stem)
        occ0 = random_occupancies(ref, W, seed)
        sampler = Sampler.from_ensemble(ref, temperature=temperature, nwalkers=W, seed=3,
                                        step_type="table-flip")
        state = dict(sampler.setup_sample(occ0))
        state.pop("words", None)
        state["occupancy"] = jnp.asarray(occ0)
        ref_tables, _, ref_tm = sampler.mckernel._get_chain_tables()
        if pad_to is not None:
            arrays = _pad_slots({n: getattr(ref_tm, n) for n in MOVE_ARRAYS[:4]}, pad_to)
            ref_tm = dataclasses.replace(ref_tm, k_max=pad_to, **arrays)
        key = jax.random.key(seed)
        dirs, ranks, seeds = _reference_table_draws(ref_tables, ref_tm, key, n_steps, W, W)
        assert len(seeds) == 1
        with pytest.MonkeyPatch.context() as mp:
            if pad_to is not None:
                ranks = _unused_slots_off_valid_ranks(dirs, ranks, ref_tm.slot_valid,
                                                      int(ref_tables.num_ranks))
                mp.setattr(pallas_chain, "table_sequences",
                           lambda *args: (jnp.asarray(dirs), jnp.asarray(ranks)))
            out = pallas_chain.make_shared_proposal_chain(
                ref_tables, n_steps, block_size=W, interpret=True, move="table",
                table_move=ref_tm)(state, key)
        _REFERENCE[cell] = dict(
            port=port, occ0=occ0, enthalpy=torch.tensor(np.array(state["enthalpy"])),
            beta=torch.tensor(np.array(state["beta"])), dirs=dirs, ranks=ranks,
            seeds=seeds, pad_to=pad_to,
            out={k: np.asarray(out[k]) for k in ("occupancy", "naccept")})
    return _REFERENCE[cell]


@pytest.mark.parametrize("lanes", [2, 4, 8, 16])
@pytest.mark.parametrize("cell,delta", [("spinel_ewald", "ising"), ("spinel_ewald", "direct"),
                                        ("lmof", "direct")])
def test_lanes_match_interpret_reference(monkeypatch, cell, delta, lanes):
    """(b): the twin and the chain factory at G lanes against the reference."""
    r = _reference(cell)
    _, _, W, n_steps, _, _, pad_to = CELLS[cell]
    port = r["port"]
    tables = _tables(port, delta)
    tm = _table_move(port, tables)
    if pad_to is not None:
        arrays = _pad_slots({n: getattr(tm, n) for n in MOVE_ARRAYS[:4]}, pad_to)
        tm = chain.make_table_move(tables, tm.n_dirs, pad_to, tm.swap_weight,
                                   *(arrays[n] for n in MOVE_ARRAYS[:4]), tm.dir_cum_probs)
    slack = _ewald_f32_slack(tables)
    assert (slack > 0) == (cell == "spinel_ewald")
    occu = torch.as_tensor(r["occ0"])
    theta = torch.as_tensor(port.natural_parameters)
    sites = np.arange(port.num_sites)
    monkeypatch.setattr(chain, "_TABLE_DESIGN", chain._LaneDesign(lanes=lanes))
    order = chain.twin_order("table", tables, W)
    assert order == {"lanes": lanes}
    occ = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
    enth = r["enthalpy"].clone()
    nacc = torch.zeros(W, dtype=torch.int32)
    margin = torch.full((W,), float("inf"))
    chain.table_chain_reference(
        occ, enth, nacc, r["beta"].to(torch.float32), torch.as_tensor(r["dirs"][0]),
        torch.as_tensor(r["ranks"][0]), torch.tensor([int(r["seeds"][0])]), tables, tm,
        n_steps, W, "hash", margin=margin, slack=slack, **order)
    port_occ = occu.clone()
    port_occ[:, tables.rank_sites] = occ.T.to(port_occ.dtype)

    # the chain factory, fed the same draws, is the twin loop exactly
    state = {"occupancy": occu.clone(), "enthalpy": r["enthalpy"].clone(),
             "beta": r["beta"], "naccept": torch.zeros(W, dtype=torch.int32),
             "accepted": torch.ones(W, dtype=torch.bool)}
    state = chain.make_shared_proposal_chain(
        tables, n_steps, block_size=W, rng="hash", move="table", table_move=tm,
        seqs=(r["dirs"], r["ranks"]), seeds=r["seeds"])(state, None)
    assert torch.equal(state["occupancy"], port_occ)
    assert torch.equal(state["enthalpy"], enth)
    assert torch.equal(state["naccept"], nacc)

    out = r["out"]
    same = np.all(port_occ.numpy() == out["occupancy"], axis=1)
    for w in np.flatnonzero(~same):
        assert margin[w] <= ULP_SLACK, (w, float(margin[w]))
    assert same.mean() >= 0.9, same.mean()
    np.testing.assert_array_equal(nacc.numpy()[same], out["naccept"][same])
    assert 0 < out["naccept"].mean() < n_steps
    assert not np.array_equal(port_occ.numpy(), r["occ0"])
    # parity (e) and the net charge, on the port's own trajectory
    exact = port.compute_features(port_occ) @ theta
    assert float((enth - exact).abs().max()) < 1e-9
    np.testing.assert_array_equal(port.site_charges[sites, port_occ.numpy()].sum(axis=1),
                                  port.site_charges[sites, r["occ0"]].sum(axis=1))


# (c): the launch plan

@pytest.mark.parametrize("stem,delta,k_max,row_bytes,resident", [
    ("spinel_ewald_sgc_2x2x2", "ising", 2, 1328, True),  # 64 KB: three blocks an SM
    ("spinel_ewald_sgc_2x2x2", "qary", 2, 2688, False),  # 130 KB: two waves
    ("spinel_ewald_sgc_2x2x2", "direct", 2, 6272, False),  # does not fit
    ("spinel_ewald_sgc_3x3x3", "ising", 2, 3184, False),
    ("spinel_ewald_sgc_3x3x3", "direct", 2, 7184, False),
    ("lmof_2x2x2", "direct", 3, 2208, True),
])
def test_launch_plan_from_shapes(stem, delta, k_max, row_bytes, resident):
    """Every rank's rows resident where they fit beside the codes, the
    launch runs at least a step a rank (a 100-step window, not a 10-step
    one) and the rows add no wave of blocks over the card's SMs, else two
    buffers of k_max row sets; 8 lanes at 8192 walkers (``LANE_THREADS``),
    256 threads a block; a design that asks for rows that do not fit raises."""
    W, block = 8192, 1024
    port = _file_port(stem)
    tables = _tables(port, delta)
    assert _table_move(port, tables).k_max == k_max
    R = tables.num_ranks
    assert chain._row_set_bytes(tables) == row_bytes
    plan = chain.launch_plan("table", tables, W, block, 100, k_max)
    assert (plan.lanes, plan.walkers_per_block, plan.resident) == (8, 32, resident)
    codes = -(-R * 36 // 16) * 16
    assert plan.shared_bytes == (R if resident else 2 * k_max) * row_bytes + codes
    assert not chain.launch_plan("table", tables, W, block, R - 1, k_max).resident
    if R * row_bytes + codes > chain.MAX_SHARED_BYTES:
        with pytest.raises(ValueError, match="shared memory"):
            chain.launch_plan("table", tables, W, block, 100, k_max,
                              chain._LaneDesign(resident=True))
    # eight slots of the largest rows stream in 16 row sets, which still fit
    streamed = chain.launch_plan("table", tables, W, block, 100, 8,
                                 chain._LaneDesign(resident=False))
    assert streamed.shared_bytes == 16 * row_bytes + codes


def test_cpu_wrapper_sums_at_the_plan_lanes():
    """The CPU wrapper runs the twin in the order the kernel would take
    for the same launch: bit for bit the twin at ``twin_order``, for the
    default and for a design; and it raises nothing for a launch whose
    plan would not fit on the card (the twin has no shared memory)."""
    port = _file_port("spinel_ewald_sgc_2x2x2")
    tables = _tables(port, "direct")
    tm = _table_move(port, tables)
    W, block, n_steps = 48, 16, 60
    occu = torch.as_tensor(random_occupancies(port, W, 4))
    gen = torch.Generator().manual_seed(3)
    dirs, ranks = chain.table_sequences(tables, tm, gen, (W // block, n_steps))
    ops = dict(occ=occu[:, tables.rank_sites].T.to(torch.int8).contiguous(),
               enthalpy=torch.zeros(W, dtype=torch.float64),
               naccept=torch.zeros(W, dtype=torch.int32),
               beta32=torch.full((W,), 5.0, dtype=torch.float32),
               dirs=dirs, ranks=ranks, seed=torch.tensor([77], dtype=torch.int64),
               tables=tables, table_move=tm, n_steps=n_steps, block_size=block)
    for design in (None, chain._LaneDesign(lanes=2),
                   chain._LaneDesign(lanes=8, resident=True)):
        order = chain.twin_order("table", tables, W, design)
        wrapper = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in ops.items()}
        twin = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in ops.items()}
        chain.table_chain(**wrapper, _design=design)
        chain.table_chain_reference(**twin, **order)
        for key in ("occ", "enthalpy", "naccept"):
            assert torch.equal(wrapper[key], twin[key]), key
        assert int(wrapper["naccept"].sum()) > 0
    assert chain.twin_order("table", tables, W) == {"lanes": 16}
