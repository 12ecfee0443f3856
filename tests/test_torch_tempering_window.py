"""A tempering window in one launch of K1: what of it runs on the CPU.

- the exchange's twin (``exchange_betas`` on a CPU tensor,
  ``exchange_betas_reference``), which the windowed launch is held to on
  the card, with uniforms of 0 (log u = -inf: every pair exchanges, its
  count at the left member), for W even and odd and both phases; its
  decisions on the reference's uniforms, with ties, are
  ``tests/test_torch_tempering.py::test_exchange_equals_reference``;
- ``make_tempering_chain`` on the CPU, from ``pt_counter`` 0 and 1,
  against its segments run one by one (``flip_chain``, then
  ``exchange_betas`` of phase (pt_counter + s + 1) % 2) on the same draws:
  codes, enthalpies, betas, accept and exchange counts, with the Ising and
  the direct body and an odd walker count; ``flip_window``, the windowed
  launch, refuses a CPU tensor;
- ``tempering_window_plan`` takes the window for flips of one chunk a
  segment on a grid the card holds at once, and runs segment by segment
  swaps, a hash-mode segment longer than a chunk, a grid too large, and
  the CPU twins.

The CPU tempering chain against the reference's window in hash mode with
injected draws on Au-Cu 2x2x2 (8 sites), with both bodies, is
``tests/test_torch_tempering.py::test_tempering_chain_equals_reference``;
it is not repeated here.  The windowed kernel itself runs on the card
(``chip_smoke.py`` phase 3, and ``tests/test_torch_kernel.py``'s
tempering chain, which takes the window there).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from smol_tpu_torch.constants import kB
from smol_tpu_torch.moca.ensemble import Ensemble, random_occupancies
from smol_tpu_torch.ops import chain
from smol_tpu_torch.parallel import (
    exchange_betas,
    make_temperature_ladder,
    make_tempering_chain,
)
from smol_tpu_torch.system import load_system

DATA = Path(__file__).resolve().parent / "data"


@pytest.mark.parametrize("phase", [0, 1])
@pytest.mark.parametrize("W", [7, 64])
def test_exchange_twin_at_zero_uniforms(W, phase):
    rng = np.random.default_rng(10 * W + phase)
    beta = torch.as_tensor(1.0 / (kB * rng.permutation(
        make_temperature_ladder(300.0, 3000.0, W))))
    enthalpy = torch.as_tensor(rng.normal(0.0, 0.05, W))
    enthalpy[::3] = enthalpy[0]  # ties among them: d == 0
    b64, b32 = beta.clone(), beta.to(torch.float32)
    counts = torch.zeros(W, dtype=torch.int32)
    exchange_betas(b64, b32, enthalpy, torch.zeros(W, dtype=torch.float64), phase, counts)
    expect = beta.clone()
    left = torch.arange(phase, W - 1, 2)
    expect[left], expect[left + 1] = beta[left + 1], beta[left]
    assert torch.equal(b64, expect)
    assert torch.equal(b32, expect.to(torch.float32))
    want = torch.zeros(W, dtype=torch.int32)
    want[left] = 1
    assert torch.equal(counts, want)


@pytest.fixture(scope="module")
def aucu_pt():
    return Ensemble.from_system(load_system(DATA / "torch_aucu_pt_3x3x3.npz"), "cpu")


@pytest.mark.parametrize("start", [0, 1])
@pytest.mark.parametrize("delta", ["ising", "direct"])
def test_tempering_chain_equals_its_segments(aucu_pt, delta, start):
    """make_tempering_chain on the CPU from pt_counter ``start`` against
    its segments one by one, 21 walkers in blocks of 7, 4 segments of 5
    steps, on the same sequences, seeds and uniforms."""
    ens = aucu_pt
    W, period, n_seg, block = 21, 5, 4, 7
    tables = chain.build_chain_tables(ens.processor, ens.sublattices,
                                      mu_table=ens.chemical_potential_table, delta=delta)
    gen = torch.Generator().manual_seed(3 + start)
    seqs = chain.rank_sequence(tables, gen, (n_seg, W // block, period))
    seeds = torch.randint(0, 2**62, (n_seg,), generator=gen)
    uniforms = torch.rand((n_seg, W), generator=gen, dtype=torch.float64)
    occu = torch.as_tensor(random_occupancies(ens, W, seed=4))
    enthalpy = ens.compute_features(occu) @ torch.as_tensor(ens.natural_parameters)
    beta = torch.as_tensor(1.0 / (kB * make_temperature_ladder(300.0, 3000.0, W)))

    occ = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
    mine = {"occ": occ, "enthalpy": enthalpy.clone().contiguous(),
            "naccept": torch.zeros(W, dtype=torch.int32), "beta": beta.clone(),
            "beta32": beta.to(torch.float32), "accepted": torch.zeros(W, dtype=torch.int32)}
    for s in range(n_seg):
        chain.flip_chain(mine["occ"], mine["enthalpy"], mine["naccept"], mine["beta32"],
                         seqs[s], seeds[s: s + 1], tables, period, block)
        exchange_betas(mine["beta"], mine["beta32"], mine["enthalpy"], uniforms[s],
                       (start + s + 1) % 2, mine["accepted"])
    with pytest.raises(ValueError, match="runs on cuda"):
        chain.flip_window(occ.clone(), enthalpy.clone(), torch.zeros(W, dtype=torch.int32),
                          beta.clone(), beta.to(torch.float32), seqs, seeds, tables, period,
                          block, uniforms, (start + 1) % 2)

    state = {"occupancy": occu.clone(), "enthalpy": enthalpy.clone().contiguous(),
             "beta": beta.clone(), "naccept": torch.zeros(W, dtype=torch.int32),
             "accepted": torch.ones(W, dtype=torch.bool), "pt_counter": start,
             "pt_accepted": torch.zeros(W, dtype=torch.int32)}
    run = make_tempering_chain(chain.make_shared_proposal_chain(
        tables, period, block_size=block, seqs=seqs[:, None], seeds=seeds), n_seg,
        uniforms=uniforms.numpy())
    state = run(state, None)
    assert state["pt_counter"] == start + n_seg
    assert torch.equal(state["occupancy"][:, tables.rank_sites].T.to(torch.int8), mine["occ"])
    assert torch.equal(state["enthalpy"], mine["enthalpy"])
    assert torch.equal(state["beta"], mine["beta"])
    assert torch.equal(state["naccept"], mine["naccept"])
    assert torch.equal(state["pt_accepted"], mine["accepted"])
    assert int(mine["accepted"].sum()) > 0
    assert torch.equal(torch.sort(mine["beta"]).values, torch.sort(beta).values)


@pytest.mark.parametrize("case, expect", [
    ({}, True),  # bench tempering's window: 256 blocks of K1-Ising, 2 an SM
    ({"blocks_per_sm": 1}, False),  # 132 blocks at once: the grid does not fit
    ({"move": "swap"}, False),
    ({"rng": "hash", "n_steps": chain.MAX_CHUNK_STEPS + 1}, False),
    ({"rng": "hash"}, True),  # a hash-mode segment of one chunk
    ({"blocks_per_sm": None}, False),  # the CPU: the twins run segment by segment
])
def test_window_plan(aucu_pt, case, expect):
    tables = chain.build_chain_tables(aucu_pt.processor, aucu_pt.sublattices,
                                      mu_table=aucu_pt.chemical_potential_table,
                                      delta="ising")
    args = {"n_steps": 10, "move": "flip", "rng": "philox", "blocks_per_sm": 2, **case}
    plan = chain.tempering_window_plan(tables, 8192, 1024, args.pop("n_steps"), 10, **args)
    assert plan.windowed is expect, plan.reason
    if plan.launch is not None:  # the plan of the window's 100 steps, as K1 plans them
        assert plan.launch == chain.launch_plan("flip", tables, 8192, 1024, 100)
        assert plan.blocks == plan.launch.blocks(8192)
