"""The CUDA chain kernels against their plain torch twins, on the card.

Marked ``cuda``: each test skips without a CUDA device (and ``nvcc``).
This file imports neither ``jax`` nor ``smol_tpu``, so it also runs where
they are not installed; there, run it without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_kernel.py

The flip kernel, and the swap kernel, must equal their twins on every
walker in both RNG modes (occupancies, accept and move counts exactly,
enthalpies to 1e-9 absolute), including a partial CUDA block, sequence
blocks smaller than a CUDA block, the main paths' launch shapes (8192
walkers in blocks of 1024, or 512 for Au-Cu), the Ewald term (the flip
kernel on the canonical spinel CE + Ewald too) and the general (runtime
slot count) kernels; a refused operand raises before any launch.  The
table-move kernel likewise, in its two-slot body (the semigrand spinel
CE + Ewald), its runtime slot count body (the rocksalt whose moves recolor
up to three sites, and the spinel's table padded to four slots), keeping
every walker's net charge.  The Wang-Landau kernel must equal its twin on
every walker and every plane (entropies to 0.0), for flips and swaps, with
both slot-count bodies, the Ewald term, a partial block, sequence blocks
below a CUDA block, 8192 walkers and a flatness reset in every run.  The
distance (SQS) kernel must equal its twin bit for bit on every walker
(occupancy, best occupancy, features, score, best score, accept count) in
both RNG modes, at beta 0, 0.2, 2 and 50, on the bench's 8-site shapes and
the 64-site one, at the main path's 2048 walkers in blocks of 512, with a
partial CUDA block, sequence blocks below a CUDA block, without the match
term, and in its general body (runtime K, up to 32 features).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from smol_tpu_torch.constants import kB
from smol_tpu_torch.moca.ensemble import Ensemble, random_occupancies
from smol_tpu_torch.moca.kernel.tableflip import TableFlip
from smol_tpu_torch.ops import chain
from smol_tpu_torch.system import load_system

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _operands(card, cell, W, n_steps, block_size, move="flip"):
    """Operands of one launch on system file ``torch_<cell>.npz`` (a bare
    supercell name is the semigrand spinel)."""
    stem = cell if "_" in cell else f"spinel_{cell}"
    ens = Ensemble.from_system(load_system(DATA / f"torch_{stem}.npz"), card)
    tables = chain.build_chain_tables(
        ens.processor, ens.sublattices, mu_table=ens.chemical_potential_table
    )
    occu = torch.as_tensor(random_occupancies(ens, W, seed=3), device=card)
    gen = torch.Generator(device=card).manual_seed(0)
    shape = (-(-W // block_size), n_steps)
    ops = dict(
        occ=occu[:, tables.rank_sites].T.to(torch.int8).contiguous(),
        enthalpy=torch.zeros(W, dtype=torch.float64, device=card),
        naccept=torch.zeros(W, dtype=torch.int32, device=card),
        beta32=torch.full((W,), 1 / (kB * 1000.0), dtype=torch.float32, device=card),
        seed=torch.tensor([12345], dtype=torch.int64, device=card),
        tables=tables, n_steps=n_steps, block_size=block_size,
    )
    if move == "swap":
        ops["useq"], ops["vseq"] = chain.rank_pair_sequence(tables, gen, shape)
        ops["nmove"] = torch.zeros(W, dtype=torch.int32, device=card)
    elif move == "table":
        usher = TableFlip(ens.sublattices, **ens.table_data)
        ops["table_move"] = chain.build_table_move(tables, usher)
        ops["dirs"], ops["ranks"] = chain.table_sequences(
            tables, ops["table_move"], gen, shape)
        ops["charges"] = torch.as_tensor(ens.site_charges, device=card)[tables.rank_sites]
    else:
        ops["seq"] = chain.rank_sequence(tables, gen, shape)
    return ops


STATE = ("occ", "enthalpy", "naccept", "nmove")


def _kernel_and_twin(ops, kernel, twin, rng, kernel_tables=None):
    """Run kernel and twin on copies of ``ops``; return both results."""
    outs = []
    for fn, tables in ((kernel, kernel_tables or ops["tables"]), (twin, ops["tables"])):
        run = {k: (v.clone() if k in STATE else v) for k, v in ops.items()}
        before = kernel.launches
        fn(**{**run, "tables": tables}, rng=rng)
        torch.cuda.synchronize()
        assert kernel.launches - before == (1 if fn is kernel else 0)
        outs.append(run)
    return outs


def _assert_same(kernel, twin, n_steps):
    for key in ("occ", "naccept", "nmove"):
        if key in kernel:
            assert torch.equal(kernel[key], twin[key]), key
    assert float((kernel["enthalpy"] - twin["enthalpy"]).abs().max()) <= 1e-9
    assert 0 < float(kernel["naccept"].double().mean()) < n_steps


@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize(
    "cell,W,block_size",
    [("2x2x2", 256, 64), ("3x3x3", 1000, 1024), ("2x2x2", 200, 8),
     ("3x3x3", 8192, 1024)],  # the last: the main path's launch shape
)
def test_kernel_matches_twin(card, rng, cell, W, block_size):
    ops = _operands(card, cell, W, 400, block_size)
    outs = []
    for fn in (chain.flip_chain, chain.flip_chain_reference):
        run = {k: (v.clone() if k in ("occ", "enthalpy", "naccept") else v)
               for k, v in ops.items()}
        before = chain.flip_chain.launches
        fn(**run, rng=rng)
        torch.cuda.synchronize()
        launched = chain.flip_chain.launches - before
        assert launched == (1 if fn is chain.flip_chain else 0)
        outs.append(run)
    kernel, twin = outs
    assert torch.equal(kernel["occ"], twin["occ"])
    assert torch.equal(kernel["naccept"], twin["naccept"])
    assert float((kernel["enthalpy"] - twin["enthalpy"]).abs().max()) <= 1e-9
    assert 0 < float(kernel["naccept"].double().mean()) < 400


@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["hash", "philox"])
def test_general_slot_count_matches_twin(card, rng):
    """A fourth, empty slot (nbr -1, stride 0) takes the runtime-K kernel."""
    ops = _operands(card, "2x2x2", 256, 400, 64)
    t = ops["tables"]
    padded = dataclasses.replace(
        t,
        nbr=torch.nn.functional.pad(t.nbr, (0, 1), value=-1),
        stride=torch.nn.functional.pad(t.stride, (0, 1), value=0),
    )
    outs = []
    for fn, tables in ((chain.flip_chain, padded), (chain.flip_chain_reference, t)):
        run = {k: (v.clone() if k in ("occ", "enthalpy", "naccept") else v)
               for k, v in ops.items()}
        fn(**{**run, "tables": tables}, rng=rng)
        outs.append(run)
    torch.cuda.synchronize()
    kernel, twin = outs
    assert torch.equal(kernel["occ"], twin["occ"])
    assert torch.equal(kernel["naccept"], twin["naccept"])
    assert float((kernel["enthalpy"] - twin["enthalpy"]).abs().max()) <= 1e-9


@pytest.mark.cuda
def test_refused_operand_raises_before_launch(card):
    ops = _operands(card, "2x2x2", 64, 10, 64)
    before = chain.flip_chain.launches
    with pytest.raises(ValueError):
        chain.flip_chain(**{**ops, "occ": ops["occ"].to(torch.int32)})
    with pytest.raises(ValueError):
        chain.flip_chain(**{**ops, "seed": ops["seed"].cpu()})
    assert chain.flip_chain.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize(
    "cell,W,block_size",
    [("spinel_ewald_2x2x2", 256, 64), ("spinel_ewald_3x3x3", 1000, 1024),
     ("aucu_4x4x4", 200, 8),
     ("aucu_4x4x4", 8192, 512)],  # the last: the canonical main path's shape
)
def test_swap_kernel_matches_twin(card, rng, cell, W, block_size):
    ops = _operands(card, cell, W, 400, block_size, move="swap")
    kernel, twin = _kernel_and_twin(ops, chain.swap_chain, chain.swap_chain_reference, rng)
    _assert_same(kernel, twin, 400)
    assert torch.all(kernel["nmove"] >= kernel["naccept"])
    counts = [(o["occ"] == 1).sum(dim=0) for o in (ops, kernel)]
    assert torch.equal(*counts)  # each walker keeps its composition


@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["hash", "philox"])
def test_flip_kernel_with_ewald_matches_twin(card, rng):
    ops = _operands(card, "spinel_ewald_2x2x2", 256, 400, 64)
    assert ops["tables"].has_ewald
    kernel, twin = _kernel_and_twin(ops, chain.flip_chain, chain.flip_chain_reference, rng)
    _assert_same(kernel, twin, 400)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["spinel_ewald_2x2x2", "aucu_4x4x4"])
def test_general_slot_count_swap_matches_twin(card, cell):
    """A fourth, empty slot (nbr -1, stride 0) takes the runtime-K swap kernel."""
    ops = _operands(card, cell, 256, 400, 64, move="swap")
    t = ops["tables"]
    padded = dataclasses.replace(
        t,
        nbr=torch.nn.functional.pad(t.nbr, (0, 1), value=-1),
        stride=torch.nn.functional.pad(t.stride, (0, 1), value=0),
    )
    kernel, twin = _kernel_and_twin(ops, chain.swap_chain, chain.swap_chain_reference,
                                    "philox", kernel_tables=padded)
    _assert_same(kernel, twin, 400)


def _table_kernel_and_twin(ops, rng, kernel_move=None):
    charges = ops.pop("charges")
    kernel_ops = {**ops, "table_move": kernel_move or ops["table_move"]}
    if kernel_move is not None:  # the padded table takes padded ranks
        pad = kernel_move.k_max - ops["ranks"].shape[-1]
        kernel_ops["ranks"] = torch.nn.functional.pad(ops["ranks"], (0, pad)).contiguous()
    outs = []
    for fn, operands in ((chain.table_chain, kernel_ops),
                         (chain.table_chain_reference, ops)):
        run = {k: (v.clone() if k in STATE else v) for k, v in operands.items()}
        before = chain.table_chain.launches
        fn(**run, rng=rng)
        torch.cuda.synchronize()
        assert chain.table_chain.launches - before == (1 if fn is chain.table_chain else 0)
        outs.append(run)
    kernel, twin = outs
    _assert_same(kernel, twin, ops["n_steps"])
    net = [charges.gather(1, o["occ"].long()).sum(dim=0) for o in (ops, kernel)]
    assert torch.equal(*net)  # each walker keeps its net charge
    assert not torch.equal(kernel["occ"], ops["occ"])


@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize(
    "cell,W,block_size",
    [("spinel_ewald_sgc_2x2x2", 256, 64), ("spinel_ewald_sgc_3x3x3", 1000, 1024),
     ("spinel_ewald_sgc_2x2x2", 200, 8), ("lmof_2x2x2", 256, 64),
     ("spinel_ewald_sgc_3x3x3", 8192, 1024)],  # the last: the main path's shape
)
def test_table_kernel_matches_twin(card, rng, cell, W, block_size):
    ops = _operands(card, cell, W, 400, block_size, move="table")
    assert ops["table_move"].k_max == (3 if cell == "lmof_2x2x2" else 2)
    _table_kernel_and_twin(ops, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("k_max", [4, 8])
def test_table_kernel_runtime_slot_count_matches_twin(card, k_max):
    """The spinel's table padded with unused slots takes the runtime body."""
    ops = _operands(card, "spinel_ewald_sgc_3x3x3", 256, 400, 64, move="table")
    tm = ops["table_move"]
    pad = k_max - tm.k_max
    padded = chain.make_table_move(
        ops["tables"], tm.n_dirs, k_max, tm.swap_weight,
        *(np.pad(x, ((0, 0), (0, pad)), constant_values=fill)
          for x, fill in ((tm.from_code, -1), (tm.to_code, -1), (tm.slot_valid, 0),
                          (tm.slot_sub, 0))),
        tm.dir_cum_probs,
    )
    _table_kernel_and_twin(ops, "philox", kernel_move=padded)


@pytest.mark.cuda
def test_table_kernel_refuses_what_it_cannot_take(card):
    ops = _operands(card, "spinel_ewald_sgc_2x2x2", 64, 10, 64, move="table")
    ops.pop("charges")
    before = chain.table_chain.launches
    with pytest.raises(ValueError, match="ranks"):
        chain.table_chain(**{**ops, "ranks": ops["ranks"][..., :1].contiguous()})
    with pytest.raises(ValueError):
        chain.table_chain(**{**ops, "dirs": ops["dirs"].cpu()})
    assert chain.table_chain.launches == before


# ---------------- the Wang-Landau kernel (K6) ----------------

WL_STATE = ("occ", "enthalpy", "naccept", "entropy", "histogram", "occurrences",
            "mod_factor", "wl_counter")


def _wl_operands(card, cell, W, n_steps, block_size, move, bins=250, **options):
    """Operands of one Wang-Landau launch on ``torch_<cell>.npz``: a window
    of ``bins`` bins, five times as wide as the starting enthalpies span."""
    system = load_system(DATA / f"torch_{cell}.npz")
    ens = Ensemble.from_system(system, card)
    tables = chain.build_chain_tables(
        ens.processor, ens.sublattices,
        mu_table=None if move == "swap" else ens.chemical_potential_table)
    if move == "swap":  # every walker a shuffle of the file's composition
        rng = np.random.default_rng(3)
        occu = np.stack([rng.permuted(system["initial_occupancy"]) for _ in range(W)])
        if "ewald_matrix" in system:  # shuffle within each sublattice only
            occu = np.tile(system["initial_occupancy"], (W, 1))
            for sl in ens.sublattices:
                occu[:, sl.sites] = rng.permuted(occu[:, sl.sites], axis=1)
        occu = torch.as_tensor(occu, device=card)
    else:
        occu = torch.as_tensor(random_occupancies(ens, W, seed=3), device=card)
    theta = torch.as_tensor(ens.natural_parameters, device=card)
    enthalpy = (ens.compute_features(occu) @ theta).contiguous()
    lo, hi = float(enthalpy.min()), float(enthalpy.max())
    span = hi - lo + 1e-3
    params = dict(min_enthalpy=lo - 2 * span, bin_size=5 * span / bins, num_levels=bins,
                  flatness=0.3, check_period=20, update_period=1, mod_divisor=2.0)
    params.update(options)
    gen = torch.Generator(device=card).manual_seed(0)
    return dict(
        chain.wl_launch_operands(tables, chain.WLChain(**params), move, occu,
                                 enthalpy, n_steps, block_size, gen),
        seed=torch.tensor([12345], dtype=torch.int64, device=card))


def _wl_kernel_and_twin(ops, rng, kernel_tables=None):
    outs = []
    for fn, tables in ((chain.wl_chain, kernel_tables or ops["tables"]),
                       (chain.wl_chain_reference, ops["tables"])):
        run = {k: (v.clone() if k in WL_STATE else v) for k, v in ops.items()}
        before = chain.wl_chain.launches
        fn(**{**run, "tables": tables}, rng=rng)
        torch.cuda.synchronize()
        assert chain.wl_chain.launches - before == (1 if fn is chain.wl_chain else 0)
        outs.append(run)
    kernel, twin = outs
    for key in WL_STATE:
        if key != "enthalpy":
            assert torch.equal(kernel[key], twin[key]), key  # entropies to 0.0
    assert float((kernel["enthalpy"] - twin["enthalpy"]).abs().max()) <= 1e-9
    n_steps = ops["n_steps"]
    assert 0 < float(kernel["naccept"].double().mean()) < n_steps
    assert bool((kernel["mod_factor"] < 1).any())  # a flatness reset happened
    assert torch.equal(kernel["occurrences"].sum(dim=0),
                       kernel["wl_counter"] // ops["wl"].update_period)
    assert bool((kernel["histogram"] <= kernel["occurrences"]).all())
    assert torch.equal(kernel["entropy"] > 0, kernel["occurrences"] > 0)
    return kernel, twin


@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize(
    "cell,move,W,block_size",
    [("aucu_wl_3x3x3", "flip", 256, 64), ("aucu_wl_3x3x3", "flip", 1000, 1024),
     ("aucu_nn_2x2x2", "flip", 200, 8), ("aucu_wl_3x3x3", "flip", 8192, 1024),
     ("aucu_4x4x4", "swap", 256, 64), ("aucu_4x4x4", "swap", 1000, 1024),
     ("aucu_4x4x4", "swap", 200, 8), ("aucu_4x4x4", "swap", 8192, 512),
     ("spinel_ewald_2x2x2", "swap", 256, 64), ("spinel_ewald_2x2x2", "flip", 256, 64)],
)
def test_wl_kernel_matches_twin(card, rng, cell, move, W, block_size):
    bins = 10 if cell == "aucu_nn_2x2x2" else 250
    ops = _wl_operands(card, cell, W, 400, block_size, move, bins=bins)
    kernel, _ = _wl_kernel_and_twin(ops, rng)
    if move == "swap":
        counts = [(o["occ"] == 1).sum(dim=0) for o in (ops, kernel)]
        assert torch.equal(*counts)  # each walker keeps its composition


@pytest.mark.cuda
@pytest.mark.parametrize("move,cell", [("flip", "aucu_wl_3x3x3"), ("swap", "aucu_4x4x4")])
def test_wl_kernel_general_slot_count_and_update_period(card, move, cell):
    """A fourth, empty slot takes the runtime-K body; ``update_period = 3``
    and a ``check_period`` above the launch (only its last step checks)."""
    ops = _wl_operands(card, cell, 256, 400, 64, move, update_period=3,
                       check_period=5000, flatness=0.1)
    t = ops["tables"]
    padded = dataclasses.replace(
        t,
        nbr=torch.nn.functional.pad(t.nbr, (0, 1), value=-1),
        stride=torch.nn.functional.pad(t.stride, (0, 1), value=0),
    )
    kernel, _ = _wl_kernel_and_twin(ops, "philox", kernel_tables=padded)
    assert bool((kernel["mod_factor"] == 0.5).any())


@pytest.mark.cuda
def test_wl_kernel_refuses_what_it_cannot_take(card):
    ops = _wl_operands(card, "aucu_nn_2x2x2", 64, 10, 64, "flip", bins=10)
    before = chain.wl_chain.launches
    with pytest.raises(ValueError, match="operand"):
        chain.wl_chain(**{**ops, "entropy": ops["entropy"].T.contiguous()})
    with pytest.raises(ValueError):
        chain.wl_chain(**{**ops, "mod_factor": ops["mod_factor"].cpu()})
    with pytest.raises(ValueError, match="flip/swap"):
        chain.wl_chain(**{**ops, "move": "table"})
    assert chain.wl_chain.launches == before


# ---------------- the distance (SQS) kernel (K7) ----------------

DISTANCE_STATE = ("occ", "best_occ", "feat", "d", "best_d", "naccept")


def _distance_operands(card, stem, W, n_steps, block_size, beta=2.0, shape=0):
    """Operands of one distance launch on shape ``shape`` of
    ``torch_<stem>.npz``: walkers at random permutations of a half-and-half
    occupancy, each its own best, at inverse temperature ``beta``."""
    from smol_tpu_torch.moca.processor.distance import CorrelationDistanceProcessor
    from smol_tpu_torch.ops import sqs
    from smol_tpu_torch.system import load_systems

    path = DATA / f"torch_{stem}.npz"
    systems = load_systems(path)
    proc = CorrelationDistanceProcessor(systems[shape], card)
    tables = sqs.build_distance_tables(proc)
    rng = np.random.default_rng(3)
    half = np.arange(proc.num_sites) % 2
    occu = torch.as_tensor(np.stack([rng.permutation(half) for _ in range(W)]),
                           dtype=torch.int32, device=card)
    gen = torch.Generator(device=card).manual_seed(0)
    beta = torch.full((W,), beta, dtype=torch.float64, device=card)
    ops = sqs.distance_launch_operands(tables, proc.compute_corr, occu, beta, n_steps,
                                       block_size, gen)
    return dict(ops, seed=torch.tensor([12345], dtype=torch.int64, device=card)), proc


def _distance_kernel_and_twin(ops, rng, kernel_ops=None):
    """Kernel (on ``kernel_ops``, default ``ops``) and twin on copies; every
    walker's state must be equal bit for bit."""
    from smol_tpu_torch.ops import sqs

    outs = []
    for fn, operands in ((sqs.distance_chain, kernel_ops or ops),
                         (sqs.distance_chain_reference, ops)):
        run = {k: (v.clone() if k in DISTANCE_STATE else v) for k, v in operands.items()}
        before = sqs.distance_chain.launches
        fn(**run, rng=rng)
        torch.cuda.synchronize()
        assert sqs.distance_chain.launches - before == (1 if fn is sqs.distance_chain else 0)
        outs.append(run)
    kernel, twin = outs
    F = ops["feat"].shape[0]
    for key in DISTANCE_STATE:
        mine = kernel[key][:F] if key == "feat" else kernel[key]
        assert torch.equal(mine, twin[key]), key
    counts = [(o["occ"] == 1).sum(dim=0) for o in (ops, kernel)]
    assert torch.equal(*counts)  # each walker keeps its composition
    assert bool((kernel["best_d"] <= ops["best_d"]).all())
    return kernel, twin


@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize(
    "stem,shape,W,block_size,beta",
    [("sqs_fcc8", 0, 256, 64, 2.0), ("sqs_fcc8", 7, 100, 64, 2.0),
     ("sqs_fcc8", 19, 96, 8, 0.0), ("sqs_fcc_4x4x4", 0, 1000, 512, 50.0),
     ("sqs_fcc8", 0, 2048, 512, 0.2),  # the main path's launch shape
     ("sqs_fcc_4x4x4", 0, 2048, 512, 2.0)],
)
def test_distance_kernel_matches_twin(card, rng, stem, shape, W, block_size, beta):
    ops, proc = _distance_operands(card, stem, W, 300, block_size, beta, shape)
    kernel, _ = _distance_kernel_and_twin(ops, rng)
    accepted = float(kernel["naccept"].double().mean()) / 300
    assert 0 < accepted < 1
    exact = proc.compute_scores(_occupancy(ops, kernel["occ"], proc))
    assert float((exact - kernel["d"]).abs().max()) < 1e-12


def _occupancy(ops, occ, proc):
    """[W, N] occupancy of rank-major codes ``occ`` (the sites outside the
    ranks hold code 0)."""
    occu = torch.zeros((occ.shape[1], proc.num_sites), dtype=torch.int64, device=occ.device)
    occu[:, ops["tables"].rank_sites] = occ.T.long()
    return occu


@pytest.mark.cuda
def test_distance_kernel_without_match_term(card):
    ops, _ = _distance_operands(card, "sqs_fcc8", 256, 300, 64, beta=2.0)
    ops["tables"] = dataclasses.replace(ops["tables"], match_weight=0.0)
    _distance_kernel_and_twin(ops, "philox")


@pytest.mark.cuda
def test_distance_kernel_general_bodies(card):
    """A fourth, empty slot and four more features with no rows, zero
    weight and target, in a last group of diameter 0, take the general
    body (runtime K, up to 32 features); neither changes a result."""
    ops, _ = _distance_operands(card, "sqs_fcc_4x4x4", 256, 300, 64, beta=2.0)
    t = ops["tables"]
    extra = 4
    zeros = torch.zeros(extra, dtype=torch.float64, device=card)
    padded = dataclasses.replace(
        t,
        nbr=torch.nn.functional.pad(t.nbr, (0, 1), value=-1),
        stride=torch.nn.functional.pad(t.stride, (0, 1), value=0),
        seg=torch.cat([t.seg, t.seg[:, -1:].expand(-1, extra)], dim=1).contiguous(),
        feature_ids=np.concatenate([t.feature_ids, np.zeros(extra, dtype=np.int64)]),
        target=torch.cat([t.target, zeros]), weight=torch.cat([t.weight, zeros]),
        group_last=torch.nn.functional.pad(t.group_last, (0, extra), value=1),
        group_diameter=torch.cat([t.group_diameter, zeros]),
    )
    kernel_ops = {**ops, "tables": padded,
                  "feat": torch.cat([ops["feat"], ops["feat"].new_zeros(extra, 256)])}
    kernel, _ = _distance_kernel_and_twin(ops, "philox", kernel_ops=kernel_ops)
    assert not bool(kernel["feat"][t.num_feats:].any())


@pytest.mark.cuda
def test_distance_kernel_refuses_what_it_cannot_take(card):
    from smol_tpu_torch.ops import sqs

    ops, _ = _distance_operands(card, "sqs_fcc8", 64, 10, 64)
    before = sqs.distance_chain.launches
    with pytest.raises(ValueError, match="operand"):
        sqs.distance_chain(**{**ops, "feat": ops["feat"][:2].contiguous()})
    with pytest.raises(ValueError):
        sqs.distance_chain(**{**ops, "best_occ": ops["best_occ"].cpu()})
    assert sqs.distance_chain.launches == before
