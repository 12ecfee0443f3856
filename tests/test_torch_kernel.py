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
slot count) kernels, the flip twin summing at the lanes of the kernel's
launch; a refused operand raises before any launch.  The flip kernel at
each launch design (1 to 16 lanes a walker, rows resident where they fit
or streamed) must equal the twin at the same lanes bit for bit
(enthalpies too) in every site body, with and without the Ewald term, and
a plan that cannot fit raises before any launch.  So must
both with K3's q-ary body: q = 3 on bench ``sgc`` (3x3x3, and 6x6x6 at the
main path's launch shape) and the ternary CE's canonical swaps, q = 2 on
Au-Cu, and the runtime neighbour count body; and the direct body on the
ternary tables.  The
table-move kernel likewise, in its two-slot body (the semigrand spinel
CE + Ewald), its runtime slot count body (the rocksalt whose moves recolor
up to three sites, and the spinel's table padded to four slots), keeping
every walker's net charge.  The Wang-Landau kernel must equal its twin on
every walker and every plane (entropies to 0.0), for flips and swaps, with
both slot-count bodies, the Ewald term, a partial block, sequence blocks
below a CUDA block, 8192 walkers and a flatness reset in every run; and in
each launch design (1 to 16 lanes a walker, rows resident or streamed, the
planes global or the entropy in shared memory), against
the twin summing in that many lanes' order.  The
distance (SQS) kernel must equal its twin bit for bit on every walker
(occupancy, best occupancy, features, score, best score, accept count) in
both RNG modes, at beta 0, 0.2, 2 and 50, on the bench's 8-site shapes and
the 64-site one, at the main path's 2048 walkers in blocks of 512, with a
partial CUDA block, sequence blocks below a CUDA block, without the match
term, and in its general body (runtime K, up to 32 features); at 1 to 16
lanes a walker with its rows resident or streamed, packed or not, against the twin
summing in that many lanes' order; and as one launch over four 8-site
shapes, against each shape's own launch and the batched twin.  The flip
and swap kernels with K1-Ising's parity body must equal the Ising twin on
the spinels (1 and 3 words of rank bits, with and without the Ewald
term), bench ``tempering``'s Au-Cu 3x3x3 (its launch shape, and a partial
block) and Au-Cu 4x4x4 swaps (the canonical launch shape), in both RNG
modes, and with masks padded to 2 and 4 words; the replica-exchange kernel
must equal its twin bit for bit (betas, their f32 copies and the accepted
counts) over 3000 sweeps, for even and odd walker counts; and a tempering
window on the card must equal the same window of twins on the CPU, as must
sweep-mode flips run in several segments of one call.  The table-move and
Wang-Landau kernels with K1-Ising's and K3's bodies must equal their twins
the same way: table moves on the semigrand spinel CE + Ewald (1 and 3 words
of rank bits, K3 with the Ewald term) and the tiny Li/Mn cell, in the
runtime slot count body too; Wang-Landau flips and swaps on Au-Cu (the
main paths' launch shapes), the 8-site cell, the spinel CE + Ewald, the
ternary ``sgc`` window (q = 3) and the quaternary rocksalt (q = 4), with
masks padded to 2 and 4 words; and K3 with q = 4, and q = 2 with the Ewald
term, in the flip and swap kernels.  The table-move and swap kernels, each with
the Ewald term, on bench ``spinel-ewald`` 2x2x2 built here as ``bench.py``
builds it (the decomposition composed with the Ewald term, the usher's
flip table derived), in the direct and K1-Ising bodies.
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


def _operands(card, cell, W, n_steps, block_size, move="flip", delta="direct",
              ensemble=None):
    """Operands of one launch on system file ``torch_<cell>.npz`` (a bare
    supercell name is the semigrand spinel), or on ``ensemble``, with the
    site body ``delta``."""
    ens = ensemble
    if ens is None:
        stem = cell if "_" in cell else f"spinel_{cell}"
        ens = Ensemble.from_system(load_system(DATA / f"torch_{stem}.npz"), card)
    tables = chain.build_chain_tables(
        ens.processor, ens.sublattices, mu_table=ens.chemical_potential_table,
        delta=delta,
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
        usher = TableFlip(ens.sublattices, **(ens.table_data or {}))  # or derived
        ops["table_move"] = chain.build_table_move(tables, usher)
        ops["dirs"], ops["ranks"] = chain.table_sequences(
            tables, ops["table_move"], gen, shape)
        ops["charges"] = torch.as_tensor(ens.site_charges, device=card)[tables.rank_sites]
    else:
        ops["seq"] = chain.rank_sequence(tables, gen, shape)
    return ops


STATE = ("occ", "enthalpy", "naccept", "nmove")


TWIN_MOVES = {chain.flip_chain_reference: "flip", chain.swap_chain_reference: "swap",
              chain.table_chain_reference: "table"}


def _twin_lanes(ops, twin):
    """The twin sums in the order of the kernel's launch (its lanes)."""
    if twin not in TWIN_MOVES:
        return {}
    return chain.twin_order(TWIN_MOVES[twin], ops["tables"], ops["occ"].shape[1])


def _kernel_and_twin(ops, kernel, twin, rng, kernel_tables=None):
    """Run kernel and twin on copies of ``ops``; return both results."""
    outs = []
    for fn, tables in ((kernel, kernel_tables or ops["tables"]), (twin, ops["tables"])):
        run = {k: (v.clone() if k in STATE else v) for k, v in ops.items()}
        before = kernel.launches
        fn(**{**run, "tables": tables}, rng=rng,
           **(_twin_lanes(ops, twin) if fn is twin else {}))
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
        fn(**run, rng=rng, **_twin_lanes(ops, fn))
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
        fn(**{**run, "tables": tables}, rng=rng, **_twin_lanes(ops, fn))
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


@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize(
    "cell,move,W,block_size",
    [("sgc_3x3x3", "flip", 256, 64), ("sgc_3x3x3", "flip", 200, 8),
     ("sgc_6x6x6", "flip", 8192, 1024),  # the sgc main path's launch shape
     ("sgc_3x3x3", "swap", 1000, 1024),  # the ternary CE, canonical swaps
     ("aucu_4x4x4", "flip", 256, 64), ("aucu_4x4x4", "swap", 8192, 512)],  # q = 2
)
def test_qary_kernel_matches_twin(card, rng, cell, move, W, block_size):
    """K3 in the flip and swap kernels against the q-ary twin."""
    ops = _operands(card, cell, W, 400, block_size, move=move, delta="qary")
    assert ops["tables"].qary == (2 if cell.startswith("aucu") else 3)
    kernel_fn, twin_fn = {"flip": (chain.flip_chain, chain.flip_chain_reference),
                          "swap": (chain.swap_chain, chain.swap_chain_reference)}[move]
    kernel, twin = _kernel_and_twin(ops, kernel_fn, twin_fn, rng)
    _assert_same(kernel, twin, 400)
    if move == "swap":
        counts = [torch.stack([(o["occ"] == c).sum(dim=0) for c in range(3)])
                  for o in (ops, kernel)]
        assert torch.equal(*counts)  # each walker keeps its composition


@pytest.mark.cuda
@pytest.mark.parametrize("move", ["flip", "swap"])
def test_qary_general_neighbour_count_matches_twin(card, move):
    """A third, empty neighbour slot (-1, frequency 0) takes the runtime-NB
    body; the direct body on the same ternary tables (TM = 27) too."""
    ops = _operands(card, "sgc_3x3x3", 256, 400, 64, move=move, delta="qary")
    t = ops["tables"]
    padded = dataclasses.replace(
        t, qnbr=torch.nn.functional.pad(t.qnbr, (0, 1), value=-1).contiguous(),
        qfreq=torch.nn.functional.pad(t.qfreq, (0, 1), value=0).contiguous())
    kernel_fn, twin_fn = {"flip": (chain.flip_chain, chain.flip_chain_reference),
                          "swap": (chain.swap_chain, chain.swap_chain_reference)}[move]
    kernel, twin = _kernel_and_twin(ops, kernel_fn, twin_fn, "philox",
                                    kernel_tables=padded)
    _assert_same(kernel, twin, 400)
    direct = _operands(card, "sgc_3x3x3", 256, 400, 64, move=move)
    kernel, twin = _kernel_and_twin(direct, kernel_fn, twin_fn, "hash")
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
        fn(**run, rng=rng, **_twin_lanes(ops, fn))
        torch.cuda.synchronize()
        assert chain.table_chain.launches - before == (1 if fn is chain.table_chain else 0)
        outs.append(run)
    kernel, twin = outs
    _assert_same(kernel, twin, ops["n_steps"])
    net = [charges.gather(1, o["occ"].long()).sum(dim=0) for o in (ops, kernel)]
    assert torch.equal(*net)  # each walker keeps its net charge
    assert not torch.equal(kernel["occ"], ops["occ"])
    return kernel, twin


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


@pytest.fixture(scope="module")
def built_spinel_ewald(card):
    """Bench ``spinel-ewald`` 2x2x2 built here as ``bench.py`` builds it (the
    decomposition composed with the Ewald term), semigrand and canonical."""
    from smol_tpu_torch.benchmarks.systems import random_expansion, spinel_prim

    ce = random_expansion(spinel_prim(), {2: 5.3, 3: 3.7}, seed=11, ewald=True)
    mus = {"Li+": 0.1, "vacA0+": 0.0, "Mn3+": 0.05, "Mn4+": 0.0}
    return {move: Ensemble.from_cluster_expansion(
        ce, np.diag([2, 2, 2]), chemical_potentials=mus if move == "table" else None,
        device=card) for move in ("table", "swap")}


@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize("delta", ["direct", "ising"])
@pytest.mark.parametrize("move,W,block_size", [
    ("table", 256, 64), ("table", 8192, 1024),  # the last: the main path's shape
    ("swap", 256, 64), ("swap", 8192, 1024)])
def test_built_ewald_kernels_match_twin(card, built_spinel_ewald, rng, delta, move, W,
                                        block_size):
    """K5 and K2, each with K4, on the decomposition + Ewald system built
    here (its usher's flip table derived), against their twins bit for bit."""
    ens = built_spinel_ewald[move]
    assert type(ens.processor.processors[0]).__name__ == "ClusterDecompositionProcessor"
    ops = _operands(card, None, W, 400, block_size, move=move, delta=delta, ensemble=ens)
    assert ops["tables"].has_ewald and ops["tables"].delta == delta
    if move == "table":
        assert ops["table_move"].k_max == 2
        kernel, twin = _table_kernel_and_twin(ops, rng)
    else:
        kernel, twin = _kernel_and_twin(ops, chain.swap_chain, chain.swap_chain_reference,
                                        rng)
        _assert_same(kernel, twin, 400)
        counts = [(o["occ"] == 1).sum(dim=0) for o in (ops, kernel)]
        assert torch.equal(*counts)  # each walker keeps its composition
    assert torch.equal(kernel["enthalpy"], twin["enthalpy"])  # bit for bit


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


def _wl_operands(card, cell, W, n_steps, block_size, move, bins=250, delta="direct",
                 **options):
    """Operands of one Wang-Landau launch on ``torch_<cell>.npz`` with the
    site body ``delta``: a window of ``bins`` bins, five times as wide as the
    starting enthalpies span."""
    system = load_system(DATA / f"torch_{cell}.npz")
    ens = Ensemble.from_system(system, card)
    tables = chain.build_chain_tables(
        ens.processor, ens.sublattices,
        mu_table=None if move == "swap" else ens.chemical_potential_table, delta=delta)
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


def _wl_kernel_and_twin(ops, rng, kernel_tables=None, design=None):
    """The kernel (launched as ``design`` says; None: the default) against
    the twin at the kernel's lanes, on every walker and plane."""
    outs = []
    lanes = chain.wl_lanes(ops["occ"].shape[1], design)
    for fn, tables, extra in ((chain.wl_chain, kernel_tables or ops["tables"],
                               {"_design": design}),
                              (chain.wl_chain_reference, ops["tables"], {"lanes": lanes})):
        run = {k: (v.clone() if k in WL_STATE else v) for k, v in ops.items()}
        before = chain.wl_chain.launches
        fn(**{**run, "tables": tables}, rng=rng, **extra)
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


WL_DESIGNS = {  # the launch's parts: lanes, rows resident or streamed, planes
    "old": chain._WL_OLD_DESIGN,
    "G2-streamed-global": chain._WLDesign(lanes=2, resident=False, planes=0),
    "G4-fit-entropy": chain._WLDesign(lanes=4, planes=1),
    "G8-streamed-entropy": chain._WLDesign(lanes=8, resident=False, planes=1),
    "G16-fit": chain._WLDesign(lanes=16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize("design", sorted(WL_DESIGNS))
@pytest.mark.parametrize("cell,move,delta,W,block_size", [
    ("aucu_wl_3x3x3", "flip", "ising", 1000, 1024), ("aucu_4x4x4", "swap", "ising", 200, 8),
    ("aucu_wl_3x3x3", "flip", "direct", 256, 64), ("aucu_4x4x4", "swap", "direct", 256, 64),
    ("spinel_ewald_2x2x2", "swap", "ising", 256, 64),
    ("sgc_wl_3x3x3", "flip", "qary", 200, 100)])
def test_wl_kernel_designs_match_twin(card, rng, design, cell, move, delta, W, block_size):
    """Each launch design (one thread a walker, 2 to 16 lanes; rows
    resident where they fit or streamed; the planes global or the entropy
    in shared memory) equals the twin summing in its lanes'
    order, bit for bit, on every body, with a partial block and sequence
    blocks below a CUDA block."""
    ops = _wl_operands(card, cell, W, 300, block_size, move, delta=delta)
    kernel, _ = _wl_kernel_and_twin(ops, rng, design=WL_DESIGNS[design])
    if move == "swap":
        counts = [(o["occ"] == 1).sum(dim=0) for o in (ops, kernel)]
        assert torch.equal(*counts)  # each walker keeps its composition


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
    proc = CorrelationDistanceProcessor.from_system(systems[shape], card)
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
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16])
def test_distance_kernel_lanes_and_layouts(card, lanes, resident, packed):
    """Each lane count, with every rank's rows resident or streamed, packed
    or not, equals the twin summing in that many lanes' order; with a
    partial block."""
    from smol_tpu_torch.ops import sqs

    ops, _ = _distance_operands(card, "sqs_fcc8", 200, 300, 64, beta=2.0, shape=3)
    design = sqs._Design(lanes=lanes, resident=resident, packed=packed)
    for rng in ("hash", "philox"):
        kernel = {k: (v.clone() if k in DISTANCE_STATE else v) for k, v in ops.items()}
        twin = {k: (v.clone() if k in DISTANCE_STATE else v) for k, v in ops.items()}
        sqs.distance_chain(**kernel, rng=rng, _design=design)
        sqs.distance_chain_reference(**twin, rng=rng, lanes=lanes)
        torch.cuda.synchronize()
        for key in DISTANCE_STATE:
            assert torch.equal(kernel[key], twin[key]), (rng, key)


@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["hash", "philox"])
def test_distance_kernel_batched_launch(card, rng):
    """One launch over four 8-site shapes (65 to 67 rows a rank, padded)
    equals each shape's own launch and the batched twin, bit for bit."""
    from smol_tpu_torch.ops import sqs

    shapes = [_distance_operands(card, "sqs_fcc8", 160, 120, 32, 2.0, s)[0]
              for s in (0, 1, 2, 11)]
    for s, ops in enumerate(shapes):
        ops["seed"] = ops["seed"] + s
    names = (*DISTANCE_STATE, "beta32", "useq", "vseq")
    stacked = {k: torch.stack([o[k] for o in shapes]) for k in names}
    stacked.update(seed=torch.cat([o["seed"] for o in shapes]), n_steps=120, block_size=32,
                   batch=sqs.stack_distance_tables([o["tables"] for o in shapes]))
    twin = {k: (v.clone() if k in DISTANCE_STATE else v) for k, v in stacked.items()}
    design = sqs._Design(lanes=2)  # the same lanes for the batch and each shape
    before = sqs.distance_chain.launches
    sqs.distance_chain_batched(**stacked, rng=rng, _design=design)
    assert sqs.distance_chain.launches - before == 1
    sqs.distance_chain_batched_reference(**twin, rng=rng, lanes=2)
    for s, ops in enumerate(shapes):
        own = {k: (v.clone() if k in DISTANCE_STATE else v) for k, v in ops.items()}
        sqs.distance_chain(**own, rng=rng, _design=design)
        torch.cuda.synchronize()
        for key in DISTANCE_STATE:
            assert torch.equal(stacked[key][s], own[key]), (s, key)
            assert torch.equal(stacked[key][s], twin[key][s]), (s, key)


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


# ---------------- K1-Ising and the replica-exchange kernel ----------------

ISING_CELLS = [  # (cell, move, W, block_size)
    ("spinel_2x2x2", "flip", 256, 64), ("spinel_3x3x3", "flip", 1000, 1024),  # NW = 3
    ("aucu_pt_3x3x3", "flip", 8192, 1024),  # bench tempering's launch shape
    ("aucu_pt_3x3x3", "flip", 200, 8),  # a partial block, sequence blocks of 8
    ("aucu_4x4x4", "swap", 8192, 512),  # bench canonical's launch shape
    ("spinel_ewald_2x2x2", "swap", 256, 64), ("spinel_ewald_3x3x3", "swap", 1000, 1024),
    ("spinel_ewald_2x2x2", "flip", 256, 64),  # the flip chain with the Ewald term
]


@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize("cell,move,W,block_size", ISING_CELLS)
def test_ising_kernel_matches_twin(card, rng, cell, move, W, block_size):
    """K1-Ising in the flip and swap kernels against the Ising twin."""
    ops = _operands(card, cell, W, 400, block_size, move=move, delta="ising")
    assert ops["tables"].ising == (3 if cell.endswith("3x3x3") and "spinel" in cell else 1)
    kernel_fn, twin_fn = {"flip": (chain.flip_chain, chain.flip_chain_reference),
                          "swap": (chain.swap_chain, chain.swap_chain_reference)}[move]
    before = kernel_fn.ising_launches
    kernel, twin = _kernel_and_twin(ops, kernel_fn, twin_fn, rng)
    assert kernel_fn.ising_launches - before == 1
    _assert_same(kernel, twin, 400)
    if move == "swap":
        counts = [(o["occ"] == 1).sum(dim=0) for o in (ops, kernel)]
        assert torch.equal(*counts)  # each walker keeps its composition


@pytest.mark.cuda
@pytest.mark.parametrize("words", [2, 4])
@pytest.mark.parametrize("move,cell", [("flip", "aucu_pt_3x3x3"),
                                       ("swap", "spinel_ewald_2x2x2")])
def test_ising_wider_words_match_twin(card, words, move, cell):
    """Masks padded with zero words take the Ising<2> and Ising<4> bodies
    (the ranks beyond R hold no code) and change nothing."""
    ops = _operands(card, cell, 256, 400, 64, move=move, delta="ising")
    t = ops["tables"]
    padded = dataclasses.replace(
        t, ising=words,
        imask=torch.nn.functional.pad(t.imask, (0, words - t.ising)).contiguous())
    kernel_fn, twin_fn = {"flip": (chain.flip_chain, chain.flip_chain_reference),
                          "swap": (chain.swap_chain, chain.swap_chain_reference)}[move]
    kernel, twin = _kernel_and_twin(ops, kernel_fn, twin_fn, "philox",
                                    kernel_tables=padded)
    _assert_same(kernel, twin, 400)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [8192, 8191, 2])
def test_exchange_kernel_matches_twin(card, W):
    """3000 sweeps of alternating phase, bit for bit: beta, its f32 copy and
    the accepted exchanges."""
    from smol_tpu_torch.parallel import exchange_betas, make_temperature_ladder

    gen = torch.Generator(device=card).manual_seed(5)
    ladder = torch.as_tensor(make_temperature_ladder(300.0, 3000.0, W), device=card)
    beta = 1.0 / (kB * ladder)
    beta32 = beta.to(torch.float32)
    twin, twin32 = beta.cpu(), beta32.cpu()
    counts = torch.zeros(W, dtype=torch.int32, device=card)
    twin_counts = counts.cpu()
    before = exchange_betas.launches
    sweeps, accepted = 3000, 0
    for s in range(sweeps):
        enthalpy = torch.randn(W, generator=gen, dtype=torch.float64, device=card)
        enthalpy[: W // 4] = 0.0  # exact ties
        u = torch.rand(W, generator=gen, dtype=torch.float64, device=card)
        old = beta.clone()
        exchange_betas(beta, beta32, enthalpy, u, s % 2, counts)
        exchange_betas(twin, twin32, enthalpy.cpu(), u.cpu(), s % 2, twin_counts)
        accepted += int((beta != old).sum())
    torch.cuda.synchronize()
    assert exchange_betas.launches - before == sweeps
    assert torch.equal(beta.cpu(), twin) and torch.equal(beta32.cpu(), twin32)
    assert torch.equal(counts.cpu(), twin_counts)
    assert torch.equal(beta32, beta.to(torch.float32))
    assert torch.equal(torch.sort(beta).values, torch.sort(1.0 / (kB * ladder)).values)
    assert accepted > 0


@pytest.mark.cuda
@pytest.mark.parametrize("delta", ["direct", "ising"])
def test_tempering_chain_on_card_matches_cpu(card, delta):
    """The same segmented window (hash mode, the same draws) through the
    kernels on the card and through the twins on the CPU."""
    from smol_tpu_torch.parallel import make_temperature_ladder, make_tempering_chain

    ens = Ensemble.from_system(load_system(DATA / "torch_aucu_pt_3x3x3.npz"), card)
    W, period, n_seg, block = 256, 10, 8, 64
    tables = {dev: chain.build_chain_tables(
        e.processor, e.sublattices, mu_table=e.chemical_potential_table, delta=delta)
        for dev, e in (("cuda", ens), ("cpu", Ensemble.from_system(
            load_system(DATA / "torch_aucu_pt_3x3x3.npz"), "cpu")))}
    gen = torch.Generator().manual_seed(1)
    seqs = chain.rank_sequence(tables["cpu"], gen, (n_seg, 1, W // block, period)).numpy()
    seeds = np.arange(n_seg, dtype=np.int64)[:, None] * 7919 + 99
    uniforms = torch.rand((n_seg, W), generator=gen, dtype=torch.float64).numpy()
    occu = random_occupancies(ens, W, seed=2)
    beta = 1.0 / (kB * make_temperature_ladder(300.0, 3000.0, W))
    theta = torch.as_tensor(ens.natural_parameters)
    enthalpy = ens.compute_features(torch.as_tensor(occu, device=card)).cpu() @ theta
    outs = {}
    for dev in ("cuda", "cpu"):
        run = make_tempering_chain(chain.make_shared_proposal_chain(
            tables[dev], period, block_size=block, rng="hash", seqs=seqs, seeds=seeds),
            n_seg, uniforms=uniforms)
        state = {"occupancy": torch.tensor(occu, device=dev),
                 "enthalpy": enthalpy.to(dev).contiguous(),
                 "beta": torch.tensor(beta, device=dev),  # a copy: exchanged in place
                 "naccept": torch.zeros(W, dtype=torch.int32, device=dev),
                 "accepted": torch.ones(W, dtype=torch.bool, device=dev), "pt_counter": 0}
        outs[dev] = run(state, None)
    torch.cuda.synchronize()
    for key in ("occupancy", "beta", "naccept"):
        assert torch.equal(outs["cuda"][key].cpu(), outs["cpu"][key]), key
    assert float((outs["cuda"]["enthalpy"].cpu() - outs["cpu"]["enthalpy"]).abs().max()) <= 1e-9
    assert outs["cuda"]["pt_counter"] == n_seg
    assert not np.array_equal(outs["cpu"]["beta"].numpy(), beta)


@pytest.mark.cuda
@pytest.mark.parametrize("delta", ["direct", "ising"])
def test_sweep_segments_on_card_match_cpu(card, delta):
    """Sweep-mode flips in several segments of one call, on the card and on
    the CPU.  The launches read a contiguous copy of the expanded sweep
    schedule; between segments an allocation the size of that copy is
    filled with -1, which would overwrite it had it gone back to the
    allocator before the last launch."""
    W, period, n_seg, block = 256, 10, 6, 64
    seeds = np.arange(n_seg, dtype=np.int64) * 7919 + 99
    outs = {}
    for dev in ("cuda", "cpu"):
        ens = Ensemble.from_system(load_system(DATA / "torch_aucu_pt_3x3x3.npz"), dev)
        tables = chain.build_chain_tables(ens.processor, ens.sublattices,
                                          mu_table=ens.chemical_potential_table,
                                          delta=delta)
        fn = chain.make_shared_proposal_chain(tables, period, block_size=block,
                                              proposal_mode="sweep", rng="hash",
                                              seeds=seeds)
        occu = torch.as_tensor(random_occupancies(ens, W, seed=2), device=dev)
        theta = torch.as_tensor(ens.natural_parameters, device=dev)
        state = {"occupancy": occu,
                 "enthalpy": (ens.compute_features(occu) @ theta).contiguous(),
                 "beta": torch.full((W,), 1.0 / (kB * 1000.0), dtype=torch.float64,
                                    device=dev),
                 "naccept": torch.zeros(W, dtype=torch.int32, device=dev),
                 "accepted": torch.ones(W, dtype=torch.bool, device=dev)}

        def between(s, beta32):
            torch.full((n_seg * (W // block) * period,), -1, dtype=torch.int32,
                       device=dev)

        outs[dev] = fn(state, None, segments=n_seg, between=between)
    torch.cuda.synchronize()
    for key in ("occupancy", "naccept"):
        assert torch.equal(outs["cuda"][key].cpu(), outs["cpu"][key]), key
    assert float((outs["cuda"]["enthalpy"].cpu() - outs["cpu"]["enthalpy"]).abs().max()) <= 1e-9
    assert 0 < int(outs["cpu"]["naccept"].sum()) < W * period * n_seg


# ---------------- the site bodies in the table and Wang-Landau kernels ----------------

@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize(
    "cell,delta,W,block_size",
    [("spinel_ewald_sgc_2x2x2", "ising", 256, 64),
     ("spinel_ewald_sgc_3x3x3", "ising", 8192, 1024),  # NW = 3, the main path's shape
     ("spinel_ewald_sgc_2x2x2", "ising", 200, 8),
     ("spinel_ewald_sgc_2x2x2", "qary", 256, 64),  # K3 (q = 2) with the Ewald term
     ("limn_tiny_2x1x1", "ising", 256, 64), ("limn_tiny_2x1x1", "qary", 256, 64)],
)
def test_table_kernel_bodies_match_twin(card, rng, cell, delta, W, block_size):
    """K1-Ising and K3 in the table-move kernel against their twins."""
    ops = _operands(card, cell, W, 400, block_size, move="table", delta=delta)
    assert ops["tables"].delta == delta
    counter = f"{delta}_launches"
    before = getattr(chain.table_chain, counter)
    _table_kernel_and_twin(ops, rng)
    assert getattr(chain.table_chain, counter) - before == 1


@pytest.mark.cuda
@pytest.mark.parametrize("delta", ["ising", "qary"])
def test_table_kernel_bodies_runtime_slot_count(card, delta):
    """The spinel's table padded to four slots: the runtime slot count body."""
    ops = _operands(card, "spinel_ewald_sgc_2x2x2", 256, 400, 64, move="table",
                    delta=delta)
    tm = ops["table_move"]
    padded = chain.make_table_move(
        ops["tables"], tm.n_dirs, 4, tm.swap_weight,
        *(np.pad(x, ((0, 0), (0, 2)), constant_values=fill)
          for x, fill in ((tm.from_code, -1), (tm.to_code, -1), (tm.slot_valid, 0),
                          (tm.slot_sub, 0))),
        tm.dir_cum_probs,
    )
    _table_kernel_and_twin(ops, "philox", kernel_move=padded)


@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize(
    "cell,move,delta,W,block_size",
    [("aucu_wl_3x3x3", "flip", "ising", 256, 64),
     ("aucu_wl_3x3x3", "flip", "ising", 8192, 1024),
     ("aucu_wl_3x3x3", "flip", "ising", 2048, 1024),  # the main path's launch shape
     ("aucu_4x4x4", "swap", "ising", 2048, 1024), ("aucu_4x4x4", "swap", "ising", 200, 8),
     ("aucu_nn_2x2x2", "flip", "ising", 200, 8),
     ("spinel_ewald_2x2x2", "swap", "ising", 256, 64),
     ("spinel_ewald_2x2x2", "swap", "qary", 256, 64),  # q = 2 with the Ewald term
     ("sgc_wl_3x3x3", "flip", "qary", 2048, 1024),  # q = 3
     ("aucu_4x4x4", "swap", "qary", 256, 64),
     ("rocksalt_q4_2x2x2", "flip", "qary", 256, 64)],  # q = 4
)
def test_wl_kernel_bodies_match_twin(card, rng, cell, move, delta, W, block_size):
    """K1-Ising and K3 in the Wang-Landau kernel against their twins."""
    bins = 10 if cell == "aucu_nn_2x2x2" else 250
    ops = _wl_operands(card, cell, W, 400, block_size, move, bins=bins, delta=delta)
    assert ops["tables"].delta == delta
    counter = f"{delta}_launches"
    before = getattr(chain.wl_chain, counter)
    kernel, _ = _wl_kernel_and_twin(ops, rng)
    assert getattr(chain.wl_chain, counter) - before == 1
    if move == "swap":
        counts = [(o["occ"] == 1).sum(dim=0) for o in (ops, kernel)]
        assert torch.equal(*counts)  # each walker keeps its composition


@pytest.mark.cuda
@pytest.mark.parametrize("words", [2, 4])
@pytest.mark.parametrize("move,cell", [("flip", "aucu_wl_3x3x3"), ("swap", "aucu_4x4x4")])
def test_wl_ising_wider_words_match_twin(card, words, move, cell):
    """Masks padded with zero words take the Ising<2> and Ising<4> bodies."""
    ops = _wl_operands(card, cell, 256, 400, 64, move, delta="ising")
    t = ops["tables"]
    padded = dataclasses.replace(
        t, ising=words,
        imask=torch.nn.functional.pad(t.imask, (0, words - t.ising)).contiguous())
    _wl_kernel_and_twin(ops, "philox", kernel_tables=padded)


@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize(
    "cell,move,q",
    [("rocksalt_q4_2x2x2", "flip", 4), ("spinel_ewald_2x2x2", "flip", 2),
     ("spinel_ewald_2x2x2", "swap", 2)],
)
def test_qary_q4_and_ewald_match_twin(card, rng, cell, move, q):
    """K3 with q = 4 (mixed quaternary and binary sites) and with the Ewald
    term in the flip and swap kernels."""
    ops = _operands(card, cell, 256, 400, 64, move=move, delta="qary")
    assert ops["tables"].qary == q
    assert ops["tables"].has_ewald == cell.startswith("spinel_ewald")
    kernel_fn, twin_fn = {"flip": (chain.flip_chain, chain.flip_chain_reference),
                          "swap": (chain.swap_chain, chain.swap_chain_reference)}[move]
    kernel, twin = _kernel_and_twin(ops, kernel_fn, twin_fn, rng)
    _assert_same(kernel, twin, 400)


# ---------------- K1's launch: lanes and resident rows ----------------

FLIP_DESIGNS = {  # threads a walker, every rank's rows resident (None: where they fit)
    "G1-streamed": chain._FlipDesign(lanes=1, resident=False),
    "G2-fit": chain._FlipDesign(lanes=2),
    "G4-streamed": chain._FlipDesign(lanes=4, resident=False),
    "G8-fit": chain._FlipDesign(lanes=8),
    "G16-fit": chain._FlipDesign(lanes=16),
    "G16-streamed": chain._FlipDesign(lanes=16, resident=False),
}
FLIP_BODY_CELLS = [  # (cell, site body): every body, with and without the Ewald term
    ("spinel_2x2x2", "ising"),  # K1-Ising, one word, rows fit
    ("spinel_3x3x3", "ising"),  # three words, rows streamed
    ("spinel_ewald_2x2x2", "ising"),  # with the Ewald term
    ("spinel_ewald_2x2x2", "qary"),  # K3, q = 2 with the Ewald term
    ("spinel_ewald_2x2x2", "direct"),  # the direct body with the Ewald term
    ("sgc_3x3x3", "qary"),  # K3, q = 3
    ("sgc_3x3x3", "direct"),  # the direct body, TM = 27
    ("rocksalt_q4_2x2x2", "qary"),  # K3, q = 4
]


@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize("design", sorted(FLIP_DESIGNS))
@pytest.mark.parametrize("cell,delta", FLIP_BODY_CELLS)
def test_flip_kernel_designs_match_twin(card, rng, design, cell, delta):
    """Each launch design of K1 (1 to 16 lanes a walker, rows resident
    where they fit or streamed) equals the twin summing in its lanes'
    order, bit for bit: occupancies, accept counts and enthalpies."""
    ops = _operands(card, cell, 256, 300, 64, delta=delta)
    assert ops["tables"].delta == delta
    d = FLIP_DESIGNS[design]
    kernel = {k: (v.clone() if k in STATE else v) for k, v in ops.items()}
    twin = {k: (v.clone() if k in STATE else v) for k, v in ops.items()}
    before = chain.flip_chain.launches
    chain.flip_chain(**kernel, rng=rng, _design=d)
    chain.flip_chain_reference(**twin, rng=rng, lanes=d.lanes)
    torch.cuda.synchronize()
    assert chain.flip_chain.launches - before == 1
    for key in ("occ", "naccept", "enthalpy"):
        assert torch.equal(kernel[key], twin[key]), key
    assert 0 < float(kernel["naccept"].double().mean()) < 300


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["G2-fit", "G16-streamed"])
def test_flip_kernel_partial_block_designs_match_twin(card, design):
    """A partial CUDA block and sequence blocks of 8 walkers (blocks of 8
    walkers), at two designs."""
    ops = _operands(card, "aucu_pt_3x3x3", 200, 300, 8, delta="ising")
    d = FLIP_DESIGNS[design]
    kernel = {k: (v.clone() if k in STATE else v) for k, v in ops.items()}
    twin = {k: (v.clone() if k in STATE else v) for k, v in ops.items()}
    chain.flip_chain(**kernel, rng="philox", _design=d)
    chain.flip_chain_reference(**twin, rng="philox", lanes=d.lanes)
    torch.cuda.synchronize()
    for key in ("occ", "naccept", "enthalpy"):
        assert torch.equal(kernel[key], twin[key]), key


@pytest.mark.cuda
def test_flip_kernel_refuses_a_plan_that_does_not_fit(card):
    """Rows asked resident where they do not fit raise before any launch."""
    ops = _operands(card, "sgc_6x6x6", 8192, 10, 1024, delta="direct")
    before = chain.flip_chain.launches
    with pytest.raises(ValueError, match="shared memory"):
        chain.flip_chain(**ops, _design=chain._FlipDesign(resident=True))
    assert chain.flip_chain.launches == before


# ---------------- K2's and K5's launch: lanes and resident rows ----------------

LANE_DESIGNS = {  # threads a walker, rows resident (None: where they fit)
    "G1-streamed": chain._LaneDesign(lanes=1, resident=False),
    "G2-fit": chain._LaneDesign(lanes=2),
    "G4-streamed": chain._LaneDesign(lanes=4, resident=False),
    "G8-fit": chain._LaneDesign(lanes=8),
    "G16-fit": chain._LaneDesign(lanes=16),
    "G16-streamed": chain._LaneDesign(lanes=16, resident=False),
}
SWAP_BODY_CELLS = [  # (cell, site body): every body, with and without the Ewald term
    ("spinel_ewald_2x2x2", "ising"),  # rows fit
    ("spinel_ewald_2x2x2", "qary"),  # K3, q = 2 with the Ewald term, rows fit
    ("spinel_ewald_2x2x2", "direct"),  # rows streamed
    ("spinel_ewald_3x3x3", "ising"),  # three words, rows streamed
    ("aucu_4x4x4", "ising"),  # no Ewald term, rows fit
    ("aucu_4x4x4", "direct"),
    ("sgc_3x3x3", "qary"),  # K3, q = 3
]
TABLE_BODY_CELLS = [
    ("spinel_ewald_sgc_2x2x2", "ising"),
    ("spinel_ewald_sgc_2x2x2", "qary"),
    ("spinel_ewald_sgc_2x2x2", "direct"),
    ("spinel_ewald_sgc_3x3x3", "ising"),
    ("lmof_2x2x2", "direct"),  # three slots: the runtime slot count
]


def _design_vs_twin(ops, move, design, rng):
    """The kernel under ``design`` and the twin in its order, bit for bit."""
    kernel_fn = {"swap": chain.swap_chain, "table": chain.table_chain}[move]
    twin_fn = {"swap": chain.swap_chain_reference, "table": chain.table_chain_reference}[move]
    charges = ops.pop("charges", None)
    kernel = {k: (v.clone() if k in STATE else v) for k, v in ops.items()}
    twin = {k: (v.clone() if k in STATE else v) for k, v in ops.items()}
    before = kernel_fn.launches
    kernel_fn(**kernel, rng=rng, _design=design)
    twin_fn(**twin, rng=rng, **chain.twin_order(move, ops["tables"], ops["occ"].shape[1],
                                                design))
    torch.cuda.synchronize()
    assert kernel_fn.launches - before == 1
    for key in ("occ", "naccept", "nmove", "enthalpy"):
        if key in kernel:
            assert torch.equal(kernel[key], twin[key]), key
    assert 0 < float(kernel["naccept"].double().mean()) < ops["n_steps"]
    if charges is not None:  # each walker keeps its net charge
        net = [charges.gather(1, o["occ"].long()).sum(dim=0) for o in (ops, kernel)]
        assert torch.equal(*net)
    else:  # each walker keeps its composition
        assert torch.equal(*(torch.sort(o["occ"], dim=0).values for o in (ops, kernel)))


@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize("design", sorted(LANE_DESIGNS))
@pytest.mark.parametrize("cell,delta", SWAP_BODY_CELLS)
def test_swap_kernel_designs_match_twin(card, rng, design, cell, delta):
    """Each launch design of K2 (1 to 16 lanes a walker, rows resident
    where they fit or streamed) equals the twin summing in its order, bit for bit: occupancies, accept
    and move counts, enthalpies."""
    ops = _operands(card, cell, 256, 300, 64, move="swap", delta=delta)
    assert ops["tables"].delta == delta
    _design_vs_twin(ops, "swap", LANE_DESIGNS[design], rng)


@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize("design", sorted(LANE_DESIGNS))
@pytest.mark.parametrize("cell,delta", TABLE_BODY_CELLS)
def test_table_kernel_designs_match_twin(card, rng, design, cell, delta):
    """Each launch design of K5, as for K2: occupancies, accept counts and
    enthalpies bit for bit, every walker's net charge kept."""
    ops = _operands(card, cell, 256, 300, 64, move="table", delta=delta)
    assert ops["tables"].delta == delta
    _design_vs_twin(ops, "table", LANE_DESIGNS[design], rng)


@pytest.mark.cuda
@pytest.mark.parametrize("move", ["swap", "table"])
def test_partial_block_designs_match_twin(card, move):
    """A partial CUDA block and sequence blocks of 8 walkers."""
    cell = "spinel_ewald_2x2x2" if move == "swap" else "spinel_ewald_sgc_2x2x2"
    for design in ("G2-fit", "G16-streamed", "G8-fit"):
        ops = _operands(card, cell, 200, 300, 8, move=move, delta="ising")
        _design_vs_twin(ops, move, LANE_DESIGNS[design], "philox")


@pytest.mark.cuda
@pytest.mark.parametrize("move", ["swap", "table"])
def test_lane_kernel_refuses_a_plan_that_does_not_fit(card, move):
    """Rows asked resident where they do not fit raise before any launch."""
    cell = "spinel_ewald_3x3x3" if move == "swap" else "spinel_ewald_sgc_3x3x3"
    ops = _operands(card, cell, 8192, 10, 1024, move=move, delta="direct")
    ops.pop("charges", None)
    kernel_fn = {"swap": chain.swap_chain, "table": chain.table_chain}[move]
    before = kernel_fn.launches
    with pytest.raises(ValueError, match="shared memory"):
        kernel_fn(**ops, _design=chain._LaneDesign(resident=True))
    assert kernel_fn.launches == before
