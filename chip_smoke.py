"""Smoke test of smol_tpu_torch on one NVIDIA GPU: build, check, drive, time.

Run from the repository root with ``python3 chip_smoke.py``.  It needs one
CUDA device and the CUDA toolkit (``nvcc``), and exits non-zero without
printing its last line when any phase fails:

1. requires a CUDA device and prints the card's name and power limit;
2. builds the flip-chain, swap-chain, table-chain, Wang-Landau-chain and
   distance-chain kernels from ``smol_tpu_torch/csrc`` (into
   ``build/smol_tpu_torch``, one ``nvcc`` per source, all at once) and
   prints the build time and each kernel's registers and spills;
3. runs each kernel and its plain torch twin on the same inputs at the
   shapes the main paths give the kernel (8192 walkers, one 100-step
   window, sequence blocks of 1024, or 512 for Au-Cu), in ``hash`` mode
   and in ``philox`` mode with a seed above 2**32: the flip chain on both
   semigrand bench spinels and, with the Ewald term, on the spinel
   CE + Ewald 2x2x2; the swap chain on the spinel CE + Ewald 2x2x2 and
   3x3x3 and on Au-Cu 4x4x4; the table chain (charge-neutral table flips)
   on the semigrand spinel CE + Ewald 2x2x2 and 3x3x3 (two slots: the
   compile-time body) and, once, on the Li/Mn/vacancy, O/F rocksalt whose
   moves recolor up to three sites (the runtime slot count body).  Then
   one hash-mode chain across a chunk boundary per kernel (2100 steps; 1076
   for table moves, whose chunk is 2048 // k_max) through
   ``make_shared_proposal_chain``, whose second chunk restarts the step
   counter and takes the next chunk seed, against the twin run chunk by
   chunk.  Occupancies and accept (and move) counts must be identical,
   except where the twin shows the decision within 4 f32 ulps of log U,
   and enthalpies must agree to 1e-9 absolute; swaps must keep every
   walker's composition and table moves every walker's net charge.
   The Wang-Landau chain against its twin on every walker and plane
   (occupancy, entropy to 0.0, histogram, occurrences, ``mod_factor``,
   ``wl_counter``, ``naccept``; enthalpy to 1e-9), 2048 walkers, 100
   steps with a flatness check every 20, in both RNG modes: flips on
   Au-Cu 3x3x3 at the bench's ~250 bins, swaps on Au-Cu 4x4x4, then one
   hash-mode run across the 2048-step chunk boundary, one with
   ``update_period = 3``, and swaps with the Ewald term on the spinel
   CE + Ewald 2x2x2; every compared run must hold a flatness reset.
   Last, the main path's launch for both moves: 2048 walkers from planes
   of zeros, one philox window at flatness 0.8 with a check every 1000
   steps, the first 5000 of its 15000 steps (the twin's time sets that).
   The distance (SQS) chain against its twin, bit for bit on every walker
   (occupancy, best occupancy, features, score, best score, accepts),
   2048 walkers from the generator's starts in blocks of 512: 300 steps on
   the bench's first 8-site shape and on the 64-site shape in both RNG
   modes, a hash-mode chain across the 2048-step chunk boundary through
   ``make_distance_chain``, beta 0, beta 50 (T = 0.02), no match term, and
   the main path's own launch (8000 philox steps at the first stage's
   beta) on the bench shape, its first 2000 steps on the 64-site shape;
   every walker keeps its composition and its score equals the exact
   rescore;
4. drives the main paths, each with the launch counts set to 0 just
   before and read just after:
   - flips: ``Ensemble.from_system(spinel 2x2x2, then 3x3x3)`` ->
     ``Sampler.from_ensemble(T=1000 K, 8192 walkers, seed=3)`` ->
     ``run(20000 steps, thin_by=100)``;
   - canonical swaps: the same on the spinel CE + Ewald 2x2x2 and 3x3x3
     (1000 K) and on Au-Cu 4x4x4 (300 K, blocks of 512), from each file's
     ``initial_occupancy``; no chemical potentials, so the sampler takes
     swaps;
   - charge-neutral table flips: the same with ``step_type="table-flip"``
     on the semigrand spinel CE + Ewald 2x2x2 and 3x3x3 (1000 K), all
     walkers from the file's charge-neutral ``initial_occupancy``;
   - Wang-Landau: ``Sampler.from_ensemble(kernel_type="wang-landau",
     2048 walkers, flatness 0.8, seed=13)`` -> ``run(90000 steps,
     thin_by=15000)``, (a) ``bench.py``'s ``wang-landau`` config, flips on
     Au-Cu 3x3x3 from its random starts, (b) swaps on Au-Cu 4x4x4 from
     shuffled half-and-half starts, each in the window its system file
     carries; checked: the counters, the planes' invariants, the
     modification factors, the compositions, the chain's accumulated
     enthalpy against the exact recompute (< 1e-9) and the one aux record;
     (c) the 8-site nearest-neighbour system, 64 walkers x 200000 steps
     (flatness 0.9, a check every 5000 steps): every walker's log density
     of states within 0.5 of the exact degeneracies;
   - SQS: ``StochasticSQSGenerator.from_processors(<shapes>,
     device="cuda").generate(mcmc_steps=8000, temperatures=linspace(5,
     0.02, 4), nwalkers=2048, seed=23)``, (a) ``bench.py``'s ``sqs``
     config, the 20 shapes of 8 sites, (b) the 64-site shape, each cold
     and then warm on the same generator (bit for bit the same search);
     checked: every launch's compositions and final score against the
     exact rescore (< 1e-9), the stored scores against an exact rescore on
     the CPU (< 1e-9), every walker's best no worse than its start, and a
     matched shell (a negative score) found;
   twice per cell (a first, cold run and a warm one on a fresh sampler,
   which must record the same occupancies and enthalpies to 1e-9), and
   checks the execution path, that the kernel was launched, the recorded
   enthalpy of the last sample against features . theta (< 1e-9
   absolute; the spinel CE + Ewald energies are about -385 eV (2x2x2) and
   -1300 eV (3x3x3), so this is at most 3e-12 of the energy scale), the
   acceptance fraction and, for swaps, that every walker of every sample
   keeps its starting composition, for table flips that every walker of
   every sample has exactly the start's net charge.  The rate is the warm run's; the
   set-up (system load, table build, and the cold run's excess over the
   warm one) is printed on its own.  Swaps also print the fraction of
   non-null proposals (pairs of different codes) and its rate;
5. times one 100-step window at 8192 walkers, kernel against twin, for
   each cell (every repetition on a copy of the same starting state, the
   one the bound is worked out for), the kernels also without their Ewald term
   (K4's share), and works out each kernel's bound: the larger of the
   bytes it must move over the memory rate and its f64 operations over
   the f64 rate (for table moves, the operations of the valid proposals
   only: an identity proposal computes nothing; for the Wang-Landau
   planes, what the launch's data needs: the flatness passes, the cells
   visited, the histograms reset).  The Wang-Landau chain
   is timed on both its cells beside the flip and swap chains on the same
   tables, and at the 2048 walkers of its main path.  The distance chain
   is timed on the main path's own 8000-step launch at 2048 walkers on both
   SQS shapes; on the launches of phase 3 that were timed (8000 steps on
   the bench shape, 2000 on the 64-site one) beside the twin's time of the
   same launch and the bound of the operations that launch's data needs.

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from smol_tpu_torch.capp.generate.special.sqs import StochasticSQSGenerator, random_starts
from smol_tpu_torch.constants import kB
from smol_tpu_torch.moca.ensemble import Ensemble, random_occupancies
from smol_tpu_torch.moca.kernel.tableflip import TableFlip
from smol_tpu_torch.moca.processor.distance import CorrelationDistanceProcessor
from smol_tpu_torch.moca.sampler.sampler import Sampler
from smol_tpu_torch.ops import _build, chain, sqs
from smol_tpu_torch.system import load_system, load_systems

ROOT = Path(__file__).resolve().parent
ULP_SLACK = 4
WALKERS = 8192
BLOCK = 1024  # the sampler's default sequence block
NSTEPS = 20_000
THIN = 100
TEMPERATURE = 1000.0
FLIP_CELLS = ("spinel_2x2x2", "spinel_3x3x3")
# canonical cells: system file stem -> (temperature K, sequence block)
SWAP_CELLS = {
    "spinel_ewald_2x2x2": (1000.0, 1024),
    "spinel_ewald_3x3x3": (1000.0, 1024),
    "aucu_4x4x4": (300.0, 512),  # bench.py's canonical config
}
TABLE_CELLS = {  # bench.py's spinel-ewald config, and its 3x3x3
    "spinel_ewald_sgc_2x2x2": (1000.0, 1024),
    "spinel_ewald_sgc_3x3x3": (1000.0, 1024),
}
MULTI_SLOT_CELL = "lmof_2x2x2"  # table moves of up to three recolorings
# Wang-Landau cells: system file stem -> move; bench.py's wang-landau config
# (2048 walkers, 90000 steps in windows of 15000, flatness 0.8, seed 13)
WL_CELLS = {"aucu_wl_3x3x3": "flip", "aucu_4x4x4": "swap"}
WL_WALKERS = 2048
WL_NSTEPS = 90_000
WL_THIN = 15_000
WL_TWIN_STEPS = 5000  # phase 3's run of the main path's launch: the twin's time sets it
WL_SEED = 13
WL_DOS_CELL = "aucu_nn_2x2x2"  # 8 sites: exact degeneracies
WL_DOS_WALKERS = 64
WL_DOS_NSTEPS = 200_000
WL_DOS_TOLERANCE = 0.5  # on every walker's log-DOS
# SQS cells: bench.py's sqs config (the 20 shapes of 8 sites; 2048 walkers
# x 4 temperatures x 8000 swap steps per shape, seed 23) and the 64-site
# diag(4, 4, 4) shape run the same way
SQS_CELLS = ("sqs_fcc8", "sqs_fcc_4x4x4")
SQS_WALKERS = 2048
SQS_STEPS = 8000
SQS_TEMPERATURES = np.linspace(5.0, 0.02, 4)
SQS_SEED = 23
SQS_BLOCK = 512  # the generator's sequence block
SQS_WINDOW = 300  # phase 3's launches
SQS_TWIN_STEPS = 2000  # the twin's part of the 64-site launch (its time sets it)
SEEDS = (("hash", 987654321), ("philox", 0x2545F4914F6CDD1D))
# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s; FP64 (vector, not the
# tensor cores) at 34 TFLOP/s, both at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_PER_S = 34e12


def check(condition, message):
    if not condition:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0]


def load(stem):
    system = load_system(ROOT / "tests" / "data" / f"torch_{stem}.npz")
    return Ensemble.from_system(system, "cuda"), system


def tables_of(ensemble, move):
    return chain.build_chain_tables(
        ensemble.processor, ensemble.sublattices,
        mu_table=None if move == "swap" else ensemble.chemical_potential_table,
    )


def table_move_of(ensemble, tables):
    usher = TableFlip(ensemble.sublattices, **ensemble.table_data)
    return chain.build_table_move(tables, usher)


def ptxas_summary(log):
    """One line per compiled kernel: its template arguments, spills, registers."""
    lines, name, spills = [], "", ""
    for line in log.splitlines():
        found = re.search(r"([a-z]+_chain_kernel)ILi(\d+)E(?:Li(\d+)E)?(?:Lb([01])E)?", line)
        if "Compiling entry function" in line and found:
            kernel, k, km, ewald = found.groups()
            slots = "" if km is None else f", k_max={km if km != '0' else 'runtime'}"
            if kernel == "wl_chain_kernel":  # <move, K, ewald>
                slots, k = f", move={('flip', 'swap')[int(k)]}", km
            if kernel == "distance_chain_kernel":  # <K, FMAX>
                slots = f", FMAX={km}"
            name = f"{kernel}<K={k if k != '0' else 'runtime'}{slots}"
            name += ">" if ewald is None else f", ewald={ewald == '1'}>"
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spills}")
    return lines


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` in ms over ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def same_window(fn, ops, reps):
    """``fn(**ops)`` for :func:`cuda_ms`, every call on a copy of the starting
    state: a chain updates its state in place, and a table move's work (and
    the bound worked out for it) depends on the occupancies it meets."""
    copies = iter([{key: ops[key].clone() for key in STATE if key in ops}
                   for _ in range(reps + 1)])  # the warm-up call takes one
    return lambda: fn(**{**ops, **next(copies)})


# ---------------- one launch, kernel against twin ----------------

KERNELS = {  # move -> (kernel wrapper, twin)
    "flip": (chain.flip_chain, chain.flip_chain_reference),
    "swap": (chain.swap_chain, chain.swap_chain_reference),
    "table": (chain.table_chain, chain.table_chain_reference),
}
SEQUENCES = {"flip": ("seq",), "swap": ("useq", "vseq"), "table": ("dirs", "ranks")}
WL_PLANES = ("entropy", "histogram", "occurrences", "mod_factor", "wl_counter")
STATE = ("occ", "enthalpy", "naccept", "nmove") + WL_PLANES


def fresh(ops):
    """``ops`` with a copy of every operand a launch updates in place."""
    return {key: (v.clone() if key in STATE else v) for key, v in ops.items()}


def window_operands(ensemble, tables, move, block, occ_seed, seq_seed, n_steps=THIN):
    """Operands of one main-path launch: 8192 walkers in blocks of ``block``."""
    device = ensemble.device
    occu = torch.as_tensor(random_occupancies(ensemble, WALKERS, occ_seed),
                           device=device)
    gen = torch.Generator(device=device).manual_seed(seq_seed)
    shape = (WALKERS // block, n_steps)
    ops = dict(
        occ=occu[:, tables.rank_sites].T.to(torch.int8).contiguous(),
        enthalpy=torch.zeros(WALKERS, dtype=torch.float64, device=device),
        naccept=torch.zeros(WALKERS, dtype=torch.int32, device=device),
        beta32=torch.full((WALKERS,), 1.0 / (kB * TEMPERATURE),
                          dtype=torch.float32, device=device),
        tables=tables, n_steps=n_steps, block_size=block,
    )
    if move == "swap":
        ops["useq"], ops["vseq"] = chain.rank_pair_sequence(tables, gen, shape)
        ops["nmove"] = torch.zeros(WALKERS, dtype=torch.int32, device=device)
    elif move == "table":
        ops["table_move"] = table_move_of(ensemble, tables)
        ops["dirs"], ops["ranks"] = chain.table_sequences(
            tables, ops["table_move"], gen, shape)
    else:
        ops["seq"] = chain.rank_sequence(tables, gen, shape)
    return ops


def net_charges(occ, tables, ensemble):
    """[W] f64 net charge of the active ranks' codes (charges are integers,
    so the sums are exact)."""
    charges = torch.as_tensor(ensemble.site_charges, device=occ.device)[tables.rank_sites]
    return charges.gather(1, occ.long()).sum(dim=0)


def invariant_of(move, tables, ensemble):
    """What a move conserves on every walker: ``occ [R, W] -> tensor``, or None."""
    if move == "swap":
        return lambda occ: compositions(occ, tables)
    if move == "table":
        return lambda occ: net_charges(occ, tables, ensemble)
    return None


def compositions(occ, tables):
    """[S * max codes, W] count of each code on each active sublattice."""
    return torch.stack([
        (occ[off: off + n] == code).sum(dim=0)
        for off, n in zip(tables.sub_offset, tables.n_active)
        for code in range(int(tables.ncode.max()))
    ])


def compare(label, kernel, twin, margin, n_steps, invariant=None, start=None):
    """Kernel against twin: equal walkers, or a decision within ULP_SLACK.

    ``invariant`` (see :func:`invariant_of`) must give ``start``, its value
    on the occupancy the chains began from, on both results.
    """
    same = (kernel["occ"] == twin["occ"]).all(dim=0) & (kernel["naccept"] == twin["naccept"])
    if "nmove" in kernel:
        same &= kernel["nmove"] == twin["nmove"]
    if invariant is not None:
        for side in (kernel, twin):
            check(torch.equal(invariant(side["occ"]), start),
                  f"{label}: a move changed a composition or a net charge")
    near_tie = margin <= ULP_SLACK
    check(bool((same | near_tie).all()),
          f"{label}: {int((~same & ~near_tie).sum())} walkers differ without a near-tie")
    check(float(same.float().mean()) >= 0.99, f"{label}: too many near-tie mismatches")
    err = float((kernel["enthalpy"] - twin["enthalpy"])[same].abs().max())
    check(err <= 1e-9, f"{label}: enthalpy difference {err}")
    accept_frac = float(kernel["naccept"].double().mean()) / n_steps
    check(0.0 < accept_frac < 1.0, f"{label}: acceptance {accept_frac}")
    print(f"phase 3 [{label}]: kernel == twin on {int(same.sum())}/{len(same)} "
          f"walkers ({int((~same).sum())} near-tie), max |dH| {err:.3e}, "
          f"acceptance {accept_frac:.4f}")
    return err


def window_vs_twin(ensemble, name, move, block, rng, seed):
    """Phase 3: one main-path window, kernel against twin."""
    tables = tables_of(ensemble, move)
    ops = window_operands(ensemble, tables, move, block, occ_seed=7, seq_seed=17)
    ops["seed"] = torch.tensor([seed], dtype=torch.int64, device=ensemble.device)
    kernel_fn, twin_fn = KERNELS[move]
    k = fresh(ops)
    t = fresh(ops)
    margin = torch.full((WALKERS,), float("inf"), device=ensemble.device)
    kernel_fn(**k, rng=rng)
    twin_fn(**t, rng=rng, margin=margin)
    torch.cuda.synchronize()
    ewald = "+ewald" if tables.has_ewald else ""
    invariant = invariant_of(move, tables, ensemble)
    return compare(f"{move}{ewald} {name} {rng} seed {seed:#x}", k, t, margin, THIN,
                   invariant, invariant and invariant(ops["occ"]))


def chunked_hash_vs_twin(ensemble, name, move, block):
    """Phase 3: a hash-mode chain across a chunk boundary, kernel vs twin.

    The kernel runs through ``make_shared_proposal_chain`` (which splits
    the steps into chunks of ``MAX_CHUNK_STEPS``, or ``MAX_CHUNK_STEPS //
    k_max`` for table moves); the twin restates the reference's chunking: chunk c takes sequence row c, seed
    ``seed0 + c * SEED_STRIDE`` and counts its steps from 0.
    """
    device = ensemble.device
    tables = tables_of(ensemble, move)
    table_move = table_move_of(ensemble, tables) if move == "table" else None
    chunk = chain.MAX_CHUNK_STEPS // (table_move.k_max if table_move else 1)
    n_steps = chunk + 52
    gen = torch.Generator(device=device).manual_seed(29)
    shape = (2, WALKERS // block, chunk)
    if move == "table":
        seqs = chain.table_sequences(tables, table_move, gen, shape)
    elif move == "swap":
        seqs = chain.rank_pair_sequence(tables, gen, shape)
    else:
        seqs = (chain.rank_sequence(tables, gen, shape),)
    seeds = [123456789 + c * chain.SEED_STRIDE for c in range(2)]
    occu = torch.as_tensor(random_occupancies(ensemble, WALKERS, 11), device=device)
    beta = torch.full((WALKERS,), 1.0 / (kB * TEMPERATURE), dtype=torch.float64,
                      device=device)
    state = {
        "occupancy": occu.clone(),
        "enthalpy": torch.zeros(WALKERS, dtype=torch.float64, device=device),
        "beta": beta,
        "naccept": torch.zeros(WALKERS, dtype=torch.int32, device=device),
        "accepted": torch.ones(WALKERS, dtype=torch.bool, device=device),
        "nmove": torch.zeros(WALKERS, dtype=torch.int32, device=device),
    }
    host_seqs = [s.cpu().numpy() for s in seqs]
    run = chain.make_shared_proposal_chain(
        tables, n_steps, block_size=block, rng="hash", move=move,
        seqs=host_seqs[0] if move == "flip" else host_seqs, seeds=np.asarray(seeds),
        table_move=table_move,
    )
    kernel_fn, twin_fn = KERNELS[move]
    before = kernel_fn.launches
    state = run(state, None)
    check(kernel_fn.launches - before == 2, "chunked run: two launches")

    occ0 = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
    twin = dict(
        occ=occ0.clone(),
        enthalpy=torch.zeros(WALKERS, dtype=torch.float64, device=device),
        naccept=torch.zeros(WALKERS, dtype=torch.int32, device=device),
        beta32=beta.to(torch.float32), tables=tables, block_size=block,
    )
    if move == "swap":
        twin["nmove"] = torch.zeros(WALKERS, dtype=torch.int32, device=device)
    if move == "table":
        twin["table_move"] = table_move
    margin = torch.full((WALKERS,), float("inf"), device=device)
    for c, seed in enumerate(seeds):
        rows = dict(zip(SEQUENCES[move], (s[c] for s in seqs)))
        twin_fn(**twin, **rows, n_steps=min(chunk, n_steps - c * chunk),
                seed=torch.tensor([seed], dtype=torch.int64, device=device),
                rng="hash", margin=margin)
    torch.cuda.synchronize()
    kernel = {"occ": state["occupancy"][:, tables.rank_sites].T.to(torch.int8),
              "enthalpy": state["enthalpy"], "naccept": state["naccept"]}
    if move == "swap":
        kernel["nmove"] = state["nmove"]
    invariant = invariant_of(move, tables, ensemble)
    return compare(f"{move} {name} hash {n_steps} steps, 2 chunks", kernel, twin,
                   margin, n_steps, invariant, invariant and invariant(occ0))


# ---------------- the Wang-Landau chain against its twin ----------------

def wl_window_of(system):
    """The Wang-Landau window a system file carries, as kernel arguments."""
    return {"min_enthalpy": float(system["wl_min_enthalpy"]),
            "max_enthalpy": float(system["wl_max_enthalpy"]),
            "bin_size": float(system["wl_bin_size"])}


def shuffled_occupancies(ensemble, occupancy, count, seed):
    """``count`` occupancies [count, N] int32: ``occupancy`` with the codes of
    each sublattice shuffled among its sites (every composition kept)."""
    rng = np.random.default_rng(seed)
    occu = np.tile(np.asarray(occupancy, dtype=np.int32), (count, 1))
    for sl in ensemble.sublattices:
        occu[:, sl.sites] = rng.permuted(occu[:, sl.sites], axis=1)
    return occu


def wl_starts(ensemble, system, move, count, seed):
    """Starting occupancies of a Wang-Landau run: uniform codes for flips,
    shuffles of the file's ``initial_occupancy`` for swaps."""
    if move == "swap":
        return shuffled_occupancies(ensemble, system["initial_occupancy"], count, seed)
    return np.random.default_rng(seed).integers(
        0, 2, (count, ensemble.num_sites)).astype(np.int32)


def wl_operands(ensemble, system, move, walkers, n_steps, block, occ_seed, seq_seed,
                n_chunks=None, **options):
    """Operands of Wang-Landau launches from fresh planes.  The window is the
    system file's or, for a file without one, five times the span of the
    starting enthalpies in 250 bins (``bench.py``'s scheme)."""
    device = ensemble.device
    tables = tables_of(ensemble, move)
    occu = torch.as_tensor(wl_starts(ensemble, system, move, walkers, occ_seed),
                           device=device)
    theta = torch.as_tensor(ensemble.natural_parameters, device=device)
    enthalpy = (ensemble.compute_features(occu) @ theta).contiguous()
    if "wl_bin_size" in system:
        window = wl_window_of(system)
    else:
        lo, hi = float(enthalpy.min()), float(enthalpy.max())
        span = hi - lo + 1e-3
        window = {"min_enthalpy": lo - 2 * span, "max_enthalpy": hi + 2 * span,
                  "bin_size": span / 50}
    bins = len(np.arange(window["min_enthalpy"], window["max_enthalpy"],
                         window["bin_size"]))
    params = dict(min_enthalpy=window["min_enthalpy"], bin_size=window["bin_size"],
                  num_levels=bins, flatness=0.8, check_period=1000, update_period=1,
                  mod_divisor=2.0)
    params.update(options)
    gen = torch.Generator(device=device).manual_seed(seq_seed)
    return chain.wl_launch_operands(tables, chain.WLChain(**params), move, occu,
                                    enthalpy, n_steps, block, gen, n_chunks)


def compare_wl(label, kernel, twin, start_occ, tables, n_steps, need_reset=True):
    """Kernel against twin on every walker and plane; returns the largest
    difference (entropies must agree to 0.0, enthalpies to 1e-9)."""
    for key in ("occ", "naccept") + WL_PLANES:
        check(torch.equal(kernel[key], twin[key]), f"{label}: {key} differs from the twin's")
    err = float((kernel["enthalpy"] - twin["enthalpy"]).abs().max())
    check(err <= 1e-9, f"{label}: enthalpy difference {err}")
    resets = int((kernel["mod_factor"] < 1).sum())
    check(resets > 0 or not need_reset, f"{label}: no flatness reset in the compared run")
    accept_frac = float(kernel["naccept"].double().mean()) / n_steps
    check(0.0 < accept_frac < 1.0, f"{label}: acceptance {accept_frac}")
    if kernel["move"] == "swap":
        check(torch.equal(compositions(kernel["occ"], tables),
                          compositions(start_occ, tables)),
              f"{label}: a swap changed a composition")
    print(f"phase 3 [{label}]: kernel == twin on all {kernel['occ'].shape[1]} walkers "
          f"and all planes (entropy to 0.0), max |dH| {err:.3e}, acceptance "
          f"{accept_frac:.4f}, {resets} walkers with a flatness reset, least "
          f"mod_factor {float(kernel['mod_factor'].min()):g}")
    return err


def wl_window_vs_twin(ensemble, system, name, move, rng, seed, **options):
    """Phase 3: one Wang-Landau launch, kernel against twin."""
    ops = wl_operands(ensemble, system, move, WL_WALKERS, THIN, BLOCK, occ_seed=7,
                      seq_seed=17, **{"flatness": 0.3, "check_period": 20, **options})
    ops["seed"] = torch.tensor([seed], dtype=torch.int64, device=ensemble.device)
    k = fresh(ops)
    t = fresh(ops)
    chain.wl_chain(**k, rng=rng)
    chain.wl_chain_reference(**t, rng=rng)
    torch.cuda.synchronize()
    ewald = "+ewald" if ops["tables"].has_ewald else ""
    extra = "".join(f", {key}={value}" for key, value in options.items())
    return compare_wl(f"wl-{move}{ewald} {name} {rng} seed {seed:#x}, "
                      f"{ops['wl'].num_levels} bins{extra}", k, t, ops["occ"],
                      ops["tables"], THIN)


def wl_main_launch_vs_twin(ensemble, system, name, move):
    """Phase 3: the main path's launch, kernel against twin: 2048 walkers
    from the cell's starts and planes of zeros, one philox window (step
    indices far above a hash chunk's 2048), flatness 0.8, a check every
    1000 steps on planes that fill as the launch goes; the first
    ``WL_TWIN_STEPS`` of its 15000 steps.  Swaps reach no flat histogram in
    one such window; the runs above cover the reset."""
    t0 = time.perf_counter()
    ops = wl_operands(ensemble, system, move, WL_WALKERS, WL_TWIN_STEPS, BLOCK,
                      occ_seed=0, seq_seed=41)
    ops["seed"] = torch.tensor([SEEDS[1][1]], dtype=torch.int64, device=ensemble.device)
    k = fresh(ops)
    t = fresh(ops)
    chain.wl_chain(**k)
    chain.wl_chain_reference(**t)
    torch.cuda.synchronize()
    wl = ops["wl"]
    err = compare_wl(f"wl-{move} {name} philox, the main path's launch: "
                     f"{WL_TWIN_STEPS} of its {WL_THIN} steps, {wl.num_levels} bins, "
                     f"flatness {wl.flatness:g}, check_period {wl.check_period}", k, t,
                     ops["occ"], ops["tables"], WL_TWIN_STEPS, need_reset=False)
    print(f"phase 3: that comparison took {time.perf_counter() - t0:.1f} s")
    return err


def wl_chunked_hash_vs_twin(ensemble, system, name, move):
    """Phase 3: a hash-mode Wang-Landau chain across the chunk boundary.

    The kernel runs through ``make_shared_proposal_chain`` (two launches:
    2048 steps, then 52, each counting its own steps for the flatness
    check and checking at its last step); the twin runs chunk by chunk.
    """
    device = ensemble.device
    chunk = chain.MAX_CHUNK_STEPS
    n_steps = chunk + 52
    ops = wl_operands(ensemble, system, move, WL_WALKERS, chunk, BLOCK, occ_seed=11,
                      seq_seed=29, n_chunks=2, flatness=0.2, check_period=150)
    tables, wl, seqs = ops["tables"], ops["wl"], ops["seqs"]
    seeds = [123456789 + c * chain.SEED_STRIDE for c in range(2)]
    occu = torch.zeros((WL_WALKERS, ensemble.num_sites), dtype=torch.int32, device=device)
    occu[:, tables.rank_sites] = ops["occ"].T.to(torch.int32)
    state = {
        "occupancy": occu, "enthalpy": ops["enthalpy"].clone(),
        "naccept": ops["naccept"].clone(),
        "accepted": torch.ones(WL_WALKERS, dtype=torch.bool, device=device),
        **{key: ops[key].T.contiguous() if ops[key].dim() == 2 else ops[key].clone()
           for key in WL_PLANES},
    }
    host_seqs = [q.cpu().numpy() for q in seqs]
    run = chain.make_shared_proposal_chain(
        tables, n_steps, block_size=BLOCK, rng="hash", move=move, wl=wl,
        seqs=host_seqs[0] if move == "flip" else host_seqs, seeds=np.asarray(seeds))
    before = chain.wl_chain.launches
    state = run(state, None)
    check(chain.wl_chain.launches - before == 2, "chunked Wang-Landau run: two launches")

    twin = fresh(ops)
    for c, seed in enumerate(seeds):
        chain.wl_chain_reference(
            **{**twin, "seqs": [q[c] for q in seqs],
               "n_steps": min(chunk, n_steps - c * chunk)},
            seed=torch.tensor([seed], dtype=torch.int64, device=device), rng="hash")
    torch.cuda.synchronize()
    kernel = {
        "occ": state["occupancy"][:, tables.rank_sites].T.to(torch.int8),
        "enthalpy": state["enthalpy"], "naccept": state["naccept"], "move": move,
        **{key: state[key].T if state[key].dim() == 2 else state[key]
           for key in WL_PLANES},
    }
    return compare_wl(f"wl-{move} {name} hash {n_steps} steps, 2 chunks, "
                      f"{wl.num_levels} bins", kernel, twin, ops["occ"], tables, n_steps)


# ---------------- the main paths ----------------

def drive_main_path(move, stem, card, temperature, block):
    """Phase 4: one main path, as a user calls it; cold, then warm."""
    t0 = time.perf_counter()
    ensemble, system = load(stem)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    canonical = ensemble.chemical_potential_table is None
    check(canonical == (move == "swap"), f"{stem}: not a system for {move} moves")
    occ0 = system.get("initial_occupancy")
    if occ0 is None:
        occ0 = random_occupancies(ensemble, WALKERS, 0)
    # flips and swaps are the sampler's defaults; table flips are asked for
    step_type = "table-flip" if move == "table" else None
    runs = []
    for _ in ("cold", "warm"):
        t0 = time.perf_counter()
        sampler = Sampler.from_ensemble(ensemble, temperature, WALKERS, seed=3,
                                        chain_block_size=block, step_type=step_type)
        path = sampler.execution_path(THIN)  # builds the chain tables
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sampler.run(NSTEPS, occ0, thin_by=THIN)
        torch.cuda.synchronize()
        runs.append((sampler, t1 - t0, time.perf_counter() - t1))
    ewald = "+ewald" if "ewald_matrix" in system else ""
    check(path.startswith(f"cuda-chain[{move}]{ewald}+direct"), f"execution path {path}")
    (cold, tables_s, cold_s), (sampler, _, wall) = runs

    samples = sampler.samples
    n = samples.num_samples
    check(n == NSTEPS // THIN, f"{n} samples recorded")
    # the same trajectories, and the same enthalpies
    occupancies = samples.get_occupancies(flat=False)  # [S, W, N]
    check(np.array_equal(cold.samples.get_occupancies(flat=False), occupancies),
          f"{stem}: the warm run did not repeat the cold run's occupancies")
    repeat = float(np.abs(cold.samples.get_enthalpies() - samples.get_enthalpies()).max())
    check(repeat <= 1e-9, f"{stem}: warm and cold enthalpies differ by {repeat}")
    last_h = samples.get_enthalpies(discard=n - 1)
    last_f = samples.get_feature_vectors(discard=n - 1)
    check(last_f.shape == (WALKERS, len(ensemble.natural_parameters)),
          f"feature shape {last_f.shape}")
    check(np.isfinite(last_h).all() and np.isfinite(last_f).all(), "non-finite")
    parity = float(np.abs(last_f @ ensemble.natural_parameters - last_h).max())
    check(parity < 1e-9, f"{stem}: recorded enthalpy vs features.theta {parity}")
    accept = float(sampler.efficiency())
    check(0.0 < accept < 1.0, f"{stem}: acceptance {accept}")
    mean_h = float(samples.mean_enthalpy(discard=n // 2))
    rate = WALKERS * NSTEPS / wall
    extra = ""
    if canonical:
        for sl in ensemble.sublattices:
            for code in sl.encoding:
                start = int((occ0[sl.sites] == code).sum())
                kept = (occupancies[:, :, sl.sites] == code).sum(axis=-1) == start
                check(bool(kept.all()), f"{stem}: a walker's composition changed")
        # nmove: proposals whose two sites held different codes (bench.py:551-562)
        frac = float(sampler._state["nmove"].double().sum()) / (WALKERS * NSTEPS)
        check(0.0 < frac < 1.0, f"{stem}: non-null fraction {frac}")
        extra = (f", compositions kept on all {n} x {WALKERS} records, non-null "
                 f"move fraction {frac:.4f} ({rate * frac / 1e6:.1f} M non-null "
                 f"moves/s)")
    if move == "table":
        charges, sites = ensemble.site_charges, np.arange(ensemble.num_sites)
        start = charges[sites, occ0].sum()
        for record in occupancies:  # charges are integers: the sums are exact
            check(bool((charges[sites, record].sum(axis=-1) == start).all()),
                  f"{stem}: a walker's net charge changed")
        extra = f", net charge {start:g} kept on all {n} x {WALKERS} records"
    print(f"phase 4 [{stem}] {card}: {ensemble.num_sites} sites, path {path}, "
          f"T {temperature:g} K, mean enthalpy {mean_h:.6f} eV, acceptance "
          f"{accept:.4f}, parity(e) {parity:.3e}, warm vs cold |dH| {repeat:.3e}, "
          f"warm run {rate / 1e6:.1f} M attempts/s end to end ({wall:.4f} s for "
          f"{WALKERS} walkers x {NSTEPS} steps){extra}; set-up: system load "
          f"{load_s:.4f} s, sampler + tables {tables_s:.4f} s, cold run "
          f"{cold_s:.4f} s ({cold_s - wall:+.4f} s over warm)")
    return ensemble, rate


def drive(move, cells, card):
    """Phase 4 for one move: counts set to 0 just before, read just after."""
    kernel_fn = KERNELS[move][0]
    kernel_fn.launches = 0
    results = {stem: drive_main_path(move, stem, card, *args)
               for stem, args in cells.items()}
    launches = kernel_fn.launches
    check(launches == len(cells) * 2 * (NSTEPS // THIN),
          f"{launches} {move} kernel launches")
    print(f"phase 4: {move}_chain launches on the {move} main path: {launches}")
    return results, launches


def plane_invariants(label, state, steps):
    """What every Wang-Landau state must satisfy after ``steps`` steps of
    walkers that began inside the window (``update_period = 1``)."""
    counter, occurrences = state["wl_counter"], state["occurrences"]
    check(bool((counter == steps).all()),
          f"{label}: a walker's in-window count is not {steps}")
    check(torch.equal(occurrences.sum(dim=1), counter),
          f"{label}: occurrences do not sum to the counter")
    check(bool((state["histogram"] <= occurrences).all()) and
          int(state["histogram"].min()) >= 0, f"{label}: histogram above occurrences")
    check(torch.equal(state["entropy"] > 0, occurrences > 0),
          f"{label}: entropy is not positive exactly where a bin was visited")
    mod = state["mod_factor"]
    check(bool((mod <= 1.0).all()) and bool((torch.frexp(mod).mantissa == 0.5).all()),
          f"{label}: a mod_factor is above its start or no power of two")


def drive_wl(stem, move, card):
    """Phase 4: one Wang-Landau cell, as a user calls it; cold, then warm."""
    ensemble, system = load(stem)
    window = wl_window_of(system)
    # (a) bench.py's starts: default_rng(0).integers(0, 2, (2048, N))
    occ0 = wl_starts(ensemble, system, move, WL_WALKERS, 0)
    runs = []
    for _ in ("cold", "warm"):
        sampler = Sampler.from_ensemble(
            ensemble, kernel_type="wang-landau", step_type=move,
            nwalkers=WL_WALKERS, seed=WL_SEED, flatness=0.8, **window)
        path = sampler.execution_path(WL_THIN)  # builds the chain tables
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler.run(WL_NSTEPS, occ0, thin_by=WL_THIN)
        torch.cuda.synchronize()
        runs.append((sampler, time.perf_counter() - t0))
    check(path.startswith(f"cuda-chain[wl-{move}]+direct"), f"execution path {path}")
    (cold, cold_s), (sampler, wall) = runs
    samples, state = sampler.samples, sampler._state
    n = samples.num_samples
    check(n == WL_NSTEPS // WL_THIN, f"{n} samples recorded")
    check("temperature" not in samples.traced_values, "a temperature trace")

    wl = sampler.mckernel.wl_chain()
    enthalpies = samples.get_enthalpies(flat=False)  # [S, W]
    features = samples.get_feature_vectors(flat=False)
    check(np.isfinite(enthalpies).all() and np.isfinite(features).all(), "non-finite")
    exact = float(np.abs(features @ ensemble.natural_parameters - enthalpies).max())
    check(exact < 1e-9, f"{stem}: recorded enthalpy vs features.theta {exact}")
    start = sampler.mckernel.initial_state(occ0)["enthalpy"].cpu().numpy()
    w = np.concatenate([start[None], enthalpies]) - wl.min_enthalpy
    check(bool(((w >= 0) & (w < wl.span)).all()), f"{stem}: a walker outside the window")
    # parity (e): what the chain accumulated over the last window against
    # the exact recompute that replaces it
    parity = float((state["chain_enthalpy"] - state["enthalpy"]).abs().max())
    check(parity < 1e-9, f"{stem}: chain enthalpy vs recompute {parity}")
    plane_invariants(stem, state, WL_NSTEPS)

    check(samples.num_aux_records == 1 and samples.aux_sample_indices.tolist() == [n - 1],
          f"{stem}: not one aux record at the end")
    check(sorted(samples.aux_traced_values) == sorted(
        ["histogram", "occurrences", "entropy", "cumulative_mean_features",
         "cumulative_mean_counts"]), f"{stem}: aux traces {samples.aux_traced_values}")
    entropy = samples.get_trace_value("entropy", flat=False)[-1]
    check(np.array_equal(entropy, state["entropy"].cpu().numpy()),
          f"{stem}: the aux record is not the final entropy")
    counts = samples.get_trace_value("cumulative_mean_counts", flat=False)[-1]
    check(bool((counts.sum(axis=1) == n).all()), f"{stem}: mean-feature counts")

    # the same trajectories, bit for bit: bench.py's window puts the lowest
    # of its 64 probe states, and every state of that level, exactly on a
    # bin edge, where the enthalpy's last bit decides the bin; the runs
    # repeat each other because the features sum in a fixed order
    occupancies = samples.get_occupancies(flat=False)  # [S, W, N]
    check(np.array_equal(cold.samples.get_occupancies(flat=False), occupancies),
          f"{stem}: the warm run did not repeat the cold run's occupancies")
    check(np.array_equal(cold.samples.get_trace_value("entropy"),
                         samples.get_trace_value("entropy")),
          f"{stem}: the warm run did not repeat the cold run's entropies")
    extra = ""
    if move == "swap":
        for sl in ensemble.sublattices:
            for code in sl.encoding:
                kept = ((occupancies[:, :, sl.sites] == code).sum(axis=-1)
                        == (occ0[:, sl.sites] == code).sum(axis=-1))
                check(bool(kept.all()), f"{stem}: a walker's composition changed")
        extra = f", compositions kept on all {n} x {WL_WALKERS} records"
    mod = state["mod_factor"]
    visited = (state["entropy"] > 0).sum(dim=1).double()
    rate = WL_WALKERS * WL_NSTEPS / wall
    print(f"phase 4 [wl {stem}] {card}: {ensemble.num_sites} sites, path {path}, "
          f"{wl.num_levels} bins, acceptance {float(sampler.efficiency()):.4f}, "
          f"parity(e) {parity:.3e}, recorded vs features.theta {exact:.3e}, bins "
          f"visited per walker {float(visited.mean()):.1f} (most {int(visited.max())}), "
          f"mod_factor {float(mod.min()):g} to {float(mod.max()):g}, "
          f"warm run {rate / 1e6:.1f} M attempts/s end to end ({wall:.4f} s for "
          f"{WL_WALKERS} walkers x {WL_NSTEPS} steps in {n} windows), cold run "
          f"{cold_s:.4f} s{extra}")
    return ensemble, system, rate


def drive_wl_dos(card):
    """Phase 4 (c): the density of states of the 8-site system on the card.

    The window and bin of the reference's own test of this system (levels
    mid-bin).  Its flatness 0.7 with a check every 250 steps halves the
    modification factor faster than the entropies can follow, and the
    error it leaves stays (about 0.25 for the median walker of 64, 0.6 for
    the worst, whatever the run's length); a check every 5000 steps at
    flatness 0.9 leaves 0.07 and 0.23.
    """
    ensemble, system = load(WL_DOS_CELL)
    exact_e = system["exact_enthalpies"]
    levels = np.unique(np.round(exact_e, 9))
    bin_size = float(levels[1] - levels[0])
    lo = float(levels[0] - bin_size / 2)
    sampler = Sampler.from_ensemble(
        ensemble, kernel_type="wang-landau", step_type="flip",
        min_enthalpy=lo, max_enthalpy=float(levels[-1] + bin_size), bin_size=bin_size,
        flatness=0.9, check_period=5000, nwalkers=WL_DOS_WALKERS, seed=9)
    occ0 = np.random.default_rng(0).integers(
        0, 2, (WL_DOS_WALKERS, ensemble.num_sites)).astype(np.int32)
    t0 = time.perf_counter()
    sampler.run(WL_DOS_NSTEPS, occ0, thin_by=WL_DOS_NSTEPS // 10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    plane_invariants(WL_DOS_CELL, sampler._state, WL_DOS_NSTEPS)
    entropy = sampler.samples.get_trace_value("entropy", flat=False)[-1]  # [W, B]
    dos = np.bincount(np.floor((exact_e - lo) / bin_size).astype(int),
                      minlength=entropy.shape[1])
    visited = dos > 0
    check(bool((entropy[:, visited] > 0).all()) and bool((entropy[:, ~visited] == 0).all()),
          "density of states: entropy off the system's levels")
    estimate = entropy[:, visited] - entropy[:, visited][:, :1]
    exact = np.log(dos[visited]) - np.log(dos[visited][0])
    worst = float(np.abs(estimate - exact).max())
    check(worst < WL_DOS_TOLERANCE,
          f"density of states: log-DOS off by {worst} on some walker")
    mod = sampler._state["mod_factor"]
    print(f"phase 4 [wl {WL_DOS_CELL}] {card}: {WL_DOS_WALKERS} walkers x "
          f"{WL_DOS_NSTEPS} steps in {wall:.4f} s, log-DOS against the exact "
          f"degeneracies {dos[visited].tolist()}: worst walker off by {worst:.4f} "
          f"(limit {WL_DOS_TOLERANCE}), mod_factor {float(mod.min()):g} to "
          f"{float(mod.max()):g}")
    return worst


def drive_wl_cells(card):
    """Phase 4 for Wang-Landau: counts set to 0 just before, read just after."""
    chain.wl_chain.launches = 0
    results = {stem: drive_wl(stem, move, card) for stem, move in WL_CELLS.items()}
    drive_wl_dos(card)
    launches = chain.wl_chain.launches
    check(launches == len(WL_CELLS) * 2 * (WL_NSTEPS // WL_THIN) + 10,
          f"{launches} Wang-Landau kernel launches")
    print(f"phase 4: wl_chain launches on the Wang-Landau main path: {launches}")
    return results, launches


# ---------------- the SQS distance chain ----------------

DISTANCE_STATE = ("occ", "best_occ", "feat", "d", "best_d", "naccept")


def sqs_processors(stem, device="cuda"):
    """The distance processors of an SQS file, one per supercell shape."""
    systems = load_systems(ROOT / "tests" / "data" / f"torch_{stem}.npz")
    return [CorrelationDistanceProcessor(system, device) for system in systems]


def sqs_compositions(occu, proc):
    """[W, S * codes] count of each code on each sublattice of occupancies
    ``occu`` [W, N] (a tensor)."""
    return torch.stack([(occu[:, sl.sites] == code).sum(dim=1)
                        for sl in proc.get_sublattices() for code in sl.encoding], dim=1)


def distance_operands(proc, n_steps, beta, seed, occ_seed=7, seq_seed=17):
    """Operands of one distance launch at the main path's shape: 2048 walkers
    from the generator's starts (``random_starts``), blocks of 512."""
    tables = sqs.build_distance_tables(proc)
    occu = torch.as_tensor(
        random_starts(proc, SQS_WALKERS, np.random.default_rng(occ_seed)), device=proc.device)
    gen = torch.Generator(device=proc.device).manual_seed(seq_seed)
    beta = torch.full((SQS_WALKERS,), beta, dtype=torch.float64, device=proc.device)
    ops = sqs.distance_launch_operands(tables, proc.compute_corr, occu, beta, n_steps,
                                       SQS_BLOCK, gen)
    ops["seed"] = torch.tensor([seed], dtype=torch.int64, device=proc.device)
    return ops


def occupancy_of(occ, tables):
    """[W, N] occupancy of rank-major codes (every site of these cells is a
    rank)."""
    occu = torch.zeros((occ.shape[1], tables.num_sites), dtype=torch.int64,
                       device=occ.device)
    occu[:, tables.rank_sites] = occ.T.long()
    return occu


def compare_distance(label, proc, kernel, twin, start, n_steps):
    """Kernel against twin: every walker equal bit for bit; returns the
    largest score difference (0.0)."""
    for key in DISTANCE_STATE:
        if key in kernel:
            check(torch.equal(kernel[key], twin[key]), f"{label}: {key} differs from the twin's")
    tables = start["tables"]
    before = sqs_compositions(occupancy_of(start["occ"], tables), proc)
    for key in ("occ", "best_occ"):
        check(torch.equal(sqs_compositions(occupancy_of(kernel[key], tables), proc), before),
              f"{label}: a swap changed a composition")
    exact = proc.compute_scores(occupancy_of(kernel["occ"], tables))
    drift = float((exact - kernel["d"]).abs().max())
    check(drift < 1e-9, f"{label}: score vs exact rescore {drift}")
    accept = float(kernel["naccept"].double().mean()) / n_steps
    check(0.0 < accept < 1.0, f"{label}: acceptance {accept}")
    print(f"phase 3 [{label}]: kernel == twin bit for bit on all {len(kernel['d'])} "
          f"walkers (occupancy, best occupancy, features, score, best score, accepts), "
          f"score vs exact rescore {drift:.3e}, acceptance {accept:.4f}, best score "
          f"{float(kernel['best_d'].min()):.6f}")
    return float((kernel["d"] - twin["d"]).abs().max())


def distance_vs_twin(proc, name, rng, seed, beta=2.0, n_steps=SQS_WINDOW, timed=False,
                     match_weight=None):
    """Phase 3: one launch, kernel against twin (with ``match_weight``, on
    the shape's system with that match weight); with ``timed`` the twin's
    time (CUDA events) and the work its data needs come back too."""
    extra = ""
    if match_weight is not None:
        coefs = np.concatenate([[-match_weight], proc.coefs[1:]])
        proc = CorrelationDistanceProcessor({**proc.system, "distance_coefs": coefs},
                                            proc.device)
        extra = f", match_weight {match_weight:g}"
    ops = distance_operands(proc, n_steps, beta, seed)
    k, t = fresh_distance(ops), fresh_distance(ops)
    sqs.distance_chain(**k, rng=rng)
    work = torch.zeros((2, SQS_WALKERS), dtype=torch.int64, device=proc.device)
    start_ev = torch.cuda.Event(enable_timing=True)
    end_ev = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start_ev.record()
    sqs.distance_chain_reference(**t, rng=rng, work=work)
    end_ev.record()
    torch.cuda.synchronize()
    err = compare_distance(f"distance {name} {rng} seed {seed:#x}, beta {beta:g}, "
                           f"{n_steps} steps{extra}", proc, k, t, ops, n_steps)
    if not timed:
        return err
    return err, {"ops": ops, "twin_ms": start_ev.elapsed_time(end_ev), "work": work}


def fresh_distance(ops):
    return {key: (v.clone() if key in DISTANCE_STATE else v) for key, v in ops.items()}


def distance_chunked_hash_vs_twin(proc, name):
    """Phase 3: a hash-mode chain across a chunk boundary through
    ``make_distance_chain`` (2048 steps, then 52, each counting its steps
    from 0 with the next chunk seed), against the twin chunk by chunk."""
    chunk = chain.MAX_CHUNK_STEPS
    n_steps = chunk + 52
    ops = distance_operands(proc, chunk, 2.0, 0, occ_seed=11)
    tables = ops["tables"]
    gen = torch.Generator(device=proc.device).manual_seed(29)
    seqs = chain.rank_pair_sequence(tables, gen, (2, SQS_WALKERS // SQS_BLOCK, chunk))
    seeds = [123456789 + c * chain.SEED_STRIDE for c in range(2)]
    occu = occupancy_of(ops["occ"], tables).to(torch.int32)
    state = {
        "occupancy": occu.clone(), "enthalpy": ops["d"].clone(),
        "beta": torch.full((SQS_WALKERS,), 2.0, dtype=torch.float64, device=proc.device),
        "naccept": torch.zeros(SQS_WALKERS, dtype=torch.int32, device=proc.device),
        "best_enthalpy": ops["best_d"].clone(), "best_occupancy": occu.clone(),
    }
    run = sqs.make_distance_chain(tables, n_steps, proc.compute_corr, block_size=SQS_BLOCK,
                                  rng="hash", seqs=[q.cpu().numpy() for q in seqs],
                                  seeds=np.asarray(seeds))
    before = sqs.distance_chain.launches
    state = run(state, None)
    check(sqs.distance_chain.launches - before == 2, "chunked distance run: two launches")
    twin = fresh_distance(ops)
    for c, seed in enumerate(seeds):
        sqs.distance_chain_reference(
            **{**twin, "useq": seqs[0][c], "vseq": seqs[1][c],
               "n_steps": min(chunk, n_steps - c * chunk),
               "seed": torch.tensor([seed], dtype=torch.int64, device=proc.device)},
            rng="hash")
    torch.cuda.synchronize()
    feat = proc.compute_corr(state["occupancy"])[:, torch.as_tensor(tables.feature_ids)]
    kernel = {  # the state carries no features: checked below against the twin's
        "occ": state["occupancy"][:, tables.rank_sites].T.to(torch.int8),
        "best_occ": state["best_occupancy"][:, tables.rank_sites].T.to(torch.int8),
        "d": state["enthalpy"], "best_d": state["best_enthalpy"],
        "naccept": state["naccept"],
    }
    feat_err = float((feat.T - twin["feat"]).abs().max())
    check(feat_err < 1e-12, f"chunked distance run: features off by {feat_err}")
    return compare_distance(f"distance {name} hash {n_steps} steps, 2 chunks", proc,
                            kernel, twin, ops, n_steps)


def drive_sqs(stem, card):
    """Phase 4: the SQS search of one cell as a user calls it; cold, then
    warm with the same seed on the same generator."""
    t0 = time.perf_counter()
    procs = sqs_processors(stem)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    generator = StochasticSQSGenerator.from_processors(procs, device="cuda")
    runs = []
    for _ in ("cold", "warm"):
        t0 = time.perf_counter()
        generator.generate(mcmc_steps=SQS_STEPS, temperatures=SQS_TEMPERATURES,
                           nwalkers=SQS_WALKERS, seed=SQS_SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append((wall, [tuple(np.copy(x) for x in rec[1:]) for rec in generator._best],
                     [{k: (v.clone() if torch.is_tensor(v) else v) for k, v in rec.items()}
                      for rec in generator.stage_records]))
    (cold_s, cold_best, cold_stages), (wall, best, stages) = runs
    path = generator.execution_path
    check(path == "cuda-distance-chain", f"execution path {path}")
    check(len(stages) == len(procs) * len(SQS_TEMPERATURES), f"{len(stages)} stages")
    # the same search, bit for bit
    for (o1, s1, f1), (o2, s2, f2) in zip(cold_best, best):
        check(np.array_equal(o1, o2) and np.array_equal(s1, s2) and np.array_equal(f1, f2),
              f"{stem}: the warm run did not repeat the cold run's best structures")
    for r1, r2 in zip(cold_stages, stages):
        check(torch.equal(r1["occupancy"], r2["occupancy"])
              and torch.equal(r1["enthalpy"], r2["enthalpy"]),
              f"{stem}: the warm run did not repeat the cold run's stages")
    # every launch: compositions kept, final score == exact rescore
    drift, accepts = 0.0, []
    for rec in stages:
        proc = procs[rec["shape"]]
        occu = rec["occupancy"]
        target = torch.as_tensor([round(x * len(sl.sites)) for sl in proc.get_sublattices()
                                  for x in sl.composition], device=occu.device)
        check(bool((sqs_compositions(occu, proc) == target).all()),
              f"{stem}: a walker's composition changed")
        drift = max(drift, float((proc.compute_scores(occu) - rec["enthalpy"]).abs().max()))
        accepts.append(float(rec["naccept"].double().mean()) / SQS_STEPS)
    check(drift < 1e-9, f"{stem}: a launch's final score vs the exact rescore {drift}")
    # stored scores against an exact rescore on the CPU; never behind a start
    rescore, found = 0.0, np.inf
    for (shape, occupancies, scores, _), start in zip(generator._best, generator.start_scores):
        cpu = CorrelationDistanceProcessor(procs[shape].system, "cpu")
        exact = cpu.compute_scores(torch.as_tensor(occupancies)).numpy()
        rescore = max(rescore, float(np.abs(exact - scores).max()))
        check(bool((scores <= start.cpu().numpy() + 1e-12).all()),
              f"{stem}: a walker's best is worse than its start")
        found = min(found, float(scores.min()))
    check(rescore < 1e-9, f"{stem}: stored score vs exact CPU rescore {rescore}")
    check(found < 0, f"{stem}: best score {found} is not a matched shell")
    best_sqs = generator.get_best_sqs(1)[0]
    attempts = len(procs) * len(SQS_TEMPERATURES) * SQS_STEPS * SQS_WALKERS
    rate = attempts / wall
    print(f"phase 4 [sqs {stem}] {card}: {len(procs)} shapes x {len(SQS_TEMPERATURES)} "
          f"temperatures x {SQS_STEPS} steps x {SQS_WALKERS} walkers, path {path}, "
          f"warm run {rate / 1e6:.1f} M attempts/s end to end ({wall:.4f} s for "
          f"{attempts} attempts), best score {best_sqs.score:.6f} (shape "
          f"{best_sqs.supercell_matrix.tolist()}), acceptance per stage "
          f"{np.round(accepts[:len(SQS_TEMPERATURES)], 4).tolist()} (first shape), "
          f"final score vs exact rescore {drift:.3e}, stored vs CPU rescore "
          f"{rescore:.3e}, warm == cold bit for bit; set-up: load {load_s:.4f} s, "
          f"cold run {cold_s:.4f} s ({cold_s - wall:+.4f} s over warm)")
    return procs, rate


def drive_sqs_cells(card):
    """Phase 4 for SQS: counts set to 0 just before, read just after."""
    sqs.distance_chain.launches = 0
    results = {stem: drive_sqs(stem, card) for stem in SQS_CELLS}
    launches = sqs.distance_chain.launches
    expected = sum(2 * len(procs) * len(SQS_TEMPERATURES) for procs, _ in results.values())
    check(launches == expected, f"{launches} distance kernel launches, not {expected}")
    print(f"phase 4: distance_chain launches on the SQS main path: {launches}")
    return results, launches


# ---------------- timing and bounds ----------------

def bound(tables, ops, move, recolorings=0, accepted=0):
    """The least time of one launch: (ms, "bytes" or "operations", bytes,
    f64 operations, ms of the Ewald term's operations alone).

    Bytes: every operand read once and every output written once (the
    occupancy [R, W] int8 in and out, the per-walker state, the sequences
    and the tables).  Operations: the f64 adds and subtracts per
    walker-step (two per local cluster of each changed site, R + 2 per
    Ewald term, the chemical work's two for a flip, the enthalpy's one).
    A table move's work depends on the data: ``recolorings`` counts the
    site recolorings these inputs need (the valid slots of the valid
    proposals, from a twin run of the same launch); each costs a flip's
    operations, and an identity proposal none.
    """
    R, W = ops["occ"].shape
    L, steps = tables.nbr.shape[1], ops["n_steps"]
    seqs = [ops[name] for name in SEQUENCES[move]]
    table_tensors = [tables.nbr, tables.stride, tables.d2, tables.g]
    if move != "swap":
        table_tensors += [tables.mu]
    if move == "flip":
        table_tensors += [tables.ncode]
    if move == "table":
        table_tensors += [ops["table_move"].dev["rows"]]
    if tables.has_ewald:
        table_tensors += [tables.ew_v, tables.ew_c]
    nbytes = (2 * R * W + W * (2 * 8 + 4) + 2 * 4 * W * (1 + (move == "swap"))
              + sum(s[:, :steps].numel() * 4 for s in seqs)
              + sum(t.numel() * t.element_size() for t in table_tensors))
    ewald_site = R + 2 if tables.has_ewald else 0
    if move == "table":
        ewald = recolorings * ewald_site
        n_ops = recolorings * (2 * L + 2) + ewald + accepted
    else:
        sites = 2 if move == "swap" else 1
        ewald = W * steps * sites * ewald_site
        n_ops = W * steps * (sites * 2 * L + 1 + (2 if move == "flip" else 0)) + ewald
    ops_s = n_ops / PEAK_F64_PER_S
    bytes_s = nbytes / PEAK_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes",
            nbytes, n_ops, ewald / PEAK_F64_PER_S * 1e3)


def time_window(ensemble, name, card, move, block, kernel_reps=50, twin_reps=3):
    """Phase 5: one 100-step window at 8192 walkers, kernel against twin."""
    tables = tables_of(ensemble, move)
    ops = window_operands(ensemble, tables, move, block, occ_seed=5, seq_seed=1)
    ops["seed"] = torch.tensor([42], dtype=torch.int64, device=ensemble.device)
    kernel_fn, twin_fn = KERNELS[move]
    counts = {}
    if move == "table":  # what this launch's data needs, from the twin
        run = fresh(ops)
        nslot = torch.zeros(WALKERS, dtype=torch.int32, device=ensemble.device)
        twin_fn(**run, nslot=nslot)
        counts = {"recolorings": int(nslot.sum()), "accepted": int(run["naccept"].sum())}
    kernel_ms = cuda_ms(same_window(kernel_fn, ops, kernel_reps), kernel_reps)
    twin_ms = cuda_ms(same_window(twin_fn, ops, twin_reps), twin_reps)
    bound_ms, bound_by, nbytes, n_ops, ewald_ms = bound(tables, ops, move, **counts)
    rate = WALKERS * THIN / (kernel_ms * 1e-3)
    line = (f"phase 5 [{move} {name}] {card}: 100-step window at {WALKERS} walkers: "
            f"kernel {kernel_ms:.4f} ms ({rate / 1e6:.1f} M attempts/s), twin "
            f"{twin_ms:.2f} ms, twin/kernel {twin_ms / kernel_ms:.1f}x, bound "
            f"{bound_ms * 1e3:.3f} us ({bound_by}; {nbytes / 1e6:.3f} MB, "
            f"{n_ops / 1e6:.1f} M f64 operations), kernel/bound "
            f"{kernel_ms / bound_ms:.0f}x")
    if counts:
        line += (f"; {counts['recolorings']} recolorings in valid proposals and "
                 f"{counts['accepted']} accepted moves of {WALKERS * THIN} proposals")
    result = {"kernel_ms": kernel_ms, "twin_ms": twin_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, **counts}
    if tables.has_ewald:  # K4's share: the same launch without the Ewald term
        plain = {**ops, "tables": dataclasses.replace(tables, ew_v=None, ew_c=None)}
        result["kernel_no_ewald_ms"] = cuda_ms(
            same_window(kernel_fn, plain, kernel_reps), kernel_reps)
        line += (f"; without the Ewald term {result['kernel_no_ewald_ms']:.4f} ms "
                 f"(the term's own bound {ewald_ms * 1e3:.3f} us)")
    print(line)
    return result


def wl_bound(ops, after):
    """The least time of one Wang-Landau launch: (ms, by, bytes, operations).

    Bytes: the chain's operands as :func:`bound` counts them, ``mod_factor``
    and ``wl_counter`` read and written once, and of the three [B, W] planes
    what this launch's data needs, read off ``after``, the state one such
    launch leaves: entropy and histogram over all bins for every flatness
    pass of the launch (12 B a cell), the cells that a walker visited (the
    launch starts from planes of zeros, so those with an occurrence) read
    once and written once in all three planes (16 B each way), and the
    histogram's zeroing (4 B a bin) for every reset (``mod_factor`` halves
    at each).  The occurrences are never moved in whole.
    Operations: the delta's f64 adds, and six per step for the rule and
    the bookkeeping (E + dE, minus the window's start, the division, its
    floor, S[b_cur] - S[b'], S + mod_factor).
    """
    tables, move, steps = ops["tables"], ops["move"], ops["n_steps"]
    R, W = ops["occ"].shape
    L, B = tables.nbr.shape[1], ops["wl"].num_levels
    table_tensors = [tables.nbr, tables.stride, tables.d2, tables.g]
    if move == "flip":
        table_tensors += [tables.mu, tables.ncode]
    if tables.has_ewald:
        table_tensors += [tables.ew_v, tables.ew_c]
    check = ops["wl"].check_period
    passes = steps // check + (1 if steps % check else 0)
    visited = int((after["occurrences"] > 0).sum())
    resets = int(torch.round(-torch.log2(after["mod_factor"] / ops["mod_factor"])).sum())
    nbytes = (2 * R * W + W * (2 * 8 + 2 * 4) + 2 * W * (8 + 4)
              + passes * B * W * 12 + visited * 2 * 16 + resets * B * 4
              + sum(q[:, :steps].numel() * 4 for q in ops["seqs"])
              + sum(t.numel() * t.element_size() for t in table_tensors))
    sites = 2 if move == "swap" else 1
    ewald_site = R + 2 if tables.has_ewald else 0
    n_ops = W * steps * (sites * (2 * L + ewald_site) + 6 + (2 if move == "flip" else 0))
    ops_s, bytes_s = n_ops / PEAK_F64_PER_S, nbytes / PEAK_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes",
            nbytes, n_ops)


def time_wl_window(ensemble, system, name, card, move, walkers, block=BLOCK,
                   kernel_reps=50, twin_reps=0):
    """Phase 5: one 100-step Wang-Landau window from fresh planes, the
    bench's parameters (flatness 0.8, a check every 1000 steps and at the
    window's end), every repetition on a copy of the starting state."""
    ops = wl_operands(ensemble, system, move, walkers, THIN, block, occ_seed=5,
                      seq_seed=1)
    ops["seed"] = torch.tensor([42], dtype=torch.int64, device=ensemble.device)
    kernel_ms = cuda_ms(same_window(chain.wl_chain, ops, kernel_reps), kernel_reps)
    after = fresh(ops)  # what this launch's data needs, from one more launch
    chain.wl_chain(**after)
    bound_ms, bound_by, nbytes, n_ops = wl_bound(ops, after)
    rate = walkers * THIN / (kernel_ms * 1e-3)
    result = {"kernel_ms": kernel_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    line = (f"phase 5 [wl-{move} {name}] {card}: 100-step window at {walkers} walkers "
            f"({-(-walkers // 64)} CUDA blocks on "
            f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs), "
            f"{ops['wl'].num_levels} bins: kernel {kernel_ms:.4f} ms "
            f"({rate / 1e6:.1f} M attempts/s), bound {bound_ms * 1e3:.3f} us "
            f"({bound_by}; {nbytes / 1e6:.3f} MB, {n_ops / 1e6:.1f} M f64 operations), "
            f"kernel/bound {kernel_ms / bound_ms:.0f}x")
    if twin_reps:
        result["twin_ms"] = cuda_ms(
            same_window(chain.wl_chain_reference, ops, twin_reps), twin_reps)
        line += (f", twin {result['twin_ms']:.2f} ms, twin/kernel "
                 f"{result['twin_ms'] / kernel_ms:.1f}x")
    print(line)
    return result


def distance_bound(ops, work):
    """The least time of one distance launch: (ms, by, bytes, operations).

    Bytes: every operand read once and every output written once (codes
    and best codes [R, W] int8, the feature plane [F, W] f64, score, best
    score and accept count in and out, beta, the pair sequences and the
    tables).  Operations: what this launch's data needs, from the twin's
    ``work`` count of the same launch: a null pair computes nothing; a
    non-null one two f64 operations per row of u and of v that it reads
    (the lookup difference and the sum), four per feature for the score
    (f + df, minus T, times W, the sum) and three more (w L, its
    subtraction, d_new - d).
    """
    t, steps = ops["tables"], ops["n_steps"]
    R, W = ops["occ"].shape
    F = t.num_feats
    table_tensors = [t.nbr, t.stride, t.d2, t.g, t.seg, t.target, t.weight,
                     t.group_last, t.group_diameter]
    nbytes = (4 * R * W + 2 * F * W * 8 + W * (4 * 8 + 2 * 4 + 4)
              + sum(q[:, :steps].numel() * 4 for q in (ops["useq"], ops["vseq"]))
              + sum(x.numel() * x.element_size() for x in table_tensors))
    nonnull, rows = (int(x) for x in work.sum(dim=1))
    n_ops = 2 * rows + (4 * F + 3) * nonnull
    ops_s, bytes_s = n_ops / PEAK_F64_PER_S, nbytes / PEAK_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes",
            nbytes, n_ops)


def time_distance(name, card, timed, kernel_reps):
    """Phase 5: the kernel on the operands of a timed phase-3 launch (every
    repetition on a copy of its starting state), beside the twin's time and
    the bound of that launch; where that launch is shorter than the main
    path's, the kernel alone on the main path's 8000-step launch too."""
    ops, work = timed["ops"], timed["work"]
    if ops["n_steps"] < SQS_STEPS:
        main = distance_operands(timed["proc"], SQS_STEPS, 1.0 / SQS_TEMPERATURES[0],
                                 SEEDS[1][1])
        main_ms = cuda_ms(same_distance_window(main, kernel_reps), kernel_reps)
        print(f"phase 5 [distance {name}] {card}: the main path's {SQS_STEPS}-step "
              f"launch at {SQS_WALKERS} walkers: kernel {main_ms:.4f} ms "
              f"({main_ms * 1e3 / SQS_STEPS:.3f} us per step)")
    kernel_ms = cuda_ms(same_distance_window(ops, kernel_reps), kernel_reps)
    bound_ms, bound_by, nbytes, n_ops = distance_bound(ops, work)
    W, steps = ops["occ"].shape[1], ops["n_steps"]
    nonnull = int(work[0].sum())
    rate = W * steps / (kernel_ms * 1e-3)
    print(f"phase 5 [distance {name}] {card}: {steps}-step launch at {W} walkers "
          f"({-(-W // 64)} CUDA blocks): kernel {kernel_ms:.4f} ms ({rate / 1e6:.1f} M "
          f"attempts/s, {kernel_ms * 1e3 / steps:.3f} us per step), twin "
          f"{timed['twin_ms']:.2f} ms, twin/kernel {timed['twin_ms'] / kernel_ms:.1f}x, "
          f"bound {bound_ms * 1e3:.3f} us ({bound_by}; {nbytes / 1e6:.3f} MB, "
          f"{n_ops / 1e6:.1f} M f64 operations; {nonnull} non-null of {W * steps} "
          f"proposals), kernel/bound {kernel_ms / bound_ms:.0f}x")
    return {"kernel_ms": kernel_ms, "twin_ms": timed["twin_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "steps": steps}


def same_distance_window(ops, reps):
    copies = iter([fresh_distance(ops) for _ in range(reps + 1)])
    return lambda: sqs.distance_chain(**next(copies))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    # phase 2: build from the checkout's sources, all kernels at once
    built = _build.build_libraries(tuple(_build.KERNELS))
    for name, (lib_path, log, seconds) in built.items():
        _build.load_chain(name)
        print(f"phase 2: built {lib_path.relative_to(ROOT)} in {seconds:.1f} s")
        for line in ptxas_summary(log):
            print("  ptxas:", line)

    # phase 3: kernels against twins at the main paths' shapes
    flips = {stem: load(stem)[0] for stem in FLIP_CELLS}
    swaps = {stem: load(stem)[0] for stem in SWAP_CELLS}
    table_cells = {stem: load(stem)[0] for stem in TABLE_CELLS}
    errs = {"flip": [], "swap": [], "table": []}
    for stem, ens in flips.items():
        for rng, seed in SEEDS:
            errs["flip"].append(window_vs_twin(ens, stem, "flip", BLOCK, rng, seed))
    errs["flip"].append(chunked_hash_vs_twin(flips["spinel_2x2x2"], "spinel_2x2x2",
                                             "flip", BLOCK))
    for rng, seed in SEEDS:  # the flip chain with the Ewald term (K4)
        errs["flip"].append(window_vs_twin(swaps["spinel_ewald_2x2x2"],
                                           "spinel_ewald_2x2x2", "flip", BLOCK, rng, seed))
    for stem, ens in swaps.items():
        for rng, seed in SEEDS:
            errs["swap"].append(window_vs_twin(ens, stem, "swap", SWAP_CELLS[stem][1],
                                               rng, seed))
    errs["swap"].append(chunked_hash_vs_twin(swaps["spinel_ewald_2x2x2"],
                                             "spinel_ewald_2x2x2", "swap", BLOCK))
    for stem, ens in table_cells.items():
        for rng, seed in SEEDS:
            errs["table"].append(window_vs_twin(ens, stem, "table", BLOCK, rng, seed))
    errs["table"].append(chunked_hash_vs_twin(
        table_cells["spinel_ewald_sgc_2x2x2"], "spinel_ewald_sgc_2x2x2", "table", BLOCK))
    # up to three recolorings per move: the runtime slot count body
    errs["table"].append(window_vs_twin(load(MULTI_SLOT_CELL)[0], MULTI_SLOT_CELL,
                                        "table", BLOCK, *SEEDS[1]))
    # the Wang-Landau chain: both moves, both RNG modes, a chunk boundary,
    # update_period = 3, and the Ewald instantiation
    wl_systems = {stem: load(stem) for stem in WL_CELLS}
    errs["wl"] = []
    for stem, move in WL_CELLS.items():
        for rng, seed in SEEDS:
            errs["wl"].append(wl_window_vs_twin(*wl_systems[stem], stem, move, rng, seed))
    errs["wl"].append(wl_chunked_hash_vs_twin(
        *wl_systems["aucu_wl_3x3x3"], "aucu_wl_3x3x3", "flip"))
    errs["wl"].append(wl_window_vs_twin(
        *wl_systems["aucu_wl_3x3x3"], "aucu_wl_3x3x3", "flip", *SEEDS[1],
        update_period=3))
    errs["wl"].append(wl_window_vs_twin(
        *load("spinel_ewald_2x2x2"), "spinel_ewald_2x2x2", "swap", *SEEDS[1]))
    for stem, move in WL_CELLS.items():  # the main path's own launch
        errs["wl"].append(wl_main_launch_vs_twin(*wl_systems[stem], stem, move))
    # the distance chain: both cells and RNG modes, a chunk boundary, beta 0
    # and 50 (T = 0.02), no match term, and the main path's own launch
    fcc8, fcc64 = sqs_processors("sqs_fcc8")[0], sqs_processors("sqs_fcc_4x4x4")[0]
    errs["distance"] = []
    for name, proc in (("sqs_fcc8 shape 0", fcc8), ("sqs_fcc_4x4x4", fcc64)):
        for rng, seed in SEEDS:
            errs["distance"].append(distance_vs_twin(proc, name, rng, seed))
    errs["distance"].append(distance_chunked_hash_vs_twin(fcc8, "sqs_fcc8 shape 0"))
    errs["distance"].append(distance_vs_twin(fcc8, "sqs_fcc8 shape 0", *SEEDS[1], beta=0.0))
    errs["distance"].append(distance_vs_twin(fcc64, "sqs_fcc_4x4x4", *SEEDS[1], beta=50.0))
    errs["distance"].append(distance_vs_twin(fcc8, "sqs_fcc8 shape 0", *SEEDS[1],
                                             match_weight=0.0))
    sqs_timed = {}
    for name, proc, steps in (("sqs_fcc8 shape 0", fcc8, SQS_STEPS),
                              ("sqs_fcc_4x4x4", fcc64, SQS_TWIN_STEPS)):
        t0 = time.perf_counter()
        err, sqs_timed[name] = distance_vs_twin(  # the first stage's launch
            proc, f"{name}, the main path's launch:", *SEEDS[1],
            beta=1.0 / SQS_TEMPERATURES[0], n_steps=steps, timed=True)
        sqs_timed[name]["proc"] = proc
        errs["distance"].append(err)
        print(f"phase 3: that comparison took {time.perf_counter() - t0:.1f} s")
    print(f"phases 2-3 took {time.perf_counter() - t_start:.1f} s")

    # phase 4: the main paths; only these runs are counted
    flip_runs, flip_launches = drive(
        "flip", {stem: (TEMPERATURE, BLOCK) for stem in FLIP_CELLS}, card)
    swap_runs, swap_launches = drive("swap", SWAP_CELLS, card)
    table_runs, table_launches = drive("table", TABLE_CELLS, card)
    wl_runs, wl_launches = drive_wl_cells(card)
    _, sqs_launches = drive_sqs_cells(card)
    print(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")

    # phase 5: window timings, kernel against twin
    timings = {("flip", stem): time_window(ens, stem, card, "flip", BLOCK)
               for stem, (ens, _) in flip_runs.items()}
    timings[("flip", "spinel_ewald_2x2x2")] = time_window(
        swaps["spinel_ewald_2x2x2"], "spinel_ewald_2x2x2", card, "flip", BLOCK)
    for stem, (ens, _) in swap_runs.items():
        timings[("swap", stem)] = time_window(ens, stem, card, "swap", SWAP_CELLS[stem][1])
    for stem, (ens, _) in table_runs.items():
        timings[("table", stem)] = time_window(ens, stem, card, "table", BLOCK)
    # the Wang-Landau chain beside the flip and swap chains on its tables
    timings[("flip", "aucu_wl_3x3x3")] = time_window(
        wl_runs["aucu_wl_3x3x3"][0], "aucu_wl_3x3x3", card, "flip", BLOCK)
    for stem, (ens, system, _) in wl_runs.items():
        move = WL_CELLS[stem]
        block = SWAP_CELLS[stem][1] if stem in SWAP_CELLS else BLOCK
        timings[(f"wl-{move}", stem)] = time_wl_window(
            ens, system, stem, card, move, WALKERS, block, twin_reps=3)
        timings[(f"wl-{move} at {WL_WALKERS} walkers", stem)] = time_wl_window(
            ens, system, stem, card, move, WL_WALKERS)
        plain = timings[(move, stem)]["kernel_ms"]
        mine = timings[(f"wl-{move}", stem)]["kernel_ms"]
        print(f"phase 5 [{stem}]: the Wang-Landau {move} window takes "
              f"{mine / plain:.3f}x the Metropolis {move} window on the same tables "
              f"({mine:.4f} vs {plain:.4f} ms)")
    for name, timed in sqs_timed.items():
        timings[("distance", name)] = time_distance(name, card, timed, kernel_reps=5)
    print("timings " + card + ": " + json.dumps(
        {f"{move} {stem}": v for (move, stem), v in timings.items()}))
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")

    def entry(move, stem, source, replaces, launches):
        t = timings[(move, stem)]
        name = move.split("-")[0]  # "wl-flip" is the wl_chain kernel
        return {
            "name": f"{name}_chain", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(errs[name]), "ms": t["kernel_ms"],
            "plain_ms": t["twin_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,  # no single PyTorch call runs a Monte Carlo chain
        }

    print(json.dumps({"kernels": [
        entry("flip", "spinel_2x2x2", "smol_tpu_torch/csrc/flip_chain.cu",
              "smol_tpu/ops/pallas_chain.py:1545", flip_launches),
        entry("swap", "spinel_ewald_2x2x2", "smol_tpu_torch/csrc/swap_chain.cu",
              "smol_tpu/ops/pallas_chain.py:1817", swap_launches),
        entry("table", "spinel_ewald_sgc_2x2x2", "smol_tpu_torch/csrc/table_chain.cu",
              "smol_tpu/ops/pallas_chain.py:1701", table_launches),
        entry("wl-flip", "aucu_wl_3x3x3", "smol_tpu_torch/csrc/wl_chain.cu",
              "smol_tpu/ops/pallas_chain.py:1866", wl_launches),
        entry("distance", "sqs_fcc8 shape 0", "smol_tpu_torch/csrc/distance_chain.cu",
              "smol_tpu/ops/pallas_sqs.py:649", sqs_launches),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
