"""Smoke test of smol_tpu_torch on one NVIDIA GPU: build, check, drive, time.

Run from the repository root with ``python3 chip_smoke.py``.  It needs one
CUDA device and the CUDA toolkit (``nvcc``), and exits non-zero without
printing its last line when any phase fails:

1. requires a CUDA device and prints the card's name and power limit;
2. builds the flip-chain, swap-chain and table-chain kernels from
   ``smol_tpu_torch/csrc`` (into ``build/smol_tpu_torch``, one ``nvcc`` per
   source, all at once) and prints the build time and each kernel's
   registers and spills;
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
   walker's composition and table moves every walker's net charge;
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
   only: an identity proposal computes nothing).

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

from smol_tpu_torch.constants import kB
from smol_tpu_torch.moca.ensemble import Ensemble, random_occupancies
from smol_tpu_torch.moca.kernel.tableflip import TableFlip
from smol_tpu_torch.moca.sampler.sampler import Sampler
from smol_tpu_torch.ops import _build, chain
from smol_tpu_torch.system import load_system

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
        found = re.search(r"([a-z]+_chain_kernel)ILi(\d+)E(?:Li(\d+)E)?Lb([01])E", line)
        if "Compiling entry function" in line and found:
            kernel, k, km, ewald = found.groups()
            slots = "" if km is None else f", k_max={km if km != '0' else 'runtime'}"
            name = (f"{kernel}<K={k if k != '0' else 'runtime'}{slots}, "
                    f"ewald={ewald == '1'}>")
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
STATE = ("occ", "enthalpy", "naccept", "nmove")


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
    k = {key: (v.clone() if key in STATE else v) for key, v in ops.items()}
    t = {key: (v.clone() if key in STATE else v) for key, v in ops.items()}
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
    # the same trajectories; the enthalpies may differ in the last bits,
    # since the initial features sum with index_add_, whose f64 atomics on
    # CUDA add in no fixed order
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
        run = {key: (v.clone() if key in STATE else v) for key, v in ops.items()}
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
    print(f"phases 2-3 took {time.perf_counter() - t_start:.1f} s")

    # phase 4: the main paths; only these runs are counted
    flip_runs, flip_launches = drive(
        "flip", {stem: (TEMPERATURE, BLOCK) for stem in FLIP_CELLS}, card)
    swap_runs, swap_launches = drive("swap", SWAP_CELLS, card)
    table_runs, table_launches = drive("table", TABLE_CELLS, card)
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
    print("timings " + card + ": " + json.dumps(
        {f"{move} {stem}": v for (move, stem), v in timings.items()}))
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")

    def entry(move, stem, source, replaces, launches):
        t = timings[(move, stem)]
        return {
            "name": f"{move}_chain", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(errs[move]), "ms": t["kernel_ms"],
            "plain_ms": t["twin_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,  # no single PyTorch call runs a Metropolis chain
        }

    print(json.dumps({"kernels": [
        entry("flip", "spinel_2x2x2", "smol_tpu_torch/csrc/flip_chain.cu",
              "smol_tpu/ops/pallas_chain.py:1545", flip_launches),
        entry("swap", "spinel_ewald_2x2x2", "smol_tpu_torch/csrc/swap_chain.cu",
              "smol_tpu/ops/pallas_chain.py:1817", swap_launches),
        entry("table", "spinel_ewald_sgc_2x2x2", "smol_tpu_torch/csrc/table_chain.cu",
              "smol_tpu/ops/pallas_chain.py:1701", table_launches),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
