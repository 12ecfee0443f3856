"""Smoke test of smol_tpu_torch on one NVIDIA GPU: build, check, drive, time.

Run from the repository root with ``python3 chip_smoke.py``.  It needs one
CUDA device and the CUDA toolkit (``nvcc``), and exits non-zero without
printing its last line when any phase fails:

1. requires a CUDA device and prints the card's name and power limit;
2. builds the flip-chain kernel from ``smol_tpu_torch/csrc`` (into
   ``build/smol_tpu_torch``) and prints the build time and register use;
3. runs the kernel and its plain torch twin on the same inputs at the
   shapes the main path gives the kernel (8192 walkers in 8 sequence
   blocks of 1024, one 100-step window) on both bench spinel sizes, in
   ``hash`` mode and in ``philox`` mode with a seed above 2**32; then one
   hash-mode chain of 2100 steps through ``make_shared_proposal_chain``,
   whose second chunk restarts the step counter and takes the next chunk
   seed, against the twin run chunk by chunk.  Occupancies and accept
   counts must be identical, except where the twin shows the decision
   within 4 f32 ulps of log U, and enthalpies must agree to 1e-9 absolute;
4. drives the main path on the 2x2x2 and then the 3x3x3 bench spinel:
   ``Ensemble.from_system`` -> ``Sampler.from_ensemble(T=1000 K, 8192
   walkers, seed=3)`` -> ``run(20000 steps, thin_by=100)``, twice per size
   (a first, cold run and a warm one on a fresh sampler, which must record
   the same occupancies and enthalpies to 1e-9), and checks that the kernel was launched, the
   execution path, the recorded enthalpy of the last sample against
   features . theta (< 1e-9) and the acceptance fraction.  The rate is the
   warm run's; the set-up (system load, table build, and the cold run's
   excess over the warm one) is printed on its own;
5. times one 100-step window at 8192 walkers, kernel against twin, for
   both sizes.

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from smol_tpu_torch.constants import kB
from smol_tpu_torch.moca.ensemble import Ensemble, random_occupancies
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
CELLS = ("2x2x2", "3x3x3")


def check(condition, message):
    if not condition:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0]


def load_ensemble(name):
    path = ROOT / "tests" / "data" / f"torch_spinel_{name}.npz"
    return Ensemble.from_system(load_system(path), "cuda")


def tables_of(ensemble):
    return chain.build_chain_tables(
        ensemble.processor, ensemble.sublattices,
        mu_table=ensemble.chemical_potential_table,
    )


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


def window_operands(ensemble, tables, occ_seed, seq_seed, n_steps=THIN):
    """Operands of one main-path launch: 8192 walkers, 8 sequence blocks."""
    device = ensemble.device
    occu = torch.as_tensor(random_occupancies(ensemble, WALKERS, occ_seed),
                           device=device)
    gen = torch.Generator(device=device).manual_seed(seq_seed)
    return dict(
        occ=occu[:, tables.rank_sites].T.to(torch.int8).contiguous(),
        enthalpy=torch.zeros(WALKERS, dtype=torch.float64, device=device),
        naccept=torch.zeros(WALKERS, dtype=torch.int32, device=device),
        beta32=torch.full((WALKERS,), 1.0 / (kB * TEMPERATURE),
                          dtype=torch.float32, device=device),
        seq=chain.rank_sequence(tables, gen, (WALKERS // BLOCK, n_steps)),
    )


def compare(label, occ_k, occ_t, n_k, n_t, e_k, e_t, margin, n_steps):
    """Kernel against twin: equal walkers, or a decision within ULP_SLACK."""
    same = (occ_k == occ_t).all(dim=0) & (n_k == n_t)
    near_tie = margin <= ULP_SLACK
    check(bool((same | near_tie).all()),
          f"{label}: {int((~same & ~near_tie).sum())} walkers differ without a near-tie")
    check(float(same.float().mean()) >= 0.99, f"{label}: too many near-tie mismatches")
    err = float((e_k - e_t)[same].abs().max())
    check(err <= 1e-9, f"{label}: enthalpy difference {err}")
    accept_frac = float(n_k.double().mean()) / n_steps
    check(0.0 < accept_frac < 1.0, f"{label}: acceptance {accept_frac}")
    print(f"phase 3 [{label}]: kernel == twin on {int(same.sum())}/{len(same)} "
          f"walkers ({int((~same).sum())} near-tie), max |dH| {err:.3e}, "
          f"acceptance {accept_frac:.4f}")
    return err


def window_vs_twin(ensemble, name, rng, seed):
    """Phase 3: one main-path window, kernel against twin."""
    tables = tables_of(ensemble)
    ops = window_operands(ensemble, tables, occ_seed=7, seq_seed=17)
    seed_t = torch.tensor([seed], dtype=torch.int64, device=ensemble.device)
    k = {key: v.clone() for key, v in ops.items()}
    t = {key: v.clone() for key, v in ops.items()}
    margin = torch.full((WALKERS,), float("inf"), device=ensemble.device)
    chain.flip_chain(k["occ"], k["enthalpy"], k["naccept"], k["beta32"],
                     k["seq"], seed_t, tables, THIN, BLOCK, rng)
    chain.flip_chain_reference(t["occ"], t["enthalpy"], t["naccept"],
                               t["beta32"], t["seq"], seed_t, tables, THIN,
                               BLOCK, rng, margin=margin)
    torch.cuda.synchronize()
    return compare(f"{name} {rng} seed {seed:#x}", k["occ"], t["occ"],
                   k["naccept"], t["naccept"], k["enthalpy"], t["enthalpy"],
                   margin, THIN)


def chunked_hash_vs_twin(ensemble, name):
    """Phase 3: a hash-mode chain across a chunk boundary, kernel vs twin.

    The kernel runs through ``make_shared_proposal_chain`` (which splits
    the steps into chunks of ``MAX_CHUNK_STEPS``); the twin restates the
    reference's chunking: chunk c takes sequence row c, seed
    ``seed0 + c * SEED_STRIDE`` and counts its steps from 0.
    """
    device = ensemble.device
    tables = tables_of(ensemble)
    chunk = chain.MAX_CHUNK_STEPS
    n_steps = chunk + 52
    gen = torch.Generator(device=device).manual_seed(29)
    seqs = chain.rank_sequence(tables, gen, (2, WALKERS // BLOCK, chunk))
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
    }
    run = chain.make_shared_proposal_chain(
        tables, n_steps, block_size=BLOCK, rng="hash",
        seqs=seqs.cpu().numpy(), seeds=np.asarray(seeds),
    )
    before = chain.flip_chain.launches
    state = run(state, None)
    check(chain.flip_chain.launches - before == 2, "chunked run: two launches")

    occ = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
    enthalpy = torch.zeros(WALKERS, dtype=torch.float64, device=device)
    nacc = torch.zeros(WALKERS, dtype=torch.int32, device=device)
    margin = torch.full((WALKERS,), float("inf"), device=device)
    for c, seed in enumerate(seeds):
        chain.flip_chain_reference(
            occ, enthalpy, nacc, beta.to(torch.float32), seqs[c],
            torch.tensor([seed], dtype=torch.int64, device=device), tables,
            min(chunk, n_steps - c * chunk), BLOCK, "hash", margin=margin,
        )
    torch.cuda.synchronize()
    occ_k = state["occupancy"][:, tables.rank_sites].T.to(torch.int8)
    return compare(f"{name} hash {n_steps} steps, 2 chunks", occ_k, occ,
                   state["naccept"], nacc, state["enthalpy"], enthalpy,
                   margin, n_steps)


def drive_main_path(name, card):
    """Phase 4: the port's main path, as a user calls it; cold, then warm."""
    t0 = time.perf_counter()
    ensemble = load_ensemble(name)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    occ0 = random_occupancies(ensemble, WALKERS, 0)
    runs = []
    for _ in ("cold", "warm"):
        t0 = time.perf_counter()
        sampler = Sampler.from_ensemble(ensemble, TEMPERATURE, WALKERS, seed=3)
        path = sampler.execution_path(THIN)  # builds the chain tables
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sampler.run(NSTEPS, occ0, thin_by=THIN)
        torch.cuda.synchronize()
        runs.append((sampler, t1 - t0, time.perf_counter() - t1))
    check(path.startswith("cuda-chain[flip]"), f"execution path {path}")
    (cold, tables_s, cold_s), (sampler, _, wall) = runs

    samples = sampler.samples
    n = samples.num_samples
    check(n == NSTEPS // THIN, f"{n} samples recorded")
    # the same trajectories; the enthalpies may differ in the last bits,
    # since the initial features sum with index_add_, whose f64 atomics on
    # CUDA add in no fixed order
    check(np.array_equal(cold.samples.get_occupancies(), samples.get_occupancies()),
          f"{name}: the warm run did not repeat the cold run's occupancies")
    repeat = float(np.abs(cold.samples.get_enthalpies() - samples.get_enthalpies()).max())
    check(repeat <= 1e-9, f"{name}: warm and cold enthalpies differ by {repeat}")
    last_h = samples.get_enthalpies(discard=n - 1)
    last_f = samples.get_feature_vectors(discard=n - 1)
    check(last_f.shape == (WALKERS, len(ensemble.natural_parameters)),
          f"feature shape {last_f.shape}")
    check(np.isfinite(last_h).all() and np.isfinite(last_f).all(), "non-finite")
    parity = float(np.abs(last_f @ ensemble.natural_parameters - last_h).max())
    check(parity < 1e-9, f"{name}: recorded enthalpy vs features.theta {parity}")
    accept = float(sampler.efficiency())
    check(0.0 < accept < 1.0, f"{name}: acceptance {accept}")
    mean_h = float(samples.mean_enthalpy(discard=n // 2))
    rate = WALKERS * NSTEPS / wall
    print(f"phase 4 [{name}] {card}: {ensemble.num_sites} sites, path {path}, "
          f"mean enthalpy {mean_h:.6f} eV, acceptance {accept:.4f}, "
          f"parity(e) {parity:.3e}, warm vs cold |dH| {repeat:.3e}, warm run {rate / 1e6:.1f} M attempts/s end "
          f"to end ({wall:.4f} s for {WALKERS} walkers x {NSTEPS} steps); "
          f"set-up: system load {load_s:.4f} s, sampler + tables {tables_s:.4f} s, "
          f"cold run {cold_s:.4f} s (+{cold_s - wall:.4f} s over warm)")
    return ensemble, rate


def time_window(ensemble, name, card, kernel_reps=50, twin_reps=3):
    """Phase 5: one 100-step window at 8192 walkers, kernel against twin."""
    tables = tables_of(ensemble)
    ops = window_operands(ensemble, tables, occ_seed=5, seq_seed=1)
    seed = torch.tensor([42], dtype=torch.int64, device=ensemble.device)
    args = (ops["occ"], ops["enthalpy"], ops["naccept"], ops["beta32"],
            ops["seq"], seed, tables, THIN, BLOCK, "philox")
    kernel_ms = cuda_ms(lambda: chain.flip_chain(*args), kernel_reps)
    twin_ms = cuda_ms(lambda: chain.flip_chain_reference(*args), twin_reps)
    rate = WALKERS * THIN / (kernel_ms * 1e-3)
    print(f"phase 5 [{name}] {card}: 100-step window at {WALKERS} walkers: kernel "
          f"{kernel_ms:.4f} ms ({rate / 1e6:.1f} M attempts/s), twin "
          f"{twin_ms:.2f} ms, twin/kernel {twin_ms / kernel_ms:.1f}x")
    return kernel_ms, twin_ms


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # phase 2: build from the checkout's sources
    lib_path, log, seconds = _build.build_library("flip_chain")
    _build.load_flip_chain()
    print(f"phase 2: built {lib_path.relative_to(ROOT)} in {seconds:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # phase 3: kernel against twin at the main path's shapes
    ensembles = {name: load_ensemble(name) for name in CELLS}
    errs = [
        window_vs_twin(ensembles[name], name, rng, seed)
        for name in CELLS
        for rng, seed in (("hash", 987654321), ("philox", 0x2545F4914F6CDD1D))
    ]
    errs.append(chunked_hash_vs_twin(ensembles["2x2x2"], "2x2x2"))

    # phase 4: the main path; only these runs are counted
    chain.flip_chain.launches = 0
    runs = [drive_main_path(name, card) for name in CELLS]
    launches = chain.flip_chain.launches
    check(launches == len(CELLS) * 2 * (NSTEPS // THIN), f"{launches} kernel launches")
    print(f"phase 4: flip_chain launches on the main path: {launches}")

    # phase 5: window timings, kernel against twin
    timings = {
        name: time_window(ens, name, card) for (ens, _), name in zip(runs, CELLS)
    }
    print("timings " + card + ": " + json.dumps(
        {k: {"kernel_ms": v[0], "twin_ms": v[1]} for k, v in timings.items()}
    ))

    kernel_ms, twin_ms = timings["2x2x2"]
    print(json.dumps({"kernels": [{
        "name": "flip_chain",
        "route": "cuda",
        "source": "smol_tpu_torch/csrc/flip_chain.cu",
        "replaces": "smol_tpu/ops/pallas_chain.py:1545",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": twin_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
