"""Where the time of the port's main paths goes on one GPU: a profiler trace.

For each cell (the semigrand spinel's flips, the canonical swaps on the
spinel CE + Ewald and on Au-Cu, and the charge-neutral table flips on the
semigrand spinel CE + Ewald), and for ``bench.py``'s ``sgc`` (ternary
flips on 6x6x6 at 800 K, once with each site body: direct and K3's
q-ary rows), a warm-up run and then a run of ``WINDOWS`` thinning windows
(8192 walkers, 100 steps each) under ``torch.profiler``; for the two Wang-Landau cells (flips on Au-Cu 3x3x3,
swaps on Au-Cu 4x4x4) the main path's run: 2048 walkers, six windows of
15000 steps; for the two SQS cells (``bench.py``'s 20 shapes of 8 sites,
and the 64-site shape) one warm ``generate`` of 2048 walkers x 4
temperatures x 8000 steps per shape.  Prints, beside the card's name and
power limit:

- the wall time of the profiled run (host clock, ending in a synchronize)
  and of one window;
- the device busy time (the union of the device activity intervals in the
  trace) and the device idle share, 1 - busy / wall;
- the device time of the chain kernel and of everything else, by name;
- the host time of the CUDA runtime calls (launches, copies,
  synchronisations), by name: a call that waits for the device shows here.

Run from the repository root with ``python scripts/profile_torch_chain.py
[metropolis] [sgc] [wang-landau] [sqs]`` (the paths to trace; all without an
argument); it needs one CUDA device and ``nvcc`` (the kernels are built at
first use).
"""

from __future__ import annotations

import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from smol_tpu_torch.capp import StochasticSQSGenerator  # noqa: E402
from smol_tpu_torch.moca.ensemble import Ensemble, random_occupancies  # noqa: E402
from smol_tpu_torch.moca.processor.distance import CorrelationDistanceProcessor  # noqa: E402
from smol_tpu_torch.moca.sampler.sampler import Sampler  # noqa: E402
from smol_tpu_torch.system import load_system, load_systems  # noqa: E402

WALKERS = 8192
THIN = 100
WINDOWS = 50
CELLS = {  # system file stem -> (temperature K, sequence block, step type)
    "spinel_2x2x2": (1000.0, 1024, None),  # None: the sampler's default
    "spinel_ewald_2x2x2": (1000.0, 1024, None),
    "spinel_ewald_3x3x3": (1000.0, 1024, None),
    "aucu_4x4x4": (300.0, 512, None),
    "spinel_ewald_sgc_2x2x2": (1000.0, 1024, "table-flip"),
    "spinel_ewald_sgc_3x3x3": (1000.0, 1024, "table-flip"),
}
SGC_CELL = ("sgc_6x6x6", 800.0, 1024)  # bench.py's sgc: stem, temperature K, block
WL_CELLS = {"aucu_wl_3x3x3": "flip", "aucu_4x4x4": "swap"}  # stem -> move
WL_WALKERS = 2048
WL_THIN = 15_000
WL_WINDOWS = 6
SQS_CELLS = ("sqs_fcc8", "sqs_fcc_4x4x4")
SQS_WALKERS = 2048
SQS_STEPS = 8000


def busy_us(events):
    """Length of the union of [start, end) intervals, in microseconds."""
    total, last_end = 0.0, -np.inf
    for start, end in sorted(events):
        if end > last_end:
            total += end - max(start, last_end)
            last_end = end
    return total


def load(stem):
    system = load_system(ROOT / "tests" / "data" / f"torch_{stem}.npz")
    return Ensemble.from_system(system, "cuda"), system


def metropolis_cell(stem, temperature, block, step_type, **options):
    """(sampler, starting occupancies) of a Metropolis cell; ``options`` go
    to the sampler (the site body)."""
    ensemble, system = load(stem)
    occ0 = system.get("initial_occupancy")
    if occ0 is None:
        occ0 = random_occupancies(ensemble, WALKERS, 0)
    sampler = Sampler.from_ensemble(ensemble, temperature, WALKERS, seed=3,
                                    chain_block_size=block, step_type=step_type,
                                    **options)
    return sampler, occ0


def wang_landau_cell(stem, move):
    """(sampler, starting occupancies) of a Wang-Landau cell: the window of
    the system file, uniform starts for flips, shuffles of the file's
    half-and-half occupancy for swaps."""
    ensemble, system = load(stem)
    rng = np.random.default_rng(0)
    if move == "swap":
        occ0 = rng.permuted(np.tile(system["initial_occupancy"], (WL_WALKERS, 1)), axis=1)
    else:
        occ0 = rng.integers(0, 2, (WL_WALKERS, ensemble.num_sites)).astype(np.int32)
    sampler = Sampler.from_ensemble(
        ensemble, kernel_type="wang-landau", step_type=move, nwalkers=WL_WALKERS,
        seed=13, flatness=0.8, min_enthalpy=float(system["wl_min_enthalpy"]),
        max_enthalpy=float(system["wl_max_enthalpy"]),
        bin_size=float(system["wl_bin_size"]))
    return sampler, occ0


def profiled(run):
    """(profiler, wall seconds) of ``run()`` under ``torch.profiler``."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        start = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    return prof, wall


def profile_cell(stem, card, sampler, occ0, windows, thin):
    walkers = len(np.atleast_2d(occ0)) if np.ndim(occ0) > 1 else WALKERS
    sampler.run(windows * thin, occ0, thin_by=thin)  # warm-up
    torch.cuda.synchronize()
    prof, wall = profiled(lambda: sampler.run(windows * thin, thin_by=thin))
    path = sampler.execution_path(thin)
    head = (f"[{stem}] {card}: {path}, {windows} windows x {thin} steps x "
            f"{walkers} walkers: wall {wall * 1e3:.3f} ms "
            f"({wall / windows * 1e3:.4f} ms per window)")
    summarize(head, prof, wall, windows)


def profile_sqs(stem, card):
    """The SQS cell: one warm ``generate`` of ``bench.py``'s sqs config (all
    shapes of the file, 2048 walkers x 4 temperatures x 8000 steps), after a
    first one that builds the tables; a window is one launch."""
    systems = load_systems(ROOT / "tests" / "data" / f"torch_{stem}.npz")
    generator = StochasticSQSGenerator.from_processors(
        [CorrelationDistanceProcessor(s, "cuda") for s in systems], device="cuda")
    temperatures = np.linspace(5.0, 0.02, 4)

    def run():
        generator.generate(mcmc_steps=SQS_STEPS, temperatures=temperatures,
                           nwalkers=SQS_WALKERS, seed=23)

    run()  # warm-up
    torch.cuda.synchronize()
    prof, wall = profiled(run)
    launches = len(systems) * len(temperatures)
    head = (f"[sqs {stem}] {card}: {generator.execution_path}, {len(systems)} shapes x "
            f"{len(temperatures)} temperatures x {SQS_STEPS} steps x {SQS_WALKERS} "
            f"walkers: wall {wall * 1e3:.3f} ms ({wall / launches * 1e3:.4f} ms per launch)")
    summarize(head, prof, wall, launches)


def summarize(head, prof, wall, windows):
    """Print the device busy time and idle share, the kernels' time by name
    and the host's CUDA calls of one profiled run of ``windows`` windows."""
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        print(head + "; device time: not measured (the trace holds no device events)")
        return
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in device]) * 1e-6
    by_name = defaultdict(float)
    for e in device:
        by_name[e.name] += (e.time_range.end - e.time_range.start) * 1e-3  # ms
    chain = sum(v for k, v in by_name.items() if "chain_kernel" in k)
    print(head + f"; device busy {busy * 1e3:.3f} ms, idle share "
          f"{1 - busy / wall:.4f}; chain kernel {chain:.3f} ms "
          f"({chain / windows:.4f} ms per window), other device work "
          f"{sum(by_name.values()) - chain:.3f} ms in "
          f"{len(device) - sum(1 for e in device if 'chain_kernel' in e.name)} "
          f"activities")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms:9.3f} ms  {name[:110]}")
    runtime = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("cuda"):
            runtime[e.name][0] += (e.time_range.end - e.time_range.start) * 1e-3
            runtime[e.name][1] += 1
    for name, (ms, count) in sorted(runtime.items(), key=lambda kv: -kv[1][0])[:5]:
        print(f"    host {ms:9.3f} ms in {count:6d} calls  {name}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_chain: torch sees no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    paths = set(sys.argv[1:]) or {"metropolis", "sgc", "wang-landau", "sqs"}
    if "metropolis" in paths:
        for stem, args in CELLS.items():
            profile_cell(stem, card, *metropolis_cell(stem, *args), WINDOWS, THIN)
    if "sgc" in paths:
        for delta in ("direct", "qary"):
            profile_cell(SGC_CELL[0], card,
                         *metropolis_cell(*SGC_CELL, None, chain_delta=delta), WINDOWS, THIN)
    if "wang-landau" in paths:
        for stem, move in WL_CELLS.items():
            profile_cell(stem, card, *wang_landau_cell(stem, move), WL_WINDOWS, WL_THIN)
    if "sqs" in paths:
        for stem in SQS_CELLS:
            profile_sqs(stem, card)


if __name__ == "__main__":
    main()
