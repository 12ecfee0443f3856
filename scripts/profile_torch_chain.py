"""Where the time of the port's main paths goes on one GPU: a profiler trace.

For each cell (the semigrand spinel's flips, the canonical swaps on the
spinel CE + Ewald and on Au-Cu, and the charge-neutral table flips on the
semigrand spinel CE + Ewald), and for ``bench.py``'s ``sgc`` (ternary
flips on 6x6x6 at 800 K, once with each site body: direct and K3's
q-ary rows), and for ``bench.py``'s ``tempering`` (replica exchange on
Au-Cu 3x3x3, 8192 replicas on a 300-3000 K ladder, an exchange every 10
steps, once with each site body: K1-Ising and direct, each with the
window in one launch of the flip kernel and segment by segment), a
warm-up run and
then a run of ``WINDOWS`` thinning windows (8192 walkers, 100 steps each)
under ``torch.profiler``, the table flips once more with each site body
(direct and K1-Ising); for the two Wang-Landau cells (flips on Au-Cu
3x3x3, swaps on Au-Cu 4x4x4) the main path's run, once with each site
body (direct and K1-Ising): 2048 walkers, six windows of 15000 steps; for the two SQS cells (``bench.py``'s 20 shapes of 8 sites,
and the 64-site shape) one warm ``generate`` of 2048 walkers x 4
temperatures x 8000 steps per shape.  Prints, beside the card's name and
power limit:

- the wall time of the profiled run (host clock, ending in a synchronize)
  and of one window;
- the device busy time (the union of the device activity intervals in the
  trace) and the device idle share, 1 - busy / wall;
- the device time of the chain kernel and of everything else, by name;
- the host time of the CUDA runtime calls (launches, copies,
  synchronisations), by name: a call that waits for the device shows here;
  for tempering also per segment of 10 steps.

For tempering it then times a 100-step window of 10 segments on the
host's clock (mean of 50 windows after a warm-up): the port's whole
window (draws, occupancy gather and scatter, and the window's one launch
of the flip kernel, which runs its segments and exchanges), and the 10 segments
alone on one window's fixed draws four ways: the port's launches
(``ChainLaunches`` and the exchange kernel), the wrappers with the plain
torch exchange, and a CUDA graph of the segments with the plain torch
exchange and with the exchange kernel, replayed.

Run from the repository root with ``python scripts/profile_torch_chain.py
[metropolis] [table] [sgc] [tempering] [wang-landau] [sqs]`` (the paths to trace;
all without an argument); it needs one CUDA device and ``nvcc`` (the
kernels are built at first use).
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
from smol_tpu_torch.constants import kB  # noqa: E402
from smol_tpu_torch.moca.ensemble import Ensemble, random_occupancies  # noqa: E402
from smol_tpu_torch.moca.processor.distance import CorrelationDistanceProcessor  # noqa: E402
from smol_tpu_torch.moca.sampler.sampler import Sampler  # noqa: E402
from smol_tpu_torch.ops import chain, sqs  # noqa: E402
from smol_tpu_torch.parallel import (  # noqa: E402
    ExchangeLaunches,
    exchange_betas,
    make_temperature_ladder,
    make_tempering_chain,
    tempering_exchange,
)
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
PT_CELL = "aucu_pt_3x3x3"  # bench.py's tempering
PT_PERIOD = 10
PT_LADDER = (300.0, 3000.0)
GRAPH_WINDOWS = 50
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
    sampler = Sampler.from_ensemble(ensemble, temperature, nwalkers=WALKERS, seed=3,
                                    chain_block_size=block, step_type=step_type,
                                    **options)
    return sampler, occ0


def wang_landau_cell(stem, move, delta=None):
    """(sampler, starting occupancies) of a Wang-Landau cell: the window of
    the system file, uniform starts for flips, shuffles of the file's
    half-and-half occupancy for swaps; ``delta`` the site body (None: the
    sampler's default)."""
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
        bin_size=float(system["wl_bin_size"]), chain_delta=delta)
    return sampler, occ0


def tempering_cell(delta, windowed=True):
    """(sampler, starting occupancies) of ``bench.py``'s ``tempering`` with
    the site body ``delta``; ``windowed=False`` runs its windows segment by
    segment, a flip launch and an exchange launch a segment (the sampler's
    window built on its kernel's chain with the exchanges left out of the
    chain's calls)."""
    ensemble, _ = load(PT_CELL)
    ladder = make_temperature_ladder(*PT_LADDER, WALKERS)
    occ0 = np.random.default_rng(0).integers(0, 2, (WALKERS, ensemble.num_sites))
    sampler = Sampler.from_ensemble(ensemble, temperature=ladder, nwalkers=WALKERS,
                                    seed=3, replica_exchange_period=PT_PERIOD,
                                    chain_delta=delta)
    if not windowed:
        chain_fn = sampler._kernel.make_chain_fn(PT_PERIOD)

        def segments_only(state, generator, exchange=None, **kwargs):
            return chain_fn(state, generator, **kwargs)

        sampler._chain_fns[THIN] = make_tempering_chain(segments_only, THIN // PT_PERIOD)
    return sampler, occ0.astype(np.int32)


def host_window_ms(run, windows=GRAPH_WINDOWS):
    """Mean host-clock ms of ``run()`` over ``windows`` calls after a warm-up
    call, ending in a synchronize."""
    run()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(windows):
        run()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / windows * 1e3


def tempering_window_ways(card, delta):
    """A tempering window on the host's clock: the port's whole window, and
    its 10 segments alone on fixed draws, with and without a CUDA graph."""
    ensemble, _ = load(PT_CELL)
    tables = chain.build_chain_tables(ensemble.processor, ensemble.sublattices,
                                      mu_table=ensemble.chemical_potential_table,
                                      delta=delta)
    segments, device = THIN // PT_PERIOD, ensemble.device
    occu = torch.as_tensor(random_occupancies(ensemble, WALKERS, 5), device=device)
    theta = torch.as_tensor(ensemble.natural_parameters, device=device)
    beta = torch.as_tensor(1.0 / (kB * make_temperature_ladder(*PT_LADDER, WALKERS)),
                           device=device)
    state = {"occupancy": occu.clone(),
             "enthalpy": (ensemble.compute_features(occu) @ theta).contiguous(),
             "beta": beta.clone(),
             "naccept": torch.zeros(WALKERS, dtype=torch.int32, device=device),
             "accepted": torch.ones(WALKERS, dtype=torch.bool, device=device),
             "pt_counter": 0}
    gen = torch.Generator(device=device).manual_seed(3)
    window = make_tempering_chain(chain.make_shared_proposal_chain(
        tables, PT_PERIOD, block_size=1024), segments)
    port_ms = host_window_ms(lambda: window(state, gen))

    # one window's operands, fixed, for the loops and the graphs
    occ = occu[:, tables.rank_sites].T.to(torch.int8).contiguous()
    enthalpy = state["enthalpy"].clone()
    nacc = torch.zeros(WALKERS, dtype=torch.int32, device=device)
    beta32 = beta.to(torch.float32)
    seqs = chain.rank_sequence(tables, gen, (segments, WALKERS // 1024, PT_PERIOD))
    seeds = torch.randint(0, 2**62, (segments,), generator=gen, device=device)
    u = torch.rand((segments, WALKERS), generator=gen, dtype=torch.float64, device=device)

    def plain_exchange(s):
        new = tempering_exchange(beta, enthalpy, u[s], (s + 1) % 2)
        beta.copy_(new)
        beta32.copy_(new.to(torch.float32))

    def kernel_exchange(s):
        exchange_betas(beta, beta32, enthalpy, u[s], (s + 1) % 2)

    def body(exchange):
        for s in range(segments):
            chain.flip_chain(occ, enthalpy, nacc, beta32, seqs[s], seeds[s: s + 1],
                             tables, PT_PERIOD, 1024)
            exchange(s)

    def port_segments():  # the port's launches: checked once, one call each
        launches = chain.ChainLaunches("flip", occ, enthalpy, (nacc,), beta32, (seqs,),
                                       seeds, tables, 1024, "philox")
        exchanges = ExchangeLaunches(beta, beta32, enthalpy, u, None)
        for s in range(segments):
            launches.launch(s, PT_PERIOD)
            exchanges(s, (s + 1) % 2)

    result = {"whole window, the port": port_ms,
              "segments, the port's launches": host_window_ms(port_segments),
              "segments, wrappers and plain exchange": host_window_ms(
                  lambda: body(plain_exchange))}
    for name, exchange in (("segments, graph with plain exchange", plain_exchange),
                           ("segments, graph with exchange kernel", kernel_exchange)):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                body(exchange)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body(exchange)
        result[name] = host_window_ms(graph.replay)
    print(f"[tempering {PT_CELL}, {delta}] {card}: a window of {segments} segments "
          f"of {PT_PERIOD} steps at {WALKERS} walkers, host clock, mean of "
          f"{GRAPH_WINDOWS}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in result.items()))
    return result


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


def profile_cell(stem, card, sampler, occ0, windows, thin, segments=None):
    walkers = len(np.atleast_2d(occ0)) if np.ndim(occ0) > 1 else WALKERS
    sampler.run(windows * thin, occ0, thin_by=thin)  # warm-up
    torch.cuda.synchronize()
    prof, wall = profiled(lambda: sampler.run(windows * thin, thin_by=thin))
    path = sampler.execution_path(thin)
    head = (f"[{stem}] {card}: {path}, {windows} windows x {thin} steps x "
            f"{walkers} walkers: wall {wall * 1e3:.3f} ms "
            f"({wall / windows * 1e3:.4f} ms per window)")
    summarize(head, prof, wall, windows, segments)


def profile_sqs(stem, card):
    """The SQS cell: one warm ``generate`` of ``bench.py``'s sqs config (all
    shapes of the file, 2048 walkers x 4 temperatures x 8000 steps), after a
    first one that builds the tables; a window is one launch (all the
    shapes of a temperature)."""
    systems = load_systems(ROOT / "tests" / "data" / f"torch_{stem}.npz")
    generator = StochasticSQSGenerator.from_processors(
        [CorrelationDistanceProcessor.from_system(s, "cuda") for s in systems], device="cuda")
    temperatures = np.linspace(5.0, 0.02, 4)

    def run():
        generator.generate(mcmc_steps=SQS_STEPS, temperatures=temperatures,
                           nwalkers=SQS_WALKERS, seed=23)

    run()  # warm-up
    torch.cuda.synchronize()
    before = sqs.distance_chain.launches
    prof, wall = profiled(run)
    launches = sqs.distance_chain.launches - before
    head = (f"[sqs {stem}] {card}: {generator.execution_path}, {len(systems)} shapes x "
            f"{len(temperatures)} temperatures x {SQS_STEPS} steps x {SQS_WALKERS} "
            f"walkers: wall {wall * 1e3:.3f} ms ({wall / launches * 1e3:.4f} ms per launch)")
    summarize(head, prof, wall, launches)


def summarize(head, prof, wall, windows, segments=None):
    """Print the device busy time and idle share, the kernels' time by name
    and the host's CUDA calls of one profiled run of ``windows`` windows
    (and, with ``segments`` per window, their share of one segment)."""
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
    if segments:
        n = windows * segments
        kernels = {k: v for k, v in by_name.items() if "chain_kernel" in k or "exchange" in k}
        calls = sum(count for name, (_, count) in runtime.items() if "Launch" in name)
        print(f"    per segment ({n} segments): chain and exchange kernels "
              f"{sum(kernels.values()) / n * 1e3:.2f} us on the device, "
              f"{calls / n:.2f} kernel launches and "
              f"{sum(ms for ms, _ in runtime.values()) / n * 1e3:.2f} us of CUDA "
              f"runtime calls on the host, wall {wall / n * 1e6:.2f} us")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_chain: torch sees no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    paths = set(sys.argv[1:]) or {"metropolis", "table", "sgc", "tempering", "wang-landau",
                                  "sqs"}
    if "metropolis" in paths:
        for stem, args in CELLS.items():
            profile_cell(stem, card, *metropolis_cell(stem, *args), WINDOWS, THIN)
    if "table" in paths:
        for stem, args in CELLS.items():
            if args[2] == "table-flip":
                for delta in ("direct", "ising"):
                    profile_cell(stem, card, *metropolis_cell(stem, *args, chain_delta=delta),
                                 WINDOWS, THIN)
    if "sgc" in paths:
        for delta in ("direct", "qary"):
            profile_cell(SGC_CELL[0], card,
                         *metropolis_cell(*SGC_CELL, None, chain_delta=delta), WINDOWS, THIN)
    if "tempering" in paths:
        for delta in ("ising", "direct"):
            for windowed in (True, False):  # one launch a window, then segment by segment
                profile_cell(f"{PT_CELL}, {'windowed' if windowed else 'segments'}", card,
                             *tempering_cell(delta, windowed), WINDOWS, THIN,
                             segments=THIN // PT_PERIOD)
        for delta in ("ising", "direct"):
            tempering_window_ways(card, delta)
    if "wang-landau" in paths:
        for stem, move in WL_CELLS.items():
            for delta in ("direct", "ising"):
                profile_cell(stem, card, *wang_landau_cell(stem, move, delta), WL_WINDOWS,
                             WL_THIN)
    if "sqs" in paths:
        for stem in SQS_CELLS:
            profile_sqs(stem, card)


if __name__ == "__main__":
    main()
