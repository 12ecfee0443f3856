"""Smoke test of smol_tpu_torch on one NVIDIA GPU: build, check, drive, time.

Run from the repository root with ``python3 chip_smoke.py``.  It needs one
CUDA device and the CUDA toolkit (``nvcc``), and exits non-zero without
printing its last line when any phase fails:

1. requires a CUDA device and prints the card's name and power limit;
2. builds the flip-chain, swap-chain, table-chain, Wang-Landau-chain,
   distance-chain and replica-exchange kernels from ``smol_tpu_torch/csrc``
   (into ``build/smol_tpu_torch``, one ``nvcc`` per source, all started at
   once; the table, Wang-Landau and distance chains', the longest, in a
   thread while phase 3 compares the flip and swap chains) and prints the
   build time and each kernel's registers and spills (the flip, swap,
   table and Wang-Landau chains in each site body: direct, K3's q-ary rows
   for q = 2 (with or without the Ewald term), 3 and 4, and K1-Ising's
   parity rows for 1 to 4 words of rank bits), and the flip kernel's
   launch plan on ``sgc`` (lanes, blocks, rows, shared memory);
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
   K3, the q-ary body, in the flip chain on bench ``sgc`` 6x6x6 (8192
   walkers, blocks of 1024, 800 K) and the direct body on the same cell
   (a ternary lookup, TM = 27); the swap chain with K3 on the ternary
   CE 3x3x3 without chemical potentials; both chains with q = 2 on Au-Cu
   4x4x4; all in both RNG modes, and one hash-mode q-ary flip chain across
   the chunk boundary on ``sgc`` 6x6x6.
   The Wang-Landau chain against its twin on every walker and plane
   (occupancy, entropy to 0.0, histogram, occurrences, ``mod_factor``,
   ``wl_counter``, ``naccept``; enthalpy to 1e-9), 2048 walkers, 100
   steps with a flatness check every 20, in both RNG modes: flips on
   Au-Cu 3x3x3 at the bench's ~250 bins, swaps on Au-Cu 4x4x4, then one
   hash-mode run across the 2048-step chunk boundary, one with
   ``update_period = 3``, and swaps with the Ewald term on the spinel
   CE + Ewald 2x2x2; every compared run must hold a flatness reset.  Each
   at the chosen launch design (``chain.wl_launch_plan``: 16 lanes a walker
   at 2048 walkers, the K1-Ising rows resident and the direct rows
   streamed, with the entropy in shared memory beside either), and on both
   cells with both bodies once more with the planes global, with the
   entropy in shared memory and in the old design (one thread a walker,
   rows streamed, planes global), and with the K1-Ising rows streamed;
   the twin sums at the kernel's lanes.
   Last, the main path's launch for both moves: 2048 walkers from planes
   of zeros, one philox window at flatness 0.8 with a check every 1000
   steps, the first 1000 of its 15000 steps (the twin's time sets that).
   The distance (SQS) chain against its twin, bit for bit on every walker
   (occupancy, best occupancy, features, score, best score, accepts),
   2048 walkers from the generator's starts in blocks of 512, at the
   chosen design (``sqs._DESIGN``: its lanes a walker, every rank's rows
   resident in shared memory on the 8-site shapes, streamed on the 64-site
   one): 300 steps on the bench's first 8-site shape and on the 64-site
   shape in both RNG modes, a hash-mode chain across the 2048-step chunk
   boundary through ``make_distance_chain``, beta 0, beta 50 (T = 0.02),
   no match term, and the old design (one thread a walker, rows streamed);
   one batched launch of the bench's 20 8-site shapes against the 20
   per-shape launches and, across the chunk boundary, through
   ``make_batched_distance_chain`` against one ``make_distance_chain`` per
   shape, in both RNG modes; and the main paths' own launches at the first
   stage's beta, the 20 shapes in one launch (300 philox steps) against
   the batched twin and the first 2000 steps of the 64-site launch; every
   walker keeps its composition and its score equals the exact rescore.
   K1-Ising, the parity body, in the flip chain on both semigrand spinels
   and on bench ``tempering``'s Au-Cu 3x3x3 (at 1000 K) and in the swap
   chain on Au-Cu 4x4x4 and the spinel CE + Ewald 2x2x2 and 3x3x3, in both
   RNG modes, and a hash chain across the chunk boundary in each kernel,
   against the Ising twin; then the replica-exchange kernel against its
   twin over 3000 sweeps of alternating phase at 8192 walkers, betas and
   their f32 copies bit for bit.  K3 with q = 4 in the flip chain on the
   quaternary and binary rocksalt, and q = 2 with the Ewald term in both
   chains on the spinel CE + Ewald 2x2x2, both RNG modes and a chunk
   crossing.  K1 at every launch design, 1, 2, 4, 8 and 16 lanes a walker
   with every rank's rows resident (where they fit) and streamed, against
   the twin at the same lanes bit for bit (occupancies, accept counts and
   enthalpies) on one main-path window in both RNG modes, for each body:
   K1-Ising on both semigrand spinels, with the Ewald term on the spinel
   CE + Ewald 2x2x2 and on bench ``tempering``'s Au-Cu 3x3x3; the direct
   body with K = 3 on ``sgc`` 6x6x6 and with a runtime slot count and the
   Ewald term (a fourth, empty slot) on the spinel CE + Ewald 2x2x2; K3
   with q = 3 on ``sgc`` 6x6x6, q = 2 with the Ewald term and q = 4 (the
   flip comparisons above, the chunk crossings included, hold the kernel
   at its plan against the twin at the plan's lanes); and bench
   ``spinel-independent``'s sweep schedule (``proposal_mode="sweep"``)
   through ``make_shared_proposal_chain`` against the twin on the same
   schedule, bit for bit, in both RNG modes.  K2 and K5 likewise at every
   launch design, 1 to 16 lanes with every rank's rows resident (where
   they fit) and streamed, against the twin in the same order bit for
   bit (occupancies, accept and move counts, enthalpies)
   with compositions and net charges kept, in both RNG modes: the swap
   chain on the spinel CE + Ewald 2x2x2 (K1-Ising, direct, K3) and 3x3x3
   (K1-Ising, direct), Au-Cu 4x4x4 (K1-Ising, direct) and the ternary
   3x3x3 (K3), the table chain on the spinel CE + Ewald sgc 2x2x2
   (K1-Ising, direct, K3) and 3x3x3 (K1-Ising, direct) and the
   Li/Mn/vacancy, O/F rocksalt (three slots).  The site bodies of the table chain: K1-Ising on both
   semigrand spinel CE + Ewald cells and K3 (q = 2, Ewald) on 2x2x2, in
   both RNG modes, each body across the chunk boundary; of the
   Wang-Landau chain: every comparison above once more with K1-Ising
   (the main path's flip launch included), and K3 (q = 3) on the ternary
   ``sgc`` 3x3x3 window in both RNG modes and across the chunk boundary;
4. drives the main paths, each with the launch counts set to 0 just
   before and read just after:
   - flips (with the default site body, K1-Ising where the system's
     tables take it, on every flip and swap path but ``sgc``):
     ``Ensemble.from_system(spinel 2x2x2, then 3x3x3)`` ->
     ``Sampler.from_ensemble(T=1000 K, 8192 walkers, seed=3)`` ->
     ``run(20000 steps, thin_by=100)``;
   - canonical swaps: the same on the spinel CE + Ewald 2x2x2 and 3x3x3
     (1000 K) and on Au-Cu 4x4x4 (300 K, blocks of 512), from each file's
     ``initial_occupancy``; no chemical potentials, so the sampler takes
     swaps; then Au-Cu 4x4x4 once more with ``chain_delta="direct"``, the
     swap chain's direct body;
   - charge-neutral table flips, ``bench.py``'s ``spinel-ewald``: the
     same with ``step_type="table-flip"`` on the semigrand spinel CE +
     Ewald 2x2x2 and 3x3x3 (1000 K), all walkers from the file's
     charge-neutral ``initial_occupancy``, with the default site body, then
     each cell once with the other (direct or K1-Ising) and 2x2x2 with K3;
   - K3 on a main path with the Ewald term (swaps on the spinel CE + Ewald
     2x2x2) and with q = 4 (flips on the quaternary and binary rocksalt);
   - ternary semigrand flips, ``bench.py``'s ``sgc``:
     ``Ensemble.from_system(sgc 6x6x6)`` (the decomposition processor) ->
     ``Sampler.from_ensemble(T=800 K, 8192 walkers, seed=3)`` ->
     ``run(20000 steps, thin_by=100)`` from the bench's starts, with the
     default site body and with ``chain_delta="qary"`` (K3), and once more
     with the container's record cap set to one byte, which must move
     every batch to host memory and record what the uncapped run did;
   - Wang-Landau: ``Sampler.from_ensemble(kernel_type="wang-landau",
     2048 walkers, flatness 0.8, seed=13)`` -> ``run(90000 steps,
     thin_by=15000)``, (a) ``bench.py``'s ``wang-landau`` config, flips on
     Au-Cu 3x3x3 from its random starts, (b) swaps on Au-Cu 4x4x4 from
     shuffled half-and-half starts, each in the window its system file
     carries, with the default site body and once with the other (direct
     or K1-Ising); checked: the counters, the planes' invariants, the
     modification factors, the compositions, the chain's accumulated
     enthalpy against the exact recompute (< 1e-9) and the one aux record;
     (c) the 8-site nearest-neighbour system, 64 walkers x 200000 steps
     (flatness 0.9, a check every 5000 steps), with the direct body and
     with K1-Ising: every walker's log density of states within 0.5 of the
     exact degeneracies; (d) K3 (q = 3) on the ternary ``sgc`` 3x3x3 window,
     flips with its chemical potentials;
   - SQS: ``StochasticSQSGenerator.from_processors(<shapes>,
     device="cuda").generate(mcmc_steps=8000, temperatures=linspace(5,
     0.02, 4), nwalkers=2048, seed=23)``, (a) ``bench.py``'s ``sqs``
     config, the 20 shapes of 8 sites, one launch a temperature for all of
     them, (b) the 64-site shape, each cold and then warm on the same
     generator (bit for bit the same search; 16 launches in all);
     checked: every launch's compositions and final score against the
     exact rescore (< 1e-9), the stored scores against an exact rescore on
     the CPU (< 1e-9), every walker's best no worse than its start, and a
     matched shell (a negative score) found;
   - replica exchange, ``bench.py``'s ``tempering``:
     ``Ensemble.from_system(aucu_pt 3x3x3)`` -> ``Sampler.from_ensemble(
     temperature=make_temperature_ladder(300, 3000, 8192), nwalkers=8192,
     seed=3, replica_exchange_period=10)`` -> ``run(20000 steps,
     thin_by=100)`` from the bench's starts (200 windows of 10 segments, a
     flip launch and an exchange launch each), on the default body
     (K1-Ising) and once more with ``chain_delta="direct"``; checked: the
     execution path,
     parity (e) on the last record, every record's temperatures a
     permutation of the ladder, the walkers travelling along it (each
     walker's rung at the first and the last record: more than
     ``PT_MIN_TRAVEL`` rungs apart on average), the warm run equal to the
     cold one bit for bit (occupancies, enthalpies, temperatures), the
     coldest eighth of the ladder annealing (its mean enthalpy over the
     last quarter of the records below its first record's); printed: the
     flip and exchange
     acceptance, the coldest and hottest eighths' mean enthalpy and
     composition, attempts/s and exchange attempts/s.  Then replica
     exchange at equilibrium: the 8-site Au-Cu FCC, 6 temperatures over
     600-4000 K with 128 walkers each, every temperature's mean enthalpy
     within 5 standard errors of exact enumeration and the coldest below
     the hottest;
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
4b. built here (ROADMAP Queue 1 item 5's host layer, which imports
   neither ``jax`` nor ``smol_tpu``): reads ``tests/data/lno_prim.json``
   and ``golden_lno_ce.json`` through ``crystal.pmg_compat``, builds the
   ``{2: 5, 3: 4.1}`` sinusoid subspace and computes the correlation vector
   of each of the 27 golden structures from the structure, its supercell
   matrix and its site mapping, within 1e-12 relative of smol's stored
   numbers (tied orbits' columns permuted, one permutation for all 27);
   builds bench ``spinel`` 2x2x2 and ``sgc`` 6x6x6 as ``bench.py`` builds
   them (``random_expansion`` -> ``Ensemble.from_cluster_expansion``, the
   decomposition processor, the bench's chemical potentials) and holds
   every array to ``torch_spinel_cd_2x2x2.npz`` and ``torch_sgc_6x6x6.npz``
   (integers equal, f64 within 1e-12 relative; printed: bit for bit or the
   largest difference, and the host build time beside the card's name and
   power limit); then runs each built ensemble, and the same from the
   file, through ``Sampler.from_ensemble(T, 8192 walkers, seed=3).run(
   20000, thin_by=100)`` (1000 K, 800 K) from the bench's starts with the
   default site body: the traces equal bit for bit where the arrays were,
   parity (e) in every run; counts set to 0 just before the runs, read
   just after, and added to K1's launches;
4c. built here, with Ewald: the 27 golden LNO vectors with an Ewald term
   (``golden_lno_ce_ewald.json``: the cluster columns within 1e-12
   relative of smol's, the Ewald column, smol's pymatgen sum, within
   1e-10); bench ``spinel-ewald`` 2x2x2 exactly as ``bench.py`` builds it
   (``random_expansion(..., ewald=True)`` -> ``Ensemble.
   from_cluster_expansion``: the decomposition composed with the Ewald
   term, the bench's chemical potentials -> ``generate_random_ordered_
   occupancy(..., charge_neutral=True, rng=default_rng(0))`` ->
   ``Sampler.from_ensemble(..., step_type="table-flip")``, whose usher
   derives its flip table from a ``CompositionSpace``), every array held
   to ``torch_spinel_ewald_cd_sgc_2x2x2.npz``, usher keys and start
   included (the Ewald matrix's largest difference printed); the 3x3x3
   expansion form held to ``torch_spinel_ewald_sgc_3x3x3.npz`` and the
   canonical 2x2x2 expansion form to ``torch_spinel_ewald_2x2x2.npz``;
   then 8192 walkers x 20000 steps (thin_by 100, 1000 K, the default
   body) of table flips (K5 with K4) from the built 2x2x2 system and from
   its file, bit for bit, of table flips on the built 3x3x3 and of
   canonical swaps (K2 with K4) on the built 2x2x2 and its file, bit for
   bit: each run's host build time, rate, acceptance, parity (e) and the
   net charge of every record (0); counts set to 0 just before the runs,
   read just after, and added to K5's and K2's launches;
4d. the reference's host API: bench ``spinel`` 2x2x2 built by hand as the
   reference's users build it (``ClusterDecompositionProcessor(subspace,
   scmatrix, interaction tensors, device="cuda")`` -> ``Ensemble(
   processor)`` -> ``ensemble.chemical_potentials = {...}``), run as phase
   4b runs it (K1, the default body), equal to phase 4b's built run bit
   for bit, and again from ``Ensemble.from_dict(json.loads(json.dumps(
   ensemble.as_dict())))``, bit for bit; 1000 single flips from its
   records, ``compute_feature_vector_change`` (the local delta over the
   flipped site's clusters) against the full recompute within 1e-12
   relative (parity (b)), and ``compute_average_drift``; then
   ``chemical_potentials = None``: the path takes swaps, one window on K2
   with parity (e); bench ``sqs`` as ``bench.py`` builds it
   (``StochasticSQSGenerator.from_structure(fcc_binary_prim(), {2: 5.0, 3:
   3.5}, 8)``, its host build time printed as set-up), its 20 shapes equal
   to ``torch_sqs_fcc8.npz`` array for array, a search of phase 3's launch
   size (300 steps, 2048 walkers a shape, the 4 temperatures) beside the
   same search from the file (best scores and occupancies equal), and
   ``get_best_sqs(5, remove_duplicates=True)`` with each structure's
   formula; counts set to 0 just before the runs, read just after, and
   added to K1's, K2's and K7's launches;
4e. the per-step path (plain torch ops over all walkers, each with its own
   proposals), where the reference's kernels leave the chain: bench
   ``spinel-independent-random`` (bench ``spinel`` built here as phase 4b
   builds it, ``shared_proposals=False``, 8192 walkers at 1000 K, seed 3,
   ``STEP_NSTEPS`` steps thinned by 100 from the bench's starts): its
   execution path, attempts/s, the device idle share of five more windows
   under ``torch.profiler`` and parity (e), and its mean enthalpy against
   the K1 chain run of the same system from the same starts (after
   ``STEP_DISCARD`` records; within ``STEP_TOLERANCE`` standard errors,
   the per-step one over walkers, the chain's over its sequence blocks);
   canonical per-step swaps on the spinel CE + Ewald 2x2x2 (compositions
   kept at every record); a fugacity-biased and a square-charge-biased
   flip run (the latter's mean |net charge| below the unbiased run's), the
   multi-step and composite ushers and ``kernel_type="uniformly-random"``
   on the built spinel; per-step replica exchange on bench ``tempering``'s
   cell with ``thin_by=15`` and a period of 10 (the ladder permuted at
   every record, one exchange-kernel launch every 10 steps); ``anneal``
   over three temperatures; parity (e) in every run.  Counts set to 0 just
   before these runs and read just after: no chain launched, the exchange
   kernel's launches added to its entry;
4f. what the chains refuse, on the per-step path (``drive_step_refusals``):
   bench ``spinel`` built as phase 4b builds it with the first quarter of
   each active sublattice's sites restricted (semigrand flips, 8192
   walkers: its path, the restricted sites unchanged at every record,
   parity (e)); per-step table flips (``shared_proposals=False``) on bench
   ``spinel-ewald`` built as phase 4c builds it, at 3000 K: path, net
   charge 0 at every record, parity (e), attempts/s, the device idle share
   of two more windows under ``torch.profiler``, and the mean enthalpy of
   the later records within ``STEP_TOLERANCE`` standard errors of a K5 run
   of the same system, temperature and start (run before the counts are
   set to 0); per-step Wang-Landau on bench ``wang-landau`` (2048 walkers,
   independent proposals) and with table flips on the built
   ``spinel-ewald`` over 50 bins spanning the K5 run's enthalpies, from its
   last records: the plane invariants, parity (e), net charge 0; the
   8-site log-DOS on the per-step path against the exact degeneracies
   (64 walkers: their mean within ``REFUSED_DOS_MEAN_TOLERANCE``, the
   median walker within ``WL_DOS_TOLERANCE``); the container's getters on
   these runs' containers against numpy over their records; the phase's
   wall time.  Counts set to 0 after the K5 run and read at the end: no
   kernel launched;
5. times one 100-step window at 8192 walkers, kernel against twin, for
   each cell (every repetition on a copy of the same starting state, the
   one the bound is worked out for), the kernels also without their Ewald term
   (K4's share), and works out each kernel's bound: the larger of the
   bytes it must move over the memory rate and its f64 operations over
   the f64 rate (for table moves, the operations of the valid proposals
   only: an identity proposal computes nothing; for the Wang-Landau
   planes, what the launch's data needs: entropy and histogram once, the
   cells visited, the histograms reset).  The Wang-Landau chain
   is timed on both its cells beside the flip and swap chains on the same
   tables, and at the 2048 walkers of its main path, with the direct body
   and with K1-Ising.  The distance chain
   is timed on the main path's own 8000-step launch at 2048 walkers a
   shape (the 20 8-site shapes in one launch, the 64-site shape alone); on
   the launches of phase 3 that were timed (300 steps of the 20 shapes in
   one launch, 2000 of the 64-site one) beside the twin's time of the same
   launch and the bound of the operations that launch's data needs, summed
   over its shapes; and its design part by part, each pair in turns on
   copies of one state of the 8000-step launch: the old design against
   2, 4, 8 and 16 lanes on one shape, the 20 shapes in one launch at the
   chosen lanes against 2, 4, 8 and 16, streamed against resident rows,
   20 launches against one, the rows unpacked against packed, and the old
   design against the new on both cells.  The Wang-Landau chain's design
   likewise (``wl_ab``), on both its cells with K1-Ising and with the
   direct body, on a 100-step window at 2048 walkers: the old design
   against 2, 4, 8 and 16 lanes (rows streamed, planes global), streamed
   against resident rows, the planes global against the entropy in
   shared memory (also on a 1500-step launch), and the old design against
   the new at 2048 and 8192 walkers (the old design run through the new
   kernel at one lane; against the parent commit's own kernel, see
   ``scripts/time_chain_windows.py``).
   K1's design (``flip_ab``), in turns (first design to last and back) on
   copies of one starting state at 8192 walkers, on ``sgc`` 6x6x6 with K3
   and the direct body, the q = 4 rocksalt with K3, both semigrand spinels
   and bench ``tempering``'s Au-Cu 3x3x3 with K1-Ising, and the latter with
   the direct body: 1, 2, 4, 8 and 16 lanes on a 100-step window, rows
   streamed against resident where they fit, and on Au-Cu 3x3x3 the same
   on ten 10-step segments in a CUDA graph, as the tempering path issues
   them (against the parent commit's kernel, see
   ``scripts/time_chain_windows.py``).  K2's and K5's (``lane_ab``) on
   the same swap and table cells as phase 3's (not the rocksalt): 1, 2,
   4, 8 and 16 lanes, and streamed against resident rows at the plan's
   lanes and at the fastest.
   K3 against the direct body on the same cells, in turns (direct, q-ary,
   q-ary, direct): the flip chain on ``sgc`` 6x6x6, the swap chain on the
   ternary CE 3x3x3; K3's operations are counted from the character rows
   of the ranks this launch proposes; likewise K3 with q = 4 (flips on the
   rocksalt) and with the Ewald term (swaps on the spinel CE + Ewald).
   K1-Ising against the direct body in turns on every cell of phase 3's
   Ising comparisons (its operations counted from the parity rows of the
   ranks proposed), and on every cell of the table and Wang-Landau main
   paths, the measurement ``default_delta`` follows; K3 against the
   direct body in the table chain (spinel 2x2x2) and the Wang-Landau chain
   (the ternary window); the exchange
   kernel at 8192 walkers against its plain version and its bound; one
   tempering segment (a 10-step flip launch and an exchange) on the
   device's clock and a 100-step window of 10 segments on the host's.

The line before the last is a JSON summary of the kernels, each chain once
for each site body: an entry's launches are the main paths' launches of
that (kernel, body) pair, its times that pair's on a cell where a main
path ran it, and a pair no main path launched fails the run; the flip,
swap and table kernels' entries carry their launch plan on each main
path's cell (``plan``).  The last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from smol_tpu_torch.benchmarks.systems import (
    fcc_binary_prim,
    fcc_ternary_prim,
    random_expansion,
    spinel_prim,
)
from smol_tpu_torch.capp.generate.random import generate_random_ordered_occupancy
from smol_tpu_torch.capp.generate.special.sqs import StochasticSQSGenerator, random_starts
from smol_tpu_torch.cofe import ClusterSubspace
from smol_tpu_torch.cofe.extern import EwaldTerm
from smol_tpu_torch.constants import kB
from smol_tpu_torch.crystal.pmg_compat import decode_pmg, load_pmg_json
from smol_tpu_torch.moca.ensemble import Ensemble, random_occupancies
from smol_tpu_torch.moca.kernel.tableflip import TableFlip
from smol_tpu_torch.moca.processor.distance import CorrelationDistanceProcessor
from smol_tpu_torch.moca.processor.expansion import ClusterDecompositionProcessor
from smol_tpu_torch.moca.sampler.sampler import Sampler
from smol_tpu_torch.ops import _build, chain, sqs
from smol_tpu_torch.parallel import (
    ExchangeLaunches,
    exchange_attempts,
    exchange_betas,
    make_temperature_ladder,
    tempering_exchange,
)
from smol_tpu_torch.system import build_system, load_system, load_systems

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
WL_TWIN_STEPS = 1000  # phase 3's run of the main path's launch: the twin's time sets it
WL_SEED = 13
WL_DOS_CELL = "aucu_nn_2x2x2"  # 8 sites: exact degeneracies
WL_DOS_WALKERS = 64
WL_DOS_NSTEPS = 200_000
WL_DOS_TOLERANCE = 0.5  # on every walker's log-DOS
# SQS cells: bench.py's sqs config (the 20 shapes of 8 sites; 2048 walkers
# x 4 temperatures x 8000 swap steps per shape, seed 23) and the 64-site
# diag(4, 4, 4) shape run the same way
SQS_CELLS = ("sqs_fcc8", "sqs_fcc_4x4x4")
# bench.py's sgc config (ternary Au-Ag-Cu FCC, decomposition processor,
# 8192 walkers at 800 K, seed 3) and its 3x3x3 companion, whose tables
# without chemical potentials serve the canonical (swap) K3 cell
SGC_CELL = "sgc_6x6x6"
SGC_TEMPERATURE = 800.0
TERNARY_CELL = "sgc_3x3x3"
QARY2_CELL = "aucu_4x4x4"  # binary: K3 with q = 2
SQS_WALKERS = 2048
SQS_STEPS = 8000
SQS_TEMPERATURES = np.linspace(5.0, 0.02, 4)
SQS_SEED = 23
SQS_BLOCK = 512  # the generator's sequence block
SQS_WINDOW = 300  # phase 3's launches
SQS_TWIN_STEPS = 2000  # the twin's part of the 64-site launch (its time sets it)
# bench.py's tempering config: 8192 replicas on Au-Cu FCC 3x3x3 with zero
# chemical potentials (decomposition processor), a geometric ladder over
# 300-3000 K, an exchange every 10 steps, starts default_rng(0).integers(0,
# 2, (8192, 27)); run as the other Metropolis paths are (20000 steps thinned
# by 100: 200 windows of 10 segments)
PT_CELL = "aucu_pt_3x3x3"
PT_PERIOD = 10
PT_LADDER = (300.0, 3000.0)
PT_TEMPERATURE = 1000.0  # phase 3's and 5's single-temperature windows
PT_SWEEPS = 3000  # phase 3's exchange kernel against its twin
PT_MIN_TRAVEL = 10  # rungs a walker moves on average, first record to last
# K1-Ising against its twin (phase 3) and the direct body (phase 5): every
# cell where its tables exist, (stem, move) -> (sequence block, temperature)
ISING_CELLS = {
    ("spinel_2x2x2", "flip"): (BLOCK, TEMPERATURE),
    ("spinel_3x3x3", "flip"): (BLOCK, TEMPERATURE),
    (PT_CELL, "flip"): (BLOCK, PT_TEMPERATURE),
    ("aucu_4x4x4", "swap"): (512, 300.0),
    ("spinel_ewald_2x2x2", "swap"): (BLOCK, TEMPERATURE),
    ("spinel_ewald_3x3x3", "swap"): (BLOCK, TEMPERATURE),
}
# K1-Ising and K3 in the table and Wang-Landau chains, and K3 with the
# Ewald term and for q = 4: bench spinel-ewald's table cells (both bodies on
# 2x2x2), bench wang-landau's cells, the ternary sgc window (q = 3), the
# spinel CE + Ewald (q = 2 with the Ewald term), the quaternary and binary
# rocksalt (q = 4)
TABLE_BODY_CELLS = {"spinel_ewald_sgc_2x2x2": ("ising", "qary"),
                    "spinel_ewald_sgc_3x3x3": ("ising",)}
WL_QARY_CELL = "sgc_wl_3x3x3"
EWALD_QARY_CELL = "spinel_ewald_2x2x2"
Q4_CELL = "rocksalt_q4_2x2x2"
# K1's launch designs: threads a walker and every rank's rows resident in
# shared memory or streamed (phase 3 holds each against the twin at its
# lanes, phase 5 times them in turns: flip_ab); and the cells of both,
# (stem, site body, temperature, slot padding): every body of the flip
# chain, with and without the Ewald term, the direct body with a fourth,
# empty slot (the runtime slot count) on the spinel CE + Ewald
FLIP_LANES = (1, 2, 4, 8, 16)
FLIP_BODY_CELLS = (
    ("spinel_2x2x2", "ising", TEMPERATURE, False),  # rows fit
    ("spinel_3x3x3", "ising", TEMPERATURE, False),  # three words, rows streamed
    ("spinel_ewald_2x2x2", "ising", TEMPERATURE, False),  # with the Ewald term
    (PT_CELL, "ising", PT_TEMPERATURE, False),  # bench tempering's cell
    (SGC_CELL, "direct", SGC_TEMPERATURE, False),  # K = 3
    ("spinel_ewald_2x2x2", "direct", TEMPERATURE, True),  # runtime K, Ewald
    (SGC_CELL, "qary", SGC_TEMPERATURE, False),  # K3, q = 3
    ("spinel_ewald_2x2x2", "qary", TEMPERATURE, False),  # K3, q = 2 with Ewald
    ("rocksalt_q4_2x2x2", "qary", TEMPERATURE, False),  # K3, q = 4
)
FLIP_AB_CELLS = (  # phase 5's sweep: (stem, site body, temperature)
    (SGC_CELL, "qary", SGC_TEMPERATURE), (SGC_CELL, "direct", SGC_TEMPERATURE),
    ("rocksalt_q4_2x2x2", "qary", TEMPERATURE), ("spinel_2x2x2", "ising", TEMPERATURE),
    ("spinel_3x3x3", "ising", TEMPERATURE), (PT_CELL, "ising", PT_TEMPERATURE),
    (PT_CELL, "direct", PT_TEMPERATURE),
)
# K2's and K5's launch designs (phase 3 holds each against the twin in its
# order, phase 5 times them in turns: swap_ab, table_ab): (stem, site body,
# sequence block, temperature) of every swap and table cell with each body
# of its main paths and K3; the rocksalt's three-slot moves in phase 3 only
SWAP_LANE_CELLS = (
    ("spinel_ewald_2x2x2", "ising", BLOCK, TEMPERATURE),  # rows fit
    ("spinel_ewald_2x2x2", "direct", BLOCK, TEMPERATURE),
    ("spinel_ewald_2x2x2", "qary", BLOCK, TEMPERATURE),  # K3, q = 2 with Ewald
    ("spinel_ewald_3x3x3", "ising", BLOCK, TEMPERATURE),  # three words, streamed
    ("spinel_ewald_3x3x3", "direct", BLOCK, TEMPERATURE),
    ("aucu_4x4x4", "ising", 512, 300.0),  # no Ewald term; rows fit (two waves)
    ("aucu_4x4x4", "direct", 512, 300.0),
    (TERNARY_CELL, "qary", BLOCK, SGC_TEMPERATURE),  # K3, q = 3
)
TABLE_LANE_CELLS = (
    ("spinel_ewald_sgc_2x2x2", "ising", BLOCK, TEMPERATURE),  # rows fit
    ("spinel_ewald_sgc_2x2x2", "direct", BLOCK, TEMPERATURE),
    ("spinel_ewald_sgc_2x2x2", "qary", BLOCK, TEMPERATURE),  # rows fit (two waves)
    ("spinel_ewald_sgc_3x3x3", "ising", BLOCK, TEMPERATURE),
    ("spinel_ewald_sgc_3x3x3", "direct", BLOCK, TEMPERATURE),
    (MULTI_SLOT_CELL, "direct", BLOCK, TEMPERATURE),  # the runtime slot count
)
SEEDS = (("hash", 987654321), ("philox", 0x2545F4914F6CDD1D))
# phase 4b: systems built here, as bench.py builds them, against the files
# exported from smol_tpu: stem -> (expansion, supercell edge, chemical
# potentials, temperature); both take the decomposition processor
BUILT_CELLS = {
    "spinel_cd_2x2x2": (lambda: random_expansion(spinel_prim(), {2: 5.3, 3: 3.7}, seed=11),
                        2, {"Li+": 0.1, "vacA0+": 0.0, "Mn3+": 0.05, "Mn4+": 0.0},
                        TEMPERATURE),
    "sgc_6x6x6": (lambda: random_expansion(fcc_ternary_prim(), {2: 5.5, 3: 4.0}, seed=7),
                  6, {"Au": 0.05, "Ag": 0.0, "Cu": -0.05}, SGC_TEMPERATURE),
}
BUILD_REL_TOL = 1e-12  # |built - file| <= 1e-12 * max(1, max |file|), f64 arrays
# phase 4d: the reference's host API, on phase 4b's bench spinel
HOST_API_CELL = "spinel_cd_2x2x2"
HOST_API_FLIPS = 1000  # single flips held to a full recompute
# phase 4c: bench spinel-ewald built here: stem -> (supercell edge,
# processor type, chemical potentials, move); table flips and swaps at 1000 K
BENCH_MUS = {"Li+": 0.1, "vacA0+": 0.0, "Mn3+": 0.05, "Mn4+": 0.0}
BUILT_EWALD_CELLS = {
    "spinel_ewald_cd_sgc_2x2x2": (2, "decomposition", BENCH_MUS, "table"),
    "spinel_ewald_sgc_3x3x3": (3, "expansion", BENCH_MUS, "table"),
    "spinel_ewald_2x2x2": (2, "expansion", None, "swap"),
}
FILE_RUNS = ("spinel_ewald_cd_sgc_2x2x2", "spinel_ewald_2x2x2")  # also run from the file
GOLDEN_EWALD_TOL = 1e-10  # smol's stored Ewald column is pymatgen's sum
# phase 4e: the per-step path; bench spinel-independent-random is bench
# spinel (phase 4b's built cell) with independent proposals
STEP_CELL = "spinel_cd_2x2x2"
STEP_NSTEPS = 3000
STEP_DISCARD = 20  # records before the per-step and K1 means are compared
STEP_TOLERANCE = 5.0  # standard errors allowed between the two means
STEP_SHORT = 500  # the other per-step runs
STEP_PT_THIN = 15  # replica exchange with a thin_by the period does not divide
STEP_PT_NSTEPS = 600
ANNEAL_TEMPERATURES = (2000.0, 1000.0, 500.0)
# phase 4f: what the chains refuse, on the per-step path: steps of each run
REFUSED_STEPS = {"restricted": 500, "table": 1500, "k5": 6000, "wl": 1500,
                 "wl_table": 600, "dos": 8000}
REFUSED_TABLE_CELL = "spinel_ewald_cd_sgc_2x2x2"  # bench spinel-ewald, built here
# the per-step table flips against K5 at 3000 K: at the bench's 1000 K the
# per-step walkers sit in the degenerate ground level within 100 steps while
# K5, which proposes mostly identities, takes tens of thousands to get there
REFUSED_TABLE_TEMPERATURE = 3000.0
REFUSED_TABLE_DISCARD = {"table": 5, "k5": 30}  # records before the means
REFUSED_WL_BINS = 50  # the table-flip window over the K5 run's enthalpies
# the 8-site density of states on the per-step path: the walkers' mean
# log-DOS within REFUSED_DOS_MEAN_TOLERANCE of exact, the median walker's
# within WL_DOS_TOLERANCE.  K6's check holds every walker to the latter
# after 200000 steps; at the per-step path's 3-5 ms a step a run of that
# length takes minutes, and in a short one a walker may stay off through
# the levels it found late (the worst of 16 walkers 0.58 and 0.86 off on
# the card after 20000 and 30000 steps, the median walker 0.13-0.26).  The
# walkers' mean, which a sampler that breaks detailed balance moves at
# every walker alike, read 0.033 on the card and 0.01-0.11 over 12 seeds on
# the CPU; the reference's table-flip Wang-Landau, which leaves out the
# a-priori factor, is 0.72 off on its cell
REFUSED_DOS_MEAN_TOLERANCE = 0.25
REFUSED_DOS_FLATNESS, REFUSED_DOS_CHECK = 0.7, 250
GETTER_TOL = 1e-12  # the container's getters against numpy, relative to max(1, |value|)
GETTER_SUM_TOL = 1e-9  # means and variances over every record (sums of 1e5-1e6 terms)
PARITY_TOL = 1e-9  # an accumulated enthalpy against features . theta, parity (e)
T_START = time.perf_counter()  # the script's start, for the phase 3 lines
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


@functools.lru_cache(maxsize=None)
def tables_of(ensemble, move, delta="direct"):
    """The chain tables of an ensemble (read-only: built once per call)."""
    return chain.build_chain_tables(
        ensemble.processor, ensemble.sublattices,
        mu_table=None if move == "swap" else ensemble.chemical_potential_table,
        delta=delta,
    )


def table_move_of(ensemble, tables):
    usher = TableFlip(ensemble.sublattices, **ensemble.table_data)
    return chain.build_table_move(tables, usher)


def kernel_label(line):
    """A compiled chain kernel's template arguments, read off its mangled
    name: the site body, the Wang-Landau move, the table's slot count, the
    distance chain's counts and row format, and whether it takes the Ewald
    term."""
    kernel = re.search(r"([a-z]+_chain_kernel|[a-z_]+_kernel)", line)
    if kernel is None:
        return line.strip()
    name, args = kernel.group(1), []
    wl = re.search(r"wl_chain_kernelILi(\d)E", line)
    if wl:
        args.append(f"move={('flip', 'swap')[int(wl.group(1))]}")
    body = re.search(r"6DirectILi(\d+)E|4QaryILi(\d+)ELi(\d+)E|5IsingILi(\d+)E", line)
    if body:
        k, q, nb, nw = body.groups()
        args.append(f"Direct<K={k if k != '0' else 'runtime'}>" if k is not None else
                    f"Ising<NW={nw}>" if nw is not None else
                    f"Qary<q={q}, NB={nb if nb != '0' else 'runtime'}>")
    slots = re.search(r"table_chain_kernel.*EELi(\d+)ELb", line)
    if slots:
        args.append(f"k_max={slots.group(1) if slots.group(1) != '0' else 'runtime'}")
    counts = re.search(r"distance_chain_kernelILi(\d+)ELi(\d+)ELb([01])ELb([01])E", line)
    if counts:
        k, fmax, packed, one_lane = counts.groups()
        args.append(f"K={k if k != '0' else 'runtime'}, FMAX={fmax}, "
                    f"packed={packed == '1'}, one_lane={one_lane == '1'}")
        return f"{name}<{', '.join(args)}>"
    ewald = re.search(r"Lb([01])E", line)
    if ewald:
        args.append(f"ewald={ewald.group(1) == '1'}")
    return f"{name}<{', '.join(args)}>"


def ptxas_summary(log):
    """One line per compiled kernel: its template arguments, spills, registers."""
    lines, name, spills = [], "", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = kernel_label(line)
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


def window_operands(ensemble, tables, move, block, occ_seed, seq_seed, n_steps=THIN,
                    temperature=TEMPERATURE):
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
        beta32=torch.full((WALKERS,), 1.0 / (kB * temperature),
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
    print(f"phase 3 [{label}] at {time.perf_counter() - T_START:.1f} s: kernel == twin "
          f"on {int(same.sum())}/{len(same)} "
          f"walkers ({int((~same).sum())} near-tie), max |dH| {err:.3e}, "
          f"acceptance {accept_frac:.4f}")
    return err


def body_label(tables):
    """The site body of ``tables`` as the execution path names it."""
    return f"qary{tables.qary}" if tables.qary else tables.delta


def window_vs_twin(ensemble, name, move, block, rng, seed, delta="direct",
                   temperature=TEMPERATURE):
    """Phase 3: one main-path window, kernel against twin."""
    tables = tables_of(ensemble, move, delta)
    ops = window_operands(ensemble, tables, move, block, occ_seed=7, seq_seed=17,
                          temperature=temperature)
    ops["seed"] = torch.tensor([seed], dtype=torch.int64, device=ensemble.device)
    kernel_fn, twin_fn = KERNELS[move]
    k = fresh(ops)
    t = fresh(ops)
    margin = torch.full((WALKERS,), float("inf"), device=ensemble.device)
    kernel_fn(**k, rng=rng)
    twin_fn(**t, rng=rng, margin=margin, **chain.twin_order(move, tables, WALKERS))
    torch.cuda.synchronize()
    ewald = "+ewald" if tables.has_ewald else ""
    invariant = invariant_of(move, tables, ensemble)
    return compare(f"{move}{ewald}+{body_label(tables)} {name} {rng} seed {seed:#x}", k, t,
                   margin, THIN, invariant, invariant and invariant(ops["occ"]))


def chunked_hash_vs_twin(ensemble, name, move, block, delta="direct"):
    """Phase 3: a hash-mode chain across a chunk boundary, kernel vs twin.

    The kernel runs through ``make_shared_proposal_chain`` (which splits
    the steps into chunks of ``MAX_CHUNK_STEPS``, or ``MAX_CHUNK_STEPS //
    k_max`` for table moves); the twin restates the reference's chunking: chunk c takes sequence row c, seed
    ``seed0 + c * SEED_STRIDE`` and counts its steps from 0.
    """
    device = ensemble.device
    tables = tables_of(ensemble, move, delta)
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
                rng="hash", margin=margin, **chain.twin_order(move, tables, WALKERS))
    torch.cuda.synchronize()
    kernel = {"occ": state["occupancy"][:, tables.rank_sites].T.to(torch.int8),
              "enthalpy": state["enthalpy"], "naccept": state["naccept"]}
    if move == "swap":
        kernel["nmove"] = state["nmove"]
    invariant = invariant_of(move, tables, ensemble)
    return compare(f"{move}+{body_label(tables)} {name} hash {n_steps} steps, 2 chunks",
                   kernel, twin, margin, n_steps, invariant, invariant and invariant(occ0))


def pt_betas(device):
    """[8192] f64 betas of the tempering ladder, in ladder order."""
    return torch.as_tensor(1.0 / (kB * make_temperature_ladder(*PT_LADDER, WALKERS)),
                           device=device)


def exchange_vs_twin(device="cuda"):
    """Phase 3: the exchange kernel against its twin (``tempering_exchange``
    on the same tensors) over ``PT_SWEEPS`` sweeps of alternating phase at
    8192 walkers, fresh enthalpies (0.5 eV spread, a quarter of them tied)
    and uniforms per sweep: betas bit for bit, the f32 copy its rounding."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(31)
    beta = pt_betas(device)
    beta32 = beta.to(torch.float32)
    twin = beta.clone()
    counts = torch.zeros(WALKERS, dtype=torch.int32, device=device)
    before = exchange_betas.launches
    for s in range(PT_SWEEPS):
        enthalpy = 0.5 * torch.randn(WALKERS, generator=gen, dtype=torch.float64,
                                     device=device)
        enthalpy[: WALKERS // 4] = 0.0
        u = torch.rand(WALKERS, generator=gen, dtype=torch.float64, device=device)
        exchange_betas(beta, beta32, enthalpy, u, (s + 1) % 2, counts)
        twin = tempering_exchange(twin, enthalpy, u, (s + 1) % 2)
    torch.cuda.synchronize()
    check(exchange_betas.launches - before == PT_SWEEPS, "exchange launches")
    check(torch.equal(beta, twin), "exchange kernel: betas differ from the twin's")
    check(torch.equal(beta32, twin.to(torch.float32)), "exchange kernel: beta32")
    check(torch.equal(torch.sort(beta).values, torch.sort(pt_betas(device)).values),
          "exchange kernel: the betas are no longer the ladder")
    acceptance = int(counts.sum()) / exchange_attempts(WALKERS, PT_SWEEPS)
    check(0.0 < acceptance <= 1.0, f"exchange acceptance {acceptance}")
    print(f"phase 3 [exchange {WALKERS} walkers]: kernel == twin bit for bit over "
          f"{PT_SWEEPS} sweeps (betas and their f32 copies), acceptance {acceptance:.4f}")
    return 0.0


# ---------------- K1's launch designs and the sweep schedule ----------------

def padded_slots(tables):
    """The direct body's tables with a fourth, empty slot (nbr -1, stride
    0): the same deltas through the runtime slot count instantiation."""
    return dataclasses.replace(
        tables, nbr=torch.nn.functional.pad(tables.nbr, (0, 1), value=-1).contiguous(),
        stride=torch.nn.functional.pad(tables.stride, (0, 1), value=0).contiguous())


def plan_label(tables, W=WALKERS, block=BLOCK, n_steps=THIN, design=None,
                    move="flip", k_max=2):
    """The launch K1 (or K2, K5: ``move``) takes under ``design``: lanes,
    blocks, rows."""
    plan = chain.launch_plan(move, tables, W, block, n_steps, k_max, design)
    return (f"G={plan.lanes}, {plan.blocks(W)} blocks of {plan.walkers_per_block} walkers, "
            f"rows {'resident' if plan.resident else 'streamed'}, {plan.shared_bytes} B "
            f"of shared memory a block")


def lane_designs(tables, W=WALKERS, block=BLOCK, move="flip", k_max=2):
    """K1's (or K2's, K5's) designs for a launch: every lane count, with
    the rows resident (where they fit) and streamed."""
    designs = []
    for lanes in FLIP_LANES:
        wpb = chain._block_walkers(W, block, lanes)
        fits = chain.chain_shared_bytes(move, tables, wpb, True, k_max) <= chain.MAX_SHARED_BYTES
        designs += [chain._LaneDesign(lanes=lanes, resident=r)
                    for r in (True, False) if fits or not r]
    return designs


def flip_designs_vs_twin(ensemble, name, delta, temperature, padded, rng, seed):
    """Phase 3: K1 at every lane count and both row plans against the twin
    at the same lanes, bit for bit (occupancies, accept counts, enthalpies),
    on one main-path window."""
    tables = tables_of(ensemble, "flip", delta)
    if padded:
        tables = padded_slots(tables)
    ops = window_operands(ensemble, tables, "flip", BLOCK, occ_seed=7, seq_seed=17,
                          temperature=temperature)
    ops["seed"] = torch.tensor([seed], dtype=torch.int64, device=ensemble.device)
    twins, designs = {}, lane_designs(tables)
    for design in designs:
        if design.lanes not in twins:
            twins[design.lanes] = fresh(ops)
            chain.flip_chain_reference(**twins[design.lanes], rng=rng, lanes=design.lanes)
        k = fresh(ops)
        chain.flip_chain(**k, rng=rng, _design=design)
        torch.cuda.synchronize()
        for key in ("occ", "naccept", "enthalpy"):
            check(torch.equal(k[key], twins[design.lanes][key]),
                  f"flip {name} {delta} {rng} G={design.lanes} resident={design.resident}: "
                  f"{key} differs from the twin's")
    accept = float(k["naccept"].double().mean()) / THIN
    check(0.0 < accept < 1.0, f"flip {name} {delta}: acceptance {accept}")
    ewald = "+ewald" if tables.has_ewald else ""
    slots = f", K = {tables.nbr.shape[2]} (runtime)" if padded else ""
    print(f"phase 3 [flip{ewald}+{body_label(tables)} {name}{slots} {rng} seed {seed:#x}, "
          f"every design] at {time.perf_counter() - T_START:.1f} s: kernel == twin bit for "
          f"bit on all {WALKERS} walkers at G = {sorted(twins)}, "
          f"{sum(d.resident for d in designs)} resident and "
          f"{sum(not d.resident for d in designs)} streamed launches; acceptance "
          f"{accept:.4f}; the plan: {plan_label(tables)}")
    return 0.0


def lane_designs_vs_twin(ensemble, name, move, delta, block, temperature, rng, seed):
    """Phase 3: K2 or K5 (``move``) at every lane count and both row plans,
    against the twin at the same lanes, bit for bit (occupancies, accept and move counts,
    enthalpies), on one main-path window; compositions (swaps) and net
    charges (table moves) kept."""
    tables = tables_of(ensemble, move, delta)
    ops = window_operands(ensemble, tables, move, block, occ_seed=7, seq_seed=17,
                          temperature=temperature)
    ops["seed"] = torch.tensor([seed], dtype=torch.int64, device=ensemble.device)
    kernel_fn, twin_fn = KERNELS[move]
    k_max = ops["table_move"].k_max if move == "table" else 2
    invariant = invariant_of(move, tables, ensemble)
    start = invariant(ops["occ"])
    twins, designs = {}, lane_designs(tables, block=block, move=move, k_max=k_max)
    for design in designs:
        order = chain.twin_order(move, tables, WALKERS, design)
        key = order["lanes"]
        if key not in twins:
            twins[key] = fresh(ops)
            twin_fn(**twins[key], rng=rng, **order)
        k = fresh(ops)
        kernel_fn(**k, rng=rng, _design=design)
        torch.cuda.synchronize()
        for name_ in ("occ", "naccept", "nmove", "enthalpy"):
            if name_ in k:
                check(torch.equal(k[name_], twins[key][name_]),
                      f"{move} {name} {delta} {rng} {design}: {name_} differs from the twin's")
        check(torch.equal(invariant(k["occ"]), start),
              f"{move} {name} {delta} {rng} {design}: a composition or net charge changed")
    accept = float(k["naccept"].double().mean()) / THIN
    check(0.0 < accept < 1.0, f"{move} {name} {delta}: acceptance {accept}")
    ewald = "+ewald" if tables.has_ewald else ""
    print(f"phase 3 [{move}{ewald}+{body_label(tables)} {name} {rng} seed {seed:#x}, every "
          f"design] at {time.perf_counter() - T_START:.1f} s: kernel == twin bit for bit on "
          f"all {WALKERS} walkers at G = {sorted(twins)}, "
          f"{sum(d.resident for d in designs)} resident and "
          f"{sum(not d.resident for d in designs)} streamed launches; acceptance "
          f"{accept:.4f}; the plan: "
          f"{plan_label(tables, block=block, move=move, k_max=k_max)}")
    return 0.0


def sweep_vs_twin(ensemble, name, rng, seed):
    """Phase 3: bench ``spinel-independent``'s sweep schedule
    (``proposal_mode="sweep"``: one fixed permutation of the ranks for every
    walker) through ``make_shared_proposal_chain`` on the card, against the
    twin on the same schedule, bit for bit."""
    device = ensemble.device
    tables = tables_of(ensemble, "flip", chain.default_delta(ensemble.processor,
                                                             ensemble.sublattices))
    run = chain.make_shared_proposal_chain(tables, THIN, block_size=BLOCK,
                                           proposal_mode="sweep", rng=rng,
                                           seeds=np.asarray([seed]))
    occu = torch.as_tensor(random_occupancies(ensemble, WALKERS, 13), device=device)
    beta = torch.full((WALKERS,), 1.0 / (kB * TEMPERATURE), dtype=torch.float64,
                      device=device)
    state = {"occupancy": occu.clone(),
             "enthalpy": torch.zeros(WALKERS, dtype=torch.float64, device=device),
             "beta": beta, "naccept": torch.zeros(WALKERS, dtype=torch.int32, device=device),
             "accepted": torch.ones(WALKERS, dtype=torch.bool, device=device)}
    before = chain.flip_chain.launches
    state = run(state, None)
    check(chain.flip_chain.launches - before == 1, "sweep: one launch")
    sched = torch.as_tensor(chain.sweep_schedule(tables.num_ranks, THIN), device=device)
    twin = dict(occ=occu[:, tables.rank_sites].T.to(torch.int8).contiguous(),
                enthalpy=torch.zeros(WALKERS, dtype=torch.float64, device=device),
                naccept=torch.zeros(WALKERS, dtype=torch.int32, device=device),
                beta32=beta.to(torch.float32),
                seq=sched.expand(WALKERS // BLOCK, THIN).contiguous(),
                seed=torch.tensor([seed], dtype=torch.int64, device=device))
    chain.flip_chain_reference(**twin, tables=tables, n_steps=THIN, block_size=BLOCK,
                               rng=rng, lanes=chain.flip_lanes(tables, WALKERS))
    torch.cuda.synchronize()
    occ = state["occupancy"][:, tables.rank_sites].T.to(torch.int8)
    check(torch.equal(occ, twin["occ"]), f"sweep {name} {rng}: occupancies")
    check(torch.equal(state["naccept"], twin["naccept"]), f"sweep {name} {rng}: accepts")
    check(torch.equal(state["enthalpy"], twin["enthalpy"]), f"sweep {name} {rng}: enthalpy")
    accept = float(state["naccept"].double().mean()) / THIN
    check(0.0 < accept < 1.0, f"sweep {name}: acceptance {accept}")
    print(f"phase 3 [flip+{body_label(tables)} {name} sweep schedule, {rng} seed {seed:#x}] "
          f"at {time.perf_counter() - T_START:.1f} s: make_shared_proposal_chain(proposal_mode"
          f"=\"sweep\") == twin bit for bit on all {WALKERS} walkers, acceptance "
          f"{accept:.4f}; {plan_label(tables)}")
    return 0.0


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
    """Starting occupancies of a Wang-Landau run: uniform codes for flips
    (``bench.py``'s ``integers(0, 2, ...)`` on binary sites), shuffles of
    the file's ``initial_occupancy`` for swaps."""
    if move == "swap":
        return shuffled_occupancies(ensemble, system["initial_occupancy"], count, seed)
    codes = np.ones(ensemble.num_sites, dtype=np.int64)
    for sl in ensemble.sublattices:
        codes[sl.sites] = len(sl.encoding)
    rng = np.random.default_rng(seed)
    if (codes == 2).all():
        return rng.integers(0, 2, (count, ensemble.num_sites)).astype(np.int32)
    return rng.integers(0, codes, (count, ensemble.num_sites)).astype(np.int32)


def wl_operands(ensemble, system, move, walkers, n_steps, block, occ_seed, seq_seed,
                n_chunks=None, delta="direct", **options):
    """Operands of Wang-Landau launches from fresh planes, with the site body
    ``delta``.  The window is the system file's or, for a file without one,
    five times the span of the starting enthalpies in 250 bins (``bench.py``'s
    scheme)."""
    device = ensemble.device
    tables = tables_of(ensemble, move, delta)
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
    print(f"phase 3 [{label}] at {time.perf_counter() - T_START:.1f} s: kernel == twin "
          f"on all {kernel['occ'].shape[1]} walkers "
          f"and all planes (entropy to 0.0), max |dH| {err:.3e}, acceptance "
          f"{accept_frac:.4f}, {resets} walkers with a flatness reset, least "
          f"mod_factor {float(kernel['mod_factor'].min()):g}")
    return err


def wl_plan_label(ops, design=None):
    """The launch a Wang-Landau operand set gets under ``design``: lanes,
    blocks, rows resident or streamed, the planes in shared memory."""
    W = ops["occ"].shape[1]
    plan = chain.wl_launch_plan(ops["tables"], W, ops["block_size"], ops["move"],
                                ops["wl"].num_levels, design)
    return (f"G={plan.lanes}, {plan.blocks(W)} blocks of {plan.walkers_per_block} walkers, "
            f"rows {'resident' if plan.resident else 'streamed'}, planes in shared "
            f"memory: {chain.WL_PLANES[plan.planes]}, {plan.shared_bytes} B of it a block")


def wl_window_vs_twin(ensemble, system, name, move, rng, seed, delta="direct",
                      design=None, **options):
    """Phase 3: one Wang-Landau launch, kernel (under ``design``; None: the
    default) against the twin at the kernel's lanes."""
    ops = wl_operands(ensemble, system, move, WL_WALKERS, THIN, BLOCK, occ_seed=7,
                      seq_seed=17, delta=delta,
                      **{"flatness": 0.3, "check_period": 20, **options})
    ops["seed"] = torch.tensor([seed], dtype=torch.int64, device=ensemble.device)
    k = fresh(ops)
    t = fresh(ops)
    chain.wl_chain(**k, rng=rng, _design=design)
    chain.wl_chain_reference(**t, rng=rng, lanes=chain.wl_lanes(WL_WALKERS, design))
    torch.cuda.synchronize()
    ewald = "+ewald" if ops["tables"].has_ewald else ""
    extra = "".join(f", {key}={value}" for key, value in options.items())
    return compare_wl(f"wl-{move}{ewald}+{body_label(ops['tables'])} {name} {rng} seed "
                      f"{seed:#x}, {ops['wl'].num_levels} bins{extra}; "
                      f"{wl_plan_label(ops, design)}", k, t, ops["occ"], ops["tables"], THIN)


def wl_main_launch_vs_twin(ensemble, system, name, move, delta="direct"):
    """Phase 3: the main path's launch, kernel against twin: 2048 walkers
    from the cell's starts and planes of zeros, one philox window (step
    indices far above a hash chunk's 2048), flatness 0.8, a check every
    1000 steps on planes that fill as the launch goes; the first
    ``WL_TWIN_STEPS`` of its 15000 steps.  Swaps reach no flat histogram in
    one such window; the runs above cover the reset."""
    t0 = time.perf_counter()
    ops = wl_operands(ensemble, system, move, WL_WALKERS, WL_TWIN_STEPS, BLOCK,
                      occ_seed=0, seq_seed=41, delta=delta)
    ops["seed"] = torch.tensor([SEEDS[1][1]], dtype=torch.int64, device=ensemble.device)
    k = fresh(ops)
    t = fresh(ops)
    chain.wl_chain(**k)
    chain.wl_chain_reference(**t)
    torch.cuda.synchronize()
    wl = ops["wl"]
    err = compare_wl(f"wl-{move}+{body_label(ops['tables'])} {name} philox, the main "
                     f"path's launch: "
                     f"{WL_TWIN_STEPS} of its {WL_THIN} steps, {wl.num_levels} bins, "
                     f"flatness {wl.flatness:g}, check_period {wl.check_period}; "
                     f"{wl_plan_label(ops)}", k, t,
                     ops["occ"], ops["tables"], WL_TWIN_STEPS, need_reset=False)
    print(f"phase 3: that comparison took {time.perf_counter() - t0:.1f} s")
    return err


def wl_chunked_hash_vs_twin(ensemble, system, name, move, delta="direct"):
    """Phase 3: a hash-mode Wang-Landau chain across the chunk boundary.

    The kernel runs through ``make_shared_proposal_chain`` (two launches:
    2048 steps, then 52, each counting its own steps for the flatness
    check and checking at its last step); the twin runs chunk by chunk.
    """
    device = ensemble.device
    chunk = chain.MAX_CHUNK_STEPS
    n_steps = chunk + 52
    ops = wl_operands(ensemble, system, move, WL_WALKERS, chunk, BLOCK, occ_seed=11,
                      seq_seed=29, n_chunks=2, delta=delta, flatness=0.2,
                      check_period=150)
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
    return compare_wl(f"wl-{move}+{body_label(tables)} {name} hash {n_steps} steps, "
                      f"2 chunks, {wl.num_levels} bins; {wl_plan_label(ops)}", kernel, twin,
                      ops["occ"], tables, n_steps)


# ---------------- the main paths ----------------

def drive_main_path(move, stem, card, temperature, block, capped=False, **options):
    """Phase 4: one main path, as a user calls it; cold, then warm (and, with
    ``capped``, once more with a record cap of one byte, which must move
    every batch to host memory and record what the warm run did).
    ``options`` go to ``Sampler.from_ensemble`` (the site body)."""
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
    for _ in ("cold", "warm", "capped")[:3 if capped else 2]:
        t0 = time.perf_counter()
        sampler = Sampler.from_ensemble(ensemble, temperature, WALKERS, seed=3,
                                        chain_block_size=block, step_type=step_type,
                                        **options)
        sampler.samples.pending_bytes_max = 1 if len(runs) == 2 else None
        path = sampler.execution_path(THIN)  # builds the chain tables
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sampler.run(NSTEPS, occ0, thin_by=THIN)
        torch.cuda.synchronize()
        runs.append((sampler, t1 - t0, time.perf_counter() - t1))
    ewald = "+ewald" if "ewald_matrix" in system else ""
    tables = sampler.mckernel.chain_tables()
    expect = options.get("chain_delta") or chain.default_delta(
        ensemble.processor, ensemble.sublattices)
    check(tables.delta == expect, f"{stem}: the {tables.delta} body ran, not {expect}")
    body = body_label(tables)
    check(path.startswith(f"cuda-chain[{move}]{ewald}+{body}"), f"execution path {path}")
    (cold, tables_s, cold_s), (sampler, _, wall) = runs[:2]

    samples = sampler.samples
    n = samples.num_samples
    check(n == NSTEPS // THIN, f"{n} samples recorded")
    # the same trajectories, and the same enthalpies
    occupancies = samples.get_occupancies(flat=False)  # [S, W, N]
    check(np.array_equal(cold.samples.get_occupancies(flat=False), occupancies),
          f"{stem}: the warm run did not repeat the cold run's occupancies")
    repeat = float(np.abs(cold.samples.get_enthalpies() - samples.get_enthalpies()).max())
    check(repeat <= 1e-9, f"{stem}: warm and cold enthalpies differ by {repeat}")
    capped_note = ""
    if capped:  # every batch on the host, the same records
        held = runs[2][0].samples
        on_host = all(v.device.type == "cpu" for batch in held._batches for v in batch.values())
        check(held.moved_batches == len(held._batches) > 1 and on_host,
              f"{stem}: {held.moved_batches} of {len(held._batches)} batches moved to the host")
        check(np.array_equal(held.get_occupancies(flat=False), occupancies)
              and np.array_equal(held.get_enthalpies(), samples.get_enthalpies()),
              f"{stem}: the capped run did not record what the uncapped run did")
        last = held.get_feature_vectors(discard=n - 1)
        check(np.array_equal(last, samples.get_feature_vectors(discard=n - 1)),
              f"{stem}: features derived from host batches differ")
        capped_note = (f"; with a 1-byte record cap {held.moved_batches} batches in pinned "
                       f"host memory, the same occupancies, enthalpies and features, "
                       f"{WALKERS * NSTEPS / runs[2][2] / 1e6:.1f} M attempts/s")
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
          f"{cold_s:.4f} s ({cold_s - wall:+.4f} s over warm){capped_note}")
    return ensemble, rate


BODY_KERNELS = (chain.flip_chain, chain.swap_chain, chain.table_chain, chain.wl_chain)


def reset_counts(*kernels):
    """Set the launch counts of ``kernels`` to 0 (the chains' per-body
    counts too)."""
    for kernel_fn in kernels:
        kernel_fn.launches = 0
        if kernel_fn in BODY_KERNELS:
            kernel_fn.qary_launches = kernel_fn.ising_launches = 0


def body_counts(kernel_fn):
    """A chain's launches since :func:`reset_counts`, by the site body that
    launched: {"direct": n, "qary": n, "ising": n}."""
    qary, ising = kernel_fn.qary_launches, kernel_fn.ising_launches
    return {"direct": kernel_fn.launches - qary - ising, "qary": qary, "ising": ising}


def drive(move, cells, card):
    """Phase 4 for one move: counts set to 0 just before, read just after.
    Returns the runs and the launches (for flips and swaps, by site body)."""
    kernel_fn = KERNELS[move][0]
    reset_counts(kernel_fn)
    results = {stem: drive_main_path(move, stem, card, *args)
               for stem, args in cells.items()}
    launches = kernel_fn.launches
    check(launches == len(cells) * 2 * (NSTEPS // THIN),
          f"{launches} {move} kernel launches")
    expect = {"direct": 0, "qary": 0, "ising": 0}
    for ens, _ in results.values():  # every cell runs the sampler's default body
        expect[chain.default_delta(ens.processor, ens.sublattices)] += \
            2 * (NSTEPS // THIN)
    bodies = body_counts(kernel_fn)
    check(bodies == expect, f"{move} main path launches by body {bodies}, not {expect}")
    print(f"phase 4: {move}_chain launches on the {move} main path: {launches} "
          f"(by site body {bodies})")
    return results, bodies


def drive_bodies(label, runs, card):
    """Phase 4: main paths with a site body asked for, ``runs`` a list of
    (move, stem, temperature, block, delta); counts set to 0 just before,
    read just after.  Returns the launches by kernel and body."""
    kernels = {move: KERNELS[move][0] for move, *_ in runs}
    reset_counts(*kernels.values())
    expect = {move: {"direct": 0, "qary": 0, "ising": 0} for move in kernels}
    for move, stem, temperature, block, delta in runs:
        drive_main_path(move, stem, card, temperature, block, chain_delta=delta)
        expect[move][delta] += 2 * (NSTEPS // THIN)
    bodies = {move: body_counts(fn) for move, fn in kernels.items()}
    check(bodies == expect, f"{label}: launches by body {bodies}, not {expect}")
    print(f"phase 4: {label}: launches by kernel and site body {bodies}")
    return bodies


def drive_swap_direct(card):
    """Phase 4: bench ``canonical``'s Au-Cu 4x4x4 swaps with
    ``chain_delta="direct"``, the swap chain's direct body on a main path
    (every canonical cell's default is K1-Ising); counts set to 0 just
    before, read just after."""
    reset_counts(chain.swap_chain)
    drive_main_path("swap", QARY2_CELL, card, *SWAP_CELLS[QARY2_CELL],
                    chain_delta="direct")
    bodies = body_counts(chain.swap_chain)
    check(bodies == {"direct": 2 * (NSTEPS // THIN), "qary": 0, "ising": 0},
          f"swap launches by body {bodies} with the direct body asked for")
    print(f"phase 4: swap_chain launches on {QARY2_CELL} with the direct body: "
          f"{bodies['direct']}")
    return bodies


def drive_sgc(card):
    """Phase 4 for bench ``sgc``: the default body (cold, warm and capped)
    and K3 (cold and warm); counts set to 0 just before, read just after."""
    reset_counts(chain.flip_chain)
    runs = {"default": drive_main_path("flip", SGC_CELL, card, SGC_TEMPERATURE, BLOCK,
                                       capped=True),
            "qary": drive_main_path("flip", SGC_CELL, card, SGC_TEMPERATURE, BLOCK,
                                    chain_delta="qary")}
    bodies = body_counts(chain.flip_chain)
    windows = NSTEPS // THIN
    check(bodies == {"direct": 3 * windows, "qary": 2 * windows, "ising": 0},
          f"flip launches on the sgc path by body {bodies}")
    print(f"phase 4: flip_chain launches on the sgc path: {chain.flip_chain.launches}, "
          f"{bodies['qary']} of them with the q-ary body (K3), {bodies['direct']} with "
          f"the direct body (the ternary system's default)")
    return runs, bodies


def golden_parity(name="golden_lno_ce", phase="4b"):
    """Phase 4b (a): the correlation vectors of the 27 structures of
    ``tests/data/golden_lno_ce.json``, computed by the port from each
    structure, its supercell matrix and its site mapping, against the
    numbers smol's own evaluator stored; the largest relative difference
    (to max(1, |stored|)).  Orbits that tie exactly in smol's sort key keep
    an order that depends on pymatgen's neighbour search, so the columns of
    each tied group may be permuted, one permutation for all 27 (as
    ``smol_tpu``'s own golden test allows).  With ``golden_lno_ce_ewald``
    (phase 4c) the subspace takes an Ewald term, whose column (smol's
    pymatgen sum) is held to ``GOLDEN_EWALD_TOL`` apart from the rest."""
    data = ROOT / "tests" / "data"
    golden = json.loads((data / f"{name}.json").read_text())
    built = golden["construction"]
    check(built["ewald"] == name.endswith("ewald"), f"{name}: its Ewald term")
    subspace = ClusterSubspace.from_cutoffs(
        load_pmg_json(str(data / "lno_prim.json")),
        {int(k): v for k, v in built["cutoffs"].items()}, basis=built["basis"])
    if built["ewald"]:
        subspace.add_external_term(EwaldTerm())
    mine = np.array([subspace.corr_from_structure(
        decode_pmg(e["structure"]), scmatrix=np.asarray(e["supercell_matrix"]),
        site_mapping=[int(x) for x in e["site_mapping"]]) for e in golden["entries"]])
    stored = np.array([e["correlations"] for e in golden["entries"]], dtype=np.float64)
    check(mine.shape == stored.shape, f"golden correlations of shape {mine.shape}")
    ewald_note = ""
    if built["ewald"]:
        rel = float((np.abs(mine[:, -1] - stored[:, -1])
                     / np.maximum(1.0, np.abs(stored[:, -1]))).max())
        check(rel <= GOLDEN_EWALD_TOL, f"golden Ewald column differs by {rel:.3e} relative")
        ewald_note = f", the Ewald column within {rel:.3e} relative of smol's pymatgen sum"
        mine, stored = mine[:, :-1], stored[:, :-1]
    groups = {}
    for orbit in subspace.orbits:
        key = (orbit.num_sites, round(orbit.base_cluster.diameter, 6), orbit.multiplicity,
               len(orbit.bit_combos))
        groups.setdefault(key, []).append(range(orbit.bit_id, orbit.bit_id + len(orbit)))
    perm = np.arange(mine.shape[1])
    for blocks in (g for g in groups.values() if len(g) > 1):
        cols = np.concatenate(blocks)
        best = min(itertools.permutations(blocks), key=lambda order: np.abs(
            mine[:, np.concatenate(order)] - stored[:, cols]).max())
        perm[cols] = np.concatenate(best)
    rel = float((np.abs(mine[:, perm] - stored) / np.maximum(1.0, np.abs(stored))).max())
    check(rel <= BUILD_REL_TOL, f"golden correlations differ by {rel:.3e} relative")
    moved = int((perm != np.arange(len(perm))).sum())
    print(f"phase {phase} [{name}]: {len(mine)} correlation vectors of "
          f"{mine.shape[1]} functions from their structures, largest relative difference "
          f"{rel:.3e} against smol's stored numbers ({moved} columns of tied orbits "
          f"permuted){ewald_note}")
    return rel


def compare_arrays(built, stored):
    """(bit for bit, largest |diff|, the keys not bit for bit) of a built
    system against its file, on the file's keys that a build makes; raises
    on a mismatch."""
    keys = sorted(k for k in stored if k != "initial_occupancy" and not k.startswith("wl_"))
    check(sorted(built) == keys, f"built keys {sorted(built)} against the file's {keys}")
    inexact, largest = [], 0.0
    for key in keys:
        mine, theirs = np.asarray(built[key]), np.asarray(stored[key])
        check(mine.dtype == theirs.dtype and mine.shape == theirs.shape,
              f"{key}: {mine.dtype}{mine.shape} against {theirs.dtype}{theirs.shape}")
        if theirs.dtype.kind == "f":
            diff = float(np.abs(mine - theirs).max(initial=0.0))
            scale = max(1.0, float(np.abs(theirs).max(initial=0.0)))
            check(diff <= BUILD_REL_TOL * scale, f"{key}: differs by {diff:.3e}")
            largest = max(largest, diff)
        else:
            check(np.array_equal(mine, theirs), f"{key}: integers differ")
        if not np.array_equal(mine, theirs):
            inexact.append(key)
    return not inexact, largest, inexact


def drive_built(card):
    """Phase 4b, built here: the golden correlations, then bench ``spinel``
    2x2x2 and ``sgc`` 6x6x6 built on this machine as ``bench.py`` builds
    them (``random_expansion`` -> ``Ensemble.from_cluster_expansion``,
    decomposition processor, the bench's chemical potentials), held array
    for array to the committed files, then each run as the main path runs
    (8192 walkers x 20000 steps, thin_by 100, the default body, from the
    bench's starts) beside the same run from the file: the traces equal bit
    for bit where the arrays did, parity (e) in every run.  Counts set to 0
    just before the runs, read just after."""
    golden = golden_parity()
    runs = {}
    for stem, (expansion, n, mus, temperature) in BUILT_CELLS.items():
        scm = np.diag([n, n, n])
        t0 = time.perf_counter()
        system = build_system(expansion(), scm, chemical_potentials=mus)
        build_s = time.perf_counter() - t0
        exact, largest, _ = compare_arrays(system, load_system(
            ROOT / "tests" / "data" / f"torch_{stem}.npz"))
        t0 = time.perf_counter()
        built = Ensemble.from_cluster_expansion(expansion(), scm, chemical_potentials=mus,
                                                device="cuda")
        torch.cuda.synchronize()
        entry_s = time.perf_counter() - t0
        print(f"phase 4b [{stem}] {card}: built here in {build_s:.4f} s on the host "
              f"(Ensemble.from_cluster_expansion, build and load on the card: "
              f"{entry_s:.4f} s); every array against the file "
              f"{'bit for bit' if exact else 'within 1e-12 relative'}, largest "
              f"difference {largest:.3e}")
        runs[stem] = (built, load(stem)[0], temperature, exact)
    reset_counts(chain.flip_chain)
    expect = {"direct": 0, "qary": 0, "ising": 0}
    built_traces = {}
    for stem, (built, stored, temperature, exact) in runs.items():
        traces = []
        for label, ensemble in (("built", built), ("file", stored)):
            sampler = Sampler.from_ensemble(ensemble, temperature, WALKERS, seed=3)
            path = sampler.execution_path(THIN)
            t0 = time.perf_counter()
            sampler.run(NSTEPS, random_occupancies(ensemble, WALKERS, 0), thin_by=THIN)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            samples = sampler.samples
            n = samples.num_samples
            check(n == NSTEPS // THIN and path.startswith("cuda-chain[flip]"),
                  f"{stem} ({label}): {n} samples, path {path}")
            last_f = samples.get_feature_vectors(discard=n - 1)
            last_h = samples.get_enthalpies(discard=n - 1)
            check(np.isfinite(last_h).all() and np.isfinite(last_f).all(),
                  f"{stem} ({label}): non-finite")
            parity = float(np.abs(last_f @ ensemble.natural_parameters - last_h).max())
            check(parity < 1e-9, f"{stem} ({label}): parity (e) {parity}")
            traces.append((samples.get_occupancies(flat=False), samples.get_enthalpies()))
            expect[chain.default_delta(ensemble.processor, ensemble.sublattices)] += n
            print(f"phase 4b [{stem}, {label}] {card}: path {path}, T {temperature:g} K, "
                  f"parity(e) {parity:.3e}, acceptance {float(sampler.efficiency()):.4f}, "
                  f"{WALKERS * NSTEPS / wall / 1e6:.1f} M attempts/s ({wall:.4f} s, "
                  f"cold)")
        built_traces[stem] = traces[0]
        same = all(np.array_equal(a, b) for a, b in zip(*traces))
        check(same or not exact, f"{stem}: the built system's trace differs from the file's")
        verdict = "equal the file run's bit for bit" if same else "differ from the file run's"
        print(f"phase 4b [{stem}]: the built run's occupancies and enthalpies {verdict}")
    bodies = body_counts(chain.flip_chain)
    check(bodies == expect, f"phase 4b: flip launches by body {bodies}, not {expect}")
    print(f"phase 4b: flip_chain launches on the built paths: {chain.flip_chain.launches} "
          f"(by site body {bodies})")
    return golden, bodies, built_traces


def drive_built_ewald(card):
    """Phase 4c, built here with Ewald: the golden vectors with an Ewald
    term, then bench ``spinel-ewald`` 2x2x2 as ``bench.py`` builds it, its
    3x3x3 expansion form and the canonical 2x2x2, each held array for array
    (usher keys and start included) to its committed file, then run:
    8192 walkers x 20000 steps of table flips (K5 + K4) or swaps (K2 + K4),
    from the built system and, for ``FILE_RUNS``, from the file, bit for
    bit.  Counts set to 0 just before the runs, read just after; returns
    the launches by kernel and body."""
    t0 = time.perf_counter()
    _build.load_host_ewald()  # g++, where this checkout has not built it yet
    library_s = time.perf_counter() - t0
    golden_parity("golden_lno_ce_ewald", phase="4c")
    data = ROOT / "tests" / "data"
    t0 = time.perf_counter()
    ce = random_expansion(spinel_prim(), {2: 5.3, 3: 3.7}, seed=11, ewald=True)
    print(f"phase 4c {card}: the host Ewald library loaded in {library_s:.4f} s (g++ "
          f"where not yet built), bench spinel-ewald's expansion built in "
          f"{time.perf_counter() - t0:.4f} s on the host")
    runs, exact_stems = [], {}
    for stem, (n, kind, mus, move) in BUILT_EWALD_CELLS.items():
        scm = np.diag([n, n, n])
        stored = load_system(data / f"torch_{stem}.npz")
        t0 = time.perf_counter()
        system = build_system(ce, scm, processor_type=kind, chemical_potentials=mus,
                              table_flip=move == "table")
        build_s = time.perf_counter() - t0
        exact, largest, inexact = compare_arrays(system, stored)
        ewald_diff = float(np.abs(system["ewald_matrix"] - stored["ewald_matrix"]).max())
        # the flow a user runs: the ensemble, its neutral start, the sampler
        t0 = time.perf_counter()
        ensemble = Ensemble.from_cluster_expansion(ce, scm, processor_type=kind,
                                                   chemical_potentials=mus, device="cuda")
        torch.cuda.synchronize()
        entry_s = time.perf_counter() - t0
        check(len(ensemble.processor.processors) == 2
              and type(ensemble.processor.processors[0]).__name__ == {
                  "decomposition": "ClusterDecompositionProcessor",
                  "expansion": "ClusterExpansionProcessor"}[kind],
              f"{stem}: processors {ensemble.processor.processors}")
        t0 = time.perf_counter()
        occ0 = generate_random_ordered_occupancy(ensemble.processor, charge_neutral=True,
                                                 rng=np.random.default_rng(0))
        start_s = time.perf_counter() - t0
        check(np.array_equal(occ0, stored["initial_occupancy"]),
              f"{stem}: the neutral start differs from the file's")
        print(f"phase 4c [{stem}] {card}: built here in {build_s:.4f} s on the host "
              f"(Ensemble.from_cluster_expansion, build and load on the card: "
              f"{entry_s:.4f} s; the charge-neutral start {start_s:.4f} s, equal to the "
              f"file's); every array against the file "
              f"{'bit for bit' if exact else 'within 1e-12 relative'}, largest difference "
              f"{largest:.3e}, of the {len(system['ewald_matrix'])}-row Ewald matrix "
              f"{ewald_diff:.3e}; not bit for bit: {', '.join(inexact) or 'none'}")
        # a canonical file carries no site charges: the built sublattices' serve
        charges = ensemble.site_charges
        runs.append((stem, "built", ensemble, occ0, move, build_s + entry_s, charges))
        if stem in FILE_RUNS:
            runs.append((stem, "file", load(stem)[0], occ0, move, 0.0, charges))
            exact_stems[stem] = (exact, inexact, ewald_diff)
    reset_counts(chain.table_chain, chain.swap_chain)
    expect = {move: {"direct": 0, "qary": 0, "ising": 0} for move in ("table", "swap")}
    traces = {}
    for stem, label, ensemble, occ0, move, host_s, charges in runs:
        sampler = Sampler.from_ensemble(
            ensemble, TEMPERATURE, WALKERS, seed=3,
            step_type="table-flip" if move == "table" else None)
        path = sampler.execution_path(THIN)
        check(path.startswith(f"cuda-chain[{move}]+ewald"), f"{stem} ({label}): path {path}")
        if move == "table":  # the usher's table: derived here, stored in the file
            usher = sampler.mckernel.mcusher
            stored = load_system(data / f"torch_{stem}.npz")
            check(np.array_equal(usher.flip_table, stored["flip_table"]),
                  f"{stem} ({label}): flip table {usher.flip_table.tolist()}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler.run(NSTEPS, np.tile(occ0, (WALKERS, 1)), thin_by=THIN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        samples = sampler.samples
        n = samples.num_samples
        check(n == NSTEPS // THIN, f"{stem} ({label}): {n} samples")
        last_f = samples.get_feature_vectors(discard=n - 1)
        last_h = samples.get_enthalpies(discard=n - 1)
        check(np.isfinite(last_h).all() and np.isfinite(last_f).all(),
              f"{stem} ({label}): non-finite")
        parity = float(np.abs(last_f @ ensemble.natural_parameters - last_h).max())
        check(parity < 1e-9, f"{stem} ({label}): parity (e) {parity}")
        occupancies = samples.get_occupancies(flat=False)  # [S, W, N]
        sites = np.arange(ensemble.num_sites)
        net = np.stack([charges[sites, record].sum(axis=-1) for record in occupancies])
        check(not net.any(), f"{stem} ({label}): net charges {np.unique(net)}")
        accept = float(sampler.efficiency())
        check(0.0 < accept < 1.0, f"{stem} ({label}): acceptance {accept}")
        delta = chain.default_delta(ensemble.processor, ensemble.sublattices)
        expect[move][delta] += n
        traces.setdefault(stem, []).append((occupancies, samples.get_enthalpies()))
        build = f"host build {host_s:.4f} s, " if label == "built" else ""
        print(f"phase 4c [{stem}, {label}] {card}: path {path}, T {TEMPERATURE:g} K, "
              f"{build}{WALKERS * NSTEPS / wall / 1e6:.1f} M attempts/s ({wall:.4f} s for "
              f"{WALKERS} walkers x {NSTEPS} steps, cold), acceptance {accept:.4f}, "
              f"parity(e) {parity:.3e}, net charge 0 on all {n} x {WALKERS} records")
    for stem, (exact, inexact, ewald_diff) in exact_stems.items():
        (occ_b, h_b), (occ_f, h_f) = traces[stem]
        if np.array_equal(occ_b, occ_f) and np.array_equal(h_b, h_f):
            print(f"phase 4c [{stem}]: the built run's occupancies and enthalpies equal "
                  f"the file run's bit for bit")
            continue
        # where the arrays are the file's bits, so must the runs be; where a
        # last bit differs, a decision that sits on it may go the other way
        check(not exact, f"phase 4c [{stem}]: the built run differs from the file run")
        why = (f"the built arrays [{', '.join(inexact)}] differ from the file's in their "
               f"last bits (the Ewald matrix by {ewald_diff:.3e}; scripts/ewald_host_terms.py "
               f"finds the steps where this host rounds otherwise than the file's)")
        parted = (occ_b != occ_f).any(axis=-1)  # [S, W]
        if not parted.any():
            dh = float(np.abs(h_b - h_f).max())
            print(f"phase 4c [{stem}]: the built run's occupancies equal the file run's on "
                  f"every record and walker, its enthalpies within {dh:.3e} eV of them, not "
                  f"bit for bit: {why}")
            continue
        walkers = int(parted.any(axis=0).sum())
        first = int(np.flatnonzero(parted.any(axis=1))[0])
        together = ~parted.any(axis=0)
        dh = float(np.abs(h_b - h_f).reshape(parted.shape)[:, together].max(initial=0.0))
        print(f"phase 4c [{stem}]: the built run differs from the file run: "
              f"{int((~parted).all(axis=1).sum())} of {len(parted)} records equal on every "
              f"walker, {walkers} of {WALKERS} walkers part (first at record {first}), the "
              f"others' enthalpies within {dh:.3e} eV; why: {why}, so the tables' last bits "
              f"differ and a decision within them of log U goes the other way; each run "
              f"keeps parity (e) and the net charge on its own")
    bodies = {"table": body_counts(chain.table_chain), "swap": body_counts(chain.swap_chain)}
    check(bodies == expect, f"phase 4c: launches by body {bodies}, not {expect}")
    print(f"phase 4c: launches on the built Ewald paths by kernel and site body {bodies}")
    return bodies


def flip_run(ensemble, temperature):
    """The bench spinel's main path, as phase 4b runs it: 8192 walkers x
    20000 steps thinned by 100 from ``random_occupancies(ensemble, 8192,
    0)``, seed 3; returns (occupancies [S, W, N], enthalpies [S * W], path)."""
    sampler = Sampler.from_ensemble(ensemble, temperature, WALKERS, seed=3)
    path = sampler.execution_path(THIN)
    sampler.run(NSTEPS, random_occupancies(ensemble, WALKERS, 0), thin_by=THIN)
    torch.cuda.synchronize()
    samples = sampler.samples
    return samples.get_occupancies(flat=False), samples.get_enthalpies(), path


def drive_host_api(card, built_trace):
    """Phase 4d, the reference's host API on the card.  (i) bench ``spinel``
    2x2x2 built by hand as the reference's users build it: the
    decomposition processor from ``(subspace, supercell matrix,
    interaction tensors)``, ``Ensemble(processor)``, then
    ``ensemble.chemical_potentials = ...``; its run on K1 must equal phase
    4b's built run (``built_trace``) bit for bit, directly and after a JSON
    round trip; 1000 single flips from its records, their local delta held
    to a full recompute (parity (b)), and the average drift; then ``None``
    set: swaps, one window on K2 with parity (e).  (ii) bench ``sqs`` built from the
    structure (``StochasticSQSGenerator.from_structure``), its 20 shapes
    held to ``torch_sqs_fcc8.npz`` array for array, a search of phase 3's
    launch size beside the same search from the file (equal best scores
    and occupancies), and the five best distinct SQS.  Counts set to 0
    just before the runs, read just after; returns the launches by kernel
    and body."""
    expansion, n, mus, temperature = BUILT_CELLS[HOST_API_CELL]
    ce = expansion()
    t0 = time.perf_counter()
    processor = ClusterDecompositionProcessor(ce.cluster_subspace, np.diag([n, n, n]),
                                              ce.cluster_interaction_tensors, device="cuda")
    ensemble = Ensemble(processor)
    ensemble.chemical_potentials = mus
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    doc = json.loads(json.dumps(ensemble.as_dict()))
    loaded = Ensemble.from_dict(doc, device="cuda")
    torch.cuda.synchronize()
    json_s = time.perf_counter() - t0
    check(np.array_equal(loaded.natural_parameters, ensemble.natural_parameters)
          and np.array_equal(loaded.chemical_potential_table,
                             ensemble.chemical_potential_table),
          "4d: the JSON round trip changed the natural parameters or the mu table")
    print(f"phase 4d [{HOST_API_CELL}] {card}: ClusterDecompositionProcessor(subspace, "
          f"scmatrix, interaction tensors) + Ensemble(processor) + chemical_potentials "
          f"set in {build_s:.4f} s on the host and the card; JSON round trip "
          f"({len(json.dumps(doc))} bytes) in {json_s:.4f} s")
    reset_counts(chain.flip_chain, chain.swap_chain)
    expect = {move: {"direct": 0, "qary": 0, "ising": 0} for move in ("flip", "swap")}
    ref_occ, ref_h = built_trace
    for label, ens in (("by hand", ensemble), ("from JSON", loaded)):
        occ, h, path = flip_run(ens, temperature)
        check(path.startswith("cuda-chain[flip]"), f"4d ({label}): path {path}")
        check(np.array_equal(occ, ref_occ) and np.array_equal(h, ref_h),
              f"4d ({label}): the run differs from phase 4b's built run")
        expect["flip"][chain.default_delta(ens.processor, ens.sublattices)] += len(occ)
        print(f"phase 4d [{HOST_API_CELL}, {label}] {card}: path {path}, occupancies and "
              f"enthalpies of all {len(occ)} x {WALKERS} records equal phase 4b's built "
              f"run bit for bit")
    # parity (b): the local delta of single flips from the recorded occupancies
    rng = np.random.default_rng(5)
    flat = occ.reshape(-1, ensemble.num_sites)
    active = np.concatenate([sl.active_sites for sl in ensemble.active_sublattices])
    ncodes = np.array([len(species) for species in processor.allowed_species])
    worst = 0.0
    t0 = time.perf_counter()
    for _ in range(HOST_API_FLIPS):
        occupancy = flat[rng.integers(len(flat))].astype(np.int32)
        site = int(rng.choice(active))
        code = int((occupancy[site] + rng.integers(1, ncodes[site])) % ncodes[site])
        change = ensemble.compute_feature_vector_change(occupancy, [(site, code)])
        after = occupancy.copy()
        after[site] = code
        before = ensemble.compute_feature_vector(occupancy)
        full = ensemble.compute_feature_vector(after) - before
        worst = max(worst, float(np.abs(change - full).max())
                    / max(1.0, float(np.abs(before).max())))
    flips_s = time.perf_counter() - t0
    check(worst <= 1e-12, f"4d: a flip's feature change vs the full recompute {worst:.3e}")
    t0 = time.perf_counter()
    drift = processor.compute_average_drift()
    drift_s = time.perf_counter() - t0
    print(f"phase 4d [{HOST_API_CELL}] {card}: {HOST_API_FLIPS} single flips from the "
          f"records, compute_feature_vector_change against the full recompute within "
          f"{worst:.3e} relative ({flips_s:.4f} s); compute_average_drift (forward, "
          f"reverse) {drift[0]:.3e}, {drift[1]:.3e} ({drift_s:.4f} s)")
    # the reset: canonical swaps, one window on K2 from the last records
    ensemble.chemical_potentials = None
    check(ensemble.chemical_potential_table is None
          and len(ensemble.natural_parameters) == ensemble.num_energy_coefs,
          "4d: the reset left the mu table or the -1 natural parameter")
    sampler = Sampler.from_ensemble(ensemble, temperature, WALKERS, seed=3)
    path = sampler.execution_path(THIN)
    check(path.startswith("cuda-chain[swap]"), f"4d (reset): path {path}")
    sampler.run(THIN, occ[-1], thin_by=THIN)
    torch.cuda.synchronize()
    samples = sampler.samples
    last_f, last_h = samples.get_feature_vectors(), samples.get_enthalpies()
    parity = float(np.abs(last_f @ ensemble.natural_parameters - last_h).max())
    check(np.isfinite(last_h).all() and parity < 1e-9, f"4d (reset): parity (e) {parity}")
    kept = all(np.array_equal(np.sort(a[sl.sites]), np.sort(b[sl.sites]))
               for a, b in zip(samples.get_occupancies(), occ[-1])
               for sl in ensemble.active_sublattices)
    check(kept, "4d (reset): a swap changed a walker's composition")
    expect["swap"][chain.default_delta(ensemble.processor, ensemble.sublattices)] += 1
    print(f"phase 4d [{HOST_API_CELL}, chemical_potentials = None] {card}: path {path}, "
          f"one window, parity(e) {parity:.3e}, compositions kept")
    bodies = {"flip": body_counts(chain.flip_chain), "swap": body_counts(chain.swap_chain)}
    check(bodies == expect, f"4d: launches by body {bodies}, not {expect}")

    # (ii) bench sqs from the structure
    t0 = time.perf_counter()
    generator = StochasticSQSGenerator.from_structure(
        fcc_binary_prim(), cutoffs={2: 5.0, 3: 3.5}, supercell_size=8, device="cuda")
    torch.cuda.synchronize()
    sqs_build_s = time.perf_counter() - t0
    stored = load_systems(ROOT / "tests" / "data" / "torch_sqs_fcc8.npz")
    check(len(generator.processors) == len(stored) == 20,
          f"4d: {len(generator.processors)} shapes")
    for shape, (processor, system) in enumerate(zip(generator.processors, stored)):
        check(sorted(processor.system) == sorted(system), f"4d: shape {shape}'s keys")
        for key, value in system.items():
            mine = np.asarray(processor.system[key])
            check(mine.dtype == value.dtype and mine.shape == value.shape
                  and np.array_equal(mine, value), f"4d: shape {shape}'s {key}")
    print(f"phase 4d [sqs_fcc8 from the structure] {card}: StochasticSQSGenerator."
          f"from_structure(fcc_binary_prim(), {{2: 5.0, 3: 3.5}}, 8) built in "
          f"{sqs_build_s:.4f} s on the host and the card (set-up); its 20 shapes' "
          f"supercell matrices and distance tables equal torch_sqs_fcc8.npz array for array")
    from_file = StochasticSQSGenerator.from_processors(sqs_processors("sqs_fcc8"),
                                                       device="cuda")
    sqs.distance_chain.launches = 0
    for g in (generator, from_file):
        g.generate(mcmc_steps=SQS_WINDOW, temperatures=SQS_TEMPERATURES,
                   nwalkers=SQS_WALKERS, seed=SQS_SEED)
    torch.cuda.synchronize()
    distance_launches = sqs.distance_chain.launches
    check(generator.execution_path == "cuda-distance-chain",
          f"4d: path {generator.execution_path}")
    for (s1, o1, b1, f1), (s2, o2, b2, f2) in zip(generator._best, from_file._best):
        check(s1 == s2 and np.array_equal(o1, o2) and np.array_equal(b1, b2)
              and np.array_equal(f1, f2), f"4d: shape {s1}'s search differs from the file's")
    check(distance_launches == 2 * len(SQS_TEMPERATURES),
          f"4d: {distance_launches} distance launches")
    t0 = time.perf_counter()
    best = generator.get_best_sqs(num_structures=5, remove_duplicates=True)
    best_s = time.perf_counter() - t0
    check(len(best) == 5 and all(a.score <= b.score for a, b in zip(best, best[1:])),
          f"4d: {len(best)} distinct SQS")
    formulas = [sqs_.structure.composition.formula for sqs_ in best]
    print(f"phase 4d [sqs_fcc8 from the structure] {card}: {SQS_WINDOW} steps x "
          f"{len(SQS_TEMPERATURES)} temperatures x {SQS_WALKERS} walkers a shape, best "
          f"scores and occupancies of all 20 shapes equal the file's search; "
          f"get_best_sqs(5, remove_duplicates=True) in {best_s:.4f} s: scores "
          f"{[round(b.score, 6) for b in best]}, formulas {formulas}")
    return bodies, distance_launches


def device_idle_share(run):
    """(wall s, device busy s, idle share) of ``run()`` under
    ``torch.profiler``: busy is the union of the device activity intervals
    of the trace, the idle share 1 - busy / wall; busy and the share are
    None where the trace holds no device events."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    intervals = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
    if not intervals:
        return wall, None, None
    busy, last = 0.0, -np.inf
    for start, end in intervals:
        if end > last:
            busy += end - max(start, last)
            last = end
    busy *= 1e-6  # us -> s
    return wall, busy, 1.0 - busy / wall


def step_parity(label, ensemble, sampler):
    """Parity (e) of every record of a run: recorded enthalpy against
    features . theta, and finite values."""
    f = sampler.samples.get_feature_vectors()
    h = sampler.samples.get_enthalpies()
    check(np.isfinite(h).all() and np.isfinite(f).all(), f"{label}: non-finite")
    parity = float(np.abs(f @ ensemble.natural_parameters - h).max())
    check(parity < 1e-9, f"{label}: parity (e) {parity}")
    return parity


def step_run(label, ensemble, card, nsteps, occ0, temperature=TEMPERATURE, thin=THIN,
             phase="4e", **options):
    """One run on the per-step path at 8192 walkers, seed 3: checks its
    execution path and parity (e) and prints them with its rate."""
    args = () if temperature is None else (temperature,)
    sampler = Sampler.from_ensemble(ensemble, *args, nwalkers=WALKERS, seed=3, **options)
    path = sampler.execution_path(thin)  # builds the step
    check(path.startswith("cuda-step["), f"{label}: path {path}")
    t0 = time.perf_counter()
    sampler.run(nsteps, occ0, thin_by=thin)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(sampler.samples.num_samples == nsteps // thin, f"{label}: samples")
    parity = step_parity(label, ensemble, sampler)
    print(f"phase {phase} [{label}] {card}: path {path}, {WALKERS} walkers x {nsteps} "
          f"steps, acceptance {float(sampler.efficiency()):.4f}, parity(e) {parity:.3e}, "
          f"{WALKERS * nsteps / wall / 1e6:.3f} M attempts/s ({wall:.4f} s, cold)")
    return sampler, wall


def walker_mean(enthalpies, groups):
    """(mean, standard error) of enthalpies [S, W]: the walkers' time means
    averaged, the error over ``groups`` equal groups of walkers' means."""
    means = enthalpies.mean(axis=0).reshape(groups, -1).mean(axis=1)
    return float(means.mean()), float(means.std(ddof=1) / np.sqrt(groups))


def net_charge(ensemble, occupancies):
    """|net charge| [..., W] of occupancies [..., W, N] from the site charges."""
    charges = ensemble.site_charges
    return np.abs(np.take_along_axis(
        np.broadcast_to(charges, occupancies.shape[:-1] + charges.shape),
        occupancies[..., None].astype(np.int64), axis=-1)[..., 0].sum(axis=-1))


def drive_step_path(card):
    """Phase 4e, the per-step path on the card (see the module docstring).
    Returns the exchange kernel's launches on it."""
    expansion, n, mus, temperature = BUILT_CELLS[STEP_CELL]
    built = Ensemble.from_cluster_expansion(expansion(), np.diag([n, n, n]),
                                            chemical_potentials=mus, device="cuda")
    occ0 = random_occupancies(built, WALKERS, 0)
    # the K1 chain run of the same system, before the counts are set to 0
    k1 = Sampler.from_ensemble(built, temperature, WALKERS, seed=3)
    k1_path = k1.execution_path(THIN)
    check(k1_path.startswith("cuda-chain[flip]"), f"K1 path {k1_path}")
    k1.run(STEP_NSTEPS, occ0, thin_by=THIN)
    reset_counts(chain.flip_chain, chain.swap_chain, chain.table_chain, exchange_betas)
    label = f"spinel-independent-random {STEP_CELL}"
    sampler, wall = step_run(label, built, card, STEP_NSTEPS, occ0, temperature,
                             shared_proposals=False)
    path = sampler.execution_path(THIN)
    check(path == "cuda-step[flip]+general+independent-proposals", f"{label}: path {path}")
    rate = WALKERS * STEP_NSTEPS / wall
    windows = 5
    pwall, busy, idle = device_idle_share(lambda: sampler.run(windows * THIN, thin_by=THIN))
    mine = walker_mean(sampler.samples.get_enthalpies(flat=False)[STEP_DISCARD:
                                                                 STEP_NSTEPS // THIN], 64)
    theirs = walker_mean(k1.samples.get_enthalpies(discard=STEP_DISCARD, flat=False),
                         WALKERS // BLOCK)
    se = float(np.hypot(mine[1], theirs[1]))
    check(abs(mine[0] - theirs[0]) < STEP_TOLERANCE * se,
          f"{label}: mean enthalpy {mine[0]} against K1's {theirs[0]} (se {se})")
    steps = windows * THIN
    print(f"phase 4e [{label}] {card}: {rate / 1e6:.3f} M attempts/s end to end "
          f"({wall:.4f} s for {WALKERS} walkers x {STEP_NSTEPS} steps, thinned by {THIN}, "
          f"cold); {windows} more windows under torch.profiler: wall {pwall * 1e3:.3f} ms, "
          + (f"device busy {busy * 1e3:.3f} ms, idle share {idle:.4f} of the profiled "
             f"wall; busy {busy / steps * 1e3:.4f} ms a step against "
             f"{wall / STEP_NSTEPS * 1e3:.4f} ms a step unprofiled: idle share "
             f"{1 - busy / steps / (wall / STEP_NSTEPS):.4f}" if busy is not None
             else "device idle share not measured (no device events in the trace)")
          + f"; mean enthalpy over records {STEP_DISCARD}-{STEP_NSTEPS // THIN} "
          f"{mine[0]:.6f} eV (se {mine[1]:.2e}, 64 groups of walkers) against the K1 "
          f"chain's {theirs[0]:.6f} eV (se {theirs[1]:.2e}, {WALKERS // BLOCK} sequence "
          f"blocks; path {k1_path}): difference {mine[0] - theirs[0]:+.2e} eV, "
          f"{abs(mine[0] - theirs[0]) / se:.2f} standard errors (limit {STEP_TOLERANCE:g})")
    unbiased_charge = float(net_charge(built, sampler.samples.get_occupancies(
        flat=False)[STEP_NSTEPS // THIN - 1]).mean())
    # canonical swaps on the spinel CE + Ewald: compositions kept
    ewald, system = load("spinel_ewald_2x2x2")
    start = np.tile(np.asarray(system["initial_occupancy"]), (WALKERS, 1))
    swaps, _ = step_run("swap spinel_ewald_2x2x2", ewald, card, STEP_SHORT, start,
                        shared_proposals=False)
    occ = swaps.samples.get_occupancies(flat=False)
    for sl in ewald.sublattices:
        for code in sl.encoding:
            check(bool(((occ[..., sl.sites] == code).sum(axis=-1)
                        == (start[0, sl.sites] == code).sum()).all()),
                  "per-step swaps changed a composition")
    print(f"phase 4e [swap spinel_ewald_2x2x2] {card}: every walker keeps its composition "
          f"at all {len(occ)} records; non-null proposals "
          f"{float(swaps._state['nmove'].double().mean()) / STEP_SHORT:.4f}")
    # the biases, the multi-step and composite ushers, the uniformly random kernel
    step_run("fugacity-bias", built, card, STEP_SHORT, occ0, temperature,
             bias_type="fugacity-bias")
    charged, _ = step_run("square-charge-bias", built, card, STEP_SHORT, occ0, temperature,
                          bias_type="square-charge-bias", bias_kwargs={"penalty": 0.5})
    biased_charge = float(net_charge(built, charged.samples.get_occupancies(
        flat=False)[-1]).mean())
    check(biased_charge < unbiased_charge,
          f"square-charge bias: mean |net charge| {biased_charge} not below {unbiased_charge}")
    print(f"phase 4e [square-charge-bias] {card}: mean |net charge| at the last record "
          f"{biased_charge:.4f} against {unbiased_charge:.4f} unbiased")
    step_run("multi-step", built, card, STEP_SHORT, occ0, temperature,
             step_type="multi-step", mcusher="flip", step_lengths=[1, 2, 3])
    step_run("composite", built, card, STEP_SHORT, occ0, temperature,
             step_type="composite", mcushers=["flip", "swap"], mcusher_weights=[1, 2])
    uniform, _ = step_run("uniformly-random", built, card, STEP_SHORT, occ0, None,
                          kernel_type="uniformly-random")
    check(float(uniform.efficiency()) == 1.0, "uniformly-random: a step was rejected")
    # replica exchange with a thin_by the period does not divide
    pt, _ = load(PT_CELL)
    ladder = make_temperature_ladder(*PT_LADDER, WALKERS)
    pt_occ = np.random.default_rng(0).integers(0, 2, (WALKERS, pt.num_sites)).astype(np.int32)
    tempering, _ = step_run(f"tempering {PT_CELL}, thin_by {STEP_PT_THIN}", pt, card,
                            STEP_PT_NSTEPS, pt_occ, ladder, thin=STEP_PT_THIN,
                            replica_exchange_period=PT_PERIOD)
    temps = tempering.samples.get_temperatures(flat=False)
    recorded = np.sort(1.0 / (kB * (1.0 / (kB * ladder))))
    check(bool((np.sort(temps, axis=1) == recorded).all()),
          "per-step tempering: a record's temperatures are not a permutation of the ladder")
    check(tempering._state["pt_counter"] == STEP_PT_NSTEPS, "per-step tempering: counter")
    exchanges = exchange_betas.launches
    check(exchanges == STEP_PT_NSTEPS // PT_PERIOD,
          f"per-step tempering: {exchanges} exchange launches")
    accepted = int(tempering._state["pt_accepted"].sum())
    print(f"phase 4e [tempering {PT_CELL}] {card}: the ladder permuted at all "
          f"{len(temps)} records, {exchanges} exchange-kernel launches, exchange "
          f"acceptance {accepted / exchange_attempts(WALKERS, STEP_PT_NSTEPS // PT_PERIOD):.4f}")
    # anneal over three temperatures, on the per-step path
    annealer = Sampler.from_ensemble(built, ANNEAL_TEMPERATURES[0], WALKERS, seed=3,
                                     shared_proposals=False)
    t0 = time.perf_counter()
    annealer.anneal(list(ANNEAL_TEMPERATURES), STEP_SHORT, occ0, thin_by=THIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    temps = annealer.samples.get_temperatures(flat=False)[:, 0]
    per = STEP_SHORT // THIN
    check(np.allclose(temps, np.repeat(ANNEAL_TEMPERATURES, per), rtol=1e-12, atol=0),
          f"anneal: recorded temperatures {temps}")
    parity = step_parity("anneal", built, annealer)
    means = annealer.samples.get_enthalpies(flat=False).mean(axis=1)
    print(f"phase 4e [anneal {ANNEAL_TEMPERATURES}] {card}: {len(temps)} records, mean "
          f"enthalpy at the end of each temperature "
          + ", ".join(f"{means[(k + 1) * per - 1]:.4f}" for k in range(3))
          + f" eV, parity(e) {parity:.3e} ({wall:.4f} s)")
    launched = {k.__name__: k.launches for k in (chain.flip_chain, chain.swap_chain,
                                                 chain.table_chain)}
    check(not any(launched.values()), f"the per-step path launched a chain: {launched}")
    print(f"phase 4e: no chain launched on the per-step paths; exchange kernel launches "
          f"{exchanges}")
    return exchanges


def getters_vs_numpy(label, ensemble, samples):
    """The container's getters on a run's records against numpy over the
    same occupancies and features: energies, their variance and minimum
    (value and occupancy), the mean features and their variance, the steps
    and shape, and, where the sublattices carry species, the species counts
    and compositions and one sampled structure."""
    occ = samples.get_occupancies(flat=False)  # [S, W, N]
    feats = samples.get_feature_vectors(flat=False)
    S, W, N = occ.shape
    ncoef = ensemble.num_energy_coefs
    params = np.asarray(samples.natural_parameters)
    energies = feats[..., :ncoef] @ params[:ncoef]
    flat_f = feats.reshape(S * W, -1)

    worst = {}

    def close(mine, theirs, what, tol=GETTER_TOL):
        mine, theirs = np.asarray(mine), np.asarray(theirs)
        scale = max(1.0, float(np.abs(theirs).max()))
        check(mine.shape == theirs.shape, f"{label}: {what} shape")
        worst[what] = float(np.abs(mine - theirs).max()) / scale
        check(worst[what] <= tol, f"{label}: {what} off by {worst[what]:.3e} relative")

    close(samples.get_energies(flat=False), energies, "get_energies")
    close(samples.get_minimum_energy(), energies.min(), "get_minimum_energy")
    # sums over every record: the device's order of summation, not numpy's
    close(samples.energy_variance(), energies.ravel().var(), "energy_variance",
          GETTER_SUM_TOL)
    close(samples.mean_feature_vector(), flat_f.mean(axis=0), "mean_feature_vector",
          GETTER_SUM_TOL)
    close(samples.feature_vector_variance(), flat_f.var(axis=0), "feature_vector_variance",
          GETTER_SUM_TOL)
    # the occupancy of the least energy (walkers tie on it: held by its energy)
    low = samples.get_minimum_energy_occupancy()
    check(bool((occ.reshape(S * W, N) == low).all(axis=1).any()),
          f"{label}: get_minimum_energy_occupancy is no record")
    low_e = ensemble.compute_feature_vector(low)[:ncoef] @ params[:ncoef]
    close(low_e, energies.min(), "the energy of get_minimum_energy_occupancy",
          PARITY_TOL)
    check(samples.shape == (W, N) and samples.total_mc_steps
          == S * samples.total_mc_steps_per_sample, f"{label}: shape and steps")
    checked = ["energies", "minimum", "features"]
    if all(sl.site_space is not None for sl in samples.sublattices):
        total = {}
        for sl in samples.sublattices:
            counts = (occ[..., sl.sites][..., None] == sl.encoding).sum(axis=-2)
            check(np.array_equal(samples.get_sublattice_species_counts(sl, flat=False),
                                 counts), f"{label}: species counts")
            for sp, c in zip(sl.species, np.moveaxis(counts, -1, 0)):
                total[str(sp)] = total.get(str(sp), 0) + c
        for sp, comp in samples.get_compositions(flat=False).items():
            close(comp, total[str(sp)] / N, f"composition of {sp}")
        structure = samples.get_sampled_structures([S * W - 1])[0]
        vacancies = sum(int((occ[-1, -1, sl.sites] == code).sum())
                        for sl in samples.sublattices
                        for sp, code in zip(sl.species, sl.encoding)
                        if str(sp).startswith("vac"))
        check(len(structure) == N - vacancies, f"{label}: sampled structure")
        checked += ["species counts", "compositions", "a sampled structure"]
    checked.append("largest relative differences " + ", ".join(
        f"{what} {value:.2e}" for what, value in worst.items()))
    return checked


def drive_step_refusals(card):
    """Phase 4f, what the chains refuse, on the per-step path (see the module
    docstring)."""
    t_phase = time.perf_counter()
    # the systems, and the K5 run the per-step table flips are held to,
    # before the counts are set to 0
    expansion, n, mus, temperature = BUILT_CELLS[STEP_CELL]
    spinel = Ensemble.from_cluster_expansion(expansion(), np.diag([n, n, n]),
                                             chemical_potentials=mus, device="cuda")
    n, kind, ewald_mus, _ = BUILT_EWALD_CELLS[REFUSED_TABLE_CELL]
    ewald = Ensemble.from_cluster_expansion(
        random_expansion(spinel_prim(), {2: 5.3, 3: 3.7}, seed=11, ewald=True),
        np.diag([n, n, n]), processor_type=kind, chemical_potentials=ewald_mus,
        device="cuda")
    start = np.tile(generate_random_ordered_occupancy(
        ewald.processor, charge_neutral=True, rng=np.random.default_rng(0)), (WALKERS, 1))
    k5 = Sampler.from_ensemble(ewald, REFUSED_TABLE_TEMPERATURE, WALKERS, seed=3,
                               step_type="table-flip")
    k5_path = k5.execution_path(THIN)
    check(k5_path.startswith("cuda-chain[table]+ewald"), f"K5 path {k5_path}")
    k5.run(REFUSED_STEPS["k5"], start, thin_by=THIN)
    reset_counts(chain.flip_chain, chain.swap_chain, chain.table_chain, chain.wl_chain,
                 exchange_betas)
    getters = {}

    # (a) restricted sites: the first quarter of each active sublattice's sites
    pinned = np.concatenate([sl.active_sites[: len(sl.active_sites) // 4]
                             for sl in spinel.active_sublattices])
    spinel.restrict_sites(pinned)
    occ0 = random_occupancies(spinel, WALKERS, 0)
    label = f"restricted {STEP_CELL}"
    restricted, _ = step_run(label, spinel, card, REFUSED_STEPS["restricted"], occ0,
                             temperature, phase="4f")
    path = restricted.execution_path(THIN)
    check(path == "cuda-step[flip]+general+independent-proposals", f"{label}: path {path}")
    occ = restricted.samples.get_occupancies(flat=False)
    check(bool((occ[:, :, pinned] == occ0[None][:, :, pinned]).all()),
          f"{label}: a restricted site moved")
    check(bool((occ != occ0[None]).any(axis=(0, 2)).all()),
          f"{label}: a walker never moved")
    multi = sum(len(sl.sites) for sl in spinel.sublattices if len(sl.encoding) > 1)
    print(f"phase 4f [{label}] {card}: {len(pinned)} of {multi} active sites restricted; "
          f"chain refusal: {chain.chain_refusal(spinel.processor, spinel.sublattices)}; "
          f"every restricted site keeps its start's code at all {len(occ)} records")
    getters[label] = getters_vs_numpy(label, spinel, restricted.samples)

    # (b) per-step table flips, against the K5 run of the same system and start
    label = f"table-flip {REFUSED_TABLE_CELL}, shared_proposals=False"
    nsteps = REFUSED_STEPS["table"]
    tables, wall = step_run(label, ewald, card, nsteps, start,
                            REFUSED_TABLE_TEMPERATURE, phase="4f",
                            step_type="table-flip", shared_proposals=False)
    path = tables.execution_path(THIN)
    check(path == "cuda-step[table-flip]+general+independent-proposals",
          f"{label}: path {path}")
    records = nsteps // THIN
    occ = tables.samples.get_occupancies(flat=False)
    net = net_charge(ewald, occ)
    check(bool((net == 0).all()), f"{label}: a record is not neutral")
    check(bool((net_charge(ewald, k5.samples.get_occupancies(flat=False)) == 0).all()),
          "K5 run: a record is not neutral")
    rate = WALKERS * nsteps / wall
    windows = 2
    pwall, busy, share = device_idle_share(lambda: tables.run(windows * THIN, thin_by=THIN))
    idle = ("not measured (no device events in the trace)" if busy is None else
            f"{share:.4f} of the profiled wall ({windows} windows, {pwall * 1e3:.3f} ms, "
            f"busy {busy / (windows * THIN) * 1e3:.4f} ms a step against "
            f"{wall / nsteps * 1e3:.4f} ms a step unprofiled: idle share "
            f"{1 - busy / (windows * THIN) / (wall / nsteps):.4f})")
    skip, k5_skip = REFUSED_TABLE_DISCARD["table"], REFUSED_TABLE_DISCARD["k5"]
    mine = walker_mean(tables.samples.get_enthalpies(flat=False)[skip:records], 64)
    theirs = walker_mean(k5.samples.get_enthalpies(discard=k5_skip, flat=False),
                         WALKERS // BLOCK)
    se = float(np.hypot(mine[1], theirs[1]))
    check(abs(mine[0] - theirs[0]) < STEP_TOLERANCE * se,
          f"{label}: mean enthalpy {mine[0]} against K5's {theirs[0]} (se {se})")
    print(f"phase 4f [{label}] {card}: {rate / 1e6:.3f} M attempts/s end to end "
          f"({wall:.4f} s for {WALKERS} walkers x {nsteps} steps, cold); device "
          f"idle share {idle}; net charge 0 at all {records} records; at "
          f"{REFUSED_TABLE_TEMPERATURE:g} K the mean enthalpy over records "
          f"{skip}-{records} {mine[0]:.6f} eV (se {mine[1]:.2e}, 64 groups of "
          f"walkers) against the K5 chain's over records {k5_skip}-"
          f"{REFUSED_STEPS['k5'] // THIN} of {REFUSED_STEPS['k5']} steps from the same "
          f"start "
          f"{theirs[0]:.6f} eV (se {theirs[1]:.2e}, {WALKERS // BLOCK} sequence "
          f"blocks; path {k5_path}): difference "
          f"{mine[0] - theirs[0]:+.2e} eV, {abs(mine[0] - theirs[0]) / se:.2f} standard "
          f"errors (limit {STEP_TOLERANCE:g}); acceptance {float(tables.efficiency()):.4f} "
          f"against K5's {float(k5.efficiency()):.4f}")
    getters[label] = getters_vs_numpy(label, ewald, tables.samples)

    # (c) Wang-Landau: bench wang-landau with independent proposals, table
    # flips on the built spinel-ewald over its K5 run's enthalpies
    system = load_system(ROOT / "tests" / "data" / "torch_aucu_wl_3x3x3.npz")
    aucu = Ensemble.from_system(system, "cuda")
    k5_enthalpies = k5.samples.get_enthalpies()
    lo, hi = float(k5_enthalpies.min()), float(k5_enthalpies.max())
    bin_size = (hi - lo) / (REFUSED_WL_BINS - 2)
    runs = (
        ("wang-landau aucu_wl_3x3x3, shared_proposals=False", aucu, "flip",
         wl_starts(aucu, system, "flip", WL_WALKERS, 0), wl_window_of(system),
         {"shared_proposals": False}, REFUSED_STEPS["wl"]),
        (f"wang-landau table-flip {REFUSED_TABLE_CELL}", ewald, "table-flip",
         k5.samples.get_occupancies(flat=False)[-1][:WL_WALKERS],
         {"min_enthalpy": lo - bin_size, "max_enthalpy": hi + bin_size,
          "bin_size": bin_size}, {}, REFUSED_STEPS["wl_table"]),
    )
    for label, ensemble, step_type, occ0, window, options, nsteps in runs:
        sampler = Sampler.from_ensemble(
            ensemble, kernel_type="wang-landau", step_type=step_type, nwalkers=WL_WALKERS,
            seed=WL_SEED, flatness=0.8, **window, **options)
        path = sampler.execution_path(nsteps // 3)
        check(path == f"cuda-step[{step_type}]+general+independent-proposals",
              f"{label}: path {path}")
        t0 = time.perf_counter()
        sampler.run(nsteps, occ0, thin_by=nsteps // 3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        plane_invariants(label, sampler._state, nsteps)
        parity = step_parity(label, ensemble, sampler)
        extra = ""
        if step_type == "table-flip":
            net = net_charge(ensemble, sampler.samples.get_occupancies())
            check(bool((net == 0).all()), f"{label}: a record is not neutral")
            extra = ", net charge 0 at every record"
        visited = (sampler._state["entropy"] > 0).sum(dim=1).double()
        print(f"phase 4f [{label}] {card}: path {path}, {WL_WALKERS} walkers x "
              f"{nsteps} steps, {len(sampler.mckernel._levels)} bins, acceptance "
              f"{float(sampler.efficiency()):.4f}, parity(e) {parity:.3e}, bins visited per "
              f"walker {float(visited.mean()):.1f}, {WL_WALKERS * nsteps / wall / 1e6:.3f} "
              f"M attempts/s ({wall:.4f} s, {wall / nsteps * 1e3:.4f} ms a step, cold); the "
              f"plane invariants hold{extra}")
        getters[label] = getters_vs_numpy(label, ensemble, sampler.samples)

    # (d) the 8-site density of states on the per-step path
    nsteps = REFUSED_STEPS["dos"]
    diff, degeneracies, path, wall, _ = wl_dos_errors(
        nsteps, 4, flatness=REFUSED_DOS_FLATNESS, check_period=REFUSED_DOS_CHECK,
        shared_proposals=False)
    check(path == "cuda-step[flip]+general+independent-proposals",
          f"8-site DOS: path {path}")
    errors = np.abs(diff).max(axis=1)
    mean_error = float(np.abs(diff.mean(axis=0)).max())
    median = float(np.median(errors))
    check(mean_error < REFUSED_DOS_MEAN_TOLERANCE and median < WL_DOS_TOLERANCE,
          f"per-step density of states: the walkers' mean off by {mean_error}, the "
          f"median walker by {median}")
    print(f"phase 4f [wl {WL_DOS_CELL}, {path}] {card}: {WL_DOS_WALKERS} walkers x "
          f"{nsteps} steps in {wall:.4f} s ({wall / nsteps * 1e3:.4f} ms a step), flatness "
          f"{REFUSED_DOS_FLATNESS:g} checked every {REFUSED_DOS_CHECK} steps, log-DOS "
          f"against the exact degeneracies {degeneracies}: the walkers' mean log-DOS off "
          f"by {mean_error:.4f} (limit {REFUSED_DOS_MEAN_TOLERANCE}), the median walker by "
          f"{median:.4f} (limit {WL_DOS_TOLERANCE}), the worst by "
          f"{float(errors.max()):.4f}")

    launched = {k.__name__: k.launches for k in (chain.flip_chain, chain.swap_chain,
                                                 chain.table_chain, chain.wl_chain,
                                                 exchange_betas)}
    check(not any(launched.values()), f"phase 4f launched a kernel: {launched}")
    for label, checked in getters.items():
        print(f"phase 4f [{label}]: the container's getters equal numpy on the records: "
              + ", ".join(checked))
    print(f"phase 4f {card}: no chain launched on the refused paths; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s")


def drive_tempering(card, delta):
    """Phase 4, bench ``tempering``: ``Sampler.from_ensemble(temperature=
    ladder, nwalkers=8192, replica_exchange_period=10, chain_delta=delta)``
    -> ``run(20000, thin_by=100)``, cold, then warm on a fresh sampler;
    ``delta=None`` is the sampler's default body."""
    t0 = time.perf_counter()
    ensemble, _ = load(PT_CELL)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ladder = make_temperature_ladder(*PT_LADDER, WALKERS)
    occ0 = np.random.default_rng(0).integers(
        0, 2, (WALKERS, ensemble.num_sites)).astype(np.int32)  # bench.py:503-505
    runs = []
    for _ in ("cold", "warm"):
        t0 = time.perf_counter()
        sampler = Sampler.from_ensemble(ensemble, temperature=ladder, nwalkers=WALKERS,
                                        seed=3, chain_block_size=BLOCK,
                                        replica_exchange_period=PT_PERIOD,
                                        chain_delta=delta)
        path = sampler.execution_path(THIN)  # builds the chain tables
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sampler.run(NSTEPS, occ0, thin_by=THIN)
        torch.cuda.synchronize()
        runs.append((sampler, t1 - t0, time.perf_counter() - t1))
    (cold, tables_s, cold_s), (sampler, _, wall) = runs
    tables = sampler.mckernel.chain_tables()
    delta = delta or chain.default_delta(ensemble.processor, ensemble.sublattices)
    check(tables.delta == delta, f"{PT_CELL}: the {tables.delta} body ran, not {delta}")
    expect = f"cuda-chain[flip]+{delta}+shared-proposals+replica-exchange@{PT_PERIOD}"
    check(path == expect, f"execution path {path}")
    samples = sampler.samples
    n = samples.num_samples
    check(n == NSTEPS // THIN, f"{n} samples recorded")
    occupancies = samples.get_occupancies(flat=False)
    enthalpies = samples.get_enthalpies(flat=False)
    temps = samples.get_temperatures(flat=False)  # [S, W]
    check(np.array_equal(cold.samples.get_occupancies(flat=False), occupancies)
          and np.array_equal(cold.samples.get_enthalpies(flat=False), enthalpies)
          and np.array_equal(cold.samples.get_temperatures(flat=False), temps),
          f"{PT_CELL}: the warm run did not repeat the cold run bit for bit")
    recorded = np.sort(1.0 / (kB * (1.0 / (kB * ladder))))  # T -> beta -> T
    check(bool((np.sort(temps, axis=1) == recorded).all()),
          f"{PT_CELL}: a record's temperatures are not a permutation of the ladder")
    # the replicas travel along the ladder: each walker's rung at the first
    # and at the last record (with no exchange, no walker moves)
    rungs = np.searchsorted(recorded, temps)  # [S, W]
    travel = np.abs(rungs[-1] - rungs[0])
    check(travel.mean() > PT_MIN_TRAVEL,
          f"{PT_CELL}: the walkers moved {travel.mean()} rungs on average from the "
          f"first record to the last, not more than {PT_MIN_TRAVEL}")
    last_h = samples.get_enthalpies(discard=n - 1)
    last_f = samples.get_feature_vectors(discard=n - 1)
    check(np.isfinite(last_h).all() and np.isfinite(last_f).all(), "non-finite")
    parity = float(np.abs(last_f @ ensemble.natural_parameters - last_h).max())
    check(parity < 1e-9, f"{PT_CELL}: recorded enthalpy vs features.theta {parity}")
    # the coldest and the hottest eighth of the ladder: mean enthalpy and
    # composition (code 1) over the last quarter of the records, and the
    # coldest eighth's at the first record.  From the bench's random starts
    # the cold replicas stay in metastable mixed states for the whole run
    # (PERF.md, PR 7) while the hot ones reach the Au-rich equilibrium, so
    # the cold mean enthalpy lies above the hot one; what is checked here is
    # that the cold replicas anneal.  The ladder's equilibrium ordering is
    # checked on the 8-site system against exact enumeration
    # (``tempering_vs_enumeration``).
    order = np.argsort(temps, axis=1)
    by_t = np.take_along_axis(enthalpies, order, axis=1)
    codes = np.take_along_axis(occupancies.mean(axis=2), order, axis=1)
    eighth, tail = WALKERS // 8, slice(3 * n // 4, None)
    cold_h, hot_h = by_t[tail, :eighth].mean(), by_t[tail, -eighth:].mean()
    cold_x, hot_x = codes[tail, :eighth].mean(), codes[tail, -eighth:].mean()
    first_h = by_t[0, :eighth].mean()
    check(cold_h < first_h, f"{PT_CELL}: the coldest eighth did not anneal "
          f"({first_h} -> {cold_h})")
    sweeps = sampler._state["pt_counter"]
    check(sweeps == NSTEPS // PT_PERIOD, f"{sweeps} exchange sweeps")
    attempts = exchange_attempts(WALKERS, sweeps)
    exchange = int(sampler._state["pt_accepted"].sum()) / attempts
    check(0.0 < exchange <= 1.0, f"exchange acceptance {exchange}")
    accept = float(sampler.efficiency())
    check(0.0 < accept < 1.0, f"{PT_CELL}: acceptance {accept}")
    rate = WALKERS * NSTEPS / wall
    print(f"phase 4 [tempering {PT_CELL}, {delta}] {card}: {ensemble.num_sites} sites, "
          f"path {path}, ladder {PT_LADDER[0]:g}-{PT_LADDER[1]:g} K, flip acceptance "
          f"{accept:.4f}, exchange acceptance {exchange:.4f} ({attempts} attempts), "
          f"coldest eighth of the ladder: mean enthalpy {first_h:.6f} eV at the first "
          f"record, {cold_h:.6f} eV over the last quarter (code-1 fraction {cold_x:.4f}); "
          f"hottest eighth {hot_h:.6f} eV ({hot_x:.4f}), walkers moved "
          f"{travel.mean():.1f} rungs on average (median {np.median(travel):g}, "
          f"{(travel == 0).mean():.4f} of them none) from the first record to the last, "
          f"parity(e) {parity:.3e}, the ladder permuted at all {n} records, warm == cold "
          f"bit for bit; warm run {rate / 1e6:.1f} M attempts/s end to end ({wall:.4f} s "
          f"for {WALKERS} walkers x {NSTEPS} steps, {attempts / wall / 1e6:.3f} M "
          f"exchange attempts/s); set-up: system load {load_s:.4f} s, sampler + tables "
          f"{tables_s:.4f} s, cold run {cold_s:.4f} s ({cold_s - wall:+.4f} s over warm)")
    return ensemble, rate


def tempering_vs_enumeration(card, copies=128, t_ladder=(600.0, 4000.0, 6)):
    """Phase 4: replica exchange at equilibrium on the card.  The 8-site
    Au-Cu FCC (flips at zero chemical potential, 256 states): a ladder of 6
    temperatures, each on ``copies`` walkers, an exchange every 10 steps,
    20000 steps thinned by 100.  Each temperature's mean enthalpy must lie
    within 5 standard errors (20 batch means over the last 160 records) of
    the exact Boltzmann mean, and the coldest rung's below the hottest's."""
    ensemble, system = load(WL_DOS_CELL)
    h = system["exact_enthalpies"]
    temperatures = make_temperature_ladder(*t_ladder)
    ladder = np.tile(temperatures, copies)  # every adjacent pair a valid exchange
    walkers = len(ladder)
    sampler = Sampler.from_ensemble(ensemble, temperature=ladder, nwalkers=walkers,
                                    seed=23, chain_block_size=64,
                                    replica_exchange_period=PT_PERIOD)
    occ0 = np.random.default_rng(4).integers(0, 2, (walkers, ensemble.num_sites))
    sampler.run(NSTEPS, occ0, thin_by=THIN)
    check(sampler.execution_path(THIN).endswith(f"+replica-exchange@{PT_PERIOD}"),
          "the 8-site tempering path")
    discard = NSTEPS // THIN // 5
    enth = sampler.samples.get_enthalpies(discard=discard, flat=False)
    temps = sampler.samples.get_temperatures(discard=discard, flat=False)
    means, worst = [], 0.0
    for t in temperatures:
        at = np.isclose(temps, t, rtol=1e-12, atol=0)
        check(bool((at.sum(axis=1) == copies).all()), "a rung lost a replica")
        series = np.where(at, enth, 0.0).sum(axis=1) / copies
        batch = np.array([b.mean() for b in np.array_split(series, 20)])
        sem = batch.std(ddof=1) / np.sqrt(len(batch))
        weights = np.exp(-(h - h.min()) / (kB * t))
        exact = float(h @ weights / weights.sum())
        worst = max(worst, abs(series.mean() - exact) / sem)
        means.append(series.mean())
    check(worst < 5.0, f"8-site tempering: a rung's mean enthalpy {worst:.2f} SE from exact")
    check(means[0] < means[-1], "8-site tempering: the coldest rung is not the lowest")
    print(f"phase 4 [tempering {WL_DOS_CELL}] {card}: {walkers} walkers on "
          f"{len(temperatures)} rungs of {t_ladder[0]:g}-{t_ladder[1]:g} K, every rung's "
          f"mean enthalpy within {worst:.2f} standard errors of exact enumeration; "
          f"mean enthalpy coldest rung {means[0]:.6f} eV < hottest {means[-1]:.6f} eV")


def drive_tempering_cells(card):
    """Phase 4 for bench ``tempering``, with the Ising body (K1-Ising) and
    with the direct body; counts set to 0 just before, read just after."""
    reset_counts(chain.flip_chain, exchange_betas)
    runs = {delta: drive_tempering(card, delta) for delta in (None, "direct")}
    bodies, exchanges = body_counts(chain.flip_chain), exchange_betas.launches
    segments = 2 * (NSTEPS // PT_PERIOD)  # cold and warm
    check(bodies == {"direct": segments, "qary": 0, "ising": segments}
          and exchanges == 2 * segments,
          f"tempering path: flip launches by body {bodies}, {exchanges} exchange launches")
    print(f"phase 4: on the tempering path flip_chain launches "
          f"{chain.flip_chain.launches} ({bodies['ising']} with the Ising body, "
          f"{bodies['direct']} with the direct body), exchange kernel launches {exchanges}")
    return runs, bodies, exchanges


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


def drive_wl(stem, move, card, delta=None):
    """Phase 4: one Wang-Landau cell, as a user calls it; cold, then warm;
    ``delta=None`` is the sampler's default body."""
    ensemble, system = load(stem)
    window = wl_window_of(system)
    # (a) bench.py's starts: default_rng(0).integers(0, 2, (2048, N))
    occ0 = wl_starts(ensemble, system, move, WL_WALKERS, 0)
    runs = []
    for _ in ("cold", "warm"):
        sampler = Sampler.from_ensemble(
            ensemble, kernel_type="wang-landau", step_type=move,
            nwalkers=WL_WALKERS, seed=WL_SEED, flatness=0.8, chain_delta=delta, **window)
        path = sampler.execution_path(WL_THIN)  # builds the chain tables
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler.run(WL_NSTEPS, occ0, thin_by=WL_THIN)
        torch.cuda.synchronize()
        runs.append((sampler, time.perf_counter() - t0))
    body = delta or chain.default_delta(ensemble.processor, ensemble.sublattices)
    tables = sampler.mckernel.chain_tables()
    check(tables.delta == body, f"{stem}: the {tables.delta} body ran, not {body}")
    check(path.startswith(f"cuda-chain[wl-{move}]+{body_label(tables)}+"),
          f"execution path {path}")
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


def wl_dos_errors(nsteps, records, **options):
    """A Wang-Landau run on the 8-site system on the card, held to its exact
    density of states: the window and bin of the reference's own test of
    this system (levels mid-bin), ``WL_DOS_WALKERS`` walkers from
    ``default_rng(0)``, seed 9, ``nsteps`` steps in ``records`` records,
    ``options`` to the sampler.  Checks the plane invariants and that the
    entropy is positive exactly on the system's levels.  Returns each
    walker's log-DOS less exact at each level [W, L] (both relative to the
    lowest level), the degeneracies, the execution path, the run's wall
    time and the sampler."""
    ensemble, system = load(WL_DOS_CELL)
    exact_e = system["exact_enthalpies"]
    levels = np.unique(np.round(exact_e, 9))
    bin_size = float(levels[1] - levels[0])
    lo = float(levels[0] - bin_size / 2)
    sampler = Sampler.from_ensemble(
        ensemble, kernel_type="wang-landau", step_type="flip",
        min_enthalpy=lo, max_enthalpy=float(levels[-1] + bin_size), bin_size=bin_size,
        nwalkers=WL_DOS_WALKERS, seed=9, **options)
    path = sampler.execution_path(nsteps // records)
    occ0 = np.random.default_rng(0).integers(
        0, 2, (WL_DOS_WALKERS, ensemble.num_sites)).astype(np.int32)
    t0 = time.perf_counter()
    sampler.run(nsteps, occ0, thin_by=nsteps // records)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    plane_invariants(WL_DOS_CELL, sampler._state, nsteps)
    entropy = sampler.samples.get_trace_value("entropy", flat=False)[-1]  # [W, B]
    dos = np.bincount(np.floor((exact_e - lo) / bin_size).astype(int),
                      minlength=entropy.shape[1])
    visited = dos > 0
    check(bool((entropy[:, visited] > 0).all()) and bool((entropy[:, ~visited] == 0).all()),
          f"density of states ({path}): entropy off the system's levels")
    estimate = entropy[:, visited] - entropy[:, visited][:, :1]
    exact = np.log(dos[visited]) - np.log(dos[visited][0])
    return estimate - exact, dos[visited].tolist(), path, wall, sampler


def drive_wl_dos(card, delta):
    """Phase 4 (c): the density of states of the 8-site system on the card.

    Its reference test's flatness 0.7 with a check every 250 steps halves
    the modification factor faster than the entropies can follow, and the
    error it leaves stays (about 0.25 for the median walker of 64, 0.6 for
    the worst, whatever the run's length); a check every 5000 steps at
    flatness 0.9 leaves 0.07 and 0.23.
    """
    diff, degeneracies, path, wall, sampler = wl_dos_errors(
        WL_DOS_NSTEPS, 10, flatness=0.9, check_period=5000, chain_delta=delta)
    check(f"+{delta}+" in path, f"execution path {path}")
    worst = float(np.abs(diff).max())
    check(worst < WL_DOS_TOLERANCE,
          f"density of states: log-DOS off by {worst} on some walker")
    mod = sampler._state["mod_factor"]
    print(f"phase 4 [wl {WL_DOS_CELL}, {delta} body] {card}: {WL_DOS_WALKERS} walkers x "
          f"{WL_DOS_NSTEPS} steps in {wall:.4f} s, log-DOS against the exact "
          f"degeneracies {degeneracies}: worst walker off by {worst:.4f} "
          f"(limit {WL_DOS_TOLERANCE}), mod_factor {float(mod.min()):g} to "
          f"{float(mod.max()):g}")
    return worst


def drive_wl_cells(card):
    """Phase 4 for Wang-Landau: each cell with the default body and once
    with the other (direct or K1-Ising), the 8-site density of states with
    both, and K3 on the ternary window; counts set to 0 just before, read
    just after.  Returns the default runs and the launches by body."""
    reset_counts(chain.wl_chain)
    results = {stem: drive_wl(stem, move, card) for stem, move in WL_CELLS.items()}
    windows = 2 * (WL_NSTEPS // WL_THIN)
    expect = {"direct": 0, "qary": 0, "ising": 0}
    for stem, (ens, _, _) in results.items():
        default = chain.default_delta(ens.processor, ens.sublattices)
        other = "direct" if default == "ising" else "ising"
        drive_wl(stem, WL_CELLS[stem], card, delta=other)
        expect[default] += windows
        expect[other] += windows
    for delta in ("direct", "ising"):
        drive_wl_dos(card, delta)
        expect[delta] += 10
    drive_wl(WL_QARY_CELL, "flip", card, delta="qary")
    expect["qary"] += windows
    bodies = body_counts(chain.wl_chain)
    check(bodies == expect, f"Wang-Landau launches by body {bodies}, not {expect}")
    print(f"phase 4: wl_chain launches on the Wang-Landau main paths: "
          f"{chain.wl_chain.launches} (by site body {bodies})")
    return results, bodies


# ---------------- the SQS distance chain ----------------

DISTANCE_STATE = ("occ", "best_occ", "feat", "d", "best_d", "naccept")


def sqs_processors(stem, device="cuda"):
    """The distance processors of an SQS file, one per supercell shape."""
    systems = load_systems(ROOT / "tests" / "data" / f"torch_{stem}.npz")
    return [CorrelationDistanceProcessor.from_system(system, device) for system in systems]


def sqs_compositions(occu, proc):
    """[W, S * codes] count of each code on each sublattice of occupancies
    ``occu`` [W, N] (a tensor)."""
    return torch.stack([(occu[:, sl.sites] == code).sum(dim=1)
                        for sl in proc.get_sublattices() for code in sl.encoding], dim=1)


@functools.lru_cache(maxsize=None)
def distance_tables(proc):
    return sqs.build_distance_tables(proc)


def distance_operands(proc, n_steps, beta, seed, occ_seed=7, seq_seed=17):
    """Operands of one distance launch at the main path's shape: 2048 walkers
    from the generator's starts (``random_starts``), blocks of 512."""
    tables = distance_tables(proc)
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


def compare_distance(label, proc, kernel, twin, start, n_steps, quiet=False):
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
    if quiet:
        return float((kernel["d"] - twin["d"]).abs().max())
    print(f"phase 3 [{label}]: kernel == twin bit for bit on all {len(kernel['d'])} "
          f"walkers (occupancy, best occupancy, features, score, best score, accepts), "
          f"score vs exact rescore {drift:.3e}, acceptance {accept:.4f}, best score "
          f"{float(kernel['best_d'].min()):.6f}")
    return float((kernel["d"] - twin["d"]).abs().max())


def distance_vs_twin(proc, name, rng, seed, beta=2.0, n_steps=SQS_WINDOW, timed=False,
                     match_weight=None, design=sqs._DESIGN):
    """Phase 3: one launch of ``design``, kernel against twin (with
    ``match_weight``, on the shape's system with that match weight); with
    ``timed`` the twin's time (CUDA events) and the work its data needs
    come back too."""
    extra = "" if design == sqs._DESIGN else f", {design_name(design)}"
    if match_weight is not None:
        coefs = np.concatenate([[-match_weight], proc.coefs[1:]])
        proc = CorrelationDistanceProcessor.from_system({**proc.system, "distance_coefs": coefs},
                                            proc.device)
        extra += f", match_weight {match_weight:g}"
    ops = distance_operands(proc, n_steps, beta, seed)
    k, t = fresh_distance(ops), fresh_distance(ops)
    sqs.distance_chain(**k, rng=rng, _design=design)
    work = torch.zeros((2, SQS_WALKERS), dtype=torch.int64, device=proc.device)
    start_ev = torch.cuda.Event(enable_timing=True)
    end_ev = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start_ev.record()
    sqs.distance_chain_reference(**t, rng=rng, work=work, lanes=design.lanes)
    end_ev.record()
    torch.cuda.synchronize()
    err = compare_distance(f"distance {name} {rng} seed {seed:#x}, beta {beta:g}, "
                           f"{n_steps} steps{extra}", proc, k, t, ops, n_steps)
    if not timed:
        return err
    return err, {"ops": ops, "twin_ms": start_ev.elapsed_time(end_ev), "work": work}


def fresh_distance(ops):
    return {key: (v.clone() if key in DISTANCE_STATE else v) for key, v in ops.items()}


def batched_operands(procs, n_steps, beta, seed):
    """Operands of one batched launch over the shapes ``procs`` at the main
    path's shape (2048 walkers each, blocks of 512; shape s from starts
    ``occ_seed`` 7 + s, pairs ``seq_seed`` 17 + s, seed ``seed`` + s), and
    each shape's own launch's operands."""
    shapes = [distance_operands(proc, n_steps, beta, seed + s, occ_seed=7 + s,
                                seq_seed=17 + s) for s, proc in enumerate(procs)]
    ops = {key: torch.stack([o[key] for o in shapes])
           for key in (*DISTANCE_STATE, "beta32", "useq", "vseq")}
    ops.update(seed=torch.cat([o["seed"] for o in shapes]), n_steps=n_steps,
               batch=sqs.stack_distance_tables([o["tables"] for o in shapes]),
               block_size=SQS_BLOCK)
    return ops, shapes


def batched_vs_per_shape(procs, name, rng, seed, n_steps=SQS_WINDOW, twin_shapes=()):
    """Phase 3: one batched launch over ``procs`` against each shape's own
    launch (the kernel, shape by shape), bit for bit on every walker of every
    shape, and against the batched twin on the shapes ``twin_shapes``."""
    ops, shapes = batched_operands(procs, n_steps, 2.0, seed)
    lanes = sqs.launch_lanes(len(procs) * SQS_WALKERS)  # the batch's, for each shape too
    k = fresh_distance(ops)
    sqs.distance_chain_batched(**k, rng=rng)
    err = 0.0
    for s, one in enumerate(shapes):
        mine = {key: k[key][s] for key in DISTANCE_STATE}
        theirs = fresh_distance(one)
        sqs.distance_chain(**theirs, rng=rng, _design=sqs._Design(lanes=lanes))
        label = f"distance {name} batched, shape {s} of {len(procs)}, {rng}"
        if s in twin_shapes:
            twin = fresh_distance(one)
            sqs.distance_chain_reference(**twin, rng=rng, lanes=lanes)
            err = max(err, compare_distance(f"{label} against the twin", procs[s], mine,
                                            twin, one, n_steps))
        for key in DISTANCE_STATE:
            check(torch.equal(mine[key], theirs[key]),
                  f"{label}: {key} differs from the shape's own launch")
    print(f"phase 3 [distance {name} batched, {rng}]: one launch of {len(procs)} shapes "
          f"x {SQS_WALKERS} walkers == the {len(procs)} per-shape launches at its {lanes} "
          f"lane(s) bit for bit (occupancy, best occupancy, features, score, best score, "
          f"accepts)")
    return err


def batched_vs_twin(procs, name, rng, seed, beta, n_steps):
    """Phase 3: one batched launch over ``procs`` (the main path's launch
    shape) against the batched twin, bit for bit on every walker of every
    shape, with the twin's time (CUDA events) and the work its data needs."""
    ops, _ = batched_operands(procs, n_steps, beta, seed)
    k, t = fresh_distance(ops), fresh_distance(ops)
    sqs.distance_chain_batched(**k, rng=rng)
    work = torch.zeros((len(procs), 2, SQS_WALKERS), dtype=torch.int64, device=k["d"].device)
    start_ev = torch.cuda.Event(enable_timing=True)
    end_ev = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start_ev.record()
    sqs.distance_chain_batched_reference(**t, rng=rng, work=work)
    end_ev.record()
    torch.cuda.synchronize()
    err = 0.0
    for s, proc in enumerate(procs):
        shape = {key: ops[key][s] for key in DISTANCE_STATE}
        shape["tables"] = ops["batch"].shapes[s]
        err = max(err, compare_distance(f"distance {name} {rng}, batched, shape {s}", proc,
                                        {key: k[key][s] for key in DISTANCE_STATE},
                                        {key: t[key][s] for key in DISTANCE_STATE}, shape,
                                        n_steps, quiet=True))
    accept = float(k["naccept"].double().mean()) / n_steps
    print(f"phase 3 [distance {name} {rng}, the main path's launch: {len(procs)} shapes x "
          f"{SQS_WALKERS} walkers in one launch, {n_steps} steps, beta {beta:g}]: kernel == "
          f"twin bit for bit on every walker of every shape (occupancy, best occupancy, "
          f"features, score, best score, accepts), each score == its exact rescore "
          f"(< 1e-9), acceptance {accept:.4f}")
    return err, {"ops": ops, "twin_ms": start_ev.elapsed_time(end_ev), "work": work,
                 "procs": procs}


def batched_chunked_vs_per_shape(procs, name, rng):
    """Phase 3: ``make_batched_distance_chain`` over ``procs`` across a chunk
    boundary (2048 steps, then 52, each counting its steps from 0 with the
    next chunk seed), against one ``make_distance_chain`` per shape, from
    the same generators' draws, bit for bit."""
    n_steps, walkers = chain.MAX_CHUNK_STEPS + 52, SQS_WALKERS
    tables = [distance_tables(proc) for proc in procs]

    def states():
        out = []
        for s, proc in enumerate(procs):
            occu = torch.as_tensor(random_starts(proc, walkers, np.random.default_rng(11 + s)),
                                   device=proc.device)
            scores = proc.compute_scores(occu)
            out.append({"occupancy": occu, "enthalpy": scores.clone(),
                        "beta": torch.full((walkers,), 2.0, dtype=torch.float64,
                                           device=proc.device),
                        "naccept": torch.zeros(walkers, dtype=torch.int32, device=proc.device),
                        "best_enthalpy": scores.clone(), "best_occupancy": occu.clone()})
        return out

    def generators():
        return [torch.Generator(device=proc.device).manual_seed(29 + s)
                for s, proc in enumerate(procs)]

    chunk = chain.MAX_CHUNK_STEPS
    run = sqs.make_batched_distance_chain(tables, n_steps, [p.compute_corr for p in procs],
                                          SQS_BLOCK, chunk, rng)
    before = sqs.distance_chain.launches
    batched = run(states(), generators())
    check(sqs.distance_chain.launches - before == 2, "batched chunked run: two launches")
    design = sqs._Design(lanes=sqs.launch_lanes(len(procs) * walkers))  # the batch's
    for s, (proc, state, gen) in enumerate(zip(procs, states(), generators())):
        own = sqs.make_distance_chain(tables[s], n_steps, proc.compute_corr, SQS_BLOCK,
                                      chunk, rng, _design=design)(state, gen)
        for key in ("occupancy", "best_occupancy", "enthalpy", "best_enthalpy", "naccept"):
            check(torch.equal(batched[s][key], own[key]),
                  f"batched chunked {rng} run, shape {s}: {key} differs from its own chain")
    exact = max(float((p.compute_scores(st["occupancy"]) - st["enthalpy"]).abs().max())
                for p, st in zip(procs, batched))
    check(exact < 1e-9, f"batched chunked run: score vs exact rescore {exact}")
    print(f"phase 3 [distance {name} batched, {rng}, {n_steps} steps in 2 chunks]: "
          f"== one chain per shape bit for bit on all {len(procs)} shapes, score vs "
          f"exact rescore {exact:.3e}")
    return 0.0


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
        cpu = CorrelationDistanceProcessor.from_system(procs[shape].system, "cpu")
        exact = cpu.compute_scores(torch.as_tensor(occupancies)).numpy()
        rescore = max(rescore, float(np.abs(exact - scores).max()))
        check(bool((scores <= start.cpu().numpy() + 1e-12).all()),
              f"{stem}: a walker's best is worse than its start")
        found = min(found, float(scores.min()))
    check(rescore < 1e-9, f"{stem}: stored score vs exact CPU rescore {rescore}")
    check(found < 0, f"{stem}: best score {found} is not a matched shell")
    best_sqs = generator.get_best_sqs(1, remove_duplicates=False)[0]
    attempts = len(procs) * len(SQS_TEMPERATURES) * SQS_STEPS * SQS_WALKERS
    rate = attempts / wall
    batches = len(generator._chain_fns(SQS_STEPS))  # launches per temperature
    print(f"phase 4 [sqs {stem}] {card}: {len(procs)} shapes x {len(SQS_TEMPERATURES)} "
          f"temperatures x {SQS_STEPS} steps x {SQS_WALKERS} walkers in {batches} "
          f"launch(es) a temperature, path {path}, "
          f"warm run {rate / 1e6:.1f} M attempts/s end to end ({wall:.4f} s for "
          f"{attempts} attempts), best score {best_sqs.score:.6f} (shape "
          f"{best_sqs.supercell_matrix.tolist()}), acceptance per stage "
          f"{np.round(accepts[:len(SQS_TEMPERATURES)], 4).tolist()} (first shape), "
          f"final score vs exact rescore {drift:.3e}, stored vs CPU rescore "
          f"{rescore:.3e}, warm == cold bit for bit; set-up: load {load_s:.4f} s, "
          f"cold run {cold_s:.4f} s ({cold_s - wall:+.4f} s over warm)")
    return procs, rate, batches


def drive_sqs_cells(card):
    """Phase 4 for SQS: counts set to 0 just before, read just after; one
    launch per temperature for all the shapes of a cell, cold and warm."""
    sqs.distance_chain.launches = 0
    results = {stem: drive_sqs(stem, card) for stem in SQS_CELLS}
    launches = sqs.distance_chain.launches
    expected = sum(2 * batches * len(SQS_TEMPERATURES) for _, _, batches in results.values())
    check(expected == 2 * len(SQS_CELLS) * len(SQS_TEMPERATURES),
          f"the shapes of a cell took {expected} launches, not one a temperature")
    check(launches == expected, f"{launches} distance kernel launches, not {expected}")
    print(f"phase 4: distance_chain launches on the SQS main path: {launches}")
    return results, launches


# ---------------- timing and bounds ----------------

def body_tables(tables):
    """The table tensors a launch reads for its site body."""
    if tables.ising:  # K1-Ising's parity rows
        return [tables.imask, tables.iamp, tables.irows]
    if tables.qary:  # K3's character rows
        return [tables.qnbr, tables.qfreq, tables.qms, tables.qac, tables.qas,
                tables.qrows]
    return [tables.nbr, tables.stride, tables.d2, tables.g]


def body_ops(tables, rows, sites):
    """The site body's f64 operations for ``sites`` recolorings that read
    ``rows`` rows (:func:`smol_tpu_torch.ops.chain.body_rows`): the direct
    lookup's two a local cluster; K1-Ising's one add a parity row (the sign
    is a select, the mask test integer work) and the scale's multiply-add a
    site; K3's products and sum a character row (two for q = 2, four
    above) with its add into the delta."""
    if tables.ising:
        return rows + sites
    if tables.qary:
        return rows * (2 if tables.qary == 2 else 4)
    return 2 * rows


def proposed_rows(tables, ops, seqs):
    """The body rows of the ranks the sequences ``seqs`` propose, summed
    over every walker and step of the launch."""
    steps, W = ops["n_steps"], ops["occ"].shape[1]
    walkers = torch.bincount(torch.arange(W, device=seqs[0].device) // ops["block_size"])
    rows = chain.body_rows(tables)
    return sum(int((rows[s[:, :steps].long()].sum(dim=1) * walkers).sum()) for s in seqs)


def bound(tables, ops, move, recolorings=0, accepted=0, rows=0):
    """The least time of one launch: (ms, "bytes" or "operations", bytes,
    f64 operations, ms of the Ewald term's operations alone).

    Bytes: every operand read once and every output written once (the
    occupancy [R, W] int8 in and out, the per-walker state, the sequences
    and the site body's tables).  Operations: the site body's on the rows
    of the ranks proposed (:func:`body_ops`), R + 2 per Ewald term, the
    chemical work's two for a flip, the enthalpy's one a step.  A table
    move's work depends on the data: ``recolorings`` counts the site
    recolorings these inputs need (the valid slots of the valid proposals,
    from a twin run of the same launch) and ``rows`` their body rows; each
    recoloring costs a flip's operations, an identity proposal none, and
    ``accepted`` moves an enthalpy add each.
    """
    R, W = ops["occ"].shape
    steps = ops["n_steps"]
    seqs = [ops[name] for name in SEQUENCES[move]]
    table_tensors = body_tables(tables)
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
        n_ops = body_ops(tables, rows, recolorings) + 2 * recolorings + ewald + accepted
    else:
        sites = W * steps * len(seqs)
        ewald = sites * ewald_site
        n_ops = (body_ops(tables, proposed_rows(tables, ops, seqs), sites) + ewald
                 + W * steps * (1 + (2 if move == "flip" else 0)))
    ops_s = n_ops / PEAK_F64_PER_S
    bytes_s = nbytes / PEAK_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes",
            nbytes, n_ops, ewald / PEAK_F64_PER_S * 1e3)


def time_window(ensemble, name, card, move, block, kernel_reps=50, twin_reps=3,
                delta="direct", temperature=TEMPERATURE):
    """Phase 5: one 100-step window at 8192 walkers, kernel against twin
    (``twin_reps=0``: the kernel alone)."""
    tables = tables_of(ensemble, move, delta)
    ops = window_operands(ensemble, tables, move, block, occ_seed=5, seq_seed=1,
                          temperature=temperature)
    ops["seed"] = torch.tensor([42], dtype=torch.int64, device=ensemble.device)
    kernel_fn, twin_fn = KERNELS[move]
    counts = {}
    if move == "table":  # what this launch's data needs, from the twin
        run = fresh(ops)
        nslot = torch.zeros(WALKERS, dtype=torch.int32, device=ensemble.device)
        nrow = torch.zeros(WALKERS, dtype=torch.int64, device=ensemble.device)
        twin_fn(**run, nslot=nslot, nrow=nrow)
        counts = {"recolorings": int(nslot.sum()), "accepted": int(run["naccept"].sum()),
                  "rows": int(nrow.sum())}
    kernel_ms = cuda_ms(same_window(kernel_fn, ops, kernel_reps), kernel_reps)
    twin_ms = cuda_ms(same_window(twin_fn, ops, twin_reps), twin_reps) if twin_reps else None
    bound_ms, bound_by, nbytes, n_ops, ewald_ms = bound(tables, ops, move, **counts)
    rate = WALKERS * THIN / (kernel_ms * 1e-3)
    twin = (f", twin {twin_ms:.2f} ms, twin/kernel {twin_ms / kernel_ms:.1f}x"
            if twin_reps else "")
    line = (f"phase 5 [{move}+{body_label(tables)} {name}] {card}: 100-step window at "
            f"{WALKERS} walkers: kernel {kernel_ms:.4f} ms ({rate / 1e6:.1f} M "
            f"attempts/s){twin}, bound {bound_ms * 1e3:.3f} us ({bound_by}; "
            f"{nbytes / 1e6:.3f} MB, {n_ops / 1e6:.1f} M f64 operations), kernel/bound "
            f"{kernel_ms / bound_ms:.0f}x")
    if counts:
        line += (f"; {counts['recolorings']} recolorings in valid proposals "
                 f"({counts['rows']} body rows) and {counts['accepted']} accepted moves "
                 f"of {WALKERS * THIN} proposals")
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


def graph_ms(capture, reps=50):
    """Device ms of one replay of a CUDA graph of ``capture()``, over
    ``reps`` replays between CUDA events.  For launches shorter than the
    host's work to issue them (a 10-step segment, an exchange), events
    around eager calls time the host; a replay issues them all at once."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        capture()  # warm-up, off the capturing stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        capture()
    return cuda_ms(graph.replay, reps)


def time_exchange(card, sweeps=10):
    """Phase 5: the exchange kernel at 8192 walkers against its plain
    version (``tempering_exchange`` and the copies into beta and beta32, as
    the wrapper's CPU path), each ``sweeps`` sweeps of alternating phase in
    one CUDA graph; and its bound, from this launch's data: each paired
    walker reads its beta and enthalpy (16 bytes), each pair its left
    member's uniform (8), and each accepted pair writes both betas and
    their f32 copies and reads and writes its count (32), the accepted
    pairs counted over one more pass of the same sweeps after the timing."""
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(7)
    beta = pt_betas(device)
    beta32 = beta.to(torch.float32)
    enthalpy = torch.randn(WALKERS, generator=gen, dtype=torch.float64, device=device)
    u = torch.rand((sweeps, WALKERS), generator=gen, dtype=torch.float64, device=device)
    counts = torch.zeros(WALKERS, dtype=torch.int32, device=device)

    def kernel():
        exchanges = ExchangeLaunches(beta, beta32, enthalpy, u, counts)
        for s in range(sweeps):
            exchanges(s, (s + 1) % 2)

    def plain():
        for s in range(sweeps):
            new = tempering_exchange(beta, enthalpy, u[s], (s + 1) % 2)
            beta.copy_(new)
            beta32.copy_(new.to(torch.float32))

    kernel_ms = graph_ms(kernel) / sweeps
    plain_ms = graph_ms(plain) / sweeps
    counts.zero_()
    kernel()
    accepted = int(counts.sum()) / sweeps  # accepted pairs per sweep
    pairs = exchange_attempts(WALKERS, sweeps) / sweeps  # pairs per sweep
    nbytes = pairs * (2 * 16 + 8) + accepted * 32
    n_ops = pairs * 3  # two differences and their product per pair
    bytes_s, ops_s = nbytes / PEAK_BYTES_PER_S, n_ops / PEAK_F64_PER_S
    bound_ms = max(bytes_s, ops_s) * 1e3
    bound_by = "bytes" if bytes_s >= ops_s else "operations"
    print(f"phase 5 [exchange {WALKERS} walkers] {card}: kernel {kernel_ms * 1e3:.2f} us, "
          f"plain torch {plain_ms * 1e3:.2f} us ({plain_ms / kernel_ms:.1f}x; device "
          f"time per sweep, graphs of {sweeps} sweeps), bound {bound_ms * 1e3:.4f} us "
          f"({bound_by}; {nbytes / 1e3:.1f} kB a sweep at {accepted / pairs:.4f} of "
          f"{pairs:g} pairs accepted), kernel/bound {kernel_ms / bound_ms:.0f}x")
    return {"kernel_ms": kernel_ms, "twin_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def time_segment(card, ensemble, delta, windows=20):
    """Phase 5: tempering segments at 8192 walkers on the device's clock (a
    CUDA graph of a window's 10 segments, each a 10-step flip launch and an
    exchange, as the port issues them; and of the 10 flip launches alone),
    and a whole 100-step window through the tempering chain on the host's
    clock (draws, launches, the occupancy's gather and scatter)."""
    from smol_tpu_torch.parallel import make_tempering_chain

    segments = THIN // PT_PERIOD
    tables = tables_of(ensemble, "flip", delta)
    ops = window_operands(ensemble, tables, "flip", BLOCK, occ_seed=5, seq_seed=1,
                          n_steps=PT_PERIOD)
    device = ensemble.device
    gen = torch.Generator(device=device).manual_seed(11)
    seqs = chain.rank_sequence(tables, gen, (segments, WALKERS // BLOCK, PT_PERIOD))
    seeds = torch.randint(0, 2**62, (segments,), generator=gen, device=device)
    u = torch.rand((segments, WALKERS), generator=gen, dtype=torch.float64, device=device)
    beta = pt_betas(device)
    beta32 = beta.to(torch.float32)

    def window(exchange):
        launches = chain.ChainLaunches("flip", ops["occ"], ops["enthalpy"],
                                       (ops["naccept"],), beta32, (seqs,), seeds, tables,
                                       BLOCK, "philox")
        exchanges = ExchangeLaunches(beta, beta32, ops["enthalpy"], u, None)
        for s in range(segments):
            launches.launch(s, PT_PERIOD)
            if exchange:
                exchanges(s, (s + 1) % 2)

    segment_ms = graph_ms(lambda: window(True)) / segments
    launch_ms = graph_ms(lambda: window(False)) / segments
    occu = torch.as_tensor(random_occupancies(ensemble, WALKERS, 5), device=device)
    theta = torch.as_tensor(ensemble.natural_parameters, device=device)
    state = {"occupancy": occu,
             "enthalpy": (ensemble.compute_features(occu) @ theta).contiguous(),
             "beta": pt_betas(device),
             "naccept": torch.zeros(WALKERS, dtype=torch.int32, device=device),
             "accepted": torch.ones(WALKERS, dtype=torch.bool, device=device),
             "pt_counter": 0}
    run = make_tempering_chain(chain.make_shared_proposal_chain(
        tables, PT_PERIOD, block_size=BLOCK), segments)
    run(state, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(windows):
        run(state, gen)
    torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) / windows * 1e3
    print(f"phase 5 [tempering segment {PT_CELL}, {delta}] {card}: on the device "
          f"{launch_ms * 1e3:.2f} us per {PT_PERIOD}-step flip launch, "
          f"{segment_ms * 1e3:.2f} us per segment (launch and exchange; graphs of a "
          f"window's {segments}); a 100-step window on the host's clock "
          f"{window_ms:.4f} ms against {segments * segment_ms:.4f} ms of its segments' "
          f"kernels")
    return {"launch_ms": launch_ms, "segment_ms": segment_ms, "window_ms": window_ms}


def wl_bound(ops, after):
    """The least time of one Wang-Landau launch: (ms, by, bytes, operations).

    Bytes: every byte that this launch's data needs read once and written
    once: the codes, enthalpy, accept count, ``mod_factor`` and
    ``wl_counter`` in and out, the proposal sequences and the tables, and
    of the three [B, W] planes what ``after``, the state one such launch
    leaves, shows was needed: entropy and histogram over all bins once
    (12 B a cell; the flatness test reads them all), the occurrences of
    the cells a walker visited (the launch starts from planes of zeros, so
    those with an occurrence) read and all three planes' such cells written
    (4 B and 16 B), and the histogram's zeroing (4 B a bin) for every reset
    (``mod_factor`` halves at each).  The same work for every launch
    design, wherever it keeps the planes and however often it checks.
    Operations: the delta's (:func:`body_ops` on the rows of the ranks
    proposed, R + 2 per Ewald term, a flip's chemical work), and six per
    step for the rule and the bookkeeping (E + dE, minus the window's
    start, the division, its floor, S[b_cur] - S[b'], S + mod_factor).
    """
    tables, move, steps = ops["tables"], ops["move"], ops["n_steps"]
    R, W = ops["occ"].shape
    B = ops["wl"].num_levels
    table_tensors = body_tables(tables)
    if move == "flip":
        table_tensors += [tables.mu, tables.ncode]
    if tables.has_ewald:
        table_tensors += [tables.ew_v, tables.ew_c]
    visited = int((after["occurrences"] > 0).sum())
    resets = int(torch.round(-torch.log2(after["mod_factor"] / ops["mod_factor"])).sum())
    nbytes = (2 * R * W + W * (2 * 8 + 2 * 4) + 2 * W * (8 + 4)
              + B * W * 12 + visited * (4 + 16) + resets * B * 4
              + sum(q[:, :steps].numel() * 4 for q in ops["seqs"])
              + sum(t.numel() * t.element_size() for t in table_tensors))
    sites = W * steps * len(ops["seqs"])
    ewald_site = R + 2 if tables.has_ewald else 0
    rows = proposed_rows(tables, ops, ops["seqs"])
    n_ops = (body_ops(tables, rows, sites) + sites * ewald_site
             + W * steps * (6 + (2 if move == "flip" else 0)))
    ops_s, bytes_s = n_ops / PEAK_F64_PER_S, nbytes / PEAK_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes",
            nbytes, n_ops)


def time_wl_window(ensemble, system, name, card, move, walkers, block=BLOCK,
                   kernel_reps=50, twin_reps=0, delta="direct"):
    """Phase 5: one 100-step Wang-Landau window from fresh planes, the
    bench's parameters (flatness 0.8, a check every 1000 steps and at the
    window's end), every repetition on a copy of the starting state."""
    ops = wl_operands(ensemble, system, move, walkers, THIN, block, occ_seed=5,
                      seq_seed=1, delta=delta)
    ops["seed"] = torch.tensor([42], dtype=torch.int64, device=ensemble.device)
    kernel_ms = cuda_ms(same_window(chain.wl_chain, ops, kernel_reps), kernel_reps)
    after = fresh(ops)  # what this launch's data needs, from one more launch
    chain.wl_chain(**after)
    bound_ms, bound_by, nbytes, n_ops = wl_bound(ops, after)
    rate = walkers * THIN / (kernel_ms * 1e-3)
    result = {"kernel_ms": kernel_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    line = (f"phase 5 [wl-{move}+{body_label(ops['tables'])} {name}] {card}: 100-step "
            f"window at {walkers} walkers ({wl_plan_label(ops)}; "
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


def wl_design_name(design):
    """A Wang-Landau launch design's label."""
    if design == chain._WL_OLD_DESIGN:
        return "old (G=1, streamed, global planes)"
    rows = {None: "rows fit", True: "rows resident", False: "rows streamed"}[design.resident]
    planes = ("planes fit" if design.planes is None
              else f"planes {('global', 'entropy shared')[design.planes]}")
    return f"G={design.lanes or 'rule'} {rows} {planes}"


def wl_in_turns(label, card, ops, designs, reps):
    """Two designs of the Wang-Landau kernel timed in turns (a, b, b, a) on
    copies of one starting state: each turn the mean of ``reps`` launches.
    Returns each design's mean of its two turns, in ms."""
    turns = {design: [] for design in designs}
    a, b = designs
    for design in (a, b, b, a):
        run = functools.partial(chain.wl_chain, _design=design)
        turns[design].append(cuda_ms(same_window(run, ops, reps), reps))
    ta, tb = (sum(turns[d]) / 2 for d in designs)
    na, nb = (wl_design_name(d) for d in designs)
    print(f"phase 5 [wl A/B {label}] {card}: {nb} {tb:.4f} ms against {na} {ta:.4f} ms "
          f"(turns a, b, b, a: {turns[a][0]:.4f}, {turns[b][0]:.4f}, {turns[b][1]:.4f}, "
          f"{turns[a][1]:.4f}; {wl_plan_label(ops, b)}), {nb if tb < ta else na} faster by "
          f"{max(ta, tb) / min(ta, tb):.3f}x")
    return {"a": ta, "b": tb}


def wl_ab(card, wl_runs, reps=10):
    """Phase 5: K6's design, part by part, each pair in turns (a, b, b, a)
    on copies of one starting state of a 100-step window from fresh planes
    (bench parameters), on the flip and the swap cell with the default
    body (K1-Ising) and the direct body, at the main path's 2048 walkers:
    (1) the old design (one thread a walker, rows streamed, planes global)
    against G = 2, 4, 8 and 16 lanes, rows streamed and planes global; (2)
    streamed against resident rows at the chosen lanes (where they fit);
    (3) the planes global against the entropy in shared memory, on the
    100-step window and on a 1500-step launch (the entropy's load and
    write-back are a fixed cost of a launch); then the old design against
    the default at 2048 and at 8192 walkers.  The old design runs through
    this kernel at one lane."""
    old = chain._WL_OLD_DESIGN
    results = {}
    for stem, (ens, system, _) in wl_runs.items():
        move = WL_CELLS[stem]
        block = SWAP_CELLS[stem][1] if stem in SWAP_CELLS else BLOCK
        for delta in ("ising", "direct"):
            ops = wl_operands(ens, system, move, WL_WALKERS, THIN, block, occ_seed=5,
                              seq_seed=1, delta=delta)
            ops["seed"] = torch.tensor([42], dtype=torch.int64, device=ens.device)
            cell = f"wl-{move}+{delta} {stem}"
            lanes = chain.wl_lanes(WL_WALKERS)
            plan = chain.wl_launch_plan(ops["tables"], WL_WALKERS, block, move,
                                        ops["wl"].num_levels)
            streamed = chain._WLDesign(resident=False, planes=0)
            rows = chain._WLDesign(resident=plan.resident, planes=0)
            entropy = chain._WLDesign(resident=plan.resident, planes=1)
            r = {"lanes": {g: wl_in_turns(f"1, lanes: {cell}", card, ops, (
                old, chain._WLDesign(lanes=g, resident=False, planes=0)), reps)
                for g in (2, 4, 8, 16)}}
            if plan.resident:
                r["resident"] = wl_in_turns(f"2, resident rows at G={lanes}: {cell}", card,
                                            ops, (streamed, rows), reps)
            # the planes' load and write-back are a fixed cost of each launch:
            # part 3 also on a launch of a tenth of the main path's 15000 steps
            long_ops = wl_operands(ens, system, move, WL_WALKERS, WL_THIN // 10, block,
                                   occ_seed=5, seq_seed=1, delta=delta)
            long_ops["seed"] = ops["seed"]
            for steps, o in ((THIN, ops), (WL_THIN // 10, long_ops)):
                r[f"entropy {steps}"] = wl_in_turns(
                    f"3, the entropy in shared memory, {steps} steps: {cell}", card, o,
                    (rows, entropy), reps)
            r["old-new"] = wl_in_turns(f"old against new at {WL_WALKERS} walkers: {cell}",
                                       card, ops, (old, chain._WL_DESIGN), reps)
            big = wl_operands(ens, system, move, WALKERS, THIN, block, occ_seed=5,
                              seq_seed=1, delta=delta)
            big["seed"] = ops["seed"]
            r["old-new 8192"] = wl_in_turns(f"old against new at {WALKERS} walkers: {cell}",
                                            card, big, (old, chain._WL_DESIGN), reps)
            results[cell] = r
    return results


def lane_design_name(design):
    """A K1, K2 or K5 launch design's label."""
    rows = {None: "rows fit", True: "rows resident", False: "rows streamed"}[design.resident]
    return f"G={design.lanes or 'rule'} {rows}"


def lanes_in_turns(label, card, time_fn, designs):
    """K1's, K2's or K5's designs timed in turns, first to last and back
    (a, b, ..., b, a): each design's time the mean of its two turns.
    Returns {design: ms}."""
    turns = {design: [] for design in designs}
    for design in (*designs, *reversed(designs)):
        turns[design].append(time_fn(design))
    means = {design: sum(t) / 2 for design, t in turns.items()}
    best = min(means, key=means.get)
    parts = "; ".join(f"{lane_design_name(d)} {means[d]:.4f} ms ({t[0]:.4f}, {t[1]:.4f})"
                      for d, t in turns.items())
    print(f"phase 5 [lane A/B {label}] {card}: {parts}; fastest {lane_design_name(best)}, "
          f"{max(means.values()) / means[best]:.3f}x the slowest")
    return means


def flip_ab(card, cells, reps=10):
    """Phase 5: K1's design in turns on copies of one starting state, on
    each of ``FLIP_AB_CELLS`` at 8192 walkers: (1) G = 1, 2, 4, 8 and 16
    lanes, rows as the plan takes them, on a 100-step window; (2) streamed
    against resident rows, where they fit, at the plan's lanes and at the
    fastest of (1); on bench tempering's cell also (3) a window's ten
    10-step segments (a CUDA graph of the launches, as the tempering path
    issues them) at each G, and streamed against resident there.  The
    launch the plan takes is the default; the parent commit's kernel is
    timed against it by ``scripts/time_chain_windows.py``."""
    results = {}
    segments = THIN // PT_PERIOD
    for stem, delta, temperature in FLIP_AB_CELLS:
        ens = cells[stem]
        tables = tables_of(ens, "flip", delta)
        cell = f"flip+{body_label(tables)} {stem}"
        plan = chain.flip_launch_plan(tables, WALKERS, BLOCK, THIN)
        ops = window_operands(ens, tables, "flip", BLOCK, occ_seed=5, seq_seed=1,
                              temperature=temperature)
        ops["seed"] = torch.tensor([42], dtype=torch.int64, device=ens.device)

        def window(design):
            run = functools.partial(chain.flip_chain, _design=design)
            return cuda_ms(same_window(run, ops, reps), reps)

        fits = any(d.resident for d in lane_designs(tables))
        r = {"plan": plan_label(tables)}
        r["lanes"] = lanes_in_turns(f"1, lanes: {cell}, 100 steps ({r['plan']})", card, window,
                                   [chain._FlipDesign(lanes=g, resident=plan.resident)
                                    for g in FLIP_LANES])
        if fits:
            fastest = min(r["lanes"], key=r["lanes"].get).lanes
            for g in sorted({plan.lanes, fastest}):
                r[f"resident G={g}"] = lanes_in_turns(
                    f"2, rows at G={g}: {cell}, 100 steps", card, window,
                    [chain._FlipDesign(lanes=g, resident=False),
                     chain._FlipDesign(lanes=g, resident=True)])
        if stem == PT_CELL:
            gen = torch.Generator(device=ens.device).manual_seed(11)
            seqs = chain.rank_sequence(tables, gen, (segments, WALKERS // BLOCK, PT_PERIOD))
            seeds = torch.randint(0, 2**62, (segments,), generator=gen, device=ens.device)
            seg_ops = fresh(ops)

            def segment(design):
                def capture():
                    launches = chain.ChainLaunches(
                        "flip", seg_ops["occ"], seg_ops["enthalpy"], (seg_ops["naccept"],),
                        ops["beta32"], (seqs,), seeds, tables, BLOCK, "philox", design)
                    for k in range(segments):
                        launches.launch(k, PT_PERIOD)
                return graph_ms(capture, reps) / segments

            seg_plan = chain.flip_launch_plan(tables, WALKERS, BLOCK, PT_PERIOD)
            r["segment lanes"] = lanes_in_turns(
                f"3, lanes: {cell}, {PT_PERIOD}-step segments, per segment", card, segment,
                [chain._FlipDesign(lanes=g, resident=seg_plan.resident) for g in FLIP_LANES])
            if fits:
                r["segment resident"] = lanes_in_turns(
                    f"3, rows at G={seg_plan.lanes}: {cell}, {PT_PERIOD}-step segments", card,
                    segment, [chain._FlipDesign(lanes=seg_plan.lanes, resident=False),
                              chain._FlipDesign(lanes=seg_plan.lanes, resident=True)])
        results[cell] = r
    return results


def lane_ab(card, move, cells, reps=10):
    """Phase 5: K2's or K5's (``move``) design in turns on copies of one
    starting state, on each cell of ``cells`` ((stem, site body, block,
    temperature, ensemble)) at 8192 walkers, a 100-step window: (1) G = 1,
    2, 4, 8 and 16 lanes, rows as the plan takes them; (2) streamed
    against resident rows, where they fit, at the plan's lanes and at the
    fastest of (1).  The launch the plan takes is the default; the parent
    commit's kernel is timed against it by
    ``scripts/time_chain_windows.py``."""
    results = {}
    kernel_fn = KERNELS[move][0]
    for stem, delta, block, temperature, ens in cells:
        tables = tables_of(ens, move, delta)
        cell = f"{move}+{body_label(tables)} {stem}"
        ops = window_operands(ens, tables, move, block, occ_seed=5, seq_seed=1,
                              temperature=temperature)
        ops["seed"] = torch.tensor([42], dtype=torch.int64, device=ens.device)
        k_max = ops["table_move"].k_max if move == "table" else 2
        plan = chain.launch_plan(move, tables, WALKERS, block, THIN, k_max)

        def window(design):
            run = functools.partial(kernel_fn, _design=design)
            return cuda_ms(same_window(run, ops, reps), reps)

        label = plan_label(tables, block=block, move=move, k_max=k_max)
        r = {"plan": label}
        r["lanes"] = lanes_in_turns(
            f"1, lanes: {cell}, 100 steps ({label})", card, window,
            [chain._LaneDesign(lanes=g, resident=plan.resident) for g in FLIP_LANES])
        fastest = min(r["lanes"], key=r["lanes"].get).lanes
        if any(d.resident for d in lane_designs(tables, block=block, move=move, k_max=k_max)):
            for g in sorted({plan.lanes, fastest}):
                r[f"resident G={g}"] = lanes_in_turns(
                    f"2, rows at G={g}: {cell}, 100 steps", card, window,
                    [chain._LaneDesign(lanes=g, resident=x) for x in (False, True)])
        results[cell] = r
    return results


def distance_bound(ops, work):
    """The least time of one distance launch: (ms, by, bytes, operations).

    Bytes: every operand read once and every output written once (codes
    and best codes [R, W] int8, the feature plane [F, W] f64, score, best
    score and accept count in and out, beta, the pair sequences and the
    tables), summed over every shape of a batched launch.  Operations:
    what this launch's data needs, from the twin's ``work`` count of the
    same launch (every shape's): a null pair computes nothing; a
    non-null one two f64 operations per row of u and of v that it reads
    (the lookup difference and the sum), four per feature for the score
    (f + df, minus T, times W, the sum) and three more (w L, its
    subtraction, d_new - d).
    """
    t, steps = ops["tables"] if "tables" in ops else ops["batch"], ops["n_steps"]
    R, W = ops["occ"].shape[-2:]
    W *= ops["occ"].numel() // (R * W)  # every shape's walkers
    F = t.num_feats
    table_tensors = [t.nbr, t.stride, t.d2, t.g, t.seg, t.target, t.weight,
                     t.group_last, t.group_diameter]
    nbytes = (4 * R * W + 2 * F * W * 8 + W * (4 * 8 + 2 * 4 + 4)
              + sum(q[..., :steps].numel() * 4 for q in (ops["useq"], ops["vseq"]))
              + sum(x.numel() * x.element_size() for x in table_tensors))
    nonnull, rows = (int(x) for x in work.reshape(-1, 2, work.shape[-1]).sum(dim=(0, 2)))
    n_ops = 2 * rows + (4 * F + 3) * nonnull
    ops_s, bytes_s = n_ops / PEAK_F64_PER_S, nbytes / PEAK_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes",
            nbytes, n_ops)


def time_distance(name, card, timed, kernel_reps):
    """Phase 5: the kernel on the operands of a timed phase-3 launch (every
    repetition on a copy of its starting state), beside the twin's time and
    the bound of that launch; where that launch is shorter than the main
    path's, the kernel alone on the main path's 8000-step launch too (a
    batched launch: every shape of the cell in one launch)."""
    ops, work = timed["ops"], timed["work"]
    batched = "batch" in ops
    window = same_batched_window if batched else same_distance_window
    W, steps = ops["occ"].shape[-1], ops["n_steps"]
    shapes = ops["batch"].num_shapes if batched else 1
    if steps < SQS_STEPS:
        beta, seed = 1.0 / SQS_TEMPERATURES[0], SEEDS[1][1]
        main = (batched_operands(timed["procs"], SQS_STEPS, beta, seed)[0] if batched
                else distance_operands(timed["procs"][0], SQS_STEPS, beta, seed))
        main_ms = cuda_ms(window(main, kernel_reps), kernel_reps)
        print(f"phase 5 [distance {name}] {card}: the main path's {SQS_STEPS}-step "
              f"launch at {shapes} x {W} walkers: kernel {main_ms:.4f} ms "
              f"({main_ms * 1e3 / SQS_STEPS:.3f} us per step, "
              f"{shapes * W * SQS_STEPS / (main_ms * 1e-3) / 1e6:.1f} M attempts/s)")
    kernel_ms = cuda_ms(window(ops, kernel_reps), kernel_reps)
    bound_ms, bound_by, nbytes, n_ops = distance_bound(ops, work)
    nonnull = int(work.reshape(-1, 2, W)[:, 0].sum())
    rate = shapes * W * steps / (kernel_ms * 1e-3)
    lanes = sqs.launch_lanes(shapes * W)
    design = sqs._Design(lanes=lanes)
    blocks = shapes * -(-W // sqs.distance_block_walkers(W, SQS_BLOCK, design))
    print(f"phase 5 [distance {name}] {card}: {steps}-step launch at {shapes} x {W} walkers "
          f"({blocks} CUDA blocks, {lanes} lane(s) a walker): kernel {kernel_ms:.4f} "
          f"ms ({rate / 1e6:.1f} M attempts/s, {kernel_ms * 1e3 / steps:.3f} us per step), "
          f"twin {timed['twin_ms']:.2f} ms, twin/kernel {timed['twin_ms'] / kernel_ms:.1f}x, "
          f"bound {bound_ms * 1e3:.3f} us ({bound_by}; {nbytes / 1e6:.3f} MB, "
          f"{n_ops / 1e6:.1f} M f64 operations; {nonnull} non-null of {shapes * W * steps} "
          f"proposals), kernel/bound {kernel_ms / bound_ms:.0f}x")
    return {"kernel_ms": kernel_ms, "twin_ms": timed["twin_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "steps": steps}


def distance_ab(card, procs8, fcc64, reps=3):
    """Phase 5: K7's design, part by part, each pair in turns (a, b, b, a)
    on copies of one starting state of the main path's 8000-step launch at
    the first stage's beta: (1) the old design (one thread a walker, rows
    streamed, one shape a launch) against G = 2, 4, 8 and 16 lanes on one
    shape, and the 20 8-site shapes in one launch at the chosen lanes
    against G = 2, 4, 8 and 16; (2) streamed against resident rows; (3) the
    20 8-site shapes as 20 launches against one; (4) the rows unpacked
    against packed; then the old design against the new on each cell."""
    beta, seed = 1.0 / SQS_TEMPERATURES[0], SEEDS[1][1]
    old, new = sqs._OLD_DESIGN, sqs._DESIGN
    lanes = dataclasses.replace(old, lanes=new.lanes)
    single = distance_operands(procs8[0], SQS_STEPS, beta, seed)
    full, _ = batched_operands(procs8, SQS_STEPS, beta, seed)
    big = distance_operands(fcc64, SQS_STEPS, beta, seed)
    shape0 = "sqs_fcc8 shape 0, one launch"
    shapes = f"the {len(procs8)} sqs_fcc8 shapes"
    sweep = (2, 4, 8, 16)
    return {
        "lanes": [distance_in_turns(f"1, lanes: {shape0}", card, single,
                                    (old, dataclasses.replace(old, lanes=g)), reps)
                  for g in sweep],
        "batched lanes": [distance_in_turns(f"1, lanes: {shapes} in one launch", card, full,
                                            (new, dataclasses.replace(new, lanes=g)), 1,
                                            batched=True)
                          for g in sweep],
        "resident": distance_in_turns(
            f"2, resident rows: {shape0}", card, single,
            (lanes, dataclasses.replace(lanes, resident=True)), reps),
        "batched": distance_in_turns(
            f"3, one launch: {shapes}", card, full,
            (dataclasses.replace(new, batched=False), new), 1, batched=True),
        "packed": distance_in_turns(
            f"4, packed rows: {shapes}", card, full,
            (dataclasses.replace(new, packed=False), new), 1, batched=True),
        "fcc8": distance_in_turns(f"old against new: {shapes}", card, full, (old, new), 1,
                                  batched=True),
        "fcc64": distance_in_turns("old against new: sqs_fcc_4x4x4", card, big, (old, new),
                                   reps),
    }


def same_distance_window(ops, reps, design=sqs._DESIGN):
    copies = iter([fresh_distance(ops) for _ in range(reps + 1)])
    return lambda: sqs.distance_chain(**next(copies), _design=design)


def same_batched_window(ops, reps, design=sqs._DESIGN):
    """One batched launch (``design.batched``), or one launch per shape, for
    :func:`cuda_ms`, every call on a copy of the starting state."""
    copies = iter([fresh_distance(ops) for _ in range(reps + 1)])
    return lambda: sqs.distance_chain_batched(**next(copies), _design=design)


def design_name(design, walkers=None):
    """A design's label; with ``walkers`` (a launch's), its lanes for them."""
    layout = {None: "fit", True: "resident", False: "streamed"}[design.resident]
    lanes = design.lanes or (sqs.launch_lanes(walkers) if walkers else "auto")
    return (f"G={lanes} {layout}"
            f"{' packed' if design.packed else ''}{'' if design.batched else ' per-shape'}")


def distance_in_turns(label, card, ops, designs, reps, batched=False):
    """Two designs of the distance kernel timed in turns (a, b, b, a) on
    copies of one starting state: each turn the mean of ``reps`` launches
    (``batched``: of :func:`same_batched_window`).  Returns each design's
    mean of its two turns, in ms."""
    window = same_batched_window if batched else same_distance_window
    turns = {design: [] for design in designs}
    a, b = designs
    for design in (a, b, b, a):
        turns[design].append(cuda_ms(window(ops, reps, design), reps))
    ta, tb = (sum(turns[d]) / len(turns[d]) for d in designs)
    shapes, W = (ops["occ"].shape[0], ops["occ"].shape[2]) if batched else (1, ops["occ"].shape[1])
    na, nb = (design_name(d, shapes * W if d.batched else W) for d in designs)
    print(f"phase 5 [distance A/B {label}] {card}: {nb} {tb:.4f} ms against {na} {ta:.4f} "
          f"ms (turns a, b, b, a: {turns[a][0]:.4f}, {turns[b][0]:.4f}, {turns[b][1]:.4f}, "
          f"{turns[a][1]:.4f}), {nb if tb < ta else na} faster by "
          f"{max(ta, tb) / min(ta, tb):.3f}x")
    return {"a": ta, "b": tb, "turns": [turns[a][0], turns[b][0], turns[b][1], turns[a][1]]}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    # phase 2: build from the checkout's sources, all kernels at once; the
    # table and Wang-Landau chains, and the distance chain, whose builds take
    # the longest, in two threads, so that phase 3 compares the other
    # kernels meanwhile
    late = (("table_chain", "wl_chain"), ("distance_chain",))
    late_builds = [{} for _ in late]

    def build_late(names, result):
        try:
            result["built"] = _build.build_libraries(names)
        except Exception as error:  # re-raised in the main thread below
            result["error"] = error

    builders = [threading.Thread(target=build_late, args=args)
                for args in zip(late, late_builds)]
    for builder in builders:
        builder.start()

    def join_build(k):
        builders[k].join()
        if "error" in late_builds[k]:
            raise late_builds[k]["error"]
        report(late_builds[k]["built"])

    def report(built):
        for name, (lib_path, log, seconds) in built.items():
            _build.load_chain(name)
            print(f"phase 2: built {lib_path.relative_to(ROOT)} in {seconds:.1f} s")
            for line in ptxas_summary(log):
                print("  ptxas:", line)

    report(_build.build_libraries(tuple(k for k in _build.KERNELS
                                        if not any(k in names for names in late))))

    sgc, ternary, aucu = (load(stem)[0] for stem in (SGC_CELL, TERNARY_CELL, QARY2_CELL))
    for delta in ("direct", "qary"):  # the bodies sgc's ternary tables take
        print(f"phase 2: {SGC_CELL} flip launch, {delta} body: "
              f"{plan_label(tables_of(sgc, 'flip', delta))}")

    # phase 3: kernels against twins at the main paths' shapes
    flips = {stem: load(stem)[0] for stem in FLIP_CELLS}
    swaps = {stem: load(stem)[0] for stem in SWAP_CELLS}
    errs = {"flip": [], "swap": []}
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
    # K3: the q-ary body in K1 (sgc 6x6x6, with the direct body beside it),
    # in K2 (the ternary CE, canonical), q = 2 in both on Au-Cu, q = 2 with
    # the Ewald term in both on the spinel CE + Ewald, and q = 4 in K1 on
    # the quaternary and binary rocksalt
    t0 = time.perf_counter()
    q4 = load(Q4_CELL)[0]
    errs.update({"qary": [], "qary4": [], "qary+ewald": []})
    for rng, seed in SEEDS:
        errs["qary"].append(window_vs_twin(sgc, SGC_CELL, "flip", BLOCK, rng, seed,
                                           "qary", SGC_TEMPERATURE))
        errs["flip"].append(window_vs_twin(sgc, SGC_CELL, "flip", BLOCK, rng, seed,
                                           "direct", SGC_TEMPERATURE))
        errs["qary"].append(window_vs_twin(ternary, TERNARY_CELL, "swap", BLOCK, rng, seed,
                                           "qary", SGC_TEMPERATURE))
        errs["qary"].append(window_vs_twin(aucu, QARY2_CELL, "flip", BLOCK, rng, seed,
                                           "qary"))
        errs["qary"].append(window_vs_twin(aucu, QARY2_CELL, "swap", SWAP_CELLS[QARY2_CELL][1],
                                           rng, seed, "qary", SWAP_CELLS[QARY2_CELL][0]))
        for move in ("flip", "swap"):
            errs["qary+ewald"].append(window_vs_twin(
                swaps[EWALD_QARY_CELL], EWALD_QARY_CELL, move, BLOCK, rng, seed, "qary"))
        errs["qary4"].append(window_vs_twin(q4, Q4_CELL, "flip", BLOCK, rng, seed, "qary"))
    errs["qary"].append(chunked_hash_vs_twin(sgc, SGC_CELL, "flip", BLOCK, "qary"))
    errs["qary+ewald"].append(chunked_hash_vs_twin(
        swaps[EWALD_QARY_CELL], EWALD_QARY_CELL, "swap", BLOCK, "qary"))
    errs["qary4"].append(chunked_hash_vs_twin(q4, Q4_CELL, "flip", BLOCK, "qary"))
    print(f"phase 3: the K3 comparisons took {time.perf_counter() - t0:.1f} s")
    # K1-Ising: the parity body in K1 and K2 on every cell where its tables
    # exist, both RNG modes, and a hash chain across the chunk boundary in
    # each kernel; then the exchange kernel over PT_SWEEPS sweeps
    t0 = time.perf_counter()
    ising_cells = {**flips, **swaps, PT_CELL: load(PT_CELL)[0]}
    errs["ising"] = []
    for (stem, move), (block, temperature) in ISING_CELLS.items():
        for rng, seed in SEEDS:
            errs["ising"].append(window_vs_twin(ising_cells[stem], stem, move, block, rng,
                                                seed, "ising", temperature))
    errs["ising"].append(chunked_hash_vs_twin(ising_cells[PT_CELL], PT_CELL, "flip", BLOCK,
                                              "ising"))
    errs["ising"].append(chunked_hash_vs_twin(swaps["aucu_4x4x4"], "aucu_4x4x4", "swap",
                                              SWAP_CELLS["aucu_4x4x4"][1], "ising"))
    errs["exchange"] = [exchange_vs_twin()]
    print(f"phase 3: the K1-Ising and exchange comparisons took "
          f"{time.perf_counter() - t0:.1f} s")
    # K1 at every lane count and row plan, each body, both RNG modes; the
    # sweep schedule (bench spinel-independent)
    t0 = time.perf_counter()
    flip_cells = {stem: load(stem)[0] for stem, *_ in FLIP_BODY_CELLS}
    for stem, delta, temperature, padded in FLIP_BODY_CELLS:
        key = {"ising": "ising", "direct": "flip"}.get(delta, "qary")
        for rng, seed in SEEDS:
            errs[key].append(flip_designs_vs_twin(flip_cells[stem], stem, delta, temperature,
                                                  padded, rng, seed))
    for rng, seed in SEEDS:
        errs["ising"].append(sweep_vs_twin(flips["spinel_2x2x2"], "spinel_2x2x2", rng, seed))
    print(f"phase 3: K1's designs and the sweep schedule took "
          f"{time.perf_counter() - t0:.1f} s")
    join_build(0)
    # the table chain: the direct body on both spinel cells, K1-Ising on
    # both, K3 (q = 2, with the Ewald term) on 2x2x2, each in both RNG modes
    # and across the chunk boundary, and the rocksalt's three recolorings
    t0 = time.perf_counter()
    table_cells = {stem: load(stem)[0] for stem in TABLE_CELLS}
    errs.update({"table": [], "table+ising": [], "table+qary": []})
    for stem, ens in table_cells.items():
        for delta in ("direct", *TABLE_BODY_CELLS[stem]):
            key = "table" if delta == "direct" else f"table+{delta}"
            for rng, seed in SEEDS:
                errs[key].append(window_vs_twin(ens, stem, "table", BLOCK, rng, seed, delta))
    for delta in ("direct", "ising", "qary"):
        key = "table" if delta == "direct" else f"table+{delta}"
        errs[key].append(chunked_hash_vs_twin(
            table_cells["spinel_ewald_sgc_2x2x2"], "spinel_ewald_sgc_2x2x2", "table", BLOCK,
            delta))
    # up to three recolorings per move: the runtime slot count body
    errs["table"].append(window_vs_twin(load(MULTI_SLOT_CELL)[0], MULTI_SLOT_CELL,
                                        "table", BLOCK, *SEEDS[1]))
    print(f"phase 3: the table comparisons took {time.perf_counter() - t0:.1f} s")
    # K2 and K5 at every lane count and row plan, each body, both RNG modes
    t0 = time.perf_counter()
    lane_cells = {stem: load(stem)[0] for stem, *_ in (*SWAP_LANE_CELLS, *TABLE_LANE_CELLS)}
    for move, cells in (("swap", SWAP_LANE_CELLS), ("table", TABLE_LANE_CELLS)):
        for stem, delta, block, temperature in cells:
            key = move if delta == "direct" else f"table+{delta}" if move == "table" else delta
            for rng, seed in SEEDS:
                errs[key].append(lane_designs_vs_twin(lane_cells[stem], stem, move, delta,
                                                      block, temperature, rng, seed))
    print(f"phase 3: K2's and K5's designs took {time.perf_counter() - t0:.1f} s")
    # the Wang-Landau chain: both moves, both RNG modes, a chunk boundary,
    # update_period = 3, the Ewald instantiation and the main path's own
    # launch, with the direct body and with K1-Ising; K3 (q = 3) on the
    # ternary window
    t0 = time.perf_counter()
    wl_systems = {stem: load(stem) for stem in WL_CELLS}
    wl_ewald = load(EWALD_QARY_CELL)
    errs.update({"wl": [], "wl+ising": [], "wl+qary": []})
    for delta, key in (("direct", "wl"), ("ising", "wl+ising")):
        for stem, move in WL_CELLS.items():
            for rng, seed in SEEDS:
                errs[key].append(wl_window_vs_twin(*wl_systems[stem], stem, move, rng,
                                                   seed, delta))
        errs[key].append(wl_chunked_hash_vs_twin(
            *wl_systems["aucu_wl_3x3x3"], "aucu_wl_3x3x3", "flip", delta))
        errs[key].append(wl_window_vs_twin(
            *wl_systems["aucu_wl_3x3x3"], "aucu_wl_3x3x3", "flip", *SEEDS[1], delta,
            update_period=3))
        errs[key].append(wl_window_vs_twin(
            *wl_ewald, EWALD_QARY_CELL, "swap", *SEEDS[1], delta))
    # the launch's parts at the chosen lanes: planes global (0), the
    # entropy in shared memory (1), K1-Ising's rows
    # streamed, and the old design (one thread a walker, rows streamed,
    # planes global)
    for stem, move in WL_CELLS.items():
        for delta, key in (("direct", "wl"), ("ising", "wl+ising")):
            for design in (*(chain._WLDesign(planes=k) for k in range(2)),
                           chain._WL_OLD_DESIGN):
                errs[key].append(wl_window_vs_twin(*wl_systems[stem], stem, move, *SEEDS[0],
                                                   delta, design))
        errs["wl+ising"].append(wl_window_vs_twin(
            *wl_systems[stem], stem, move, *SEEDS[1], "ising", chain._WLDesign(resident=False)))
    for stem, move in WL_CELLS.items():  # the main path's own launch
        errs["wl"].append(wl_main_launch_vs_twin(*wl_systems[stem], stem, move))
    errs["wl+ising"].append(wl_main_launch_vs_twin(
        *wl_systems["aucu_wl_3x3x3"], "aucu_wl_3x3x3", "flip", "ising"))
    sgc_wl = load(WL_QARY_CELL)
    for rng, seed in SEEDS:
        errs["wl+qary"].append(wl_window_vs_twin(*sgc_wl, WL_QARY_CELL, "flip", rng, seed,
                                                 "qary"))
    errs["wl+qary"].append(wl_chunked_hash_vs_twin(*sgc_wl, WL_QARY_CELL, "flip", "qary"))
    print(f"phase 3: the Wang-Landau comparisons took {time.perf_counter() - t0:.1f} s")
    join_build(1)
    # the distance chain at the chosen design (rows resident on the 8-site
    # shapes, streamed on the 64-site one): both cells and RNG modes, a chunk
    # boundary, beta 0 and 50 (T = 0.02), no match term, the old design;
    # a batched launch of the 20 8-site shapes against their own launches
    # and, across a chunk boundary, against one chain per shape, in both RNG
    # modes; and the main paths' own launches against the twin
    t0 = time.perf_counter()
    procs8 = sqs_processors("sqs_fcc8")
    fcc8, fcc64 = procs8[0], sqs_processors("sqs_fcc_4x4x4")[0]
    errs["distance"] = []
    for name, proc in (("sqs_fcc8 shape 0", fcc8), ("sqs_fcc_4x4x4", fcc64)):
        for rng, seed in SEEDS:
            errs["distance"].append(distance_vs_twin(proc, name, rng, seed))
    errs["distance"].append(distance_chunked_hash_vs_twin(fcc8, "sqs_fcc8 shape 0"))
    errs["distance"].append(distance_vs_twin(fcc8, "sqs_fcc8 shape 0", *SEEDS[1], beta=0.0))
    errs["distance"].append(distance_vs_twin(fcc64, "sqs_fcc_4x4x4", *SEEDS[1], beta=50.0))
    errs["distance"].append(distance_vs_twin(fcc8, "sqs_fcc8 shape 0", *SEEDS[1],
                                             match_weight=0.0))
    errs["distance"].append(distance_vs_twin(fcc8, "sqs_fcc8 shape 0", *SEEDS[0],
                                             design=sqs._OLD_DESIGN))
    for rng, seed in SEEDS:
        errs["distance"].append(batched_vs_per_shape(procs8, "sqs_fcc8", rng, seed))
        errs["distance"].append(batched_chunked_vs_per_shape(procs8, "sqs_fcc8", rng))
    print(f"phase 3: the distance comparisons took {time.perf_counter() - t0:.1f} s")
    sqs_timed = {}
    t0 = time.perf_counter()
    err, sqs_timed["sqs_fcc8 batched"] = batched_vs_twin(  # the first stage's launch
        procs8, "sqs_fcc8", *SEEDS[1], beta=1.0 / SQS_TEMPERATURES[0], n_steps=SQS_WINDOW)
    errs["distance"].append(err)
    err, sqs_timed["sqs_fcc_4x4x4"] = distance_vs_twin(
        fcc64, "sqs_fcc_4x4x4, the main path's launch:", *SEEDS[1],
        beta=1.0 / SQS_TEMPERATURES[0], n_steps=SQS_TWIN_STEPS, timed=True)
    sqs_timed["sqs_fcc_4x4x4"]["procs"] = [fcc64]
    errs["distance"].append(err)
    print(f"phase 3: the main launches against the twin took {time.perf_counter() - t0:.1f} s")
    print(f"phases 2-3 took {time.perf_counter() - t_start:.1f} s")

    # phase 4: the main paths; only these runs are counted
    # launches of the chains by site body, summed over the paths
    _, flip_bodies = drive(
        "flip", {stem: (TEMPERATURE, BLOCK) for stem in FLIP_CELLS}, card)
    _, swap_bodies = drive("swap", SWAP_CELLS, card)
    swap_direct = drive_swap_direct(card)
    # bench spinel-ewald on the default body, then each cell once with the
    # other (direct or K1-Ising) and 2x2x2 with K3
    table_runs, table_bodies = drive("table", TABLE_CELLS, card)
    other = {stem: "direct" if chain.default_delta(ens.processor, ens.sublattices)
             == "ising" else "ising" for stem, (ens, _) in table_runs.items()}
    table_other = drive_bodies("table paths, the other body and K3", [
        *(("table", stem, *TABLE_CELLS[stem], other[stem]) for stem in TABLE_CELLS),
        ("table", "spinel_ewald_sgc_2x2x2", *TABLE_CELLS["spinel_ewald_sgc_2x2x2"], "qary")],
        card)["table"]
    # K3 with the Ewald term in K2 and with q = 4 in K1
    qary_paths = drive_bodies("K3 paths with the Ewald term and q = 4", [
        ("swap", EWALD_QARY_CELL, *SWAP_CELLS[EWALD_QARY_CELL], "qary"),
        ("flip", Q4_CELL, TEMPERATURE, BLOCK, "qary")], card)
    _, sgc_bodies = drive_sgc(card)
    _, built_bodies, built_traces = drive_built(card)
    t0 = time.perf_counter()
    ewald_bodies = drive_built_ewald(card)
    print(f"phase 4c took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    api_bodies, api_distance = drive_host_api(card, built_traces[HOST_API_CELL])
    print(f"phase 4d took {time.perf_counter() - t0:.1f} s")
    _, pt_bodies, exchange_launches = drive_tempering_cells(card)
    t0 = time.perf_counter()
    exchange_launches += drive_step_path(card)
    print(f"phase 4e took {time.perf_counter() - t0:.1f} s")
    drive_step_refusals(card)
    launches = {("flip", body): flip_bodies[body] + sgc_bodies[body] + pt_bodies[body]
                + built_bodies[body] + api_bodies["flip"][body]
                for body in ("direct", "qary", "ising")}
    launches.update({("swap", body): swap_bodies[body] + swap_direct[body]
                     + ewald_bodies["swap"][body] + api_bodies["swap"][body]
                     for body in ("direct", "qary", "ising")})
    launches.update({("table", body): table_bodies[body] + table_other[body]
                     + ewald_bodies["table"][body] for body in ("direct", "qary", "ising")})
    launches[("flip", "qary4")] = qary_paths["flip"]["qary"]
    launches[("swap", "qary+ewald")] = qary_paths["swap"]["qary"]
    tempering_vs_enumeration(card)
    wl_runs, wl_bodies = drive_wl_cells(card)
    launches.update({("wl", body): wl_bodies[body] for body in ("direct", "qary", "ising")})
    _, sqs_launches = drive_sqs_cells(card)
    print(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")

    # phase 5: window timings, kernel against twin (the flip and swap cells'
    # direct body in the turns against K1-Ising below); the flip chain with
    # the Ewald term, and the Wang-Landau chain at its main path's walkers
    timings = {("flip", "spinel_ewald_2x2x2"): time_window(
        swaps["spinel_ewald_2x2x2"], "spinel_ewald_2x2x2", card, "flip", BLOCK)}
    for stem, (ens, system, _) in wl_runs.items():
        move = WL_CELLS[stem]
        block = SWAP_CELLS[stem][1] if stem in SWAP_CELLS else BLOCK
        for delta in ("direct", "ising"):
            timings[(f"wl-{move} at {WL_WALKERS} walkers+{delta}", stem)] = time_wl_window(
                ens, system, stem, card, move, WL_WALKERS, delta=delta)
    for name, timed in sqs_timed.items():
        timings[("distance", name)] = time_distance(name, card, timed, kernel_reps=5)
    distance_ab(card, procs8, fcc64)
    wl_ab(card, wl_runs)
    flip_ab(card, flip_cells)
    lane_ab(card, "swap", [(*c, lane_cells[c[0]]) for c in SWAP_LANE_CELLS])
    lane_ab(card, "table", [(*c, lane_cells[c[0]]) for c in TABLE_LANE_CELLS
                            if c[0] != MULTI_SLOT_CELL])

    def in_turns(label, time_fn, bodies):
        """Two bodies timed in turns (a, b, b, a): the twin on the first turn
        of each, the kernel's time the mean of its two turns."""
        turns = {}
        for delta in (bodies[0], bodies[1], bodies[1], bodies[0]):
            turns.setdefault(delta, []).append(time_fn(delta, len(turns.get(delta, ()))))
        for delta, (first, second) in turns.items():
            timings[(f"{label}+{delta}", time_fn.stem)] = {
                **first, "kernel_ms": (first["kernel_ms"] + second["kernel_ms"]) / 2}
        a, b = (timings[(f"{label}+{d}", time_fn.stem)]["kernel_ms"] for d in bodies)
        print(f"phase 5 [{label} {time_fn.stem}] {card}: {bodies[1]} {b:.4f} ms against "
              f"{bodies[0]} {a:.4f} ms per 100-step window at {WALKERS} walkers (means of "
              f"two turns): {bodies[1] if b < a else bodies[0]} faster by "
              f"{max(a, b) / min(a, b):.3f}x")

    def window_timer(ens, stem, move, block, temperature=TEMPERATURE, twin_reps=3):
        def time_fn(delta, turn):
            return time_window(ens, stem, card, move, block,
                               twin_reps=0 if turn else twin_reps, delta=delta,
                               temperature=temperature)
        time_fn.stem = stem
        return time_fn

    def wl_timer(ens, system, stem, move, block):
        def time_fn(delta, turn):
            return time_wl_window(ens, system, stem, card, move, WALKERS, block,
                                  twin_reps=0 if turn else 1, delta=delta)
        time_fn.stem = stem
        return time_fn

    # K3 against the direct body on the same cells, in turns
    in_turns("flip", window_timer(sgc, SGC_CELL, "flip", BLOCK, SGC_TEMPERATURE),
             ("direct", "qary"))
    in_turns("swap", window_timer(ternary, TERNARY_CELL, "swap", BLOCK, SGC_TEMPERATURE),
             ("direct", "qary"))
    in_turns("flip", window_timer(q4, Q4_CELL, "flip", BLOCK, twin_reps=1),
             ("direct", "qary"))
    in_turns("swap", window_timer(swaps[EWALD_QARY_CELL], EWALD_QARY_CELL, "swap", BLOCK,
                                  twin_reps=1), ("direct", "qary"))
    # K1-Ising against the direct body on every cell where its tables exist,
    # in turns; then the exchange kernel and one tempering segment
    for (stem, move), (block, temperature) in ISING_CELLS.items():
        in_turns(move, window_timer(ising_cells[stem], stem, move, block, temperature,
                                    twin_reps=1), ("direct", "ising"))
        tables = tables_of(ising_cells[stem], move, "ising")
        rows = float(tables.irows.double().mean()) * (2 if move == "swap" else 1)
        ising = timings[(f"{move}+ising", stem)]["kernel_ms"]
        print(f"phase 5 [{move} {stem}]: Ising {ising * 1e6 / THIN / rows:.1f} ns per "
              f"parity row ({rows:.0f} a step)")
    # the table and Wang-Landau chains: K1-Ising against the direct body on
    # every cell of their main paths (the A/B that picks the default), K3
    # against the direct body on its cells
    for stem, ens in table_cells.items():
        in_turns("table", window_timer(ens, stem, "table", BLOCK, twin_reps=1),
                 ("direct", "ising"))
    in_turns("table", window_timer(table_cells["spinel_ewald_sgc_2x2x2"],
                                   "spinel_ewald_sgc_2x2x2", "table", BLOCK, twin_reps=1),
             ("direct", "qary"))
    for stem, (ens, system, _) in wl_runs.items():
        move = WL_CELLS[stem]
        block = SWAP_CELLS[stem][1] if stem in SWAP_CELLS else BLOCK
        in_turns(f"wl-{move}", wl_timer(ens, system, stem, move, block),
                 ("direct", "ising"))
    in_turns("wl-flip", wl_timer(*sgc_wl, WL_QARY_CELL, "flip", BLOCK), ("direct", "qary"))
    for chain_name, stems in (("table", TABLE_CELLS), ("wl-flip", ("aucu_wl_3x3x3",)),
                              ("wl-swap", ("aucu_4x4x4",))):
        wins = [timings[(f"{chain_name}+ising", stem)]["kernel_ms"]
                < timings[(f"{chain_name}+direct", stem)]["kernel_ms"] for stem in stems]
        first = next(iter(stems))
        ens = table_cells[first] if chain_name == "table" else wl_runs[first][0]
        default = chain.default_delta(ens.processor, ens.sublattices)
        print(f"phase 5 [{chain_name}] {card}: K1-Ising beat the direct body on "
              f"{sum(wins)} of {len(wins)} cells; default_delta names {default!r}")
    timings[("exchange", PT_CELL)] = time_exchange(card)
    for delta in ("ising", "direct"):
        timings[(f"segment+{delta}", PT_CELL)] = time_segment(card, ising_cells[PT_CELL],
                                                              delta)
    print("timings " + card + ": " + json.dumps(
        {f"{move} {stem}": v for (move, stem), v in timings.items()}))
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")

    def entry(name, timing, source, replaces, launches, err_key, plan=None):
        t = timings[timing]
        return {**({"plan": plan} if plan else {}),
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(errs[err_key]),
            "ms": t["kernel_ms"], "plain_ms": t["twin_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,  # no single PyTorch call runs a Monte Carlo chain
        }

    def flip_plans(delta, cells):
        """K1's launch plan on each main path's cell of a body: its 100-step
        windows and, on the tempering cell, its 10-step segments."""
        return {stem: plan_label(tables_of(ens, "flip", delta),
                                      n_steps=PT_PERIOD if stem == PT_CELL else THIN)
                for stem, ens in cells.items()}

    def lane_plans(move, delta, cells):
        """K2's or K5's launch plan on each main path's cell of a body."""
        return {stem: plan_label(
            tables_of(ens, move, delta), move=move,
            block=SWAP_CELLS[stem][1] if move == "swap" else BLOCK)
            for stem, ens in cells.items()}

    # each entry's launches are those of its (kernel, body) pair on the main
    # paths, its times that pair's on a cell where a main path ran it
    flip_src, swap_src = "smol_tpu_torch/csrc/flip_chain.cu", "smol_tpu_torch/csrc/swap_chain.cu"
    table_src, wl_src = "smol_tpu_torch/csrc/table_chain.cu", "smol_tpu_torch/csrc/wl_chain.cu"
    body_src = "smol_tpu_torch/csrc/chain_common.cuh"
    ref = "smol_tpu/ops/pallas_chain.py"
    kernels = [
        entry("flip_chain (direct body)", ("flip+direct", SGC_CELL), flip_src,
              f"{ref}:1545", launches[("flip", "direct")], "flip",
              flip_plans("direct", {SGC_CELL: sgc, PT_CELL: ising_cells[PT_CELL]})),
        entry("swap_chain (direct body)", ("swap+direct", "aucu_4x4x4"), swap_src,
              f"{ref}:1817", launches[("swap", "direct")], "swap",
              lane_plans("swap", "direct", {"aucu_4x4x4": swaps["aucu_4x4x4"]})),
        entry("table_chain (direct body)", ("table+direct", "spinel_ewald_sgc_2x2x2"),
              table_src, f"{ref}:1701", launches[("table", "direct")], "table",
              lane_plans("table", "direct", table_cells)),
        entry("table_chain (K1-Ising body)", ("table+ising", "spinel_ewald_sgc_2x2x2"),
              table_src, f"{ref}:1754", launches[("table", "ising")], "table+ising",
              lane_plans("table", "ising", table_cells)),
        entry("table_chain (K3 body, q = 2, Ewald)", ("table+qary", "spinel_ewald_sgc_2x2x2"),
              table_src, f"{ref}:1754", launches[("table", "qary")], "table+qary",
              lane_plans("table", "qary", {"spinel_ewald_sgc_2x2x2":
                                           table_cells["spinel_ewald_sgc_2x2x2"]})),
        entry("wl_chain (direct body)", ("wl-flip+direct", "aucu_wl_3x3x3"), wl_src,
              f"{ref}:1866", launches[("wl", "direct")], "wl"),
        entry("wl_chain (K1-Ising body)", ("wl-flip+ising", "aucu_wl_3x3x3"), wl_src,
              f"{ref}:1866", launches[("wl", "ising")], "wl+ising"),
        entry("wl_chain (K3 body, q = 3)", ("wl-flip+qary", WL_QARY_CELL), wl_src,
              f"{ref}:1866", launches[("wl", "qary")], "wl+qary"),
        entry("distance_chain", ("distance", "sqs_fcc8 batched"),
              "smol_tpu_torch/csrc/distance_chain.cu", "smol_tpu/ops/pallas_sqs.py:649",
              sqs_launches + api_distance, "distance"),
        entry("qary_body (K3, in flip_chain)", ("flip+qary", SGC_CELL), body_src,
              f"{ref}:519", launches[("flip", "qary")], "qary",
              flip_plans("qary", {SGC_CELL: sgc})),
        entry("qary_body (K3, q = 4, in flip_chain)", ("flip+qary", Q4_CELL), body_src,
              f"{ref}:519", launches[("flip", "qary4")], "qary4",
              flip_plans("qary", {Q4_CELL: q4})),
        entry("qary_body (K3, q = 2 with Ewald, in swap_chain)",
              ("swap+qary", EWALD_QARY_CELL), body_src, f"{ref}:570",
              launches[("swap", "qary+ewald")], "qary+ewald",
              lane_plans("swap", "qary", {EWALD_QARY_CELL: swaps[EWALD_QARY_CELL]})),
        entry("ising_body (K1-Ising, in flip_chain)", ("flip+ising", PT_CELL), body_src,
              f"{ref}:374", launches[("flip", "ising")], "ising",
              flip_plans("ising", {**flips, PT_CELL: ising_cells[PT_CELL]})),
        entry("ising_body (K1-Ising, in swap_chain)", ("swap+ising", "aucu_4x4x4"), body_src,
              f"{ref}:410", launches[("swap", "ising")], "ising",
              lane_plans("swap", "ising", swaps)),
        entry("tempering_exchange", ("exchange", PT_CELL), "smol_tpu_torch/csrc/tempering.cu",
              "smol_tpu/parallel/tempering.py:42", exchange_launches, "exchange"),
    ]
    for k in kernels:  # every kernel of the paths ran on them
        check(k["launches"] > 0, f"{k['name']}: no launch on the main paths")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
