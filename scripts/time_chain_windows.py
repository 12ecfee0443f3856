"""Time the flip, swap, table, Wang-Landau and distance chains of one checkout on one GPU.

For an A/B of two versions of a kernel on the same card, one after the other:
unpack the other version beside this one (``mkdir -p ab_trees/parent; git
archive <commit> | tar -x -C ab_trees/parent``; ``.gitignore`` lists
``ab_trees/``) and run, in turns,

    python scripts/time_chain_windows.py parent ab_trees/parent
    python scripts/time_chain_windows.py change
    python scripts/time_chain_windows.py change
    python scripts/time_chain_windows.py parent ab_trees/parent

Each run builds the named checkout's kernels (default: the checkout this
script lies in) and times ``chip_smoke.time_window`` of that checkout: one
100-step window at 8192 walkers on the semigrand spinel cells (flips) and,
where the checkout has them, on the flip chain's other cells (bench
``sgc`` 6x6x6 with K3 and with the direct body, the q = 4 rocksalt with K3,
bench ``tempering``'s Au-Cu 3x3x3 with the direct body), on
the canonical cells (swaps, the spinel CE + Ewald with and without the
Ewald term, and Au-Cu) and on the charge-neutral table-flip cells (with
and without the Ewald term), and, where the checkout has them, the two
Wang-Landau cells (flips on
Au-Cu 3x3x3, swaps on Au-Cu 4x4x4, each in its main path's sequence block;
``chip_smoke.time_wl_window``, at 8192 walkers and at the Wang-Landau main
path's 2048, with each site body the checkout has) and the distance chain on the SQS main
path's launch (8000 steps at 2048 walkers on the bench's first 8-site
shape and on the 64-site shape, mean of 5, each on a copy of one starting
state), and, where the checkout has them, the flip and swap cells of
K1-Ising (``chip_smoke.ISING_CELLS``) with the Ising body, and the table
cells with K1-Ising (``chip_smoke.TABLE_BODY_CELLS``), and bench
``tempering``'s 10-step flip launches (``chip_smoke.time_segment``, with
K1-Ising and the direct body: device time per launch in CUDA graphs of a
window's ten), and, where the checkout has them, K3 in the swap chain
(q = 2 with the Ewald term on ``chip_smoke.EWALD_QARY_CELL``, q = 3 on
``chip_smoke.TERNARY_CELL``) and in the table chain (the
``TABLE_BODY_CELLS`` that take it), and, where the checkout has it, K7's
wide body on ``chip_smoke.WIDE_CELL`` (``wide``: the 20 shapes x 2048
walkers in one launch of ``chip_smoke.WIDE_AB_STEPS`` and one of
``chip_smoke.SQS_STEPS`` steps, each once after a warm-up launch, each on a
copy of one starting state, at the checkout's launch plan).
Further arguments after the tree name the kinds to time (``flip``,
``swap``, ``table``, ``wl``, ``distance``, ``ising``, ``segment``,
``qary``, ``wide``; all without).
Prints the card's name and power limit and one ``AB`` line per cell:
label, move, cell, kernel ms, kernel ms without the Ewald term (``nan``
for a cell without one); a distance line ends with a checksum of the
launch's scores and codes, which two versions of the kernel must share.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path


def main():
    label = sys.argv[1]
    tree = Path(sys.argv[2] if len(sys.argv) > 2 else Path(__file__).parent.parent)
    kinds = set(sys.argv[3:]) or {"flip", "swap", "table", "wl", "distance", "ising",
                                  "segment", "qary", "wide"}
    tree = tree.resolve()
    os.chdir(tree)
    sys.path.insert(0, str(tree))
    import chip_smoke  # the named checkout's

    card = chip_smoke.card_line()
    print(card)
    wl_cells = getattr(chip_smoke, "WL_CELLS", {}) if "wl" in kinds else {}
    sqs_cells = getattr(chip_smoke, "SQS_CELLS", ()) if "distance" in kinds else ()
    wide = "wide" in kinds and hasattr(chip_smoke, "wide_generator")
    ising_cells = getattr(chip_smoke, "ISING_CELLS", {}) if "ising" in kinds else {}
    chip_smoke._build.build_libraries(
        tuple(name for name, on in (("flip_chain", bool(kinds & {"flip", "ising", "segment"})),
                                    ("swap_chain", bool(kinds & {"swap", "qary"})
                                     or bool(ising_cells)),
                                    ("table_chain", bool(kinds & {"table", "qary"})),
                                    ("wl_chain", bool(wl_cells)),
                                    ("distance_chain", bool(sqs_cells) or wide)) if on))
    cells = [("flip", stem, chip_smoke.BLOCK) for stem in chip_smoke.FLIP_CELLS
             if "flip" in kinds]
    cells += [("table", stem, chip_smoke.BLOCK) for stem in chip_smoke.TABLE_CELLS
              if "table" in kinds]
    cells += [("swap", stem, block) for stem, (_, block) in chip_smoke.SWAP_CELLS.items()
              if "swap" in kinds]
    for move, stem, block in cells:
        ensemble = chip_smoke.load(stem)[0]
        t = chip_smoke.time_window(ensemble, stem, card, move, block, twin_reps=1)
        print("AB", label, move, stem, t["kernel_ms"],
              t.get("kernel_no_ewald_ms", float("nan")), flush=True)
    # the flip chain's other bodies and cells, where the checkout has them:
    # (stem constant, site body, temperature constant)
    flip_bodies = [("SGC_CELL", "qary", "SGC_TEMPERATURE"),
                   ("SGC_CELL", "direct", "SGC_TEMPERATURE"),
                   ("Q4_CELL", "qary", "TEMPERATURE"), ("PT_CELL", "direct", "PT_TEMPERATURE")]
    for stem_name, delta, temperature_name in flip_bodies if "flip" in kinds else ():
        stem = getattr(chip_smoke, stem_name, None)
        if stem is None:
            continue
        t = chip_smoke.time_window(chip_smoke.load(stem)[0], stem, card, "flip",
                                   chip_smoke.BLOCK, twin_reps=0, delta=delta,
                                   temperature=getattr(chip_smoke, temperature_name))
        print("AB", label, f"flip+{delta}", stem, t["kernel_ms"], float("nan"), flush=True)
    pt_cell = getattr(chip_smoke, "PT_CELL", None)
    for delta in ("ising", "direct") if "segment" in kinds and pt_cell else ():
        t = chip_smoke.time_segment(card, chip_smoke.load(pt_cell)[0], delta)
        print("AB", label, f"segment+{delta}", pt_cell, t["launch_ms"], float("nan"),
              flush=True)
    for (stem, move), (block, temperature) in ising_cells.items():
        ensemble = chip_smoke.load(stem)[0]
        t = chip_smoke.time_window(ensemble, stem, card, move, block, twin_reps=0,
                                   delta="ising", temperature=temperature)
        print("AB", label, f"{move}+ising", stem, t["kernel_ms"], float("nan"), flush=True)
    # the table and Wang-Landau chains' K1-Ising body, where the checkout has it
    bodies = hasattr(chip_smoke, "TABLE_BODY_CELLS") and "ising" in kinds
    if bodies and "table" in kinds:
        for stem in chip_smoke.TABLE_CELLS:
            t = chip_smoke.time_window(chip_smoke.load(stem)[0], stem, card, "table",
                                       chip_smoke.BLOCK, twin_reps=0, delta="ising")
            print("AB", label, "table+ising", stem, t["kernel_ms"],
                  t.get("kernel_no_ewald_ms", float("nan")), flush=True)
    # K3 in the swap and table chains, where the checkout has it
    qary_cells = []
    if "qary" in kinds and hasattr(chip_smoke, "TABLE_BODY_CELLS"):
        qary_cells = [("swap", chip_smoke.EWALD_QARY_CELL, chip_smoke.BLOCK,
                       chip_smoke.TEMPERATURE),
                      ("swap", chip_smoke.TERNARY_CELL, chip_smoke.BLOCK,
                       chip_smoke.SGC_TEMPERATURE)]
        qary_cells += [("table", stem, chip_smoke.BLOCK, chip_smoke.TEMPERATURE)
                       for stem, bodies in chip_smoke.TABLE_BODY_CELLS.items()
                       if "qary" in bodies]
    for move, stem, block, temperature in qary_cells:
        t = chip_smoke.time_window(chip_smoke.load(stem)[0], stem, card, move, block,
                                   twin_reps=0, delta="qary", temperature=temperature)
        print("AB", label, f"{move}+qary", stem, t["kernel_ms"],
              t.get("kernel_no_ewald_ms", float("nan")), flush=True)
    wl_bodies = ("direct", "ising") if hasattr(chip_smoke, "TABLE_BODY_CELLS") else ("direct",)
    wl_walkers = sorted({chip_smoke.WALKERS, getattr(chip_smoke, "WL_WALKERS", chip_smoke.WALKERS)})
    for stem, move in wl_cells.items():
        block = chip_smoke.SWAP_CELLS.get(stem, (None, chip_smoke.BLOCK))[1]
        for delta in wl_bodies:
            extra = {"delta": delta} if len(wl_bodies) > 1 else {}
            for walkers in wl_walkers:
                t = chip_smoke.time_wl_window(*chip_smoke.load(stem), stem, card, move,
                                              walkers, block, **extra)
                print("AB", label, f"wl-{move}" + ("+ising" if delta == "ising" else ""),
                      f"{stem}@{walkers}", t["kernel_ms"], float("nan"), flush=True)
    for stem in sqs_cells:
        proc = chip_smoke.sqs_processors(stem)[0]
        ops = chip_smoke.distance_operands(proc, chip_smoke.SQS_STEPS,
                                           1.0 / chip_smoke.SQS_TEMPERATURES[0],
                                           chip_smoke.SEEDS[1][1])
        ms = chip_smoke.cuda_ms(chip_smoke.same_distance_window(ops, 5), 5)
        out = chip_smoke.fresh_distance(ops)
        chip_smoke.sqs.distance_chain(**out)
        checksum = (float(out["d"].sum()), int(out["occ"].long().sum()),
                    int(out["naccept"].sum()))
        print("AB", label, "distance", stem, ms, float("nan"), checksum, flush=True)
    procs = chip_smoke.wide_generator()[0].processors if wide else ()
    for steps in (chip_smoke.WIDE_AB_STEPS, chip_smoke.SQS_STEPS) if wide else ():
        ops, _ = chip_smoke.batched_operands(procs, steps, 1.0 / chip_smoke.SQS_TEMPERATURES[0],
                                             chip_smoke.SEEDS[1][1])
        ms = chip_smoke.cuda_ms(chip_smoke.same_batched_window(ops, 1), 1)
        out = chip_smoke.fresh_distance(ops)
        chip_smoke.sqs.distance_chain_batched(**out)
        checksum = (float(out["d"].sum()), int(out["occ"].long().sum()),
                    int(out["naccept"].sum()))
        print("AB", label, "wide", f"{chip_smoke.WIDE_CELL}@{steps}", ms, float("nan"),
              checksum, flush=True)


if __name__ == "__main__":
    main()
