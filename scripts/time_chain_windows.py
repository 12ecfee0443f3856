"""Time the flip, swap, table, Wang-Landau and distance chains of one checkout on one GPU.

For an A/B of two versions of a kernel on the same card, one after the other:
unpack the other version beside this one (``git archive <commit> | tar -x
-C build/parent``) and run, in turns,

    python scripts/time_chain_windows.py parent build/parent
    python scripts/time_chain_windows.py change
    python scripts/time_chain_windows.py change
    python scripts/time_chain_windows.py parent build/parent

Each run builds the named checkout's kernels (default: the checkout this
script lies in) and times ``chip_smoke.time_window`` of that checkout: one
100-step window at 8192 walkers on the semigrand spinel cells (flips), on
the canonical cells (swaps, the spinel CE + Ewald with and without the
Ewald term, and Au-Cu) and on the charge-neutral table-flip cells (with
and without the Ewald term), and, where the checkout has them, the two
Wang-Landau cells (flips on
Au-Cu 3x3x3, swaps on Au-Cu 4x4x4, each in its main path's sequence block;
``chip_smoke.time_wl_window``) and the distance chain on the SQS main
path's launch (8000 steps at 2048 walkers on the bench's first 8-site
shape and on the 64-site shape, mean of 5, each on a copy of one starting
state), and, where the checkout has them, the flip and swap cells of
K1-Ising (``chip_smoke.ISING_CELLS``) with the Ising body.  Further
arguments after the tree name the kinds to time (``flip``, ``swap``,
``table``, ``wl``, ``distance``, ``ising``; all without).
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
    kinds = set(sys.argv[3:]) or {"flip", "swap", "table", "wl", "distance", "ising"}
    tree = tree.resolve()
    os.chdir(tree)
    sys.path.insert(0, str(tree))
    import chip_smoke  # the named checkout's

    card = chip_smoke.card_line()
    print(card)
    wl_cells = getattr(chip_smoke, "WL_CELLS", {}) if "wl" in kinds else {}
    sqs_cells = getattr(chip_smoke, "SQS_CELLS", ()) if "distance" in kinds else ()
    ising_cells = getattr(chip_smoke, "ISING_CELLS", {}) if "ising" in kinds else {}
    chip_smoke._build.build_libraries(
        tuple(name for name, on in (("flip_chain", "flip" in kinds or bool(ising_cells)),
                                    ("swap_chain", "swap" in kinds or bool(ising_cells)),
                                    ("table_chain", "table" in kinds),
                                    ("wl_chain", bool(wl_cells)),
                                    ("distance_chain", bool(sqs_cells))) if on))
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
    for (stem, move), (block, temperature) in ising_cells.items():
        ensemble = chip_smoke.load(stem)[0]
        t = chip_smoke.time_window(ensemble, stem, card, move, block, twin_reps=0,
                                   delta="ising", temperature=temperature)
        print("AB", label, f"{move}+ising", stem, t["kernel_ms"], float("nan"), flush=True)
    for stem, move in wl_cells.items():
        block = chip_smoke.SWAP_CELLS.get(stem, (None, chip_smoke.BLOCK))[1]
        t = chip_smoke.time_wl_window(*chip_smoke.load(stem), stem, card, move,
                                      chip_smoke.WALKERS, block)
        print("AB", label, f"wl-{move}", stem, t["kernel_ms"], float("nan"), flush=True)
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


if __name__ == "__main__":
    main()
