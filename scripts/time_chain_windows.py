"""Time the swap and table chain windows of one checkout on one GPU.

For an A/B of two versions of a kernel on the same card, one after the other:
unpack the other version beside this one (``git archive <commit> | tar -x
-C build/parent``) and run, in turns,

    python scripts/time_chain_windows.py parent build/parent
    python scripts/time_chain_windows.py change
    python scripts/time_chain_windows.py change
    python scripts/time_chain_windows.py parent build/parent

Each run builds the named checkout's kernels (default: the checkout this
script lies in) and times ``chip_smoke.time_window`` of that checkout: one
100-step window at 8192 walkers on the spinel CE + Ewald cells, canonical
swaps and charge-neutral table flips, with and without the Ewald term,
and, where the checkout has them, the two Wang-Landau cells (flips on
Au-Cu 3x3x3, swaps on Au-Cu 4x4x4, each in its main path's sequence block;
``chip_smoke.time_wl_window``).
Prints the card's name and power limit and one ``AB`` line per cell:
label, move, cell, kernel ms, kernel ms without the Ewald term (``nan``
for a cell without one).
"""

from __future__ import annotations

import os
import sys
from pathlib import Path


def main():
    label = sys.argv[1]
    tree = Path(sys.argv[2] if len(sys.argv) > 2 else Path(__file__).parent.parent)
    tree = tree.resolve()
    os.chdir(tree)
    sys.path.insert(0, str(tree))
    import chip_smoke  # the named checkout's

    card = chip_smoke.card_line()
    print(card)
    wl_cells = getattr(chip_smoke, "WL_CELLS", {})  # absent before the WL slice
    chip_smoke._build.build_libraries(
        ("swap_chain", "table_chain") + (("wl_chain",) if wl_cells else ()))
    cells = [("table", stem) for stem in chip_smoke.TABLE_CELLS]
    cells += [("swap", stem) for stem in chip_smoke.SWAP_CELLS if "ewald" in stem]
    for move, stem in cells:
        ensemble = chip_smoke.load(stem)[0]
        t = chip_smoke.time_window(ensemble, stem, card, move, chip_smoke.BLOCK,
                                   twin_reps=1)
        print("AB", label, move, stem, t["kernel_ms"], t["kernel_no_ewald_ms"],
              flush=True)
    for stem, move in wl_cells.items():
        block = chip_smoke.SWAP_CELLS.get(stem, (None, chip_smoke.BLOCK))[1]
        t = chip_smoke.time_wl_window(*chip_smoke.load(stem), stem, card, move,
                                      chip_smoke.WALKERS, block)
        print("AB", label, f"wl-{move}", stem, t["kernel_ms"], float("nan"), flush=True)


if __name__ == "__main__":
    main()
