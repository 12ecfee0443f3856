"""Split the port's Ewald matrices into their steps, to compare two hosts.

The Ewald matrix that ``smol_tpu_torch.crystal.ewald.EwaldSummation`` builds
goes through several host libraries: numpy's matrix products (BLAS) and its
``exp``, and ``std::erfc`` of the C library in the real-space sums of
``csrc/host_ewald.cpp``.  This script recomputes every intermediate array of
bench ``spinel-ewald``'s 2x2x2 and 3x3x3 supercells step by step (and checks
that the steps give ``EwaldSummation``'s matrices bit for bit), holds the
total to the committed ``tests/data/torch_spinel_ewald_{n}.npz``, and:

- with ``--save FILE`` writes every intermediate array to ``FILE``;
- with ``--against FILE`` (a file that ``--save`` wrote on another host)
  prints, for each step, the largest difference between this host's array
  and the other's, and the largest difference when this host repeats the
  step alone on the other host's inputs.  A step whose isolated repeat
  differs is where the two hosts round otherwise.

Run it on each host:

    python scripts/ewald_host_terms.py --save build/ewald_terms_a.npz
    python scripts/ewald_host_terms.py --against build/ewald_terms_a.npz
"""

from __future__ import annotations

import argparse
import platform
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from smol_tpu_torch.benchmarks.systems import spinel_prim  # noqa: E402
from smol_tpu_torch.cofe.extern.ewald import EwaldTerm  # noqa: E402
from smol_tpu_torch.crystal.ewald import CONV_FACT, EwaldSummation  # noqa: E402
from smol_tpu_torch.ops._build import HOST_FLAGS, host_ewald_real_sums  # noqa: E402

SIZES = (2, 3)


def _recip_steps(s: EwaldSummation, coords) -> dict:
    """The steps of ``EwaldSummation._calc_recip``, in its arithmetic."""
    lattice = s._structure.lattice
    recip = lattice.reciprocal_lattice.matrix
    ginv = np.linalg.inv(recip @ recip.T)
    bounds = np.ceil(s._gmax * np.sqrt(np.diag(ginv))).astype(int)
    ranges = [np.arange(-b, b + 1) for b in bounds]
    hkl = np.stack(np.meshgrid(*ranges, indexing="ij"), axis=-1).reshape(-1, 3)
    gs = hkl @ recip
    g2 = np.sum(gs * gs, axis=1)
    mask = (g2 > 1e-12) & (g2 < s._gmax**2)
    gs, g2 = gs[mask], g2[mask]
    return {"recip_lattice": recip, "gs": gs, "g2": g2}


def _weights(g2, eta):
    return np.exp(-g2 / (4 * eta)) / g2


def _arg(gs, coords):
    return gs @ coords.T


def _phases(arg):
    return np.exp(1j * arg)


def _m(phases, weights):
    return np.real(phases.T.conj() @ (weights[:, None] * phases))


def _images(s: EwaldSummation):
    lattice = s._structure.lattice
    ginv = np.linalg.inv(lattice.metric_tensor)
    spans = np.ceil(s._rmax * np.sqrt(np.diag(ginv))).astype(int) + 1
    ranges = [np.arange(-sp, sp + 1) for sp in spans]
    images = np.stack(np.meshgrid(*ranges, indexing="ij"), axis=-1).reshape(-1, 3)
    return images @ lattice.matrix


def steps(n: int) -> dict:
    """Every intermediate array of the Ewald matrix of the n x n x n spinel."""
    supercell = spinel_prim().make_supercell(np.diag([n, n, n]))
    structure, _ = EwaldTerm.get_ewald_structure(supercell)
    s = EwaldSummation(structure)
    out = {"eta": np.float64(s._eta), "sqrt_eta": np.float64(s._sqrt_eta),
           "rmax": np.float64(s._rmax), "gmax": np.float64(s._gmax),
           "coords": np.asarray(s._coords, dtype=np.float64), "charges": s._charges}
    out.update(_recip_steps(s, out["coords"]))
    out["weights"] = _weights(out["g2"], s._eta)
    out["arg"] = _arg(out["gs"], out["coords"])
    out["phases"] = _phases(out["arg"])
    out["m"] = _m(out["phases"], out["weights"])
    qq = np.outer(s._charges, s._charges)
    vol = s._structure.lattice.volume
    out["recip"] = CONV_FACT * (2 * np.pi / vol) * out["m"] * qq
    out["img_cart"] = _images(s)
    out["sums"] = host_ewald_real_sums(out["coords"], out["img_cart"], s._sqrt_eta, s._rmax)
    out["real"] = 0.5 * CONV_FACT * qq * out["sums"]
    out["point"] = np.asarray(s._point)
    out["total"] = s.total_energy_matrix
    for key, got in (("recip", s.reciprocal_space_energy_matrix),
                     ("real", s.real_space_energy_matrix)):
        if not np.array_equal(out[key], got):
            raise SystemExit(f"{n}x{n}x{n}: the steps' {key} is not EwaldSummation's")
    return out


def _diff(a, b) -> str:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return f"shapes {a.shape} and {b.shape}"
    if np.array_equal(a, b):
        return "equal bit for bit"
    d = np.abs(a - b)
    k = int(np.argmax(d))
    scale = float(np.abs(b).max()) or 1.0
    return (f"{int((a != b).sum())} of {a.size} differ, max |diff| {float(d.flat[k]):.3e} "
            f"({float(d.flat[k]) / scale:.3e} of max |value|)")


def isolated(mine: dict, theirs: dict) -> dict:
    """Each step repeated here on the other host's inputs to that step."""
    return {
        "weights": _weights(theirs["g2"], theirs["eta"]),
        "arg": _arg(theirs["gs"], theirs["coords"]),
        "phases": _phases(theirs["arg"]),
        "m": _m(theirs["phases"], theirs["weights"]),
        "sums": host_ewald_real_sums(theirs["coords"], theirs["img_cart"],
                                     float(theirs["sqrt_eta"]), float(theirs["rmax"])),
    }


def host_text() -> str:
    try:
        gxx = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True).stdout.splitlines()[0]
    except (OSError, IndexError):
        gxx = "g++ not found"
    cpu = platform.machine()
    try:
        cpu = next(line.split(":", 1)[1].strip() for line in open("/proc/cpuinfo")
                   if line.startswith("model name"))
    except (OSError, StopIteration):
        pass
    return (f"host: {cpu}, "
            f"{platform.libc_ver()[0]} {platform.libc_ver()[1]}, numpy {np.__version__}, "
            f"{gxx}, host flags {' '.join(HOST_FLAGS)}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--save", type=Path)
    parser.add_argument("--against", type=Path)
    args = parser.parse_args()
    print(host_text())
    saved, other = {}, np.load(args.against) if args.against else None
    for n in SIZES:
        mine = steps(n)
        stem = f"spinel_ewald_{n}x{n}x{n}"
        committed = np.load(ROOT / "tests" / "data" / f"torch_{stem}.npz")["ewald_matrix"]
        print(f"{stem}: total against the committed ewald_matrix: "
              f"{_diff(mine['total'], committed)}")
        saved.update({f"{stem}/{k}": v for k, v in mine.items()})
        if other is None:
            continue
        theirs = {k: other[f"{stem}/{k}"] for k in mine}
        alone = isolated(mine, theirs)
        for key in mine:
            text = f"{stem} {key}: against the other host's: {_diff(mine[key], theirs[key])}"
            if key in alone:
                text += f"; this step alone on its inputs: {_diff(alone[key], theirs[key])}"
            print(text)
    if args.save:
        args.save.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(args.save, **saved)
        print(f"wrote {args.save}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
