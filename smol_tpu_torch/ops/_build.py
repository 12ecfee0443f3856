"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, under
``build/smol_tpu_torch/`` at the repository root, and loaded with
``ctypes``.  The library's file name carries a hash of its source and of
the headers in ``csrc/``, so an edited source is rebuilt and a stale
library is never loaded.  Nothing is built or loaded when a module is
imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "KERNELS", "build_libraries", "load_chain"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "smol_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_ptr, _i32, _f64, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_float
# name -> argtypes of its entry point smol_<name>
KERNELS = {
    # occ enthalpy naccept beta seq | seq_stride | seed nbr stride d2 g mu
    # ncode ew_v ew_c qnbr qfreq qms qac qas qrows imask iamp irows | R L K
    # TM C W block_size n_steps rng_mode q Lq NB Li NW | stream
    "flip_chain": [_ptr] * 5 + [_i32] + [_ptr] * 18 + [_i32] * 14 + [_ptr],
    # occ enthalpy naccept nmove beta useq vseq | seq_stride | seed nbr
    # stride d2 g ew_v ew_c qnbr qfreq qms qac qas qrows imask iamp irows | R
    # L K TM W block_size n_steps rng_mode q Lq NB Li NW | stream
    "swap_chain": [_ptr] * 7 + [_i32] + [_ptr] * 16 + [_i32] * 13 + [_ptr],
    # occ enthalpy naccept beta dirs ranks | dir_stride rank_stride | seed nbr
    # stride d2 g mu move_rows ew_v ew_c | R L K TM C W block_size n_steps
    # rng_mode k_max n_rows | stream
    "table_chain": [_ptr] * 6 + [_i32] * 2 + [_ptr] * 9 + [_i32] * 11 + [_ptr],
    # occ enthalpy naccept entropy histogram occurrences mod_factor wl_counter
    # useq vseq | seq_stride | seed nbr stride d2 g mu ncode ew_v ew_c | R L K
    # TM C W block_size n_steps rng_mode move num_levels check_period
    # update_period | min_enthalpy bin_size span mod_divisor | flatness | stream
    "wl_chain": [_ptr] * 10 + [_i32] + [_ptr] * 9 + [_i32] * 13 + [_f64] * 4
                + [_f32] + [_ptr],
    # occ best_occ feat d best_d naccept beta useq vseq | seq_stride | seed nbr
    # stride d2 g seg target weight group_last group_diameter | R L K TM F W
    # block_size n_steps rng_mode | match_tol match_weight | stream
    "distance_chain": [_ptr] * 9 + [_i32] + [_ptr] * 10 + [_i32] * 9 + [_f64] * 2
                      + [_ptr],
    # beta beta32 enthalpy uniforms accepted | W phase | stream
    "tempering": [_ptr] * 5 + [_i32] * 2 + [_ptr],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    for root in (CUDA_HOME, "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build")


def _library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build_libraries(names) -> dict:
    """Compile ``csrc/<name>.cu`` for each name, all nvcc runs at once.

    Returns ``{name: (library path, nvcc log, seconds)}``; the seconds are
    0 and the log empty for a library already built from the same sources.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results, running = {}, {}
    start = time.perf_counter()
    for name in names:
        lib = _library_path(name)
        if lib.exists():
            results[name] = (lib, "", 0.0)
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        source = CSRC_DIR / f"{name}.cu"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running[name] = (proc, lib, tmp, source)
    failures = []
    for name, (proc, lib, tmp, source) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {source} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        results[name] = (lib, log, time.perf_counter() - start)
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


@functools.lru_cache(maxsize=None)
def load_chain(name: str) -> ctypes.CDLL:
    """The library of kernel ``name`` (built on first call), with signatures."""
    (path, _, _), = build_libraries([name]).values()
    lib = ctypes.CDLL(str(path))
    entry = getattr(lib, f"smol_{name}")
    entry.argtypes = KERNELS[name]
    entry.restype = _i32
    lib.smol_cuda_error_string.argtypes = [_i32]
    lib.smol_cuda_error_string.restype = ctypes.c_char_p
    return lib
