"""Build and load the port's CUDA kernels and its host library.

Each ``csrc/<name>.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, under
``build/smol_tpu_torch/`` at the repository root, and loaded with
``ctypes``.  The library's file name carries a hash of its source and of
the headers in ``csrc/``, so an edited source is rebuilt and a stale
library is never loaded.  Nothing is built or loaded when a module is
imported.

The host library ``csrc/host_ewald.cpp`` (the real-space Ewald sums of
:class:`smol_tpu_torch.crystal.ewald.EwaldSummation`) is compiled the same
way by ``g++`` (:func:`load_host_ewald`), with :data:`HOST_FLAGS`.  Every
build writes a private file and renames it into place, so a process never
loads another's half-written library; a failed build raises.
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

import numpy as np

__all__ = ["BUILD_DIR", "CSRC_DIR", "ENTRIES", "HOST_FLAGS", "KERNELS", "build_libraries",
           "host_ewald_real_sums", "load_chain", "load_host_ewald"]

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
    # TM C W block_size n_steps rng_mode q Lq NB Li NW lanes walkers_per_block
    # resident | stream
    "flip_chain": [_ptr] * 5 + [_i32] + [_ptr] * 18 + [_i32] * 17 + [_ptr],
    # occ enthalpy naccept nmove beta useq vseq | seq_stride | seed nbr
    # stride d2 g ew_v ew_c qnbr qfreq qms qac qas qrows imask iamp irows | R
    # L K TM W block_size n_steps rng_mode q Lq NB Li NW lanes
    # walkers_per_block resident | stream
    "swap_chain": [_ptr] * 7 + [_i32] + [_ptr] * 16 + [_i32] * 16 + [_ptr],
    # occ enthalpy naccept beta dirs ranks | dir_stride rank_stride | seed nbr
    # stride d2 g mu move_rows ew_v ew_c qnbr qfreq qms qac qas qrows imask
    # iamp irows | R L K TM C W block_size n_steps rng_mode k_max n_rows q Lq
    # NB Li NW lanes walkers_per_block resident | stream
    "table_chain": [_ptr] * 6 + [_i32] * 2 + [_ptr] * 18 + [_i32] * 19 + [_ptr],
    # occ enthalpy naccept entropy histogram occurrences mod_factor wl_counter
    # useq vseq | seq_stride | seed nbr stride d2 g mu ncode ew_v ew_c qnbr
    # qfreq qms qac qas qrows imask iamp irows | R L K TM C W block_size
    # n_steps rng_mode move num_levels check_period update_period q Lq NB Li
    # NW lanes walkers_per_block resident planes | min_enthalpy bin_size span
    # mod_divisor | flatness | stream
    "wl_chain": [_ptr] * 10 + [_i32] + [_ptr] * 18 + [_i32] * 22 + [_f64] * 4
                + [_f32] + [_ptr],
    # occ best_occ feat d best_d naccept beta useq vseq | seq_stride
    # seq_shape_stride | seed nbr stride d2 g seg target weight group_last
    # group_diameter match meta | S R L K TM F W block_size n_steps rng_mode
    # lanes walkers_per_block resident packed wide stage_bytes | stream
    "distance_chain": [_ptr] * 9 + [_i32] * 2 + [_ptr] * 12 + [_i32] * 16 + [_ptr],
    # beta beta32 enthalpy uniforms accepted | W phase | stream
    "tempering": [_ptr] * 5 + [_i32] * 2 + [_ptr],
}
# name -> {further entry point of its library: argtypes}
ENTRIES = {
    "flip_chain": {
        # smol_flip_chain's operands but the stream | beta64 snap uniforms
        # accepted | seq_segment | n_segments phase0 | stream
        "smol_flip_window": KERNELS["flip_chain"][:-1] + [_ptr] * 4 + [ctypes.c_int64]
                            + [_i32] * 2 + [_ptr],
        # q NW ewald K NB threads smem | out
        "smol_flip_window_blocks_per_sm": [_i32] * 7 + [_ptr],
    },
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
    for entry_name, argtypes in {f"smol_{name}": KERNELS[name],
                                 **ENTRIES.get(name, {})}.items():
        entry = getattr(lib, entry_name)
        entry.argtypes = argtypes
        entry.restype = _i32
    lib.smol_cuda_error_string.argtypes = [_i32]
    lib.smol_cuda_error_string.restype = ctypes.c_char_p
    return lib


# g++ flags of the host library: no -march=native and no contraction into
# fused multiply-adds beyond the two the source writes out, so the sums do
# not depend on whether the CPU has FMA or how the compiler contracts
# (csrc/host_ewald.cpp)
HOST_FLAGS = ("-O2", "-ffp-contract=off", "-fopenmp", "-shared", "-fPIC")


@functools.lru_cache(maxsize=None)
def load_host_ewald() -> ctypes.CDLL:
    """The host Ewald library (built with ``g++`` on first call), or raise
    ``RuntimeError`` where it cannot build or load."""
    source = CSRC_DIR / "host_ewald.cpp"
    digest = hashlib.sha1(source.read_bytes() + " ".join(HOST_FLAGS).encode())
    lib = BUILD_DIR / f"libhost_ewald_{digest.hexdigest()[:12]}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("g++ not found: the host Ewald library needs it")
        proc = subprocess.run([cxx, *HOST_FLAGS, str(source), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {source} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    try:
        handle = ctypes.CDLL(str(lib))
    except OSError as err:
        raise RuntimeError(f"cannot load the host Ewald library {lib}: {err}") from err
    entry = handle.smol_host_ewald_real_sums
    entry.argtypes = [_ptr, ctypes.c_int64, _ptr, ctypes.c_int64, _f64, _f64, _ptr]
    entry.restype = None
    return handle


def host_ewald_real_sums(coords, img_cart, sqrt_eta: float, rmax: float):
    """[n, n] f64: for each site pair, the sum over the periodic images of
    erfc(sqrt_eta r) / r for 0 < r <= rmax, in image order (``csrc/
    host_ewald.cpp``); coincident pairs are skipped."""
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    img = np.ascontiguousarray(img_cart, dtype=np.float64)
    n = len(coords)
    out = np.zeros((n, n), dtype=np.float64)
    load_host_ewald().smol_host_ewald_real_sums(
        coords.ctypes.data, n, img.ctypes.data, len(img), float(sqrt_eta),
        float(rmax), out.ctypes.data)
    return out
