"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, under
``build/smol_tpu_torch/`` at the repository root, and loaded with
``ctypes``.  The library's file name carries a hash of its source, so an
edited source is rebuilt and a stale library is never loaded.  Nothing is
built or loaded when a module is imported.
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

__all__ = ["BUILD_DIR", "CSRC_DIR", "build_library", "load_flip_chain"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "smol_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    for root in (CUDA_HOME, "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build")


def build_library(name: str) -> tuple[Path, str, float]:
    """Compile ``csrc/<name>.cu``; return (library path, nvcc log, seconds).

    The seconds are 0 and the log empty when the library was already built
    from the same source.
    """
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha1(source.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    start = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True, check=False,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr, time.perf_counter() - start


@functools.lru_cache(maxsize=None)
def load_flip_chain() -> ctypes.CDLL:
    """The flip-chain library (built on first call), with its signatures."""
    path, _, _ = build_library("flip_chain")
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.smol_flip_chain.argtypes = (
        [ptr] * 5 + [i32, ptr] + [ptr] * 6 + [i32] * 9 + [ptr]
    )
    lib.smol_flip_chain.restype = i32
    lib.smol_cuda_error_string.argtypes = [i32]
    lib.smol_cuda_error_string.restype = ctypes.c_char_p
    return lib
