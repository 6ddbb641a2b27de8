"""Lazy build of the port's CUDA C++ kernels into ``build/iaf_torch/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared
library loaded through ``ctypes``; nothing is built at import, so the
package imports on a machine without ``nvcc``. A library is rebuilt when
its source, or a header ``csrc/*.cuh`` it may include, is newer. Each
source has its own lock, so several sources can build at once from
several threads.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "iaf_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}
_locks: dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()
build_log: dict[str, str] = {}   # nvcc's output (ptxas register report)
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of iaf_torch are "
                       "built at first use and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """The library is missing or older than its source or a shared
    header (every source may include ``csrc/*.cuh``)."""
    lib = _lib_path(name)
    if not lib.is_file():
        return True
    srcs = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in srcs)


def _compile(name: str) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    build_log[name] = proc.stdout
    build_seconds[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, _lib_path(name))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if _stale(name):
            _compile(name)
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
        return lib
