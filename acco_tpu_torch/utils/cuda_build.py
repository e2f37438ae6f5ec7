"""Build a CUDA source of this package into a shared library and load it.

Each kernel source under ``acco_tpu_torch/csrc/`` exposes a plain C
interface. It is compiled with ``nvcc`` for Hopper (``sm_90a``) at first
use into ``build/`` at the root of the checkout and loaded with
``ctypes``. The library's file name carries a hash of the source, the
shared headers of ``csrc/`` and the flags, so an edited source is
rebuilt and never confused with an old build. Nothing here runs at
import time: the CPU tests import every module on a machine without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# name -> {"path", "seconds", "log", "cached"}: what the last build of each
# library did (``log`` holds nvcc's and ptxas's output: registers, spills;
# ``cached``: the library was already in ``build/``, nothing ran).
BUILD_INFO: dict[str, dict] = {}
_LOADED: dict[str, ctypes.CDLL] = {}
# one build of a library at a time (the compile warmup's threads and a
# first use may ask for the same one)
_LOCKS: dict[str, threading.Lock] = {}
_LOCKS_GUARD = threading.Lock()


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from the toolkit at $CUDA_HOME (by
    convention /usr/local/cuda)."""
    nvcc = shutil.which("nvcc")
    fallback = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if nvcc is None and os.path.exists(fallback):
        nvcc = fallback
    if nvcc is None:
        raise RuntimeError(
            f"nvcc not found (PATH, {fallback}): the CUDA kernels of "
            "acco_tpu_torch are built at first use and need the CUDA toolkit"
        )
    return nvcc


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source (and
    of the headers beside it) exists (the key: ``compile.cache.library_key``)."""
    from acco_tpu_torch.compile.cache import library_key

    with _LOCKS_GUARD:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        return _build(name, library_key(name))


def _build(name: str, digest: str) -> Path:
    source = PACKAGE_DIR / "csrc" / f"{name}.cu"
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        BUILD_INFO.setdefault(name, {"path": str(out), "seconds": 0.0, "log": "",
                                     "cached": True})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    BUILD_INFO[name] = {
        "path": str(out), "seconds": seconds, "log": proc.stdout + proc.stderr,
        "cached": False,
    }
    return out


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first call.
    ``signatures`` maps each C function to its ctypes argtypes; every one
    returns an int (a cudaError_t)."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[name] = lib
    return lib
