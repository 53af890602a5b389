"""Builds the CUDA C++ kernels of `csrc/` with nvcc for `sm_90a` and loads
them with ctypes.

Each source has a plain C interface (no PyTorch headers), so a build takes
seconds; a source may be built more than once with different `-D` defines
(K2: one library per element type), each its own library, and builds
started from several threads run side by side.  Libraries go to
`uncltmo_tpu_torch/.build/` (git-ignored), named by a hash of the source,
flags and defines: a changed source rebuilds, an unchanged one loads at
once.  A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}
# per library file name: {"seconds": build time (0 when loaded from
# .build), "log": nvcc's and ptxas' output}
build_info: dict = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "uncltmo_tpu_torch are built from source at first use")


def library_path(source: str, defines: tuple = ()) -> str:
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS
                                                    + defines).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def compile_source(source: str, defines: tuple = ()) -> str:
    """nvcc `csrc/<source>` with `defines` into the build directory (if not
    there yet) and return the library's path.  Safe to call from several
    threads and processes: the library is written under a temporary name
    and renamed into place."""
    out = library_path(source, defines)
    name = os.path.basename(out)
    if os.path.exists(out):
        build_info.setdefault(name, {"seconds": 0.0, "log": "cached"})
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, *defines, "-o", tmp,
             os.path.join(CSRC, source)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} "
                               f"(rc={proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_info[name] = {"seconds": time.perf_counter() - t0,
                        "log": proc.stdout + proc.stderr}
    return out


def load_library(source: str, defines: tuple = ()) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<source>` built with `defines`, built on
    first use (outside the lock, so that two libraries build at once)."""
    key = (source, tuple(defines))
    with _lock:
        if key in _loaded:
            return _loaded[key]
    path = compile_source(source, tuple(defines))
    with _lock:
        if key not in _loaded:
            _loaded[key] = ctypes.CDLL(path)
        return _loaded[key]
