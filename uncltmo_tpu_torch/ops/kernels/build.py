"""Builds the CUDA C++ kernels of `csrc/` with nvcc for `sm_90a`, loads them
with ctypes and calls them.

Each source is one library with a plain C interface (no PyTorch headers),
so a build takes seconds, and builds started from several threads run side
by side.  Its headers are `csrc/`'s (`-I`, also for a copy of a source kept
elsewhere).  Libraries go to `uncltmo_tpu_torch/.build/` (git-ignored),
named by a hash of the source, the headers it includes and the flags: a
changed file rebuilds, an unchanged one loads at once.  A failed build
raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)

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


def source_files(source: str) -> dict:
    """{path: contents} of `csrc/<source>` and of every header of `csrc/` it
    includes (`#include "..."`), directly or through another header."""
    files: dict = {}
    todo = [os.path.join(CSRC, source)]
    while todo:
        path = todo.pop(0)
        if path not in files:
            with open(path, "rb") as f:
                files[path] = f.read()
            todo += [os.path.join(CSRC, name.decode())
                     for name in _INCLUDE.findall(files[path])]
    return files


def library_path(source: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path, text in source_files(source).items():
        digest.update(os.path.basename(path).encode() + b"\0" + text)
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def compile_source(source: str) -> str:
    """nvcc `csrc/<source>` into the build directory (if not there yet) and
    return the library's path.  Safe to call from several threads and
    processes: the library is written under a temporary name and renamed
    into place."""
    out = library_path(source)
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
            [nvcc_path(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
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


def load_library(source: str) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<source>`'s library, built on first use
    (outside the lock, so that two libraries build at once)."""
    with _lock:
        if source in _loaded:
            return _loaded[source]
    path = compile_source(source)
    with _lock:
        if source not in _loaded:
            _loaded[source] = ctypes.CDLL(path)
        return _loaded[source]


def _c_type(arg):
    if hasattr(arg, "data_ptr"):
        return ctypes.c_void_p
    if isinstance(arg, float):
        return ctypes.c_float
    if isinstance(arg, int):
        return ctypes.c_int
    return type(arg)


def call(lib: ctypes.CDLL, name: str, *args, on=None) -> None:
    """Call `lib`'s entry point `name`, which returns a cudaError_t, and raise
    with the library's error string unless it is 0.  Its argument types are
    set at the first call: a tensor is its data pointer, a float a C float,
    an int a C int, a ctypes array itself.  With `on`, a CUDA tensor, the
    call launches on its card: with that card current (a launch and its
    shared-memory attribute go to the current card) and its current stream
    as the last argument."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = ([_c_type(a) for a in args]
                       + [ctypes.c_void_p] * (on is not None))
        fn.restype = ctypes.c_int
    c_args = [a.data_ptr() if hasattr(a, "data_ptr") else a for a in args]
    if on is None:
        err = fn(*c_args)
    else:
        import torch    # here: chip_smoke.py starts nvcc before torch loads
        with torch.cuda.device(on.device):
            err = fn(*c_args, torch.cuda.current_stream(on.device).cuda_stream)
    if err != 0:
        text = lib.uncltmo_cuda_error_string
        text.argtypes, text.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{name} failed: {text(err).decode()}")
