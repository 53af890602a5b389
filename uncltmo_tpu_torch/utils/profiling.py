"""Tracing, timing and numerics debugging.

Port of `uncltmo_tpu/utils/profiling.py`.  The reference has no profiler
(only `time.time()` spans, `test_imageTMO.py:43,55`) and runs its steps
under `torch.autograd.detect_anomaly()` (`GanTrainer.py:179`).  Here:

  * `trace(name)` -- a named span of `torch.profiler` (`record_function`);
    `start_trace` / `stop_trace` / `traced_to` record the CPU and, on a
    card, CUDA activity of a block into a Chrome trace;
  * `timed(fn)` -- mean seconds per call: CUDA events when the call returns
    CUDA tensors, `perf_counter` otherwise;
  * `enable_anomaly_detection()` -- `torch.autograd.set_detect_anomaly`
    (what `opt.debug_nans` turns on);
  * `checked(fn)` -- raises when the call returns a non-finite value.

The JAX package's `utils/bootstrap.py` (XLA's persistent compile cache) has
no counterpart: eager PyTorch compiles nothing ahead of a call, and the
kernels keep their own caches (Triton's, and `ops/kernels/build.py`'s).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, List, Optional

import torch

_active: dict = {}


def trace(name: str):
    """A named span in the profiler's timeline."""
    return torch.profiler.record_function(name)


def start_trace(log_dir: str) -> None:
    """Start recording CPU and (when a card is present) CUDA activity; the
    trace lands in {log_dir}/trace.json at `stop_trace`."""
    if _active:
        raise RuntimeError("a trace is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    _active.update(prof=prof, log_dir=log_dir)


def stop_trace() -> str:
    """Stop the running trace and write it; returns the file's path."""
    prof, log_dir = _active.pop("prof"), _active.pop("log_dir")
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def traced_to(log_dir: Optional[str]):
    """Trace the enclosed block to log_dir (nothing when log_dir is
    falsy)."""
    if not log_dir:
        yield
        return
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()


def _cuda_tensors(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out] if out.is_cuda else []
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _cuda_tensors(o)]
    return []


def timed(fn: Callable, *args, warmup: int = 1, iters: int = 10,
          **kwargs) -> float:
    """Mean seconds per call, after `warmup` calls.  When the call returns
    CUDA tensors, CUDA events on the current stream time it (the card's
    time, to the end of the last call's work); otherwise `perf_counter`."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    if out is None:
        out = fn(*args, **kwargs)
    if _cuda_tensors(out):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args, **kwargs)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    return (time.perf_counter() - t0) / iters


def enable_anomaly_detection(enable: bool = True) -> None:
    """Autograd's anomaly detection: a backward that produces NaN raises
    with the forward operation that caused it."""
    torch.autograd.set_detect_anomaly(enable)


def _non_finite(out, where: str = "output") -> Optional[str]:
    if isinstance(out, torch.Tensor):
        if out.is_floating_point() and not bool(torch.isfinite(out).all()):
            return where
        return None
    if isinstance(out, dict):
        out = [(f"{where}[{k!r}]", v) for k, v in out.items()]
    elif isinstance(out, (list, tuple)):
        out = [(f"{where}[{i}]", v) for i, v in enumerate(out)]
    else:
        return None
    for w, v in out:
        bad = _non_finite(v, w)
        if bad:
            return bad
    return None


def checked(fn: Callable) -> Callable:
    """`fn` that raises FloatingPointError when a floating tensor it
    returns holds a NaN or an infinity."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        bad = _non_finite(out)
        if bad:
            raise FloatingPointError(
                f"{getattr(fn, '__name__', 'fn')}: non-finite value in {bad}")
        return out

    return wrapper
