"""Tracing and numerics debugging.

Port of `uncltmo_tpu/utils/profiling.py`.  The reference has no profiler
(only `time.time()` spans, `test_imageTMO.py:43,55`) and runs its steps
under `torch.autograd.detect_anomaly()` (`GanTrainer.py:179`).  Here:

  * `trace(name)` -- the program's one kind of span: a `record_function`
    range while a profiler records, on the clock of the device trace, and
    a shared no-op context otherwise (one read of the profiler's flag);
    `start_trace` / `stop_trace` / `traced_to` record the CPU and, on a
    card, CUDA activity of a block, spans included, into a Chrome trace;
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
from typing import Callable, Optional

import torch
import torch.autograd.profiler as _profiler

_active: dict = {}
_OFF = contextlib.nullcontext()


def trace(name: str):
    """A named span in the profiler's timeline: a `record_function` range
    (a `user_annotation` event) while a profiler records, else one shared
    no-op context, so that a span costs a flag read when nobody traces.
    The program's spans are named `uncltmo.<layer>.<part>` (README,
    "Tracing the program")."""
    if not _profiler._is_profiler_enabled:
        return _OFF
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
    """Trace the enclosed block to {log_dir}/trace.json (nothing when
    log_dir is falsy): the way to record the program's spans, which cost a
    flag read and record nothing outside a trace.  Open the trace in
    Perfetto or `chrome://tracing`; the spans are its `user_annotation`
    events."""
    if not log_dir:
        yield
        return
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()


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
