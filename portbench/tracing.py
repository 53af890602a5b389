"""Spans opened by the benchmark around calls into the program's layers, and
the reading of a torch.profiler trace.

`Spans` wraps functions and methods and hooks modules for the traced
stretch only: each call is timed on the host and enters a
`torch.profiler.record_function` range of the span's name, which the
profiler records on the calling thread.  `profile` runs a stretch under
the profiler (host and device activity) and returns a `Trace`: every
device operation with its interval and the benchmark spans open on the
launching thread when it was launched, the spans themselves, the host's
operations, and the traced window.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

from . import measure

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host intervals of named spans, and the records of hooked modules."""

    def __init__(self):
        self.host: List[tuple] = []          # (name, start_s, end_s)
        self.calls: Dict[str, list] = defaultdict(list)
        self._undo: List[Callable] = []
        self._open = threading.local()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.host.append((name, t0, time.perf_counter()))

    def wrap(self, owner, attr: str, name: str) -> None:
        """Route owner.attr through a span of `name` until `remove`."""
        original = getattr(owner, attr)
        own = attr in vars(owner)

        def wrapped(*args, **kwargs):
            with self.span(name):
                return original(*args, **kwargs)

        setattr(owner, attr, wrapped)
        self._undo.append(lambda: setattr(owner, attr, original) if own
                          else delattr(owner, attr))

    def hook(self, module: torch.nn.Module, name: str,
             record: Optional[Callable] = None) -> None:
        """A span of `name` around every call of `module`; `record(module,
        inputs, output)` is kept in `calls[name]` when given."""
        stack = self._open

        def pre(mod, inputs):
            ctx = self.span(name)
            ctx.__enter__()
            stack.__dict__.setdefault("ctx", []).append(ctx)

        def post(mod, inputs, output):
            stack.ctx.pop().__exit__(None, None, None)
            if record is not None:
                self.calls[name].append(record(mod, inputs, output))

        handles = [module.register_forward_pre_hook(pre),
                   module.register_forward_hook(post)]
        self._undo.append(lambda: [h.remove() for h in handles])

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()

    def host_ms(self, name: str) -> List[float]:
        return [1e3 * (e - s) for n, s, e in self.host if n == name]


class Trace:
    """The device operations of a traced stretch, in seconds of the
    trace's clock."""

    def __init__(self, events: list):
        by_corr = {}
        annotations = defaultdict(list)
        self.host_ops = defaultdict(list)
        self.window = None
        device = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            args = e.get("args") or {}
            start, end = e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6
            if cat in DEVICE_CATS:
                device.append((start, end, e.get("name", ""),
                               args.get("correlation")))
            elif cat in ("cuda_runtime", "cuda_driver"):
                if "correlation" in args:
                    by_corr[args["correlation"]] = (e["tid"], start)
            elif cat == "user_annotation":
                if e.get("name") == WINDOW:
                    self.window = (start, end)
                else:
                    annotations[e["tid"]].append((start, end, e["name"]))
            elif cat == "cpu_op":
                self.host_ops[e["tid"]].append((start, end, e["name"]))
        self.spans = {tid: sorted(v) for tid, v in annotations.items()}
        self._all_spans = sorted(x for v in annotations.values() for x in v)
        self._all_ops = sorted(x for v in self.host_ops.values() for x in v)
        self._edges = sorted({t for s, e, _ in self._all_spans
                              + self._all_ops for t in (s, e)})
        self.ops = []                  # (start, end, name, spans open)
        for start, end, name, corr in sorted(device):
            launch = by_corr.get(corr)
            names = self._open_at(*launch) if launch else ()
            self.ops.append((start, end, name, frozenset(names)))
        if self.window is None:
            raise ValueError(f"trace has no {WINDOW} span")

    def _open_at(self, tid, t: float):
        spans = self.spans.get(tid, [])
        i = bisect.bisect_right(spans, (t, float("inf"), ""))
        return [n for s, e, n in spans[:i] if e >= t]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def intervals(self, span: Optional[str] = None) -> list:
        return [(s, e) for s, e, _, names in self.ops
                if span is None or span in names]

    def device_s(self, span: Optional[str] = None) -> float:
        """Device time of the operations launched inside `span` (all of
        them when None), overlapping operations counted once."""
        return measure.busy_time(self.intervals(span), *self.window)

    @property
    def busy_s(self) -> float:
        return self.device_s()

    def top_ops(self, n: int = 10) -> list:
        total = defaultdict(float)
        for s, e, name, _ in self.ops:
            total[name[:160]] += e - s
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle stretches of the window, summed by what the host was doing
        in them: the innermost benchmark span and host operation open,
        stretch by stretch between their starts and ends."""
        total = defaultdict(float)
        for s, e in measure.gaps(self.intervals(), *self.window):
            lo = bisect.bisect_right(self._edges, s)
            hi = bisect.bisect_left(self._edges, e)
            cuts = [s] + self._edges[lo:hi] + [e]
            for a, b in zip(cuts, cuts[1:]):
                if b > a:
                    total[self._host_at((a + b) / 2)] += b - a
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda kv: -kv[1])[:n]

    def _host_at(self, t: float) -> str:
        span = _innermost(self._all_spans, t)
        op = _innermost(self._all_ops, t)
        return f"{span or 'outside spans'}/{op or 'no host op'}"


def _innermost(intervals: list, t: float):
    """The name of the latest-started interval still open at t."""
    i = bisect.bisect_right(intervals, (t, float("inf"), ""))
    for s, e, name in reversed(intervals[max(0, i - 2000):i]):
        if e >= t:
            return name
    return None


def profile(fn: Callable[[], None], cuda: bool = True) -> Trace:
    """Run fn once under torch.profiler (host and, with `cuda`, device
    activity) inside a window span that starts and ends with the device
    idle."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with torch_profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events)
