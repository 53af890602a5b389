"""One run of one benchmark cell, found by name.

`BENCHMARK.json` (at the root of the checkout) names the cell's
configuration and traffic mix; the configuration is the JSON file it
names, the traffic mix is `portbench/traffic/<traffic>.json`, whose
`driver` is `portbench/drivers/<driver>.py`, and every metric is read by
`portbench/metrics/<metric>.py`.  A run:

1. builds the cell and warms up its own shapes (`setup_s` ends at the
   first timed item);
2. measures for `--seconds` (the driver's window);
3. with `--trace 1`, runs a short stretch more under the profiler, with
   the benchmark's spans installed;
4. reads the device's peak memory, refuses to report if JAX or the JAX
   package was loaded, frees the program's state;
5. compares what the window delivered with the plain reference;
6. prints the numbers compared with their limits on standard error, and
   the result as one JSON line last on standard output.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "uncltmo_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: Any
    metrics: List[dict]          # BENCHMARK.json entries, this run's kind


@dataclass
class Check:
    """One number compared with the reference, and its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Window:
    """What the measured window did: its bounds on the host clock, the
    items completed (frames, files or steps) and each item's latency."""
    start: float
    end: float
    items: int
    latencies_s: List[float] = field(default_factory=list)
    tiles: int = 0               # generator tiles run, for `mfu.serve`

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Run:
    """Everything a metric reader may read."""
    cell: Cell
    setup_s: float
    window: Window
    trace: Any = None            # trace.Trace of the traced stretch
    spans: Any = None            # trace.Spans of the traced stretch
    traced_items: int = 0        # frames or steps in the traced stretch
    driver: Any = None           # the cell's driver, for what it counts


def cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout, set
    before anything imports Triton; Flax and JAX stay out of any library
    that offers them."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(HERE, ".cache", "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read_json(path: str, what: str) -> dict:
    if not os.path.exists(path):
        raise ValueError(f"{what}: no file {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def resolve(workload: str, traced: bool, root: str = ROOT,
            bench: Optional[dict] = None) -> Cell:
    """The cell named `workload`, with its configuration, traffic mix,
    driver and this run's metrics; refuses by name whatever is missing.
    `bench` is root's BENCHMARK.json unless given."""
    bench = bench or _read_json(os.path.join(root, "BENCHMARK.json"),
                                "benchmark")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise ValueError(f"unknown workload {workload!r}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise ValueError(f"workload {workload!r}: unknown config "
                         f"{w['config']!r}")
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]),
                        f"config {w['config']!r}")
    bench_dir = os.path.join(root, "portbench")
    traffic = _read_json(os.path.join(bench_dir, "traffic",
                                      w["traffic"] + ".json"),
                         f"traffic {w['traffic']!r}")
    drv_path = os.path.join(bench_dir, "drivers", traffic["driver"] + ".py")
    if not os.path.exists(drv_path):
        raise ValueError(f"traffic {w['traffic']!r}: unknown driver "
                         f"{traffic['driver']!r}")
    driver = load_module(drv_path, "portbench_driver_" + traffic["driver"])
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", cells)]
    reported = {m["name"] for m in e2e}
    if traced:
        metrics = [m for m in bench["per_layer"]
                   if (workload in m["workloads"] if "workloads" in m
                       else m["moves"] in reported)]
    else:
        metrics = e2e
    for m in metrics:
        if not os.path.exists(_metric_path(root, m["name"])):
            raise ValueError(f"metric {m['name']!r}: no reader "
                             f"portbench/metrics/{m['name']}.py")
    return Cell(workload, int(w["chips"]), config, traffic, driver, metrics)


def _metric_path(root: str, name: str) -> str:
    return os.path.join(root, "portbench", "metrics", name + ".py")


def read_metrics(run: Run, root: str = ROOT) -> Dict[str, dict]:
    """Each metric's reader on `run`; a reader that finds nothing to read
    returns None and its metric is left out."""
    out = {}
    for m in run.cell.metrics:
        reader = load_module(_metric_path(root, m["name"]),
                             "portbench_metric_" + m["name"].replace(".",
                                                                    "_"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def loaded_forbidden() -> List[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in FORBIDDEN if t in tops)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def device_record(torch, count: int, peak: int, trace=None) -> dict:
    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": count, "memory_peak_bytes": int(peak)}
    if trace is not None:
        rec["busy_s"] = trace.busy_s
        rec["window_s"] = trace.window_s
    return rec


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, started: float, device: str = "cuda",
         cell: Optional[Cell] = None) -> int:
    """One run; `started` is the process's start on the perf_counter clock.
    `device` and `cell` exist for the tests, which drive a run on the CPU
    at a small size."""
    args = parse_args(argv)
    import torch
    cell = cell or resolve(args.workload, bool(args.trace))
    if device == "cuda" and not (torch.cuda.is_available()
                                 and torch.cuda.device_count() >= cell.chips):
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    drv = cell.driver.Driver(cell.config, cell.traffic, args.seed, device)
    try:
        drv.setup()
        setup_s = time.perf_counter() - started
        run = Run(cell, setup_s, drv.window(args.seconds), driver=drv)
        if args.trace:
            from . import tracing
            run.spans = tracing.Spans()
            run.trace, run.traced_items = drv.traced(run.spans)
            run.spans.remove()
        cuda = device == "cuda"
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        metrics = read_metrics(run)
        dev = (device_record(torch, cell.chips, peak, run.trace) if cuda
               else {"platform": "cpu", "kind": "cpu", "count": 0,
                     "memory_peak_bytes": 0})
        breakdown = None
        if run.trace is not None:
            breakdown = {"device_ops": run.trace.top_ops(),
                         "idle_gaps": run.trace.idle_gaps()}
        drv.release()
        if cuda:
            torch.cuda.empty_cache()
        checks = drv.check()
    finally:
        drv.close()
    correct = bool(checks) and all(c.ok for c in checks)
    result = {"correct": correct, "attempted": drv.attempted,
              "failed": drv.failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if cuda:
        result["card"] = card_line()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    found = loaded_forbidden()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
