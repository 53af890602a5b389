"""Shared pieces of the benchmark's CPU tests: each cell at a size that a
CPU run holds, and a run of the harness on the CPU that returns its
result line."""
from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# traffic at a CPU test's size: one tile row and column more than 256
SMALL = {
    "image_1080p": dict(frames=2, height=260, width=300, warmup=1,
                        compare=2),
    "video_1080p_sb2": dict(scenes=2, frames=2, height=260, width=300,
                            warmup=1, compare=1),
    "image_files_hdr": dict(files=2, height=1040, width=1200, compare=2),
    "train_image_b8": dict(batch=2, size=112, ring=4, traced_items=1),
}


# The directory cell, kept out of BENCHMARK.json (its host-bound rate
# spreads too widely for a bound, see PERF.md): the entries that would add
# it back, which the tests resolve it from.
FILES_CELL = {"name": "image_files_hdr", "config": "uncltmo_image",
              "traffic": "files_hdr_d2x", "chips": 1, "why": "directory"}
FILES_METRICS = [
    {"name": n, "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "host I/O", "moves": "frames_per_s",
     "workloads": ["image_files_hdr"]} for n in ("hdr_read_ms",
                                                 "png_write_ms")]


def bench_with_files() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append(FILES_CELL)
    bench["per_layer"] += FILES_METRICS
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("frames_per_s", "device_idle_pct.serve",
                         "mfu.serve"):
            m["workloads"].append("image_files_hdr")
    return bench


def small_cell(name: str, traced: bool = False):
    from portbench import harness
    bench = bench_with_files() if name == FILES_CELL["name"] else None
    cell = harness.resolve(name, traced, bench=bench)
    cell.traffic = dict(cell.traffic, **SMALL[name])
    return cell


def cpu_run(name: str, seed: int = 2 ** 31 + 11, seconds: float = 0.5,
            traced: bool = False, cell=None) -> dict:
    """One run of `name` on the CPU at the small size: its result line."""
    from portbench import harness
    cell = cell or small_cell(name, traced)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.main(["--workload", name, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace",
                           str(int(traced))], time.perf_counter(),
                          device="cpu", cell=cell)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture
def cuda_card():
    """Skips unless a CUDA card is present (decided here, not at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
