"""The readers of the program's own spans on a synthetic trace: device time
a step (or frame) of the operations launched inside `uncltmo.*` spans,
overlaps counted once, and the host time of the step span; each reader
finds nothing, and returns None, where its spans are absent."""
from __future__ import annotations

import pytest

from portbench import harness, tracing
from portbench.tests.conftest import small_cell
from portbench.tests.test_portbench_metrics import _trace_events

TRAIN = ("train_d_update_ms", "train_g_update_ms", "train_adam_ms",
         "k2_pack_ms.train", "train_host_ms")
SERVE = ("gcn_ms_per_frame",)


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def _span(name, start, end):
    return _x("user_annotation", name, start, end - start)


def _launch(corr, at, start, end):
    """A launch on the host thread at `at` and its kernel [start, end]."""
    return [_x("cuda_runtime", "cudaLaunchKernel", at, 5, correlation=corr),
            _x("kernel", f"k{corr}", start, end - start, tid=7,
               correlation=corr)]


def _two_steps():
    """Two traced steps in a window of 10 ms (times in us).  Step one packs
    K2's weights in its D update and runs the GCN in its G update; step two
    does neither; one kernel is launched after both steps."""
    ev = [_x("user_annotation", tracing.WINDOW, 0, 10000),
          _span("uncltmo.train.step", 100, 4100),
          _span("uncltmo.train.d_update", 150, 2000),
          _span("uncltmo.k2.pack", 200, 300),
          _span("uncltmo.train.d_adam", 1500, 1900),
          _span("uncltmo.train.g_update", 2100, 4000),
          _span("uncltmo.gen.gcn", 2200, 2400),
          _span("uncltmo.train.g_adam", 3500, 3900),
          _span("uncltmo.train.step", 5000, 8000),
          _span("uncltmo.train.d_update", 5050, 6000),
          _span("uncltmo.train.d_adam", 5800, 5950),
          _span("uncltmo.train.g_update", 6100, 7900),
          _span("uncltmo.train.g_adam", 7700, 7850)]
    for launch in [(1, 250, 300, 800),       # in the packing
                   (2, 400, 600, 1500),      # overlaps k1 by 0.2 ms
                   (3, 1600, 1600, 1800),    # D's Adam
                   (4, 2300, 2300, 3300),    # the GCN
                   (5, 3600, 3600, 3700),    # G's Adam
                   (6, 5100, 5100, 5900),
                   (7, 5900, 5900, 6000),    # D's Adam
                   (8, 6200, 6200, 7200),
                   (9, 7800, 7800, 7850),    # G's Adam
                   (10, 8500, 8500, 8600)]:  # outside the steps
        ev += _launch(*launch)
    return ev


def _run(cell, events, items):
    run = harness.Run(small_cell(cell), 1.0, harness.Window(0.0, 1.0, 1))
    run.trace, run.traced_items = tracing.Trace(events), items
    return run


def _metric(name):
    return harness.load_module(harness._metric_path(harness.ROOT, name),
                               "probe_" + name.replace(".", "_"))


@pytest.mark.parametrize("name, want", [
    # k1 and k2 union to 1.2 ms, + 0.2 + 0.8 + 0.1, over 2 steps
    ("train_d_update_ms", (1.2 + 0.2 + 0.8 + 0.1) / 2),
    ("train_g_update_ms", (1.0 + 0.1 + 1.0 + 0.05) / 2),
    ("train_adam_ms", (0.2 + 0.1 + 0.1 + 0.05) / 2),
    ("k2_pack_ms.train", 0.5 / 2),
    # the step spans' host intervals: 4.0 and 3.0 ms
    ("train_host_ms", (4.0 + 3.0) / 2),
    ("gcn_ms_per_frame", 1.0 / 2),
])
def test_each_reader_against_a_hand_count(name, want):
    cell = "image_1080p" if name in SERVE else "train_image_b8"
    assert _metric(name).read(_run(cell, _two_steps(), 2)) == pytest.approx(
        want)


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_each_reader_is_none_without_its_spans(name):
    cell = "image_1080p" if name in SERVE else "train_image_b8"
    # a trace of other spans only, as the parent commit records
    assert _metric(name).read(_run(cell, _trace_events(), 1)) is None
    # no traced stretch at all
    assert _metric(name).read(_run(cell, _two_steps(), 0)) is None
    run = _run(cell, _two_steps(), 2)
    run.trace = None
    assert _metric(name).read(run) is None


def test_the_cells_that_read_them():
    names = {c: {m["name"] for m in harness.resolve(c, traced=True).metrics}
             for c in ("train_image_b8", "image_1080p", "video_1080p_sb2")}
    assert set(TRAIN) <= names["train_image_b8"]
    assert not set(SERVE) & names["train_image_b8"]
    for c in ("image_1080p", "video_1080p_sb2"):
        assert set(SERVE) <= names[c] and not set(TRAIN) & names[c]
