"""The yardstick's arithmetic on synthetic data: operation counts from
shapes, the window rate, the 95th percentile, the idle share from the
union of device intervals, and the reading of a profiler trace."""
from __future__ import annotations

import statistics

import pytest
import torch

from portbench import harness, measure, roofline, tracing
from portbench.reference import unet
from portbench.tests.conftest import small_cell


@pytest.mark.parametrize("shape", [(1, 1, 32, 20, 20), (3, 32, 64, 30, 26),
                                   (2, 128, 256, 16, 16)])
def test_double_conv_flops_equal_flop_counter(shape):
    b, cin, cout, h, w = shape
    p = {"c.conv.weight": torch.empty(cout, cin, 3, 3, device="meta"),
         "c.conv.bias": torch.empty(cout, device="meta"),
         "c.conv1.weight": torch.empty(cout, cout, 3, 3, device="meta"),
         "c.conv1.bias": torch.empty(cout, device="meta")}
    x = torch.empty(b, cin, h, w, device="meta")
    counted = roofline.counted_flops(
        lambda: unet._double_conv(unet.Precision(), p, "c.", x))
    flops, nbytes = roofline.double_conv_work(b, cin, cout, cout, h, w)
    assert flops == counted
    assert nbytes == 4 * (b * cin * h * w + 9 * cin * cout + cout
                          + 9 * cout * cout + cout
                          + b * cout * (h - 4) * (w - 4))


def test_generator_flops_per_tile():
    assert roofline.generator_flops_per_tile() == pytest.approx(18.296e9,
                                                                rel=1e-3)


def test_roofline_share_is_the_least_time_over_the_time():
    # bound by bytes: 3.35e9 bytes take 1 ms at the peak bandwidth
    assert roofline.roofline_pct(1.0, 3.35e9, 2e-3) == pytest.approx(50.0)
    # bound by operations: 495e9 flops take 1 ms at the float32 peak
    assert roofline.roofline_pct(495e9, 1.0, 1e-3) == pytest.approx(100.0)


def _run(name, latencies, start=10.0, end=None, tiles=0):
    cell = small_cell(name)
    end = end if end is not None else start + sum(latencies)
    return harness.Run(cell, 1.0, harness.Window(start, end, len(latencies),
                                                 list(latencies), tiles))


def _metric(name):
    return harness.load_module(harness._metric_path(harness.ROOT, name),
                               "probe_" + name.replace(".", "_"))


def test_rate_counts_every_frame_over_the_whole_window():
    lat = [0.05] * 30 + [0.5]          # one slow frame at the end
    run = _run("image_1080p", lat)
    got = _metric("frames_per_s").read(run)
    assert got == pytest.approx(31 / (30 * 0.05 + 0.5))
    assert got < 31 / (30 * 0.05)      # the slow frame's time counts


def test_p95_is_over_all_frames_not_chunk_medians():
    # four chunks of 50 frames: 47 fast and 3 slow frames each, so every
    # chunk's median is fast while 6% of all frames are slow
    lat = ([0.040] * 47 + [0.200] * 3) * 4
    run = _run("image_1080p", lat)
    got = _metric("frame_p95_ms").read(run)
    chunk_medians = [statistics.median(lat[i:i + 50])
                     for i in range(0, 200, 50)]
    assert max(chunk_medians) == pytest.approx(0.040)
    assert got == pytest.approx(1e3 * measure.percentile(lat, 95))
    assert got > 100.0


def test_percentile_and_spread():
    v = list(range(1, 101))
    assert measure.percentile(v, 95) == pytest.approx(95.05)
    assert measure.spread([10, 10, 10, 10]) == 0.0
    assert measure.spread([9, 10, 10, 11]) == pytest.approx(
        (10.75 - 9.25) / 10)


def test_busy_time_counts_overlapping_intervals_once():
    iv = [(0.0, 1.0), (0.5, 1.5), (0.2, 0.4), (3.0, 4.0)]
    assert measure.busy_time(iv, 0.0, 5.0) == pytest.approx(2.5)
    assert measure.busy_time(iv, 1.0, 3.5) == pytest.approx(1.0)
    assert measure.gaps(iv, 0.0, 5.0) == [(1.5, 3.0), (4.0, 5.0)]


def _trace_events():
    """A window of 10 ms; two overlapping kernels launched inside span
    `a`, one inside `b`, each launch correlated to its kernel."""
    def x(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "tid": tid, "pid": 1, "args": args}
    return [
        x("user_annotation", tracing.WINDOW, 0, 10000),
        x("user_annotation", "a", 100, 1000),
        x("user_annotation", "b", 2000, 1000),
        x("cuda_runtime", "cudaLaunchKernel", 150, 5, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 160, 5, correlation=2),
        x("cuda_runtime", "cudaLaunchKernel", 2100, 5, correlation=3),
        x("cpu_op", "aten::sort", 5000, 3000),
        x("kernel", "k1", 200, 2000, tid=7, correlation=1),
        x("kernel", "k2", 1000, 1900, tid=8, correlation=2),
        x("kernel", "k3", 3500, 500, tid=7, correlation=3),
    ]


def test_trace_attributes_kernels_to_spans_and_unions_them():
    tr = tracing.Trace(_trace_events())
    assert tr.window_s == pytest.approx(0.010)
    # k1 and k2 overlap by 1.2 ms: 2.7 ms busy in `a`, not 3.9
    assert tr.device_s("a") == pytest.approx(0.0027)
    assert tr.device_s("b") == pytest.approx(0.0005)
    assert tr.busy_s == pytest.approx(0.0032)
    run = _run("image_1080p", [0.01])
    run.trace, run.traced_items = tr, 1
    assert _metric("device_idle_pct.serve").read(run) == pytest.approx(68.0)
    gaps = dict(tr.idle_gaps())
    # the idle stretch after k3 is split by what the host did in it
    assert gaps["outside spans/aten::sort"] == pytest.approx(0.003)
    assert gaps["a/no host op"] == pytest.approx(0.0001)
    assert gaps["b/no host op"] == pytest.approx(0.0001)
    assert sum(gaps.values()) == pytest.approx(0.010 - 0.0032)
    assert [k for k, _ in tr.top_ops()] == ["k1", "k2", "k3"]


def test_a_reader_with_nothing_to_read_returns_none():
    run = _run("image_1080p", [0.05])
    for name in ("prepost_ms_per_frame", "decoder_ms_per_frame",
                 "double_conv_roofline.serve", "device_idle_pct.serve",
                 "hdr_read_ms"):
        assert _metric(name).read(run) is None


def test_reservoir_keeps_a_seeded_uniform_sample():
    picks = []
    for seed in range(400):
        r = measure.Reservoir(2, seed)
        for i in range(10):
            r.offer(lambda i=i: i)
        picks += r.items
        assert len(r.items) == 2
    counts = [picks.count(i) for i in range(10)]
    assert min(counts) > 50 and max(counts) < 110
    again = measure.Reservoir(2, 7)
    first = measure.Reservoir(2, 7)
    for i in range(10):
        again.offer(lambda i=i: i)
        first.offer(lambda i=i: i)
    assert again.items == first.items
