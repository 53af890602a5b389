"""The port's spans (CPU): the tree a stage-0 training step records under
`profiling.traced_to`, the engine's and the generator's spans once a chunk
or frame step and never once a tile, K2's packing span on a cache miss
only, no `record_function` while nobody traces, and span names that the
benchmark's own spans cannot collide with.  Sizes are those of
`tests/test_torch_train_step.py` (112 x 112, B = 2) and
`tests/test_torch_inference.py` (tiles of 128 with an overlap of 32)."""
import glob
import json
import os
import re

import numpy as np
import torch

from uncltmo_tpu_torch.inference.engine import TileEngine
from uncltmo_tpu_torch.models.blocks import DoubleConv, DoubleConvT
from uncltmo_tpu_torch.models.discriminator import SimpleDiscriminator
from uncltmo_tpu_torch.models.unet import UNetTMO, bottleneck_grid
from uncltmo_tpu_torch.training import train_step as tstep
from uncltmo_tpu_torch.training.state import TrainState
from uncltmo_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 112
GEN = ["uncltmo.gen.encoder", "uncltmo.gen.gcn", "uncltmo.gen.decoder"]
# (name, children) of one stage-0 step, in the order they open
STEP_TREE = ("uncltmo.train.step", [
    ("uncltmo.train.d_update", [
        ("uncltmo.train.d_forward", [(g, []) for g in GEN]),
        ("uncltmo.train.d_backward", []),
        ("uncltmo.train.d_adam", [])]),
    ("uncltmo.train.g_update", [
        ("uncltmo.train.g_forward", [(g, []) for g in GEN]),
        ("uncltmo.train.g_loss", []),
        ("uncltmo.train.g_backward", []),
        ("uncltmo.train.g_adam", [])]),
    ("uncltmo.train.logs", [])])
ENGINE = ["uncltmo.engine.cut", "uncltmo.engine.forward",
          "uncltmo.engine.blend"]


def _names(node):
    name, children = node
    return {name}.union(*(_names(c) for c in children))


PROGRAM_SPANS = _names(STEP_TREE) | set(ENGINE) | {
    "uncltmo.k2.pack", "uncltmo.up.pack", "uncltmo.serve.preprocess",
    "uncltmo.serve.postprocess"}


def _spans(log_dir):
    """The program's spans of a trace: [(start, end, name)] by start."""
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") == "user_annotation"
                  and e["name"].startswith("uncltmo."))


def _tree(spans):
    """Nest the spans by their intervals: [(name, children)]."""
    roots, stack = [], []
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] < e:
            stack.pop()
        node = (name, [])
        (stack[-1][2][1] if stack else roots).append(node)
        stack.append((s, e, node))
    return roots


def _counts(spans):
    out = {}
    for _, _, name in spans:
        out[name] = out.get(name, 0) + 1
    return out


def _step_fixture():
    torch.manual_seed(0)
    gen = UNetTMO(gcn_grid=bottleneck_grid(SIZE))
    disc = SimpleDiscriminator(input_size=SIZE)
    step = tstep.make_train_step(gen, disc, tstep.LossConfig(),
                                 device="cpu")
    rng = np.random.default_rng(0)
    batch = {"hdr": rng.random((2, 2, SIZE, SIZE, 1), np.float32) * 0.4
             + 0.2,
             "ldr_pos": rng.random((2, 2, SIZE, SIZE, 1), np.float32),
             "ldr_neg": rng.random((2, 2, SIZE, SIZE, 1), np.float32) ** 3}
    return step, TrainState.create(gen, disc), batch


def _run_step(step, state, batch):
    return step(state, batch, torch.Generator().manual_seed(0), 1e-5,
                1.5e-5)


def test_a_traced_step_records_the_span_tree(tmp_path):
    step, state, batch = _step_fixture()
    _run_step(step, state, batch)
    with profiling.traced_to(str(tmp_path)):
        _run_step(step, state, batch)
    assert _tree(_spans(str(tmp_path))) == [STEP_TREE]


def test_the_step_takes_its_backwards_on_its_own_thread(monkeypatch):
    step, state, batch = _step_fixture()
    grad = torch.autograd.grad
    seen = []

    def recording(*a, **k):
        seen.append(torch._C._is_multithreading_enabled())
        return grad(*a, **k)
    monkeypatch.setattr(torch.autograd, "grad", recording)
    _run_step(step, state, batch)
    assert seen == [False, False]
    assert torch._C._is_multithreading_enabled()


def test_no_record_function_while_nobody_traces(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) untraced")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.trace("uncltmo.a") is profiling.trace("uncltmo.b")
    step, state, batch = _step_fixture()
    _run_step(step, state, batch)
    eng = TileEngine(UNetTMO(gcn_grid=4), tile=128, overlap=32, chunk=4,
                     device="cpu")
    eng.run_image(torch.rand(160, 320, 1))
    DoubleConv(8, 16).packed_weights()


def _engine_spans(tmp_path, run):
    torch.manual_seed(1)
    eng = TileEngine(UNetTMO(gcn_grid=4), tile=128, overlap=32, chunk=4,
                     device="cpu")
    with profiling.traced_to(str(tmp_path)):
        out = run(eng)
    return eng, out, _spans(str(tmp_path))


def test_a_tiled_image_opens_the_engine_spans_once_a_chunk(tmp_path):
    eng, out, spans = _engine_spans(
        tmp_path, lambda e: e.run_image(torch.rand(160, 320, 1)))
    n = eng._plan(160, 320)[-1]
    chunks = -(-n // eng._chunk_for(n))
    assert n == 6 and chunks == 2
    assert _counts(spans) == {name: chunks for name in ENGINE + GEN}
    # each chunk: cut, then the forward around the generator, then blend
    assert _tree(spans) == [(ENGINE[0], []),
                            (ENGINE[1], [(g, []) for g in GEN]),
                            (ENGINE[2], [])] * chunks
    assert out.shape == (160, 320, 1)


def test_a_two_scene_video_opens_them_once_a_group(tmp_path):
    frames = 2
    eng, out, spans = _engine_spans(
        tmp_path, lambda e: e.run_videos(torch.rand(2, frames, 160, 160, 1)))
    # one group of 2 x 4 tiles: one cut, forward and blend; the generator's
    # spans once a frame step
    assert _counts(spans) == dict({name: 1 for name in ENGINE},
                                  **{g: frames for g in GEN})
    assert _tree(spans)[1] == (ENGINE[1], [(g, []) for g in GEN] * frames)
    assert out.shape == (2, frames, 160, 160, 1)


def test_k2_packs_under_its_span_on_a_miss_only(tmp_path):
    cell = DoubleConv(8, 16)
    with profiling.traced_to(str(tmp_path / "a")):
        first = cell.packed_weights()
        assert cell.packed_weights() is first          # a hit
    with torch.no_grad():
        cell.conv1.weight.mul_(2.0)                    # a new version
    with profiling.traced_to(str(tmp_path / "b")):
        assert cell.packed_weights() is not first
        cell.packed_weights()
    for d in ("a", "b"):
        assert _counts(_spans(str(tmp_path / d))) == {"uncltmo.k2.pack": 1}


def test_up_cell_packs_under_its_span_on_a_miss_only(tmp_path):
    cell = DoubleConvT(128, 32)
    with profiling.traced_to(str(tmp_path / "a")):
        first = cell.packed_weights()
        assert cell.packed_weights() is first          # a hit
    with torch.no_grad():
        cell.conv.bias.add_(1.0)                       # a new version
    with profiling.traced_to(str(tmp_path / "b")):
        assert cell.packed_weights() is not first
        cell.packed_weights()
    for d in ("a", "b"):
        assert _counts(_spans(str(tmp_path / d))) == {"uncltmo.up.pack": 1}


def _benchmark_span_names():
    """Every string literal handed to the benchmark's span, wrap and hook
    calls, and its window span's name."""
    names = set()
    for path in glob.glob(os.path.join(ROOT, "portbench", "**", "*.py"),
                          recursive=True):
        with open(path) as f:
            text = f.read()
        for args in re.findall(r"\.(?:span|wrap|hook)\(([^()]*)\)", text):
            names.update(re.findall(r'"([^"]+)"', args))
        names.update(re.findall(r'WINDOW = "([^"]+)"', text))
    return names


def test_program_span_names_are_the_listed_ones_and_their_own():
    found = set()
    for path in glob.glob(os.path.join(ROOT, "uncltmo_tpu_torch", "**",
                                       "*.py"), recursive=True):
        with open(path) as f:
            found.update(re.findall(r'profiling\.trace\(\s*"([^"]+)"',
                                    f.read()))
    assert found == PROGRAM_SPANS
    bench = _benchmark_span_names()
    assert {"preprocess", "postprocess", "fetch", "engine", "generator",
            "decoder", "double_conv", "hdr_read", "png_write",
            "portbench.window"} <= bench
    assert not found & bench
    assert all(n.startswith("uncltmo.") for n in found)
