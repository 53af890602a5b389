"""What the serving drivers share: the runner built from a configuration
and seeded weights, the spans of the traced stretch, the uint8 fetch, and
the comparison of delivered frames with the reference's."""
from __future__ import annotations

import contextlib
import time
from typing import List

import numpy as np
import torch

from . import weights
from .harness import Check, Window
from .measure import Reservoir

MASK64 = (1 << 63) - 1


def stream(seed: int, k: int) -> int:
    """The seed of the run's k-th random stream."""
    return (seed * 1000003 + k) & MASK64


class ServingDriver:
    """A closed loop of one caller.  Subclasses set up their inputs
    (`setup`), define `serve(i)` (item i of the window, delivered to the
    host; with `control`, the reference's TF32 answer in its place) and
    `pairs(item)` (each delivered frame of a kept item beside the
    reference's)."""

    per_item = 1                 # frames an item delivers
    tiles_per_frame = 0

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: str = "cuda", control: bool = False):
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.control = control
        self.attempted = self.failed = 0
        self.kept = Reservoir(int(traffic["compare"]), stream(seed, 7))
        self.rng = np.random.default_rng(stream(seed, 1))
        self.gen = torch.Generator(device=self.device).manual_seed(
            stream(seed, 2))
        self.state = weights.generator_state(stream(seed, 3), self.device)
        self.runner = self.spans = None
        if not control:
            from uncltmo_tpu_torch.inference.runner import InferenceRunner
            self.runner = InferenceRunner(
                config["model_params"], None, video=config["video"],
                tile=config["tile"], overlap=config["overlap"],
                state_dict=self.state, device=self.device)

    @property
    def lambda_scale(self) -> float:
        """The runner's factor from a lambda to the luma's f."""
        return 255.0 * float(self.config["model_params"]["factor_coeff"])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float) -> Window:
        self.sync()
        start = time.perf_counter()
        lat: List[float] = []
        i = 0
        while True:
            t0 = time.perf_counter()
            self.attempted += self.per_item
            item = self.serve(i)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            if item is not None:
                self.kept.offer(lambda: (i, item.clone()))
            i += 1
            if t1 - start >= seconds:
                break
        frames = i * self.per_item
        return Window(start, t1, frames, lat,
                      tiles=frames * self.tiles_per_frame)

    def traced(self, spans):
        from . import tracing
        self.install(spans)
        n = int(self.traffic["traced_items"])
        trace = tracing.profile(lambda: [self.serve(i) for i in range(n)],
                                self.device.type == "cuda")
        return trace, n * self.per_item

    def warm_up(self) -> None:
        """`warmup` items of the cell's own shapes, before the window."""
        for i in range(int(self.traffic["warmup"])):
            self.serve(i)
        self.sync()

    def span(self, name: str):
        """A span of the traced stretch around the driver's own calls into
        the program; nothing outside it."""
        return (self.spans.span(name) if self.spans is not None
                else contextlib.nullcontext())

    def install(self, spans) -> None:
        """The benchmark's spans around the engine's layers."""
        self.spans = spans
        from uncltmo_tpu_torch.inference import runner as runner_mod
        engine = self.runner.engine
        spans.wrap(engine, "_cut", "engine")
        spans.wrap(engine, "_blend", "engine")
        spans.wrap(engine, "_forward", "generator")
        spans.wrap(runner_mod, "postprocess_device", "postprocess")
        model = engine.model
        for up in model.up_path:
            spans.hook(up, "decoder")
        cells = [model.inc.conv] + [d.mpconv[1] for d in
                                    model.down_path[:-1]]
        for cell in cells:
            spans.hook(cell, "double_conv", _cell_shape)

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        self.runner = None

    def close(self) -> None:
        """Remove what set-up wrote."""

    def check(self) -> List[Check]:
        """The share of uint8 samples that differ from the reference's, in
        the worst frame kept."""
        worst = max(differing_pct(got, want) for item in self.kept.items
                    for got, want in self.pairs(item))
        return [Check("differing_pct", worst,
                      self.traffic["limits"]["differing_pct"])]

    def pairs(self, item):
        """(delivered, reference) uint8 frames of a kept item."""
        raise NotImplementedError


def _cell_shape(module, inputs, output):
    """(batch, cin, c1, c2, h, w) of a double-conv cell's call."""
    x = inputs[0]
    return (x.shape[0], x.shape[1], module.conv.weight.shape[0],
            module.conv1.weight.shape[0], x.shape[2], x.shape[3])


def to_u8(out01: torch.Tensor) -> torch.Tensor:
    """A [0, 1] frame -> uint8 (clip, x255, truncate: the runner's PNG
    rule), on its device."""
    return (out01.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


class Fetch:
    """The host side of a call: `n` uint8 frames of `shape` fetched into
    page-locked host buffers that every call reuses, as a server's output
    ring does; `done()` waits for the copies.  On the CPU the frames are
    returned as they are."""

    def __init__(self, n: int, shape, device: torch.device):
        self.cuda = device.type == "cuda"
        self.bufs = (torch.empty((n,) + tuple(shape), dtype=torch.uint8,
                                 pin_memory=True) if self.cuda else None)
        self.out: list = [None] * n

    def put(self, slot: int, out01: torch.Tensor) -> None:
        u8 = to_u8(out01)
        if self.cuda:
            self.bufs[slot].copy_(u8, non_blocking=True)
            u8 = self.bufs[slot]
        self.out[slot] = u8

    def done(self) -> torch.Tensor:
        if self.cuda:
            torch.cuda.current_stream().synchronize()
            return self.bufs
        return torch.stack(self.out)


def differing_pct(got: torch.Tensor, want: torch.Tensor) -> float:
    """% of uint8 samples of `got` that differ from `want` (100 for a frame
    of another shape)."""
    got, want = torch.as_tensor(got).cpu(), torch.as_tensor(want).cpu()
    if got.shape != want.shape:
        return 100.0
    return 100.0 * float((got != want).double().mean())


