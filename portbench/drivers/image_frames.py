"""Closed-loop tone mapping of preloaded HDR frames, one frame at a time.

Traffic keys: `frames` (distinct seeded frames on the card, cycled),
`height`, `width`, `lambda_range`, `warmup` (frames before the window),
`traced_items` (frames of the traced stretch), `compare` (frames kept for
the reference, drawn from the seed), `limits`.

Per frame: `runner.preprocess_device` -> `preprocess.pad_to_unet_grid` ->
`InferenceRunner._tonemap_loaded` (tiles -> generator -> blend ->
`postprocess_device`) -> uint8 -> host.  An item's latency runs from the
HDR frame on the card to its uint8 frame on the host."""
from __future__ import annotations

import torch

from portbench import inputs, serving
from portbench.reference import pipeline, unet


class Driver(serving.ServingDriver):

    def setup(self) -> None:
        t = self.traffic
        self.frames = inputs.hdr_frames(self.gen, t["frames"], t["height"],
                                        t["width"])
        self.f = [lam * self.lambda_scale
                  for lam in inputs.lambdas(self.rng, t["frames"],
                                            *t["lambda_range"])]
        self.tiles_per_frame = (
            len(pipeline.axis_weights(pipeline.grid_size(t["height"]))[0])
            * len(pipeline.axis_weights(pipeline.grid_size(t["width"]))[0]))
        self._want = {}
        self.fetch = serving.Fetch(1, (t["height"], t["width"], 3),
                                   self.device)
        self.warm_up()

    def serve(self, i: int) -> torch.Tensor:
        k = i % len(self.f)
        if self.control:
            return pipeline.tonemap_image(self.state, self.frames[k],
                                          self.f[k], unet.Precision(True)
                                          ).cpu()
        from uncltmo_tpu_torch.inference.runner import preprocess_device
        from uncltmo_tpu_torch.ops.preprocess import pad_to_unet_grid
        with self.span("preprocess"):
            rgb, gray = preprocess_device(self.frames[k], self.f[k],
                                          self.runner.data_trc)
            rgb_p, dy, dx = pad_to_unet_grid(rgb)
            gray_p, dy, dx = pad_to_unet_grid(gray)
        out01 = self.runner._tonemap_loaded(rgb_p, gray_p, dy, dx)
        with self.span("fetch"):
            self.fetch.put(0, out01)
            return self.fetch.done()[0]

    def pairs(self, item):
        i, got = item
        k = i % len(self.f)
        if k not in self._want:
            self._want[k] = pipeline.tonemap_image(self.state,
                                                   self.frames[k], self.f[k])
        yield got, self._want[k]
