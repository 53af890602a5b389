"""Closed-loop tone mapping of preloaded HDR scenes, `scene_batch` scenes a
call, the serving path of `InferenceRunner.run_on_video_path`.

Traffic keys: `scenes` (distinct seeded scenes on the card; call i takes
scenes (i * scene_batch + j) mod scenes), `scene_batch`, `frames` (a
scene's), `height`, `width`, `pan` and `gain` (a scene's motion and
brightening a frame), `lambda_range` (one lambda a scene), `warmup`,
`traced_items` (calls), `compare` (calls kept for the reference, drawn
from the seed), `limits`.

Per call: every frame through `preprocess_device` and the grid pad,
`TileEngine.run_videos` on the (scene_batch, frames) stack (each frame
step runs the tiles of every scene in one batch, with the carry), then
`postprocess_device` and a uint8 fetch for every frame."""
from __future__ import annotations

import torch

from portbench import inputs, serving
from portbench.reference import pipeline, unet


class Driver(serving.ServingDriver):

    def setup(self) -> None:
        t = self.traffic
        self.sb = int(t["scene_batch"])
        self.per_item = self.sb * int(t["frames"])
        self.scenes = inputs.hdr_scenes(self.gen, t["scenes"], t["frames"],
                                        t["height"], t["width"], t["pan"],
                                        t["gain"])
        self.f = [lam * self.lambda_scale
                  for lam in inputs.lambdas(self.rng, t["scenes"],
                                            *t["lambda_range"])]
        self.tiles_per_frame = (
            len(pipeline.axis_weights(pipeline.grid_size(t["height"]))[0])
            * len(pipeline.axis_weights(pipeline.grid_size(t["width"]))[0]))
        self._want = {}
        self.fetch = serving.Fetch(self.per_item,
                                   (t["height"], t["width"], 3), self.device)
        self.warm_up()

    def group(self, i: int) -> list:
        return [(i * self.sb + j) % len(self.f) for j in range(self.sb)]

    def serve(self, i: int) -> torch.Tensor:
        group = self.group(i)
        if self.control:
            return torch.cat([pipeline.tonemap_scene(
                self.state, self.scenes[s], self.f[s], unet.Precision(True)
            ).cpu() for s in group])
        from uncltmo_tpu_torch.inference import runner as runner_mod
        from uncltmo_tpu_torch.ops.preprocess import pad_to_unet_grid
        grays, rgbs = [], []
        with self.span("preprocess"):
            for s in group:
                g_s = []
                for frame in self.scenes[s]:
                    rgb, gray = runner_mod.preprocess_device(
                        frame, self.f[s], self.runner.data_trc)
                    rgb_p, dy, dx = pad_to_unet_grid(rgb)
                    gray_p, dy, dx = pad_to_unet_grid(gray)
                    rgbs.append(rgb_p)
                    g_s.append(gray_p)
                grays.append(torch.stack(g_s))
        fakes = self.runner.engine.run_videos(torch.stack(grays))
        fakes = fakes.reshape((-1,) + tuple(fakes.shape[2:]))
        for slot, (rgb_p, fake) in enumerate(zip(rgbs, fakes)):
            self.fetch.put(slot, runner_mod.postprocess_device(rgb_p, fake,
                                                               dy, dx))
        return self.fetch.done()

    def pairs(self, item):
        i, got = item
        frames = int(self.traffic["frames"])
        for j, s in enumerate(self.group(i)):
            if s not in self._want:
                self._want[s] = pipeline.tonemap_scene(
                    self.state, self.scenes[s], self.f[s])
            for k in range(frames):
                yield got[j * frames + k], self._want[s][k]
