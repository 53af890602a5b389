"""Whole passes of `InferenceRunner.run_on_path` over a directory of
Radiance `.hdr` files, at the HDR-Survey launcher's `scale` (the loader
thread reads and resizes file i + 1 and the saver thread fetches and
encodes file i - 1 while the card runs file i).  PNGs are overwritten
every pass.

Traffic keys: `files`, `height`, `width` (of a file), `scale`,
`lambda_range`, `traced_items` (passes), `compare` (files of the last
pass compared with the reference, drawn from the seed), `limits`.

Set-up writes the files (run-length RGBE, `inputs.write_rle_hdr`) and the
lambda dictionary into a directory under TMPDIR, removed at `close`, and
warms up on one file."""
from __future__ import annotations

import os
import shutil
import tempfile

import torch

from portbench import inputs, serving
from portbench.reference import hdrio, pipeline, unet


class Driver(serving.ServingDriver):

    def setup(self) -> None:
        t = self.traffic
        self.per_item = int(t["files"])
        self.dir = tempfile.mkdtemp(prefix="portbench-files-")
        self.inp = os.path.join(self.dir, "in")
        self.out = os.path.join(self.dir, "out")
        os.makedirs(self.inp)
        self.names = [f"file{i}" for i in range(self.per_item)]
        self.lams = inputs.lambdas(self.rng, self.per_item,
                                   *t["lambda_range"])
        self.lam_path = inputs.write_lambda_dict(
            os.path.join(self.dir, "lambdas.npy"), self.names, self.lams)
        for name in self.names:
            frame = inputs.hdr_frames(self.gen, 1, t["height"], t["width"])[0]
            inputs.write_rle_hdr(os.path.join(self.inp, name + ".hdr"), frame)
            del frame
        h, w = t["height"] // t["scale"], t["width"] // t["scale"]
        self.tiles_per_frame = (
            len(pipeline.axis_weights(pipeline.grid_size(h))[0])
            * len(pipeline.axis_weights(pipeline.grid_size(w))[0]))
        if not self.control:
            self.runner.run_single_image(
                os.path.join(self.inp, self.names[0] + ".hdr"), "warmup",
                self.dir, self.lam_path, t["scale"])
        self.sync()

    def serve(self, i: int):
        scale = int(self.traffic["scale"])
        if self.control:            # the control answers in `pairs`
            return None
        self.runner.run_on_path(self.inp, self.out, self.lam_path, scale)
        return None

    def install(self, spans) -> None:
        from uncltmo_tpu_torch.inference import runner as runner_mod
        super().install(spans)
        spans.wrap(runner_mod, "read_hdr_image", "hdr_read")
        spans.wrap(runner_mod, "save_uint8_png", "png_write")

    def _expected(self, name: str, lam: float, prec=None) -> torch.Tensor:
        with open(os.path.join(self.inp, name + ".hdr"), "rb") as f:
            rgb = torch.from_numpy(hdrio.decode_radiance(f.read()))
        rgb = hdrio.downscale(rgb.to(self.device),
                              int(self.traffic["scale"]))
        return pipeline.tonemap_image(self.state, rgb,
                                      lam * self.lambda_scale, prec)

    def check(self):
        """The last pass's PNGs of `compare` files drawn from the seed."""
        k = min(int(self.traffic["compare"]), self.per_item)
        picks = sorted(self.rng.choice(self.per_item, k, replace=False))
        self.kept.items = [(int(j), None) for j in picks]
        return super().check()

    def pairs(self, item):
        j, _ = item
        if self.control:
            got = self._expected(self.names[j], self.lams[j],
                                 unet.Precision(True))
        else:
            path = os.path.join(self.out, self.names[j] + "_UnCLTMO.png")
            with open(path, "rb") as f:
                got = torch.from_numpy(hdrio.decode_png(f.read()))
        yield got, self._expected(self.names[j], self.lams[j])

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
