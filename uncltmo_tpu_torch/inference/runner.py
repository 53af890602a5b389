"""End-to-end inference: HDR file -> tone-mapped PNG (port of
`uncltmo_tpu/inference/runner.py`): tiled images, whole images, and video
scenes (one directory of frames per scene, tiled, with the temporal
recurrence).

The host reads the file and, with `scale`, resizes it; the luma transform,
the grid pad, the tiled forward, the percentile clamp/stretch, the ratio-
image color, the crop and the display stretch run as torch ops on the
device.  `run_on_path` overlaps the three stages across images: a loader
thread reads image i+1 and a saver thread fetches and encodes image i-1
while the device runs image i.  `run_on_video_path` with `scene_batch > 1`
does the same across groups of scenes.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from uncltmo_tpu_torch import params
from uncltmo_tpu_torch.config import options_from_model_params
from uncltmo_tpu_torch.data.pipeline import device_prefetch
from uncltmo_tpu_torch.inference.engine import TileEngine
from uncltmo_tpu_torch.models.unet import make_generator, min_input_size
from uncltmo_tpu_torch.ops import color, preprocess
from uncltmo_tpu_torch.ops.resize import bicubic_resize
from uncltmo_tpu_torch.utils.convert import load_state, read_generator_state
from uncltmo_tpu_torch.utils.io import (list_hdr_names, load_lambda_dict,
                                        read_hdr_image, save_uint8_png)

_NO_ADD_FRAME_VIDEO = (
    "add_frame=1 checkpoints have no consistent video path (the "
    "reference's 5-D tiler crops every tile's output, "
    "`model_save_util.py:427`, so the tiles no longer fit the stitch; "
    "published configs use add_frame=0)")


def preprocess_device(rgb_hw3: torch.Tensor, f_factor,
                      data_trc: str = "min_log"):
    """RGB HDR -> (min-shifted rgb, lambda-log luma), both unpadded."""
    rgb = rgb_hw3 - torch.clamp(rgb_hw3.min(), max=0.0)
    gray = preprocess.hdr_to_network_input(rgb, f_factor, data_trc)
    return rgb, gray


def postprocess_device(rgb_padded: torch.Tensor, fake: torch.Tensor,
                       diff_y: int, diff_x: int) -> torch.Tensor:
    """Percentile clamp/stretch + ratio-image color + frame crop + display
    stretch (`model_save_util.py:389-405`).  Returns (H, W, 3) in [0, 1]."""
    fake_stretch = color.percentile_clamp_stretch(fake, 0.5, 99.5)
    im_color = color.back_to_color(rgb_padded, fake_stretch)
    im_max = im_color.max()
    im_color = preprocess.crop_frame(im_color, diff_y, diff_x)
    im_color = torch.minimum(torch.clamp(im_color, min=0.0), im_max)
    # the reference saver clamps to [0, 1] BEFORE the outlier percentile
    # stretch (`hdr_image_util.py:237-241`)
    im_color = torch.clamp(im_color, 0.0, 1.0)
    return color.to_01_outlier(im_color)


def postprocess_whole_device(rgb_padded: torch.Tensor, fake: torch.Tensor,
                             out_h: int, out_w: int) -> torch.Tensor:
    """Whole-image postprocess (`run_model_on_single_image`,
    `model_save_util.py:273-291`): percentile clamp/stretch, ratio-image
    color on the PADDED frame, then the pad is removed by a bicubic
    downscale to (out_h, out_w) -- the reference resizes on this path, it
    does not crop -- clamped to [0, max before the resize]."""
    fake_stretch = color.percentile_clamp_stretch(fake, 0.5, 99.5)
    im_color = color.back_to_color(rgb_padded, fake_stretch)
    im_max = im_color.max()
    im_color = bicubic_resize(im_color.permute(2, 0, 1)[None], out_h,
                              out_w)[0].permute(1, 2, 0)
    im_color = torch.minimum(torch.clamp(im_color, min=0.0), im_max)
    im_color = torch.clamp(im_color, 0.0, 1.0)
    return color.to_01_outlier(im_color)


class _BoundedSaver:
    """One saver thread with a bounded backlog: `submit` blocks on the
    oldest job once more than `backlog` are pending, so the device results
    pinned by pending jobs stay O(backlog).  `finish` returns every job's
    result in submission order."""

    def __init__(self, backlog: int = 2):
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._backlog = backlog
        self._futures: list = []
        self._results: list = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._pool.shutdown(wait=True)
        return False

    def submit(self, fn, *args) -> None:
        self._futures.append(self._pool.submit(fn, *args))
        while len(self._futures) > self._backlog:
            self._results.append(self._futures.pop(0).result())

    def finish(self) -> list:
        self._results += [f.result() for f in self._futures]
        self._futures = []
        return list(self._results)


class InferenceRunner:
    """Loads a generator once and tone-maps images and video scenes.

    `net_path` is a reference `.pth` checkpoint; `state_dict` (numpy or
    torch values in the `.pth` layout, e.g. from
    `utils.convert.state_dict_from_flax`) is used instead when given.
    add_frame checkpoints run whole-image only: the reference's tiled
    add_frame inference crops every tile's output, so the tiles no longer
    fit the stitch (`model_save_util.py:427`)."""

    def __init__(self, model_params: Dict, net_path: Optional[str],
                 video: bool = False, tile: int = params.TILE,
                 overlap: int = params.TILE_OVERLAP,
                 dtype: torch.dtype = torch.float32,
                 chunk: Optional[int] = None, state_dict=None,
                 whole_image: bool = False, device="cuda"):
        self.add_frame = bool(int(model_params.get("add_frame", 0)))
        self.whole_image = whole_image or self.add_frame
        if self.add_frame and video:
            raise ValueError(_NO_ADD_FRAME_VIDEO)
        self.video = video
        self.device = torch.device(device)
        if self.device.type == "cuda" and dtype == torch.float32:
            # cuDNN's default TF32 would break float32 parity
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model_params = model_params
        gen = make_generator(options_from_model_params(model_params))
        load_state(gen, state_dict if state_dict is not None
                   else read_generator_state(net_path))
        self.engine = TileEngine(gen, tile=tile, overlap=overlap, chunk=chunk,
                                 dtype=dtype, device=self.device)
        self.factor_coeff = float(model_params.get("factor_coeff", 0.1))
        self.data_trc = str(model_params.get("data_trc", "min_log"))

    def _lambda_for(self, f_factor_path: str, key: str) -> float:
        data = load_lambda_dict(f_factor_path)
        return float(data[key]) * 255.0 * self.factor_coeff

    def load_image(self, im_path: str, f_factor_path: str, scale: int = 4):
        """Host read + /scale resize (`model_save_util.py:219-240`), then
        device preprocessing + padding.  The resize is cv2 INTER_LINEAR's
        rule: bilinear, half-pixel centres, no antialiasing."""
        f_factor = self._lambda_for(
            f_factor_path, os.path.splitext(os.path.basename(im_path))[0])
        rgb = torch.from_numpy(read_hdr_image(im_path)).to(self.device)
        if scale != 1:
            h, w = rgb.shape[0] // scale, rgb.shape[1] // scale
            rgb = F.interpolate(rgb.permute(2, 0, 1)[None], size=(h, w),
                                mode="bilinear", align_corners=False,
                                antialias=False)[0].permute(1, 2, 0)
        rgb, gray = preprocess_device(rgb, f_factor, self.data_trc)
        # whole-image mode pads only to the 16k+16 U-Net grid; the floor of
        # 256 is the tiler's (an image below the tile size cannot feed it)
        min_size = 16 if self.whole_image else 256
        rgb_p, dy, dx = preprocess.pad_to_unet_grid(rgb, min_size=min_size)
        gray_p, dy, dx = preprocess.pad_to_unet_grid(gray, min_size=min_size)
        return rgb_p, gray_p, dy, dx

    def _tonemap_loaded(self, rgb_p, gray_p, dy, dx) -> torch.Tensor:
        """Loaded padded frame -> tone-mapped [0, 1] RGB on the device (not
        yet fetched: callers overlap the fetch with the next image).  Tiled
        by default; whole-image mode runs one forward of the whole padded
        frame, with the GCN's tables fitted to its bottleneck."""
        if self.whole_image:
            least = min_input_size(self.engine.model.depth)
            if min(gray_p.shape[:2]) < least:
                raise ValueError(
                    f"whole-image inference needs a padded frame of at "
                    f"least {least} x {least} pixels, got "
                    f"{gray_p.shape[0]} x {gray_p.shape[1]}: the generator's "
                    "valid convolutions leave nothing at the bottleneck")
            x = gray_p.permute(2, 0, 1)[None].to(self.engine.dtype)
            with torch.no_grad():
                fake = self.engine.model(x, apply_crop=self.add_frame,
                                         diffY=dy, diffX=dx)[0]
            fake = fake[0].permute(1, 2, 0).float()
            if self.add_frame:
                rgb = preprocess.crop_frame(rgb_p, dy, dx)
                return postprocess_device(rgb, fake, 0, 0)
            h, w = rgb_p.shape[0], rgb_p.shape[1]
            return postprocess_whole_device(rgb_p, fake, h - dy, w - dx)
        fake = self.engine.run_image(gray_p)
        return postprocess_device(rgb_p, fake, dy, dx)

    def run_single_image(self, im_path: str, im_name: str, output_path: str,
                         f_factor_path: str, scale: int = 4,
                         suffix: str = "_UnCLTMO") -> str:
        """`run_model_on_single_image2` (`model_save_util.py:293-405`);
        whole-image mode takes the non-tiled path instead."""
        out01 = self._tonemap_loaded(*self.load_image(im_path, f_factor_path,
                                                      scale))
        return save_uint8_png(out01.cpu().numpy(), output_path,
                              im_name + suffix)

    def run_on_path(self, input_images_path: str, output_images_path: str,
                    f_factor_path: str, scale: int = 4,
                    pipeline_io: bool = True) -> List[str]:
        """Tone-map every HDR file of a directory (`model_save_util.py:
        160-174`); with `pipeline_io`, loading, device work and saving
        overlap across images.  Outputs are identical either way."""
        names = list_hdr_names(input_images_path)
        if not pipeline_io or len(names) < 2:
            return [self.run_single_image(
                os.path.join(input_images_path, n), os.path.splitext(n)[0],
                output_images_path, f_factor_path, scale) for n in names]

        def load(img_name):
            return img_name, self.load_image(
                os.path.join(input_images_path, img_name), f_factor_path,
                scale)

        def save(img_name, out01):
            # the device -> host copy runs here, on the saver thread
            return save_uint8_png(out01.cpu().numpy(), output_images_path,
                                  os.path.splitext(img_name)[0] + "_UnCLTMO")

        with _BoundedSaver() as saver:
            for img_name, loaded in device_prefetch(names, load):
                saver.submit(save, img_name, self._tonemap_loaded(*loaded))
            return saver.finish()

    def _load_scene(self, im_paths: List[str], f_factor_path: str):
        """Per-scene lambda (the directory's name) and per-frame preprocess
        and pad.  Returns (scene, rgbs, grays, dy, dx)."""
        scene = os.path.basename(os.path.dirname(im_paths[0]))
        f_factor = self._lambda_for(f_factor_path, scene)
        rgbs, grays = [], []
        dy = dx = 0
        for p in im_paths:
            rgb, gray = preprocess_device(
                torch.from_numpy(read_hdr_image(p)).to(self.device),
                f_factor, self.data_trc)
            rgb_p, dy, dx = preprocess.pad_to_unet_grid(rgb)
            gray_p, dy, dx = preprocess.pad_to_unet_grid(gray)
            rgbs.append(rgb_p)
            grays.append(gray_p)
        return scene, rgbs, grays, dy, dx

    def _save_scene(self, scene, rgbs, fakes, dy, dx, im_names,
                    output_path: str, suffix: str) -> List[str]:
        save_dir = os.path.join(output_path, scene)
        outs = []
        for i, name in enumerate(im_names):
            out01 = postprocess_device(rgbs[i], fakes[i], dy, dx)
            outs.append(save_uint8_png(out01.cpu().numpy(), save_dir,
                                       name + suffix))
        return outs

    def run_video_scene(self, im_paths: List[str], im_names: List[str],
                        output_path: str, f_factor_path: str,
                        suffix: str = "_UnCLTMO") -> List[str]:
        """`run_model_on_video` (`model_save_util.py:567-614`): per-scene
        lambda, the stacked frames through the video tiler with the
        temporal recurrence, per-frame postprocess."""
        if self.add_frame:
            raise ValueError(_NO_ADD_FRAME_VIDEO)
        scene, rgbs, grays, dy, dx = self._load_scene(im_paths,
                                                      f_factor_path)
        fakes = self.engine.run_video(torch.stack(grays))
        return self._save_scene(scene, rgbs, fakes, dy, dx, im_names,
                                output_path, suffix)

    def run_on_video_path(self, input_images_path: str,
                          output_images_path: str, f_factor_path: str,
                          scene_batch: int = 1) -> List[str]:
        """Tone-map every scene directory.  `scene_batch > 1` is the serving
        path: consecutive scenes with the same (frames, H, W) share one
        conv batch per frame step through `TileEngine.run_videos` (the
        recurrence caps one scene's batch at its tile count)."""
        if self.add_frame:
            raise ValueError(_NO_ADD_FRAME_VIDEO)
        scene_jobs = []
        for scene in sorted(os.listdir(input_images_path)):
            scene_dir = os.path.join(input_images_path, scene)
            if not os.path.isdir(scene_dir):
                continue
            names = list_hdr_names(scene_dir)
            if not names:
                continue
            scene_jobs.append(([os.path.join(scene_dir, n) for n in names],
                               [os.path.splitext(n)[0] for n in names]))
        outs: List[str] = []
        if scene_batch <= 1:
            for im_paths, im_names in scene_jobs:
                outs += self.run_video_scene(im_paths, im_names,
                                             output_images_path,
                                             f_factor_path)
            return outs
        # Stages pipelined as in `run_on_path`: a loader thread decodes and
        # preprocesses ahead, this thread forms groups of matching shape
        # and runs the device, a saver thread postprocesses, fetches and
        # encodes the previous group.  The loader stays at most
        # scene_batch + 1 scenes ahead (the group being built plus one
        # lookahead that did not match), so residency is O(scene_batch).

        def load(job):
            im_paths, im_names = job
            return self._load_scene(im_paths, f_factor_path), im_names

        def save_group(group, fakes):
            saved = []
            for s, ((scene, rgbs, _, dy, dx), im_names) in enumerate(group):
                saved += self._save_scene(scene, rgbs, fakes[s], dy, dx,
                                          im_names, output_images_path,
                                          "_UnCLTMO")
            return saved

        loaded = device_prefetch(scene_jobs, load, depth=scene_batch + 1)
        pending = None                 # lookahead from the previous group
        with _BoundedSaver() as saver:
            try:
                while True:
                    if pending is not None:
                        group, pending = [pending], None
                    else:
                        head = next(loaded, None)
                        if head is None:
                            break
                        group = [head]
                    g0 = group[0][0][2]
                    while len(group) < scene_batch:
                        cand = next(loaded, None)
                        if cand is None:
                            break
                        if (len(cand[0][2]) == len(g0)
                                and cand[0][2][0].shape == g0[0].shape):
                            group.append(cand)
                        else:
                            pending = cand
                            break
                    stack = torch.stack([torch.stack(g)
                                         for (_, _, g, _, _), _ in group])
                    fakes = self.engine.run_videos(stack)
                    saver.submit(save_group, group, fakes)
                    del group, stack, fakes
            finally:
                loaded.close()         # stops the loader thread
            for saved in saver.finish():
                outs += saved
        return outs
