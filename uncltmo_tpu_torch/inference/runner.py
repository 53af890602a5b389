"""End-to-end image inference: HDR file -> tone-mapped PNG (port of
`uncltmo_tpu/inference/runner.py`, tiled image path).

The host reads the file and, with `scale`, resizes it; the luma transform,
the grid pad, the tiled forward, the percentile clamp/stretch, the ratio-
image color, the crop and the display stretch run as torch ops on the
device.  `run_on_path` overlaps the three stages across images: a loader
thread reads image i+1 and a saver thread fetches and encodes image i-1
while the device runs image i.
"""
from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from uncltmo_tpu_torch import params
from uncltmo_tpu_torch.config import options_from_model_params
from uncltmo_tpu_torch.inference.engine import TileEngine
from uncltmo_tpu_torch.models.unet import make_generator
from uncltmo_tpu_torch.ops import color, preprocess
from uncltmo_tpu_torch.utils.convert import load_state, read_generator_state
from uncltmo_tpu_torch.utils.io import (HDR_EXTENSIONS, load_lambda_dict,
                                        read_hdr_image, save_uint8_png)


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


_DONE = object()


def _prefetch(items, prepare, depth: int = 2):
    """Yield prepare(item) for each item, computed on a loader thread that
    stays `depth` items ahead.  Exceptions re-raise in the consumer; leaving
    the generator early stops the thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in items:
                if stop.is_set() or not put(prepare(item)):
                    return
            put(_DONE)
        except BaseException as e:      # noqa: BLE001 — re-raised below
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=10)


class InferenceRunner:
    """Loads a generator once and tone-maps images (tiled path).

    `net_path` is a reference `.pth` checkpoint; `state_dict` (numpy or
    torch values in the `.pth` layout, e.g. from
    `utils.convert.state_dict_from_flax`) is used instead when given."""

    def __init__(self, model_params: Dict, net_path: Optional[str],
                 tile: int = params.TILE,
                 overlap: int = params.TILE_OVERLAP,
                 dtype: torch.dtype = torch.float32,
                 chunk: Optional[int] = None, state_dict=None,
                 whole_image: bool = False, device="cuda"):
        if whole_image or int(model_params.get("add_frame", 0)):
            raise NotImplementedError(
                "whole-image inference (and add_frame checkpoints, which "
                "need it) is not ported yet (ROADMAP Queue 1 item 3)")
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
        rgb_p, dy, dx = preprocess.pad_to_unet_grid(rgb)
        gray_p, dy, dx = preprocess.pad_to_unet_grid(gray)
        return rgb_p, gray_p, dy, dx

    def _tonemap_loaded(self, rgb_p, gray_p, dy, dx) -> torch.Tensor:
        """Loaded padded frame -> tone-mapped [0, 1] RGB on the device (not
        yet fetched: callers overlap the fetch with the next image)."""
        fake = self.engine.run_image(gray_p)
        return postprocess_device(rgb_p, fake, dy, dx)

    def run_single_image(self, im_path: str, im_name: str, output_path: str,
                         f_factor_path: str, scale: int = 4,
                         suffix: str = "_UnCLTMO") -> str:
        """`run_model_on_single_image2` (`model_save_util.py:293-405`)."""
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
        names = [n for n in sorted(os.listdir(input_images_path))
                 if os.path.splitext(n)[1].lower() in HDR_EXTENSIONS]
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
            for img_name, loaded in _prefetch(names, load):
                saver.submit(save, img_name, self._tonemap_loaded(*loaded))
            return saver.finish()
