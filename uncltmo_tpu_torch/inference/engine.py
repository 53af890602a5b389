"""Batched tiled-inference engine (port of `uncltmo_tpu/inference/engine.py`,
image and video paths).

Tiles are cut from the padded log-luma frame, run through the generator in
batches ("chunks"), weighted by the partition-of-unity masks `wy ⊗ wx` of
the tile plan and summed into a float32 canvas.  A video tile is the full
frame sequence of one spatial tile, (T, t, t); the temporal recurrence runs
per tile (`video_apply`), so a chunk of video tiles is one conv batch per
frame step, and the canvas is (T, H, W).  PyTorch runs eagerly, so
the JAX engine's compile-time split into an unrolled and a streamed program
(`engine.py:30-43`) becomes one Python chunk loop that builds each chunk's
masks from the per-axis weights (the dense (N, t, t) mask array is never
built).  Chunk composition matters for `stretch_g='batchMax'` checkpoints
(the max is taken over the batch), so the chunking and padding follow the
JAX engine exactly:

* plans of <= 120 tiles: chunks of `_chunk_for(n)` tiles, the last padded
  with all-zero tiles;
* larger plans: equalised chunks, padded with tiles cut at origin (0, 0)
  that carry zero weight;
* `run_images`: the tiles of `frames_per_step` frames form one batch
  (plans of <= 120 tiles);
* `run_videos`: the S*N video tiles of S scenes form one batch per frame
  step, without padding (plans of <= 120 tiles; larger plans run scene by
  scene).

The engine works on a copy of the module it is given, and takes new
weights through `update_variables`, as the JAX engine keeps a cast copy of
its variables (`engine.py:129-155`): the caller's module (a generator in
training, say) is never moved, switched to `eval()` or cast.

`devices=` is the JAX engine's `mesh=`: the tile batch of every chunk is
split evenly over a list of devices, one copy of the module on each (kept
in step by `update_variables`), the chunk granularity is the device count
(`engine.py:194`; 4 without), every device's forward is issued before any
result is waited on, and the outputs are gathered to the first device
before the float32 blend.  The chunk's values are the one-device engine's:
the tiles are independent, and `batchMax`, the one batch-coupled step, is
taken over the whole gathered chunk, as JAX's max over a sharded batch is.
A video tile's carry stays on the device that runs it.

`_run_frame` and `_run_group` open the spans `uncltmo.engine.cut`,
`uncltmo.engine.forward` and `uncltmo.engine.blend` once a chunk or group
(`utils/profiling.py`).

`run_images`' `post_name` contract is not ported: it keys a compile cache
that eager PyTorch does not have.
"""
from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from uncltmo_tpu_torch import params
from uncltmo_tpu_torch.inference.tiling import axis_plan
from uncltmo_tpu_torch.models.unet import video_apply
from uncltmo_tpu_torch.parallel.mesh import get_mesh
from uncltmo_tpu_torch.utils import profiling

# Plans above this many tiles run in equalised chunks of ~120 tiles
# (`engine.py:43`, `:174-201`).
STREAM_TILE_THRESHOLD = 120


def disable_tf32(device) -> None:
    """Turn TF32 off for cuDNN and matmul when `device` is a CUDA device:
    the port's float32 paths (serving, training, the Tester) hold the JAX
    package's float32 results, which TF32's 10-bit products would round.
    The flags are global to the process."""
    if torch.device(device).type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class TileEngine:
    """Runs the generator over arbitrarily large (padded) images.

    Args:
      model: a `UNetTMO`, left as it is: the engine runs a copy of it on
        `device`, in `eval()` mode and with batch norm's running statistics,
        whose parameters and running statistics are cast to `dtype` once.
      tile, overlap: tiling config (256 / 64 for the quarter-res protocol).
      chunk: tiles per forward, or None for the JAX engine's policy.
      dtype: compute dtype of the forward; the blend is always float32.
        A float32 engine on the card turns TF32 off (`disable_tf32`).
      device: "cuda" by default; tests pass "cpu".
      devices: a list of devices to split every chunk over (the JAX
        engine's `mesh=`), the first of them holding the plan, the canvas
        and the result; `device` is then not read.
    """

    def __init__(self, model: torch.nn.Module, tile: int = params.TILE,
                 overlap: int = params.TILE_OVERLAP,
                 chunk: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 devices: Optional[Sequence] = None):
        self.mesh = None if devices is None else get_mesh(devices=devices)
        self.devices = self.mesh or [torch.device(device)]
        self.device = self.devices[0]
        if dtype == torch.float32:
            for d in self.devices:
                disable_tf32(d)
        self.tile = tile
        self.overlap = overlap
        self.chunk = chunk
        self.dtype = dtype
        self.models = [self._copy(model, d, dtype) for d in self.devices]
        self.model = self.models[0]
        # over a mesh the gathered chunk takes batchMax's max (`_forward`)
        self._batch_max = (self.mesh is not None
                           and getattr(model, "stretch_g", "") == "batchMax")
        if self._batch_max:
            for m in self.models:
                m.stretch_g = "none"
        self._plans: dict = {}

    @staticmethod
    def _copy(model: torch.nn.Module, device, dtype) -> torch.nn.Module:
        """The engine's own copy of `model` on `device`, in eval mode."""
        m = copy.deepcopy(model).to(device).eval()
        if dtype != torch.float32:
            # every float32 leaf of the JAX engine's variables once
            # (`engine.py:129-155`): the parameters and batch norm's running
            # statistics, which the norm reads back as float32; the GCN's
            # relative-position buffer (no JAX variable) stays float32 for
            # the float32 KNN
            for p in m.parameters():
                p.data = p.data.to(dtype)
            for mod in m.modules():
                if isinstance(mod, torch.nn.BatchNorm2d):
                    mod.running_mean = mod.running_mean.to(dtype)
                    mod.running_var = mod.running_var.to(dtype)
        return m

    def update_variables(self, state_dict) -> None:
        """Copy new weights (a state dict of the model's layout, on any
        device) into the engine's module on every device, each cast to the
        dtype of the tensor it replaces: parameters and running statistics
        to `dtype`, the other float32 buffers stay float32
        (`engine.py:144-155`)."""
        with torch.no_grad():
            for m in self.models:
                m.load_state_dict(state_dict, strict=True)

    def _chunk_for(self, n: int) -> int:
        """Tiles per conv batch for an n-tile plan (`engine.py:174-201`):
        the explicit `chunk` rounded up to the granularity (the device
        count over a mesh, else 4) and capped at the padded plan; else one
        batch for n <= 120, equalised chunks of ~120 above."""
        gran = len(self.mesh) if self.mesh is not None else 4
        if self.chunk is not None:
            return min(_round_up(self.chunk, gran), _round_up(n, gran))
        if n > STREAM_TILE_THRESHOLD:
            n_chunks = -(-n // 120)
            return min(_round_up(-(-n // n_chunks), gran),
                       _round_up(n, gran))
        return _round_up(n, gran)

    def _plan(self, h: int, w: int):
        """Tile origins and per-axis weights on the device, cached per
        (h, w): (oy, ox, wy, wx, n)."""
        key = (h, w)
        if key not in self._plans:
            py = axis_plan(h, self.tile, self.overlap)
            px = axis_plan(w, self.tile, self.overlap)
            ny, nx = len(py.origins), len(px.origins)
            dev = self.device
            self._plans[key] = (
                np.repeat(py.origins, nx).astype(np.int64),
                np.tile(px.origins, ny).astype(np.int64),
                torch.from_numpy(np.repeat(py.weights, nx, axis=0)).to(dev),
                torch.from_numpy(np.tile(px.weights, (ny, 1))).to(dev),
                ny * nx)
        return self._plans[key]

    def _forward(self, tiles: torch.Tensor) -> torch.Tensor:
        """(N, t, t) image tiles or (N, T, t, t) video tiles -> float32
        generator outputs of the same shape.  Over a mesh: the tiles split
        evenly, every device's forward issued before any output is read,
        the outputs gathered to the first device."""
        outs = []
        with torch.no_grad():
            for model, dev, part in zip(self.models, self.devices,
                                        tiles.tensor_split(len(self.devices))):
                if not len(part):
                    continue
                x = part.to(dev, non_blocking=True).unsqueeze(-3)
                x = x.to(self.dtype)
                if tiles.dim() == 4:
                    out, _ = video_apply(model, x, with_features=False)
                else:
                    out, _ = model(x)
                outs.append(out)
            out = outs[0] if len(outs) == 1 else torch.cat(
                [o.to(self.device) for o in outs])
            if self._batch_max:
                # the model's x / x.max() of every frame, over the chunk
                dims = (0,) + tuple(range(out.dim() - 3, out.dim()))
                out = out / out.amax(dim=dims, keepdim=True)
        return out.float().squeeze(-3)

    def _cut(self, image: torch.Tensor, oy, ox) -> torch.Tensor:
        """(H, W) or (T, H, W) -> (N, t, t) or (N, T, t, t)."""
        t = self.tile
        return torch.stack([image[..., y:y + t, x:x + t]
                            for y, x in zip(oy, ox)])

    def _blend(self, canvas: torch.Tensor, outs: torch.Tensor, wy, wx, oy,
               ox, streamed: bool) -> None:
        """Add the weighted tiles into the (H, W) or (T, H, W) canvas in
        place.  The unrolled JAX path multiplies by the mask wy ⊗ wx, the
        streamed one by wy then wx; the same order keeps float32 results
        identical."""
        wy, wx = wy[:, :, None], wx[:, None, :]
        if outs.dim() == 4:
            wy, wx = wy[:, None], wx[:, None]
        weighted = outs * wy * wx if streamed else outs * (wy * wx)
        t = self.tile
        for i, (y, x) in enumerate(zip(oy, ox)):
            canvas[..., y:y + t, x:x + t] += weighted[i]

    def _run_frame(self, image: torch.Tensor) -> torch.Tensor:
        """One (H, W) frame or one (T, H, W) scene through its tile plan."""
        h, w = image.shape[-2:]
        oy, ox, wy, wx, n = self._plan(h, w)
        chunk = self._chunk_for(n)
        n_pad = _round_up(n, chunk)
        streamed = n > STREAM_TILE_THRESHOLD
        canvas = torch.zeros(image.shape, dtype=torch.float32,
                             device=self.device)
        for c0 in range(0, n_pad, chunk):
            real = range(c0, min(c0 + chunk, n))
            with profiling.trace("uncltmo.engine.cut"):
                tiles = self._cut(image, oy[real.start:real.stop],
                                  ox[real.start:real.stop])
                n_fill = chunk - len(real)
                if n_fill:
                    if streamed:     # origin-(0, 0) tiles, zero weight
                        fill = self._cut(image, [0] * n_fill, [0] * n_fill)
                    else:            # zero tiles
                        fill = torch.zeros((n_fill,) + tiles.shape[1:],
                                           dtype=tiles.dtype,
                                           device=tiles.device)
                    tiles = torch.cat([tiles, fill])
            with profiling.trace("uncltmo.engine.forward"):
                outs = self._forward(tiles)[:len(real)]
            sl = slice(real.start, real.stop)
            with profiling.trace("uncltmo.engine.blend"):
                self._blend(canvas, outs, wy[sl], wx[sl], oy[sl], ox[sl],
                            streamed)
        return canvas

    def _run_group(self, group: torch.Tensor) -> list:
        """(G, H, W) frames or (G, T, H, W) scenes -> G canvases.  The tiles
        of the whole group share one conv batch, unpadded (plans of <= 120
        tiles); larger plans run member by member in chunks."""
        h, w = group.shape[-2:]
        oy, ox, wy, wx, n = self._plan(h, w)
        if n > STREAM_TILE_THRESHOLD:
            return [self._run_frame(member) for member in group]
        with profiling.trace("uncltmo.engine.cut"):
            tiles = torch.cat([self._cut(member, oy, ox)
                               for member in group])
        with profiling.trace("uncltmo.engine.forward"):
            outs = self._forward(tiles)
        canvases = []
        with profiling.trace("uncltmo.engine.blend"):
            for o in outs.reshape(group.shape[0], n, *outs.shape[1:]):
                canvas = torch.zeros(group.shape[1:], dtype=torch.float32,
                                     device=self.device)
                self._blend(canvas, o, wy, wx, oy, ox, False)
                canvases.append(canvas)
        return canvases

    def run_image(self, image_hw1: torch.Tensor) -> torch.Tensor:
        """(H, W, 1) padded log-luma -> (H, W, 1) tone-mapped luma (f32)."""
        image = image_hw1.to(self.device)[..., 0]
        return self._run_frame(image)[..., None]

    def run_images(self, frames_fhw1: torch.Tensor,
                   post_fn: Optional[Callable] = None,
                   frames_per_step: int = 2) -> torch.Tensor:
        """(F, H, W, 1) -> per-frame results, stacked.

        The tiles of `frames_per_step` frames share one conv batch (plans of
        <= 120 tiles; larger plans run frame by frame in chunks, as
        `engine.py:374-411`).  `post_fn(frame_result)` is applied to each
        (H, W, 1) result.  F must be a multiple of frames_per_step."""
        f = int(frames_fhw1.shape[0])
        g = frames_per_step
        if f % g:
            raise ValueError(f"{f} frames is not a multiple of "
                             f"frames_per_step={g}")
        frames = frames_fhw1.to(self.device)[..., 0]
        results = []
        for g0 in range(0, f, g):
            for canvas in self._run_group(frames[g0:g0 + g]):
                res = canvas[..., None]
                results.append(post_fn(res) if post_fn else res)
        return torch.stack(results)

    def run_video(self, video_thw1: torch.Tensor) -> torch.Tensor:
        """(T, H, W, 1) padded log-luma frames -> (T, H, W, 1) (f32)."""
        video = video_thw1.to(self.device)[..., 0]
        return self._run_frame(video)[..., None]

    def run_videos(self, scenes_sthw1: torch.Tensor) -> torch.Tensor:
        """(S, T, H, W, 1) padded log-luma scenes -> (S, T, H, W, 1).

        The serving path: independent scenes have independent carries, so
        each recurrent frame step runs the S*N tiles of all scenes as one
        conv batch (`engine.py:549-606`)."""
        scenes = scenes_sthw1.to(self.device)[..., 0]
        return torch.stack(self._run_group(scenes))[..., None]
