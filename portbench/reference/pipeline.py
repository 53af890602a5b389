"""Plain reference of the tiled tone-mapping pipeline, HDR radiance ->
uint8 RGB (reference `utils/model_save_util.py`, `run_model_on_single_image2`
and `run_model_on_video`, quarter-res protocol).

1. The lambda-log luma: min-shift, Rec.601 luma, min-shift,
   log10(L / max * f + 1), divided by its max.
2. Replicate-pad to 16 * floor(n / 16) + 16 (at least 256) per axis.
3. 256 / 64 tiles; the reference cross-fades each tile into an accumulator,
   which is a fixed partition of unity `w_t = wy_t (x) wx_t` per tile
   (`axis_weights` simulates the reference's 1-D update once per axis).
4. The generator on every tile (for video: every tile's whole frame
   sequence, with the carry).
5. Clamp the luma to its 0.5 / 99.5 percentiles and stretch to [0, 1]; the
   ratio-image colour (rgb / luma)^0.5 * luma; crop the pad; clamp to
   [0, max]; clip to [0, 1]; stretch the 0.1 / 99 percentiles to [0, 1].
6. uint8: clip to [0, 1], x255, truncate.

Percentiles are numpy's "linear" rule with the rank taken in float64.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import unet

REC601 = (0.299, 0.587, 0.114)


def network_input(rgb: torch.Tensor, f_factor: float):
    """(H, W, 3) radiance -> (min-shifted rgb, (H, W) lambda-log luma)."""
    rgb = rgb - torch.clamp(rgb.min(), max=0.0)
    w = torch.tensor(REC601, dtype=rgb.dtype, device=rgb.device)
    gray = (rgb * w).sum(-1)
    gray = gray - gray.min()
    a = torch.log10(gray / gray.max() * f_factor + 1.0)
    return rgb, a / a.max()


def grid_size(n: int, least: int = 256) -> int:
    return max(16 * int(n / 16.0) + 16, least)


def pad_hw(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Replicate-pad the last two axes of x to (th, tw), the smaller half of
    the difference before."""
    dy, dx = th - x.shape[-2], tw - x.shape[-1]
    lead = x.shape[:-2]
    x4 = x.reshape((-1, 1) + tuple(x.shape[-2:]))
    x4 = F.pad(x4, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2),
               mode="replicate")
    return x4.reshape(lead + (th, tw))


@functools.lru_cache(maxsize=None)
def axis_weights(length: int, tile: int = 256, overlap: int = 64):
    """Tile origins and (n, tile) float32 weights along one axis, from the
    reference's sequential cross-fade: regular tiles at (tile - overlap) * i
    while tile * (i + 1) - overlap * i < length, each fading in over
    `overlap` pixels with ramps j / (overlap - 1); then a last tile anchored
    at length - tile that fades in over what it shares with the one
    before and overwrites the rest."""
    if length == tile:
        return np.zeros(1, np.int64), np.ones((1, tile), np.float32)
    origins = []
    i = 1
    while tile * i - overlap * (i - 1) < length:
        origins.append((tile - overlap) * (i - 1))
        i += 1
    prev_end = origins[-1] + tile
    origins.append(length - tile)
    acc = np.zeros((len(origins), length))   # weight of tile t at pixel g
    for t, s in enumerate(origins):
        if t == 0:
            acc[0, :tile] = 1.0
            continue
        last = t == len(origins) - 1
        ramp = (prev_end - s) if last else overlap
        flat = prev_end if last else s + overlap
        end = length if last else s + tile
        if ramp >= 2:
            j = np.arange(ramp) / (ramp - 1)
            acc[:, s:s + ramp] *= 1.0 - j
            acc[t, s:s + ramp] += j
        acc[:, flat:end] = 0.0
        acc[t, flat:end] = 1.0
    w = np.stack([acc[t, s:s + tile] for t, s in enumerate(origins)])
    return np.asarray(origins, np.int64), w.astype(np.float32)


def tiled(fn, image: torch.Tensor, tile: int = 256, overlap: int = 64,
          block: int = 60) -> torch.Tensor:
    """Blend fn over the tiles of `image` (..., H, W): fn maps (N, ..., t, t)
    tiles to outputs of the same shape; tiles run `block` at a time."""
    h, w = image.shape[-2:]
    oy, wy = axis_weights(h, tile, overlap)
    ox, wx = axis_weights(w, tile, overlap)
    dev = image.device
    wy, wx = torch.from_numpy(wy).to(dev), torch.from_numpy(wx).to(dev)
    coords = [(a, b) for a in range(len(oy)) for b in range(len(ox))]
    canvas = torch.zeros(image.shape, dtype=torch.float32, device=dev)
    for c0 in range(0, len(coords), block):
        part = coords[c0:c0 + block]
        tiles = torch.stack([image[..., oy[a]:oy[a] + tile,
                                   ox[b]:ox[b] + tile] for a, b in part])
        outs = fn(tiles)
        for (a, b), o in zip(part, outs):
            canvas[..., oy[a]:oy[a] + tile, ox[b]:ox[b] + tile] += (
                o * (wy[a][:, None] * wx[b][None, :]))
    return canvas


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """np.percentile(x, q), linear rule, rank in float64."""
    srt = torch.sort(x.reshape(-1)).values
    n = srt.numel()
    pos = q / 100.0 * (n - 1)
    i0 = int(np.floor(pos))
    frac = pos - i0
    return srt[i0] * (1.0 - frac) + srt[min(i0 + 1, n - 1)] * frac


def _stretch(x, lo, hi):
    d = hi - lo
    d = torch.where(d == 0, d + unet.EPS, d)
    return (x - lo) / d


def colour_out(rgb_p: torch.Tensor, luma: torch.Tensor, dy: int, dx: int
               ) -> torch.Tensor:
    """Padded min-shifted rgb (H, W, 3) and tone-mapped luma (H, W) ->
    uint8 (h, w, 3) with the pad removed."""
    lo, hi = percentile(luma, 0.5), percentile(luma, 99.5)
    luma = _stretch(torch.clamp(luma, lo, hi), lo, hi)
    rgb_p = rgb_p - torch.clamp(rgb_p.min(), max=0.0)
    w = torch.tensor(REC601, dtype=rgb_p.dtype, device=rgb_p.device)
    gray = (rgb_p * w).sum(-1, keepdim=True)
    im = torch.pow(rgb_p / (gray + unet.EPS), 0.5) * luma[..., None]
    top = im.max()
    h, w_ = im.shape[0], im.shape[1]
    im = im[dy // 2:h - (dy - dy // 2), dx // 2:w_ - (dx - dx // 2)]
    im = torch.clamp(torch.minimum(torch.clamp(im, min=0.0), top), 0.0, 1.0)
    im = torch.clamp(_stretch(im, percentile(im, 0.1), percentile(im, 99.0)),
                     0.0, 1.0)
    return (im * 255.0).to(torch.uint8)


def tonemap_image(p, rgb: torch.Tensor, f_factor: float,
                  prec: unet.Precision | None = None, block: int = 60
                  ) -> torch.Tensor:
    """(H, W, 3) radiance -> uint8 (H, W, 3), tiled 256 / 64."""
    rgb, luma = network_input(rgb, f_factor)
    h, w = luma.shape
    th, tw = grid_size(h), grid_size(w)
    luma_p = pad_hw(luma, th, tw)
    rgb_p = pad_hw(rgb.permute(2, 0, 1), th, tw).permute(1, 2, 0)

    def net(tiles):
        out, _ = unet.generator_frame(p, tiles[:, None], None, prec)
        return out[:, 0]

    fake = tiled(net, luma_p, block=block)
    return colour_out(rgb_p, fake, th - h, tw - w)


def tonemap_scene(p, rgbs: torch.Tensor, f_factor: float,
                  prec: unet.Precision | None = None, block: int = 60
                  ) -> torch.Tensor:
    """(T, H, W, 3) radiance frames of one scene, one lambda -> uint8
    (T, H, W, 3): every tile's frame sequence through the carry."""
    pairs = [network_input(r, f_factor) for r in rgbs]
    h, w = pairs[0][1].shape
    th, tw = grid_size(h), grid_size(w)
    lumas = pad_hw(torch.stack([g for _, g in pairs]), th, tw)

    def net(tiles):                           # (N, T, t, t)
        return unet.generator_scene(p, tiles[:, :, None], prec)[:, :, 0]

    fakes = tiled(net, lumas, block=block)
    outs = []
    for (rgb, _), fake in zip(pairs, fakes):
        rgb_p = pad_hw(rgb.permute(2, 0, 1), th, tw).permute(1, 2, 0)
        outs.append(colour_out(rgb_p, fake, th - h, tw - w))
    return torch.stack(outs)
