"""Color math on (H, W, C) tensors: Rec.601 luma, ratio-image color
re-attachment, percentile stretches (port of `uncltmo_tpu/ops/color.py`).

Percentiles follow np.percentile's "linear" rule, from one sort of the
flattened image: `torch.quantile` refuses inputs above 2^24 elements, and
`to_01_outlier` sees 2160x3840x3 at full resolution.
"""
from __future__ import annotations

import numpy as np
import torch

from uncltmo_tpu_torch import params


def to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma.  rgb: (..., 3) -> (..., 1)."""
    w = torch.tensor(params.REC601, dtype=rgb.dtype, device=rgb.device)
    return torch.sum(rgb[..., :3] * w, dim=-1, keepdim=True)


def back_to_color(im_hdr: torch.Tensor, fake_luma: torch.Tensor
                  ) -> torch.Tensor:
    """(rgb / gray)^0.5 * fake_luma (reference `hdr_image_util.py:109-132`).
    im_hdr: (H, W, 3) linear HDR; fake_luma: (H, W, 1) in [0, 1]."""
    im_hdr = im_hdr - torch.clamp(im_hdr.min(), max=0.0)
    gray = to_gray(im_hdr)
    norm_im = torch.pow(im_hdr / (gray + params.EPSILON), 0.5)
    return norm_im * fake_luma


def percentiles(x: torch.Tensor, qs) -> torch.Tensor:
    """np.percentile(x, qs) with the "linear" rule; (len(qs),) values."""
    flat = x.reshape(-1)
    n = flat.numel()
    srt = torch.sort(flat).values
    out = []
    for q in qs:
        # rank position in float32, as the JAX package computes it
        pos = np.float32(q) / np.float32(100.0) * np.float32(n - 1)
        i0 = int(np.floor(pos))
        frac = float(pos - np.float32(i0))
        v0 = srt[i0]
        v1 = srt[min(i0 + 1, n - 1)]
        out.append(v0 * (1.0 - frac) + v1 * frac)
    return torch.stack(out)


def to_01_outlier(im: torch.Tensor) -> torch.Tensor:
    """Stretch the 0.1 / 99.0 percentiles to [0, 1], then clip
    (reference `hdr_image_util.py:93-102`; epsilon denominator on a
    constant image)."""
    p = percentiles(im, (0.1, 99.0))
    im_min, im_max = p[0], p[1]
    denom = im_max - im_min
    denom = torch.where(denom == 0.0, denom + params.EPSILON, denom)
    return torch.clamp((im - im_min) / denom, 0.0, 1.0)


def percentile_clamp_stretch(fake: torch.Tensor, lo: float = 0.5,
                             hi: float = 99.5) -> torch.Tensor:
    """Clamp to the [lo, hi] percentiles, then min-max stretch to [0, 1]
    (reference `model_save_util.py:389-394`).  The clamped image's min and
    max are the two percentiles themselves."""
    p = percentiles(fake, (lo, hi))
    min_p, max_p = p[0], p[1]
    denom = max_p - min_p
    denom = torch.where(denom == 0.0, denom + params.EPSILON, denom)
    return (torch.clamp(fake, min_p, max_p) - min_p) / denom
