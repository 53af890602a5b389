"""Bicubic resampling with torch `F.interpolate(mode='bicubic',
align_corners=False)` semantics (port of `uncltmo_tpu/ops/resize.py`).

`bicubic_resize` (`:59-96`) is two matrix products: the whole-image path's
pad-removal downscale and the GCN's pos-embed resize.  The weight matrices
are built in float64 on the host, exactly as the JAX package builds them,
and cast to the input's dtype.  `bicubic_half` (`:21-44`) is the fixed 0.5x
step between the levels of the structural loss's pyramid: at that scale the
Keys kernel is the constant 4-tap filter [-3, 19, 19, -3] / 32 on
edge-clamped taps, a separable stride-2 convolution.  `haar_half`
(`:47-56`) is TMQI's pyramid step, a 2x2 mean with stride 2.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from uncltmo_tpu_torch.ops.windows import _conv1d_valid

# Keys cubic kernel (a = -0.75) at |x| = 1.5, 0.5, 0.5, 1.5
_BICUBIC_HALF_TAPS = (-0.09375, 0.59375, 0.59375, -0.09375)


def _keys_cubic(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel (torch's bicubic, a = -0.75)."""
    x = np.abs(x)
    out = np.zeros_like(x)
    m1 = x <= 1
    out[m1] = (a + 2) * x[m1] ** 3 - (a + 3) * x[m1] ** 2 + 1
    m2 = (x > 1) & (x < 2)
    out[m2] = a * (x[m2] ** 3 - 5 * x[m2] ** 2 + 8 * x[m2] - 4)
    return out


@functools.lru_cache(maxsize=8)
def _bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 interpolation weights: half-pixel source
    coordinates, 4 Keys taps, edge-clamped indices (a clamped tap folds its
    weight onto the border sample)."""
    w = np.zeros((n_out, n_in), np.float64)
    scale = n_in / n_out
    for i in range(n_out):
        s = (i + 0.5) * scale - 0.5
        f = int(np.floor(s))
        for t in range(-1, 3):
            idx = min(max(f + t, 0), n_in - 1)
            w[i, idx] += _keys_cubic(np.asarray(s - (f + t)))
    return w


@functools.lru_cache(maxsize=8)
def _bicubic_weights(n_in: int, n_out: int, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """`_bicubic_matrix` as a tensor on the device, kept: at 1080p the two
    matrices are 40 MB of float64 on the host, and converting and copying
    them for every frame cost more than the products."""
    return torch.as_tensor(_bicubic_matrix(n_in, n_out), dtype=dtype,
                           device=device)


def bicubic_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NCHW -> (N, C, out_h, out_w), rows first, then columns."""
    wh = _bicubic_weights(x.shape[2], out_h, x.dtype, x.device)
    ww = _bicubic_weights(x.shape[3], out_w, x.dtype, x.device)
    y = torch.einsum("oh,nchw->ncow", wh, x)
    return torch.einsum("ow,nchw->ncho", ww, y)


def bicubic_half(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NCHW with H and W halved (floor).  Output pixel i reads taps
    2i-1 .. 2i+2 clamped to the edge: one replicated sample before, and two
    after an even size (none after an odd one, whose last tap is in range)."""
    k = torch.tensor(_BICUBIC_HALF_TAPS, dtype=x.dtype, device=x.device)
    pad_h = 2 if x.shape[2] % 2 == 0 else 0
    pad_w = 2 if x.shape[3] % 2 == 0 else 0
    x = _conv1d_valid(F.pad(x, (0, 0, 1, pad_h), mode="replicate"), k,
                      axis=2, stride=2)
    return _conv1d_valid(F.pad(x, (1, pad_w, 0, 0), mode="replicate"), k,
                         axis=3, stride=2)


def haar_half(x: torch.Tensor) -> torch.Tensor:
    """TMQI's pyramid downsample (reference `TMQI.py:150-165`): the valid
    2x2 mean with stride 2, NCHW -> NCHW; odd sizes floor."""
    c = x.shape[1]
    kern = torch.full((c, 1, 2, 2), 0.25, dtype=x.dtype, device=x.device)
    return F.conv2d(x, kern, stride=2, groups=c)
