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

`pil_bicubic_resize_u8` is PIL's antialiased bicubic resample of uint8
images (`Image.resize(..., BICUBIC)`, libImaging `Resample.c`), which the
FID protocol resizes with (`uncltmo_tpu/metrics/fid.py:46-54`): written
here on the host in integer arithmetic and bit-exact, because PIL is not
a dependency of the port.
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


# PIL's fixed point: 8-bit samples times coefficients of 22 fraction bits
_PIL_PRECISION_BITS = 22


def _pil_bicubic_filter(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic kernel (a = -0.5), its expressions in its order."""
    x = np.abs(x)
    near = ((-0.5 + 2.0) * x - (-0.5 + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * -0.5
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


@functools.lru_cache(maxsize=16)
def _pil_coeffs(n_in: int, n_out: int) -> tuple:
    """PIL's fixed-point taps (`precompute_coeffs` + `normalize_coeffs_8bpc`):
    support 2 x max(n_in / n_out, 1), each output's taps normalised in
    double, then scaled by 2^22 and rounded half away from zero.  Returns
    (index, coefficient), both (n_out, taps) int64; a tap past an output's
    window has coefficient 0 (and a clamped index)."""
    scale = float(n_in) / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    taps = int(np.ceil(support)) * 2 + 1
    index = np.zeros((n_out, taps), np.int64)
    coef = np.zeros((n_out, taps), np.int64)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in)
        w = _pil_bicubic_filter(
            (np.arange(xmin, xmax, dtype=np.float64) - center + 0.5)
            * (1.0 / filterscale))
        ww = np.cumsum(w)[-1] if w.size else 0.0     # summed in order
        if ww != 0.0:
            w = w / ww
        k = w * (1 << _PIL_PRECISION_BITS)
        coef[xx, :w.size] = np.trunc(np.where(k < 0, k - 0.5, k + 0.5))
        index[xx] = np.minimum(xmin + np.arange(taps), n_in - 1)
    return index, coef


def _pil_pass(x: np.ndarray, taps: tuple, axis: int) -> np.ndarray:
    """One pass of PIL's 8-bit resample along `axis` (0 or 1) of (H, W, C)
    uint8: the sum of samples x coefficients from 2^21 in integers,
    shifted by 22 bits and clipped to uint8."""
    index, coef = taps
    acc = np.full(x.shape[:axis] + (index.shape[0],) + x.shape[axis + 1:],
                  1 << (_PIL_PRECISION_BITS - 1), np.int64)
    shape = (-1, 1, 1) if axis == 0 else (1, -1, 1)
    for t in range(index.shape[1]):
        acc += (np.take(x, index[:, t], axis=axis).astype(np.int64)
                * coef[:, t].reshape(shape))
    return np.clip(acc >> _PIL_PRECISION_BITS, 0, 255).astype(np.uint8)


def pil_bicubic_resize_u8(im: np.ndarray, out_w: int,
                          out_h: int) -> np.ndarray:
    """PIL's `Image.resize((out_w, out_h), BICUBIC)` of a uint8 image:
    (H, W) for mode L, (H, W, 3) RGB, (H, W, 4) RGBA.  Horizontal pass
    first, then vertical, each to uint8, a pass skipped where its size
    does not change.  RGBA is resampled premultiplied (PIL's RGBa) and
    un-premultiplied after, as PIL does; at the same size it is a copy.
    Returns a C-contiguous array."""
    im = np.asarray(im, np.uint8)
    if im.shape[:2] == (out_h, out_w):
        return im.copy()
    x = im[..., None] if im.ndim == 2 else im
    rgba = x.shape[-1] == 4
    if rgba:                         # RGBA -> RGBa: MULDIV255 of each colour
        a = x[..., 3:].astype(np.uint32)
        t = x[..., :3].astype(np.uint32) * a + 128
        x = np.concatenate([((t >> 8) + t) >> 8, a], -1).astype(np.uint8)
    if out_w != x.shape[1]:
        x = _pil_pass(x, _pil_coeffs(x.shape[1], out_w), axis=1)
    if out_h != x.shape[0]:
        x = _pil_pass(x, _pil_coeffs(x.shape[0], out_h), axis=0)
    if rgba:                         # RGBa -> RGBA: 255 c / a, truncated
        a = x[..., 3:].astype(np.uint32)
        c = x[..., :3].astype(np.uint32)
        keep = (a == 0) | (a == 255)
        un = np.minimum(255 * c // np.maximum(a, 1), 255)
        x = np.concatenate([np.where(keep, c, un), a], -1).astype(np.uint8)
    return x[..., 0] if im.ndim == 2 else x
