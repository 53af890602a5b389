"""Sliding-window statistics on NCHW tensors (port of
`uncltmo_tpu/ops/windows.py`): the separable Gaussian and box windows,
window mean / variance / covariance, the 11x11 Gaussian local-variance map
of the contrastive feature head, the global average pool, and TMQI's
helpers: `window_mean_auto` (scipy's 'valid' when the image is smaller than
the window), the moving-window and the block std means.

Every window is an outer product of a 1-D kernel, so a window statistic is
two depthwise valid 1-D convolutions (`F.conv2d` with `groups=C`).  With
TF32 off these are full float32 products, the JAX package's
`Precision.HIGHEST`.  The entry points that autocast code reaches
(`window_stats`, `contrast_map`, `adaptive_avg_pool_1`) are float32
islands (`ops/precision.py`): under bfloat16 autocast they take their
inputs as float32 and return float32.  `window_mean`, `window_var` and
`window_mean_auto` follow their inputs' dtype; every caller of theirs is
an island already (the structural loss, TMQI's naturalness) or works in
float64 (TMQI's structural fidelity).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from uncltmo_tpu_torch.ops.precision import float32_island


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """Sampled (non-normalised) Gaussian, like `scipy.signal.gaussian`."""
    n = np.arange(0, size) - (size - 1.0) / 2.0
    return np.exp(-(n ** 2) / (2.0 * sigma ** 2))


@functools.lru_cache(maxsize=None)
def fspecial_gauss_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """1-D factor of the reference's `fspecial_gauss(size, sigma)` window:
    outer(g, g) / sum(g)^2 with g the integer-grid Gaussian."""
    g = gaussian_kernel_1d(size, sigma)
    return g / g.sum()


@functools.lru_cache(maxsize=None)
def box_kernel_1d(size: int = 5) -> np.ndarray:
    return np.full((size,), 1.0 / size)


def _conv1d_valid(x: torch.Tensor, k: torch.Tensor, axis: int,
                  stride: int = 1) -> torch.Tensor:
    """Valid 1-D convolution of an NCHW tensor along H (axis=2) or W
    (axis=3), the same kernel on every channel."""
    c = x.shape[1]
    ksz = k.shape[0]
    if axis == 2:
        kern, strides = k.reshape(1, 1, ksz, 1), (stride, 1)
    else:
        kern, strides = k.reshape(1, 1, 1, ksz), (1, stride)
    return F.conv2d(x, kern.to(x.dtype).expand(c, 1, *kern.shape[2:]),
                    stride=strides, groups=c)


def window_mean(x: torch.Tensor, k1d) -> torch.Tensor:
    """Separable valid window filter of an NCHW tensor."""
    k = torch.as_tensor(np.asarray(k1d), dtype=x.dtype, device=x.device)
    return _conv1d_valid(_conv1d_valid(x, k, axis=2), k, axis=3)


def _conv1d_full(x: torch.Tensor, k: torch.Tensor, axis: int) -> torch.Tensor:
    """Full 1-D convolution (zero padding ksz - 1 on both sides) along H
    (axis=2) or W (axis=3) of an NCHW tensor, every channel alike."""
    c = x.shape[1]
    ksz = k.shape[0]
    if axis == 2:
        kern, pad = k.reshape(1, 1, ksz, 1), (ksz - 1, 0)
    else:
        kern, pad = k.reshape(1, 1, 1, ksz), (0, ksz - 1)
    return F.conv2d(x, kern.to(x.dtype).expand(c, 1, *kern.shape[2:]),
                    padding=pad, groups=c)


def window_mean_auto(x: torch.Tensor, k1d) -> torch.Tensor:
    """`window_mean`, but with scipy.signal.convolve('valid') semantics when
    the image is smaller than the window in both dimensions: the roles swap
    and the output is where the image fully overlaps the window (TMQI's
    smallest pyramid levels).  Mixed containment has no 'valid' output and
    raises `ValueError`."""
    k = torch.as_tensor(np.asarray(k1d), dtype=x.dtype, device=x.device)
    ksz = k.shape[0]
    h, w = x.shape[2], x.shape[3]
    if h >= ksz and w >= ksz:
        return window_mean(x, k1d)
    if h > ksz or w > ksz:
        raise ValueError(
            f"mixed window/image containment ({h}x{w} vs {ksz}) has no "
            "scipy 'valid' equivalent")
    y = _conv1d_full(x, k, axis=2)[:, :, h - 1:ksz]
    return _conv1d_full(y, k, axis=3)[:, :, :, w - 1:ksz]


def window_var(x: torch.Tensor, k1d) -> torch.Tensor:
    """sigma^2 = W*(x^2) - (W*x)^2 with a normalised separable window."""
    mu = window_mean(x, k1d)
    return window_mean(x * x, k1d) - mu * mu


@float32_island
def window_stats(x: torch.Tensor, y: torch.Tensor, k1d):
    """(mu_x, mu_y, var_x, var_y, cov_xy) under a separable window (valid)."""
    mu_x = window_mean(x, k1d)
    mu_y = window_mean(y, k1d)
    var_x = window_mean(x * x, k1d) - mu_x * mu_x
    var_y = window_mean(y * y, k1d) - mu_y * mu_y
    cov = window_mean(x * y, k1d) - mu_x * mu_y
    return mu_x, mu_y, var_x, var_y, cov


@float32_island
def contrast_map(x: torch.Tensor, size: int = 11, sigma: float = 1.5
                 ) -> torch.Tensor:
    """11x11 Gaussian local-variance map (the reference's ContrastExtracter):
    NCHW -> NCHW with H, W reduced by size-1.  Not clamped: small negative
    values are possible, as in the reference."""
    return window_var(x, fspecial_gauss_1d(size, sigma))


@float32_island
def adaptive_avg_pool_1(x: torch.Tensor) -> torch.Tensor:
    """Global average pool NCHW -> (N, C, 1, 1), float32: the pooled
    contrastive features enter `k |a - b|` with k = 1e3 in the losses, where
    a bfloat16 rounding of the mean would flip signs."""
    return x.mean(dim=(2, 3), keepdim=True)


def _symmetric_index(n: int, r: int, device) -> torch.Tensor:
    """Indices of np.pad(mode='symmetric') by r on both sides of n samples:
    the edge sample repeated, reflected again as often as r needs."""
    i = torch.arange(-r, n + r, device=device) % (2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def moving_std_mean(x: torch.Tensor, size: int = 11) -> torch.Tensor:
    """Mean of the per-pixel moving-window (size x size) population std:
    `scipy.ndimage.generic_filter(x, np.std, size)` with its default
    `mode='reflect'`, which is np.pad's 'symmetric' (the edge sample
    repeated; `F.pad(mode='reflect')` is numpy's 'reflect' and would skip
    it).  TMQIr's revised naturalness term (reference `TMQI.py:232`).

    x: (..., H, W) -> (...)."""
    r = size // 2
    h, w = x.shape[-2:]
    lead = x.shape[:-2]
    xp = x.reshape(-1, 1, h, w)
    xp = xp.index_select(2, _symmetric_index(h, r, x.device))
    xp = xp.index_select(3, _symmetric_index(w, r, x.device))
    k = box_kernel_1d(size)
    mu = window_mean(xp, k)
    var = window_mean(xp * xp, k) - mu * mu
    std = torch.sqrt(torch.clamp(var, min=0.0))
    return std.mean(dim=(1, 2, 3)).reshape(lead)


def block_std_mean(x: torch.Tensor, block: int = 11) -> torch.Tensor:
    """Mean of the population std of non-overlapping block x block tiles
    (TMQI's naturalness term, reference `TMQI.py:219-229`).

    x: (..., H, W) -> (...).  H and W are zero-padded by `block - dim %
    block`, which appends a whole block of zeros when the size already
    divides, as the reference does."""
    h, w = x.shape[-2:]
    x = F.pad(x, (0, block - w % block, 0, block - h % block))
    hb, wb = x.shape[-2] // block, x.shape[-1] // block
    v = x.reshape(*x.shape[:-2], hb, block, wb, block).transpose(-3, -2)
    v = v.reshape(*x.shape[:-2], hb * wb, block * block)
    return v.std(dim=-1, correction=0).mean(dim=-1)
