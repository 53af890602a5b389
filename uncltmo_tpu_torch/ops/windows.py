"""Sliding-window statistics on NCHW tensors (port of
`uncltmo_tpu/ops/windows.py:24-76`, `:114-142`): the separable Gaussian and
box windows, window mean / variance / covariance, the 11x11 Gaussian
local-variance map of the contrastive feature head, and the global average
pool.

Every window is an outer product of a 1-D kernel, so a window statistic is
two depthwise valid 1-D convolutions (`F.conv2d` with `groups=C`).  With
TF32 off these are full float32 products, the JAX package's
`Precision.HIGHEST`.  `block_std_mean` (`:162-181`) serves the naturalness
score of the contrastive losses.  The helpers that only the full TMQI needs
(`window_mean_auto`, `moving_std_mean`) are not ported yet (ROADMAP Queue 1,
metrics and tools).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


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


def window_var(x: torch.Tensor, k1d) -> torch.Tensor:
    """sigma^2 = W*(x^2) - (W*x)^2 with a normalised separable window."""
    mu = window_mean(x, k1d)
    return window_mean(x * x, k1d) - mu * mu


def window_stats(x: torch.Tensor, y: torch.Tensor, k1d):
    """(mu_x, mu_y, var_x, var_y, cov_xy) under a separable window (valid)."""
    mu_x = window_mean(x, k1d)
    mu_y = window_mean(y, k1d)
    var_x = window_mean(x * x, k1d) - mu_x * mu_x
    var_y = window_mean(y * y, k1d) - mu_y * mu_y
    cov = window_mean(x * y, k1d) - mu_x * mu_y
    return mu_x, mu_y, var_x, var_y, cov


def contrast_map(x: torch.Tensor, size: int = 11, sigma: float = 1.5
                 ) -> torch.Tensor:
    """11x11 Gaussian local-variance map (the reference's ContrastExtracter):
    NCHW -> NCHW with H, W reduced by size-1.  Not clamped: small negative
    values are possible, as in the reference."""
    return window_var(x, fspecial_gauss_1d(size, sigma))


def adaptive_avg_pool_1(x: torch.Tensor) -> torch.Tensor:
    """Global average pool NCHW -> (N, C, 1, 1)."""
    return x.mean(dim=(2, 3), keepdim=True)


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
