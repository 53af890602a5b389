"""Structural loss: a pyramid of window-standardised MSE, NCHW.

Port of `uncltmo_tpu/losses/struct.py` (reference `models/struct_loss.py`).
The reference standardises every 5x5 window of both images and takes their
MSE; that expectation expands into five box-filter responses, so the value
and its gradients come from separable stride-1 convolutions alone:

    E_o[(a x[p+o] - b y[p+o] - c_p)^2]
        = a^2 S_xx + b^2 S_yy - 2 a b S_xy - c_p^2,
    a = 1/(std_x + e), b = 1/(std_y + e), c_p = a mu_x - b mu_y,
    S_xx = box(x^2), S_yy = box(y^2), S_xy = box(x y),
    std = sqrt(max(box(x^2) - mu^2, 0) + e2)     (e2 = 1e-5)

The expansion cancels large terms scaled by 1/sigma^2, so it is computed in
float32 whatever the input's dtype, and with autocast off (a float32 island,
`ops/precision.py`); its box filters want full float32 products (TF32
off).
"""
from __future__ import annotations

from typing import Sequence

import torch

from uncltmo_tpu_torch import params
from uncltmo_tpu_torch.ops.precision import float32_island
from uncltmo_tpu_torch.ops.resize import bicubic_half
from uncltmo_tpu_torch.ops.windows import box_kernel_1d, window_mean


@float32_island
def struct_loss_single(fake: torch.Tensor, hdr_input: torch.Tensor,
                       window_size: int = 5) -> torch.Tensor:
    """One pyramid level (`struct_loss.py:57-87`): (B, C, H, W) pairs -> a
    scalar."""
    e2 = params.EPSILON2
    k = box_kernel_1d(window_size)
    mu_x = window_mean(fake, k)
    mu_y = window_mean(hdr_input, k)
    s_xx = window_mean(fake * fake, k)
    s_yy = window_mean(hdr_input * hdr_input, k)
    s_xy = window_mean(fake * hdr_input, k)
    # torch.maximum halves the gradient at a tie, as jnp.maximum does
    zero = fake.new_zeros(())
    std_x = torch.sqrt(torch.maximum(s_xx - mu_x * mu_x, zero) + e2)
    std_y = torch.sqrt(torch.maximum(s_yy - mu_y * mu_y, zero) + e2)
    a = 1.0 / (std_x + e2)
    b = 1.0 / (std_y + e2)
    c = a * mu_x - b * mu_y
    mse = a * a * s_xx + b * b * s_yy - 2.0 * a * b * s_xy - c * c
    # the exact value is a mean of squares; the clamp keeps the optimizer
    # from exploiting a rounding residue below zero
    return torch.mean(torch.maximum(mse, zero))


def struct_loss_pyramid(fake: torch.Tensor, hdr_input: torch.Tensor,
                        pyramid_weights: Sequence[float],
                        window_size: int = 5) -> torch.Tensor:
    """Weighted sum over the pyramid (`struct_loss.py:46-54`), a bicubic
    0.5x step between levels."""
    total = 0.0
    x, y = fake, hdr_input
    for i, w in enumerate(pyramid_weights):
        total = total + w * struct_loss_single(x, y, window_size)
        if i + 1 < len(pyramid_weights):
            x = bicubic_half(x)
            y = bicubic_half(y)
    return total
