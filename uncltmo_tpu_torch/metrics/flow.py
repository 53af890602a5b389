"""Dense optical flow on the device: pyramidal Horn-Schunck in torch (port
of `uncltmo_tpu/metrics/flow_jax.py`).

The warp-error metric's flow backend on the card, and on the host where cv2
is absent: the reference estimates flow with cv2.optflow DeepFlow on the
host; this estimator runs where the frames are.  Classic Horn-Schunck with
incremental warping on an L-level pyramid: at each level the current flow
warps frame 1 onto frame 0, spatio-temporal gradients are taken at the
warped position, and `iters` Jacobi updates solve

    u <- ubar - Ix (Ix (ubar - u0) + Iy (vbar - v0) + It)
                   / (alpha^2 + Ix^2 + Iy^2)

(ubar the 4-neighbour average, u0 the flow the level's warp used).  JAX's
`map_coordinates(order=1, mode='nearest')` is `grid_sample(...,
align_corners=True, padding_mode='border')`, `jnp.gradient` is
`torch.gradient` (one-sided at the edges) and the linear `jax.image.resize`
of an upsample is `F.interpolate(mode='bilinear', align_corners=False)`:
both sample at half-pixel centres and clamp at the edges.  In eager mode a
call is 720 Jacobi updates of a few small kernels each (4 levels x 3 warps
x 60), so on the card it is bound by launches.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean of an (H, W) image; an odd last row or column is dropped."""
    h, w = x.shape
    x = x[: h - h % 2, : w - w % 2]
    return x.reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3))


def _neighbor_avg(f: torch.Tensor) -> torch.Tensor:
    """4-neighbour average with edge replication (Horn-Schunck's ubar)."""
    up = torch.cat([f[:1], f[:-1]], dim=0)
    dn = torch.cat([f[1:], f[-1:]], dim=0)
    lf = torch.cat([f[:, :1], f[:, :-1]], dim=1)
    rt = torch.cat([f[:, 1:], f[:, -1:]], dim=1)
    return 0.25 * (up + dn + lf + rt)


def _sample(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor
            ) -> torch.Tensor:
    """Bilinear samples of (C, H, W) at pixel coordinates (y, x) of shape
    (H', W'), clamped to the border -> (C, H', W')."""
    h, w = img.shape[-2:]
    grid = torch.stack([x * (2.0 / max(w - 1, 1)) - 1.0,
                        y * (2.0 / max(h - 1, 1)) - 1.0], dim=-1)
    return F.grid_sample(img[None], grid[None], mode="bilinear",
                         padding_mode="border", align_corners=True)[0]


def _warp(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor
          ) -> torch.Tensor:
    """img(p + (u, v)) of an (H, W) image."""
    h, w = img.shape
    yy = torch.arange(h, dtype=img.dtype, device=img.device)[:, None]
    xx = torch.arange(w, dtype=img.dtype, device=img.device)[None, :]
    return _sample(img[None], yy + v, xx + u)[0]


def _grad(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    gy, gx = torch.gradient(img)
    return gx, gy


def _hs_level(i0, i1, u, v, alpha: float, iters: int):
    """Horn-Schunck at one pyramid level, linearised around the warp by
    (u, v)."""
    i1w = _warp(i1, u, v)
    ix0, iy0 = _grad(i0)
    ix1, iy1 = _grad(i1w)
    ix = 0.5 * (ix0 + ix1)
    iy = 0.5 * (iy0 + iy1)
    it = i1w - i0
    denom = alpha * alpha + ix * ix + iy * iy
    uu, vv = u, v
    for _ in range(iters):
        ubar = _neighbor_avg(uu)
        vbar = _neighbor_avg(vv)
        t = (ix * (ubar - u) + iy * (vbar - v) + it) / denom
        uu, vv = ubar - ix * t, vbar - iy * t
    return uu, vv


def _upsample(f: torch.Tensor, shape) -> torch.Tensor:
    return F.interpolate(f[None, None], size=tuple(shape), mode="bilinear",
                         align_corners=False)[0, 0]


def horn_schunck_flow(img0: torch.Tensor, img1: torch.Tensor,
                      levels: int = 4, iters: int = 60, warps: int = 3,
                      alpha: float = 0.08) -> torch.Tensor:
    """Dense flow f with img1(p + f(p)) ~= img0(p) (the warp error's
    convention).  img0, img1: (H, W) in [0, 1], on any device.  Returns
    (H, W, 2) float32 with f[..., 0] = dx and f[..., 1] = dy."""
    img0 = img0.to(torch.float32)
    img1 = img1.to(torch.float32)
    pyr = [(img0, img1)]
    for _ in range(levels - 1):
        a, b = pyr[-1]
        pyr.append((_avg_pool2(a), _avg_pool2(b)))
    a = pyr[-1][0]
    u = torch.zeros_like(a)
    v = torch.zeros_like(a)
    with torch.no_grad():
        for lvl in range(levels - 1, -1, -1):
            a, b = pyr[lvl]
            if u.shape != a.shape:
                u = 2.0 * _upsample(u, a.shape)
                v = 2.0 * _upsample(v, a.shape)
            for _ in range(warps):
                u, v = _hs_level(a, b, u, v, alpha, iters)
    return torch.stack([u, v], dim=-1)


def estimate_inv_flow_torch(img0_u8, img1_u8, device="cuda") -> torch.Tensor:
    """The warp error's on-device backend: uint8 grayscale frames in, the
    (H, W, 2) float32 flow out.  numpy frames go to `device`; tensors stay
    on theirs."""
    def as01(im):
        if not isinstance(im, torch.Tensor):
            im = torch.from_numpy(np.ascontiguousarray(im)).to(device)
        return im.to(torch.float32) / 255.0
    return horn_schunck_flow(as01(img0_u8), as01(img1_u8))
