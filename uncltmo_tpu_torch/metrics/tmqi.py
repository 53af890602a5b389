"""TMQI, the Tone-Mapped image Quality Index, and its revised variant TMQIr
(port of `uncltmo_tpu/metrics/tmqi.py`; Yeganeh & Wang, IEEE TIP 2013;
reference `TMQI.py:92-257`):

    Q = 0.8012 * S^0.3046 + 0.1988 * N^0.7088
    S = prod_l s_l^w_l over 5 pyramid levels (2x2-mean downsample),
        s_l = mean of the CSF-weighted local structural fidelity map
    N = beta.pdf(sig / 64.29; 4.4, 10.1) / C0
        * norm.pdf(mu; 115.94, 27.99) / B0

with `mu` the mean of the grayscale LDR image in [0, 255] and `sig` the
mean std of its 11x11 blocks (TMQIr: of the moving 11x11 window).  The
training losses rank samples and patches by N alone; the Tester scores
every render with Q.

N runs in the input's dtype on its device: the training losses call it on
float32 batches, as the JAX package does.  Q, S and the s-maps run in
float64 on the device, as the reference computes them (scipy), where the
JAX package runs float32: the HDR luma is kept in [0, 1] and its local
std scaled by k = 2^32 - 1 where the metric needs the reference's range,
and the scale multiplies rounding residues as well.  On an exactly flat
patch a float32 window variance or covariance E[xy] - E[x]E[y] is 0 or a
residue of a few ulps; scaled by 2^32 - 1 the residue becomes a std of
hundreds, or a covariance of tens over a denominator of c2 = 10, and the
order of a sum decides which.  A render clips its brightest percent to 1,
so its flat patches are the rule: there a float32 S depends on the order
of the sums and can leave [0, 1] (`tests/test_torch_tmqi.py::
test_saturated_renders_match_a_float64_reference` shows it for the JAX
package).  In float64 the residues are 2^29 times smaller.  On textured inputs the JAX
package and the port agree to 5e-5.  The densities are written in closed
form; the beta density's constant is computed in float64 on the host.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from uncltmo_tpu_torch.ops.color import to_gray_709
from uncltmo_tpu_torch.ops.precision import float32_island
from uncltmo_tpu_torch.ops.resize import haar_half
from uncltmo_tpu_torch.ops.windows import (block_std_mean, gaussian_kernel_1d,
                                           moving_std_mean, window_mean_auto)

_A = 0.8012
_ALPHA = 0.3046
_BETA = 0.7088
_LEVEL_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
_K_RANGE = float(2 ** 32 - 1)

# naturalness priors (reference `TMQI.py:210-242`)
_PHAT1, _PHAT2 = 4.4, 10.1
_MUHAT, _SIGMAHAT = 115.94, 27.99

_LOG_BETA = (math.lgamma(_PHAT1) + math.lgamma(_PHAT2)
             - math.lgamma(_PHAT1 + _PHAT2))


def _beta_pdf(x):
    """Beta(4.4, 10.1) density of a tensor or a float in (0, 1)."""
    if isinstance(x, float):
        return math.exp((_PHAT1 - 1.0) * math.log(x)
                        + (_PHAT2 - 1.0) * math.log1p(-x) - _LOG_BETA)
    return torch.exp((_PHAT1 - 1.0) * torch.log(x)
                     + (_PHAT2 - 1.0) * torch.log1p(-x) - _LOG_BETA)


def _tmqi_window() -> np.ndarray:
    """1-D factor of the 11x11 sigma=1.5 Gaussian window, normalised so the
    2-D outer product sums to 1 (reference `TMQI.py:117-119`, `:176`)."""
    g = gaussian_kernel_1d(11, 1.5)
    return g / g.sum()


@float32_island
def statistical_naturalness(ldr: torch.Tensor,
                            revised: bool = False) -> torch.Tensor:
    """N of grayscale LDR images in [0, 255]: (..., H, W) -> (...).

    `revised` takes TMQIr's moving-window std with symmetric borders
    (reference `TMQI.py:230-232`) instead of the 11x11 blocks.  Outside the
    beta density's support [0, 1] the value is 0 (scipy's rule); inside,
    the argument is clipped to [1e-6, 1 - 1e-6].  A float32 island
    (`ops/precision.py`): float32, with autocast off, whatever the caller's
    compute dtype (the pseudo-label and infoNCE2 losses of a bfloat16
    training step reach it)."""
    u = ldr.mean(dim=(-2, -1))
    sig = moving_std_mean(ldr, 11) if revised else block_std_mean(ldr, 11)
    x = sig / 64.29
    c0 = _beta_pdf((_PHAT1 - 1.0) / (_PHAT1 + _PHAT2 - 2.0))
    c = torch.where((x < 0.0) | (x > 1.0), torch.zeros_like(x),
                    _beta_pdf(x.clamp(1e-6, 1.0 - 1e-6)))
    z = (u - _MUHAT) / _SIGMAHAT
    b_over_b0 = torch.exp(-0.5 * z * z)
    return b_over_b0 * (c / c0)


def batched_naturalness(ldr_bhw: torch.Tensor) -> torch.Tensor:
    """N of each image of a (B, H, W) batch in [0, 255] -> (B,)."""
    return statistical_naturalness(ldr_bhw)


def _s_local(hdr01, ldr, sf: float, k_hdr: float, k_ldr=1.0):
    """One pyramid level's structural fidelity (reference `TMQI.py:174-207`).

    hdr01: (1, 1, H, W) HDR luma in [0, 1] (x k_hdr = the metric's range);
    ldr: (1, 1, H, W) in [0, 255].  `k_ldr` rescales the LDR's local std
    the same way (TMQIr rescales both images to 2^32 - 1; an affine rescale
    enters the s-map only through the stds and the covariance, so a scalar
    factor is exact).  Returns (mean of the s-map, the (H', W') s-map)."""
    win = _tmqi_window()
    mu1 = window_mean_auto(hdr01, win)
    mu2 = window_mean_auto(ldr, win)
    sig1_sq = window_mean_auto(hdr01 * hdr01, win) - mu1 * mu1
    sig2_sq = window_mean_auto(ldr * ldr, win) - mu2 * mu2
    sig12 = window_mean_auto(hdr01 * ldr, win) - mu1 * mu2
    sig1 = torch.sqrt(torch.clamp(sig1_sq, min=0.0)) * k_hdr
    sig2 = torch.sqrt(torch.clamp(sig2_sq, min=0.0)) * k_ldr
    sig12 = sig12 * k_hdr * k_ldr

    csf = 100.0 * 2.6 * (0.0192 + 0.114 * sf) * np.exp(-(0.114 * sf) ** 1.1)
    u_hdr = 128.0 / (1.4 * csf)
    sig_hdr = u_hdr / 3.0
    sig1p = torch.special.ndtr((sig1 - u_hdr) / sig_hdr)
    sig2p = torch.special.ndtr((sig2 - u_hdr) / sig_hdr)

    c1, c2 = 0.01, 10.0
    s_map = ((2.0 * sig1p * sig2p + c1) / (sig1p ** 2 + sig2p ** 2 + c1)
             * ((sig12 + c2) / (sig1 * sig2 + c2)))
    return s_map.mean(), s_map[0, 0]


def structural_fidelity(hdr01: torch.Tensor, ldr: torch.Tensor,
                        k_hdr: float = _K_RANGE, k_ldr=1.0):
    """5-level S (reference `TMQI.py:145-168`) of (H, W) images.  Returns
    (S, the five s_l, the five s-maps), all tensors."""
    f = 32.0
    s_locals, s_maps = [], []
    x, y = hdr01[None, None], ldr[None, None]
    for _ in _LEVEL_WEIGHTS:
        f = f / 2.0
        sl, sm = _s_local(x, y, f, k_hdr, k_ldr)
        s_locals.append(sl)
        s_maps.append(sm)
        x = haar_half(x)
        y = haar_half(y)
    s = torch.prod(torch.stack(
        [sl ** w for sl, w in zip(s_locals, _LEVEL_WEIGHTS)]))
    return s, s_locals, s_maps


def _tmqi_full(hdr: torch.Tensor, ldr: torch.Tensor, revised: bool = False):
    """Q, S, N, the s_l and the s-maps of (H, W) grayscale images, computed
    in float64.  revised=True is TMQIr (reference `TMQI.py:245-257`): the
    LDR rescaled to the 2^32 - 1 range in S as well, and the moving-window
    naturalness."""
    hdr, ldr = hdr.to(torch.float64), ldr.to(torch.float64)
    n = statistical_naturalness(ldr, revised=revised)
    hdr01 = (hdr - hdr.min()) / (hdr.max() - hdr.min())
    k_ldr = (_K_RANGE / (ldr.max() - ldr.min())) if revised else 1.0
    s, s_locals, s_maps = structural_fidelity(hdr01, ldr, _K_RANGE, k_ldr)
    q = _A * (s ** _ALPHA) + (1.0 - _A) * (n ** _BETA)
    return q, s, n, s_locals, s_maps


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def tmqi_gray(hdr, ldr, device="cuda"):
    """Full TMQI of grayscale images: hdr (H, W) linear luminance (any
    range), ldr (H, W) in [0, 255].  Returns (Q, S, N) as 0-dim tensors."""
    q, s, n, _, _ = _tmqi_full(_as_tensor(hdr, device), _as_tensor(ldr, device))
    return q, s, n


def tmqi(hdr_image, ldr_image, revised: bool = False, device="cuda"):
    """The reference's entry (`TMQI.py:92-103`): RGB or gray images, numpy
    arrays or tensors, on `device` (the card unless the caller asks for
    the CPU; a tensor is moved there).  Returns (Q, S, N, s_local, s_maps):
    floats, a list of five floats, and the five s-maps as tensors on the
    device.  `revised` is TMQIr (the metric CLI's --revised)."""
    hdr = _as_tensor(hdr_image, device)
    ldr = _as_tensor(ldr_image, device)
    # the reference asserts equal shapes up front (`TMQI.py:94`)
    if hdr.shape != ldr.shape:
        raise ValueError(f"TMQI needs images of one shape, got "
                         f"{tuple(hdr.shape)} and {tuple(ldr.shape)}")
    if hdr.dim() == 3:
        hdr, ldr = to_gray_709(hdr), to_gray_709(ldr)
    q, s, n, s_locals, s_maps = _tmqi_full(hdr, ldr, revised=revised)
    vals = torch.stack([q, s, n] + list(s_locals)).tolist()
    return vals[0], vals[1], vals[2], vals[3:], s_maps


class TMQI:
    """Callable with the reference class's API (`TMQI.py:73`)."""

    revised = False

    def __init__(self, device="cuda"):
        self.device = device

    def __call__(self, hdrImage, ldrImage, window=None):
        return tmqi(hdrImage, ldrImage, revised=self.revised,
                    device=self.device)


class TMQIr(TMQI):
    """The revised variant (`TMQI.py:245-257`): both images rescaled to the
    2^32 - 1 range in S; the moving-window naturalness std."""

    revised = True
