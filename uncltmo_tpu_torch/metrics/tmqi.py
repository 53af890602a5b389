"""TMQI's statistical naturalness (port of `uncltmo_tpu/metrics/tmqi.py:
37-76`; Yeganeh & Wang, IEEE TIP 2013; reference `TMQI.py:210-242`):

    N = beta.pdf(sig / 64.29; 4.4, 10.1) / C0
        * norm.pdf(mu; 115.94, 27.99) / B0

with `mu` the mean of a grayscale LDR image in [0, 255], `sig` the mean
standard deviation of its 11x11 blocks, and C0, B0 the densities' maxima.
This is the part of TMQI the training losses use (they rank samples and
patches by it).  The densities are written in closed form, in float32 on
the tensor's device; the beta density's constant is computed in float64 on
the host.

Structural fidelity, the revised naturalness (TMQIr) and the `tmqi` entry
are not ported yet: they raise `NotImplementedError` (ROADMAP Queue 1
item 4).
"""
from __future__ import annotations

import math

import torch

from uncltmo_tpu_torch.ops.windows import block_std_mean

# naturalness priors (reference `TMQI.py:210-242`)
_PHAT1, _PHAT2 = 4.4, 10.1
_MUHAT, _SIGMAHAT = 115.94, 27.99

_NOT_PORTED = ("is not ported yet: the port holds the naturalness score of "
               "the training losses only (ROADMAP Queue 1 item 4)")

_LOG_BETA = (math.lgamma(_PHAT1) + math.lgamma(_PHAT2)
             - math.lgamma(_PHAT1 + _PHAT2))


def _beta_pdf(x):
    """Beta(4.4, 10.1) density of a tensor or a float in (0, 1)."""
    if isinstance(x, float):
        return math.exp((_PHAT1 - 1.0) * math.log(x)
                        + (_PHAT2 - 1.0) * math.log1p(-x) - _LOG_BETA)
    return torch.exp((_PHAT1 - 1.0) * torch.log(x)
                     + (_PHAT2 - 1.0) * torch.log1p(-x) - _LOG_BETA)


def statistical_naturalness(ldr: torch.Tensor,
                            revised: bool = False) -> torch.Tensor:
    """N of grayscale LDR images in [0, 255]: (..., H, W) -> (...).

    Outside the beta density's support [0, 1] the value is 0 (scipy's
    rule); inside, the argument is clipped to [1e-6, 1 - 1e-6]."""
    if revised:
        raise NotImplementedError("TMQIr's moving-window naturalness "
                                  + _NOT_PORTED)
    u = ldr.mean(dim=(-2, -1))
    x = block_std_mean(ldr, 11) / 64.29
    c0 = _beta_pdf((_PHAT1 - 1.0) / (_PHAT1 + _PHAT2 - 2.0))
    c = torch.where((x < 0.0) | (x > 1.0), torch.zeros_like(x),
                    _beta_pdf(x.clamp(1e-6, 1.0 - 1e-6)))
    z = (u - _MUHAT) / _SIGMAHAT
    b_over_b0 = torch.exp(-0.5 * z * z)
    return b_over_b0 * (c / c0)


def batched_naturalness(ldr_bhw: torch.Tensor) -> torch.Tensor:
    """N of each image of a (B, H, W) batch in [0, 255] -> (B,)."""
    return statistical_naturalness(ldr_bhw)


def structural_fidelity(*args, **kwargs):
    raise NotImplementedError("structural_fidelity " + _NOT_PORTED)


def tmqi_gray(*args, **kwargs):
    raise NotImplementedError("tmqi_gray " + _NOT_PORTED)


def tmqi(*args, **kwargs):
    raise NotImplementedError("tmqi " + _NOT_PORTED)
