"""BTMQI, the blind tone-mapped image quality score, from the paper (port of
`uncltmo_tpu/metrics/btmqi.py`; Gu et al., "Blind Quality Assessment of
Tone-Mapped Images Using Information, Naturalness and Structure", IEEE TMM
2016).

The reference ships BTMQI as encrypted MATLAB p-code and a libsvm model
(`metrics/BTMQI_metric/{BTMQI.p, model.mat}`), so the JAX package
reconstructs the 11 features from the paper: five entropies of the
Gaussian-smoothed image under gamma re-exposures, four dyadic-scale mean
gradient energies, TMQI's statistical naturalness, and the dispersion of
the gradient energy.  `btmqi(image)` returns the surrogate scalar of those
features; `btmqi(image, model_mat=...)` runs the reference's nu-SVR
(`SVRModel`, libsvm's RBF decision value, float64 on the host) on them.
See the JAX module's docstring for what the reconstruction can and cannot
claim.

The features run in torch on `device` (the card unless the caller asks for
the CPU).  The entropies put `x * 4095` truncated into 4096 bins, so a
smoothed value on the other side of a bin edge moves an entropy: the
smoothing runs in float64 and is cast to float32, which puts the bins
where the JAX package's float32 smoothing puts them on the golden render
(a float32 convolution in another order moves 5-8 bins).
"""
from __future__ import annotations

import os
from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from uncltmo_tpu_torch import params as P
from uncltmo_tpu_torch.metrics.tmqi import statistical_naturalness
from uncltmo_tpu_torch.ops.windows import (fspecial_gauss_1d, window_mean,
                                           window_var)

_EXPOSURES = (0.0, 1.0, 2.0, 3.0, 4.0)
_N_SCALES = 4
_BINS = 4096


def _entropy(x01: torch.Tensor) -> torch.Tensor:
    """Shannon entropy (bits) of a [0, 1] image quantised to 4096 bins: the
    smoothed field is continuous-valued, so it can exceed the 8 bits of
    the source (the SV column-0 envelope reaches ~11.4)."""
    idx = torch.clamp((x01 * (_BINS - 1)).to(torch.int32), 0, _BINS - 1)
    hist = torch.bincount(idx.reshape(-1), minlength=_BINS).to(torch.float32)
    p = hist / hist.sum()
    return -torch.sum(torch.where(
        p > 0, p * torch.log2(torch.clamp(p, min=1e-12)),
        torch.zeros_like(p)))


def _half_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling (the dyadic scale step), odd edges truncated."""
    h, w = x.shape[0] // 2 * 2, x.shape[1] // 2 * 2
    x = x[:h, :w]
    return 0.25 * (x[0::2, 0::2] + x[1::2, 0::2]
                   + x[0::2, 1::2] + x[1::2, 1::2])


def _grad_energy(x01: torch.Tensor) -> torch.Tensor:
    """Local gradient energy: the 11x11 Gaussian-window std, (H', W')."""
    gvar = window_var(x01[None, None], fspecial_gauss_1d(11, 1.5))[0, 0]
    return torch.sqrt(torch.clamp(gvar, min=0.0))


def _smoothed_mean(x01: torch.Tensor, kernel_1d) -> torch.Tensor:
    """Separable Gaussian local mean, same size through edge padding, in
    float64 and cast back to the input's dtype."""
    pad = len(kernel_1d) // 2
    xp = F.pad(x01.to(torch.float64)[None, None], (pad, pad, pad, pad),
               mode="replicate")
    return window_mean(xp, kernel_1d)[0, 0].to(x01.dtype)


def btmqi_features(gray01: torch.Tensor) -> torch.Tensor:
    """The 11-D feature vector of a grayscale tone-mapped image in [0, 1],
    (H, W) float32, laid out as the model.mat support-vector columns:

      [0:5]  entropy (bits) of the smoothed image under the gamma
             re-exposures I^(2^k), k = 0..4;
      [5:9]  16 x the mean local gradient energy at 4 dyadic scales;
      [9]    TMQI statistical naturalness, in [0, 1];
      [10]   the std of the scale-0 gradient energy map.
    """
    mu = torch.clamp(_smoothed_mean(gray01, fspecial_gauss_1d(11, 1.5)),
                     0.0, 1.0)
    feats = [_entropy(mu ** (2.0 ** k)) for k in _EXPOSURES]
    x = gray01
    for _ in range(_N_SCALES):
        feats.append(16.0 * torch.mean(_grad_energy(x)))
        x = _half_pool(x)
    feats.append(statistical_naturalness(gray01 * 255.0))
    feats.append(torch.std(_grad_energy(gray01), correction=0))
    return torch.stack(feats)


class SVRModel:
    """An RBF-kernel (nu-/epsilon-)SVR in libsvm's parameterisation."""

    def __init__(self, support_vectors: np.ndarray, sv_coef: np.ndarray,
                 rho: float, gamma: float):
        self.support_vectors = np.asarray(support_vectors, np.float64)
        self.sv_coef = np.ravel(np.asarray(sv_coef, np.float64))
        self.rho = float(rho)
        self.gamma = float(gamma)
        if self.support_vectors.shape[0] != self.sv_coef.shape[0]:
            raise ValueError(
                f"{self.support_vectors.shape[0]} support vectors but "
                f"{self.sv_coef.shape[0]} coefficients")

    def predict(self, features: np.ndarray) -> np.ndarray:
        """libsvm's decision value: sum_i coef_i K(SV_i, x) - rho with
        K(u, v) = exp(-gamma ||u - v||^2) (svm.cpp `svm_predict_values`,
        RBF), float64."""
        x = np.atleast_2d(np.asarray(features, np.float64))
        d2 = ((self.support_vectors[None, :, :] - x[:, None, :]) ** 2
              ).sum(-1)
        out = np.exp(-self.gamma * d2) @ self.sv_coef - self.rho
        return out if out.shape[0] > 1 else out[0]


def load_svr_model(model_mat_path: str) -> SVRModel:
    """A libsvm MATLAB model struct (the reference's
    `metrics/BTMQI_metric/model.mat`): Parameters = [svm_type,
    kernel_type, degree, gamma, coef0]; only the RBF kernel (kernel_type
    2) that the BTMQI model uses is taken."""
    import scipy.io as sio
    if not os.path.exists(model_mat_path):
        raise FileNotFoundError(f"SVR model not found: {model_mat_path}")
    m = sio.loadmat(model_mat_path)["model"][0, 0]
    params = np.ravel(np.asarray(m["Parameters"], np.float64))
    kernel_type = int(params[1])
    if kernel_type != 2:
        raise ValueError(f"only the RBF kernel is supported "
                         f"(kernel_type={kernel_type})")
    svs = m["SVs"]
    if hasattr(svs, "toarray"):     # MATLAB sparse
        svs = svs.toarray()
    return SVRModel(np.asarray(svs, np.float64), m["sv_coef"],
                    float(np.ravel(m["rho"])[0]), gamma=float(params[3]))


def btmqi(image: np.ndarray,
          model_mat: Union[None, str, SVRModel] = None,
          device="cuda") -> Tuple[float, np.ndarray]:
    """Blind quality score (higher is better) and the feature vector.

    image: (H, W) or (H, W, 3) tone-mapped LDR in [0, 1] or [0, 255]; its
    gray (Rec. 709) is taken on the host, as the JAX package takes it, and
    the features on `device`.  Without `model_mat`: the surrogate scalar.
    With it (a path to the reference's libsvm model.mat, or a loaded
    `SVRModel`): the reference's SVR on the reconstructed features."""
    im = np.asarray(image, np.float32)
    if im.max() > 1.5:
        im = im / 255.0
    if im.ndim == 3:
        im = im[..., :3] @ np.asarray(P.REC709, np.float32)
    f = btmqi_features(torch.from_numpy(np.ascontiguousarray(im)).to(
        device)).cpu().numpy()
    if model_mat is not None:
        model = (model_mat if isinstance(model_mat, SVRModel)
                 else load_svr_model(model_mat))
        return float(model.predict(f)), f
    # surrogate: mean re-exposure entropy (/12, to ~[0, 1]) + naturalness
    # + local-contrast energy (scaled)
    score = float(f[:5].mean() / 12.0 + f[9] + f[5] / 3.0)
    return score, f
