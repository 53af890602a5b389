"""Brightness-factor (lambda) estimation (port of
`uncltmo_tpu/ops/lambda_est.py`; reference `utils/adaptive_lambda.py:7-67`).

Per HDR image, the lambda in [1, 1e9] whose 20-bin histogram of
log10(gray * lambda + 1) / max is closest in cross-entropy to a mean LDR
histogram.  The histogram of that monotone transform of the gray values is
read off the sorted luminances: count(y <= e) = count(g <= (10^(e M) - 1) /
lambda), one `torch.searchsorted` per bin edge, batched over a whole grid
of lambdas.  `fit_lambda` sweeps a 512-point log grid and zooms twice, on
the card unless the caller asks for the CPU.  The thresholds are float32,
as in the JAX package; `pow` and `log10` may round an ulp apart from XLA's,
which moves a count only where a luminance sits within an ulp of a
threshold.  `fit_lambda_de` is the reference's scipy differential
evolution (scipy imported inside it).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from uncltmo_tpu_torch import params as P
from uncltmo_tpu_torch.ops.preprocess import reshape_image_np
from uncltmo_tpu_torch.utils.io import read_hdr_image


def cross_entropy_np(factor: float, gray_im: np.ndarray,
                     targets: np.ndarray, bins: int) -> float:
    """The reference's objective (`adaptive_lambda.py:7-21`) on the host."""
    y = np.log10(gray_im * factor + 1.0)
    y = y / y.max()
    pred, _ = np.histogram(y.reshape(-1), bins=bins, density=True,
                           range=(0, 1))
    return float(-np.sum(targets * np.log(pred + 1e-9)) / bins)


def _ce_for_lambdas(sorted_gray: torch.Tensor, lambdas: torch.Tensor,
                    targets: torch.Tensor, bins: int) -> torch.Tensor:
    """The cross-entropy of every lambda of a vector, float32.

    sorted_gray: (N,) ascending, normalised to max 1; lambdas: (L,);
    targets: (bins,).  Returns (L,)."""
    n = sorted_gray.shape[0]
    # jnp.linspace(0, 1, bins + 1) in float32 is i / bins, bit for bit
    edges = torch.from_numpy(np.arange(1, bins, dtype=np.float32)
                             / np.float32(bins)).to(sorted_gray.device)
    m = torch.log10(sorted_gray[-1] * lambdas + 1.0)
    thresholds = (torch.pow(10.0, edges[None, :] * m[:, None]) - 1.0
                  ) / lambdas[:, None]
    counts = torch.searchsorted(sorted_gray, thresholds, right=True)
    counts = torch.cat([counts[:, :1], torch.diff(counts, dim=1),
                        n - counts[:, -1:]], dim=1)
    density = counts.to(torch.float32) * (bins / n)
    return -torch.sum(targets * torch.log(density + 1e-9), dim=1) / bins


def fit_lambda(gray_im, targets, bins: int = 20, lo: float = 1.0,
               hi: float = 1e9, grid: int = 512, refinements: int = 2,
               device="cuda") -> float:
    """Best lambda by a log-grid sweep and `refinements` zooms onto the
    neighbours of the argmin.  gray_im: numpy or tensor, any shape."""
    if not isinstance(gray_im, torch.Tensor):
        gray_im = torch.from_numpy(np.asarray(gray_im, np.float32))
    g = gray_im.to(device=device, dtype=torch.float32).reshape(-1)
    g = torch.sort(g).values
    g = g / g[-1]
    t = torch.as_tensor(np.asarray(targets, np.float32), device=device)
    log_lo, log_hi = np.log10(lo), np.log10(hi)
    for _ in range(refinements + 1):
        lambdas = np.power(10.0, np.linspace(log_lo, log_hi, grid)).astype(
            np.float32)
        ces = _ce_for_lambdas(g, torch.from_numpy(lambdas).to(device), t,
                              bins).cpu().numpy()
        i = int(np.nanargmin(ces))
        # the zoom window: the grid points on either side of the argmin,
        # their log10 taken in float32 as the JAX package takes it
        log_lo = float(np.log10(lambdas[max(i - 1, 0)]))
        log_hi = float(np.log10(lambdas[min(i + 1, grid - 1)]))
    return float(lambdas[i])


def fit_lambda_de(gray_im: np.ndarray, targets: np.ndarray,
                  bins: int = 20, seed=None) -> float:
    """The reference's optimizer: scipy differential evolution over the same
    objective, bounds [(1, 1e9)], maxiter=1000 (`adaptive_lambda.py:
    59-60`).  Stochastic unless `seed` is given, and ~100x slower than
    `fit_lambda`."""
    from scipy import optimize
    sol = optimize.differential_evolution(
        cross_entropy_np, args=(gray_im, targets, bins),
        bounds=[(1, 1000000000)], maxiter=1000, seed=seed)
    return float(sol.x[0])


def verify_lambda_dict(f_factor_path: str, input_images_path: str,
                       extensions=None) -> bool:
    """True if every input image already has a lambda in the dict
    (`adaptive_lambda.py:24-35`).  With `extensions`, other directory
    entries are skipped, and so is the dict itself when it lives in the
    input directory: otherwise a README, or the dict, would send every run
    back to the fit."""
    if not f_factor_path or not os.path.isfile(f_factor_path):
        return False
    data = np.load(f_factor_path, allow_pickle=True)[()]
    dict_path = os.path.realpath(f_factor_path)
    for im_name in os.listdir(input_images_path):
        stem, ext = os.path.splitext(im_name)
        if extensions is not None and ext not in extensions:
            continue
        if os.path.realpath(
                os.path.join(input_images_path, im_name)) == dict_path:
            continue
        if stem not in data:
            return False
    return True


def calc_lambda(f_factor_path: str, extensions, input_images_path: str,
                mean_hist_path: str, lambda_output_path: str,
                bins: int = 20, optimizer: str = "grid",
                device="cuda") -> Optional[str]:
    """The reference's batch entry (`adaptive_lambda.py:38-67`): fits the
    lambdas a directory lacks, caching them into
    {lambda_output_path}/input_images_lambdas.npy, and returns the dict's
    path (`f_factor_path` itself when it already covers the directory).
    optimizer: 'grid' (`fit_lambda` on `device`) or 'de' (scipy)."""
    if verify_lambda_dict(f_factor_path, input_images_path, extensions):
        return f_factor_path
    print("Calculating lambdas for input data...")
    mean_data = np.load(mean_hist_path, allow_pickle=True)[()]
    targets = np.asarray(mean_data["mean_vals"], np.float32)
    out_path = os.path.join(lambda_output_path, "input_images_lambdas.npy")
    res = {}
    if os.path.isfile(out_path):
        res = np.load(out_path, allow_pickle=True)[()]
    # lambda dicts are .npy files too: never read one as an image
    skip_paths = {os.path.realpath(p)
                  for p in (f_factor_path, out_path)
                  if p and os.path.isfile(p)}
    for img_name in sorted(os.listdir(input_images_path)):
        stem, ext = os.path.splitext(img_name)
        if stem in res or ext not in extensions:
            continue
        img_path = os.path.join(input_images_path, img_name)
        if os.path.realpath(img_path) in skip_paths:
            continue
        rgb = read_hdr_image(img_path)
        gray = rgb[..., :3] @ np.asarray(P.REC601, np.float32)
        if gray.min() < 0:
            gray = gray - gray.min()
        gray = reshape_image_np(gray)
        gray = gray / gray.max()
        if optimizer == "de":
            lam = fit_lambda_de(gray, targets, bins=int(bins))
        else:
            lam = fit_lambda(gray, targets, bins=int(bins), device=device)
        print(f"[{img_name}] [{lam:.4f}]")
        res[stem] = lam
        np.save(out_path, res)
    print("Lambdas data saved successfully")
    return out_path
