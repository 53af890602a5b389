"""FID with the reference's patch-vector protocol (port of
`uncltmo_tpu/metrics/fid.py`; reference `fid/fid_score.py`, a pytorch-fid
fork):

  * images decoded, a 10-px border cropped, resized to 299^2 with PIL's
    antialiased bicubic (`fid_score.py:65-81`; `ops/resize.py:
    pil_bicubic_resize_u8`, bit-exact, on the host);
  * fake-side mean shift toward 0.45 with alpha 0.8 (`:135-141`);
  * InceptionV3 Mixed_6e features (768 channels) taken as an 8x8 grid, 64 patch
    vectors an image (`:122-159`), on the card (`metrics/inception.py`);
  * at most 900 images a side (`:259-261`);
  * the Frechet distance of the two Gaussian fits, in float64 on the host
    with `scipy.linalg.sqrtm` (`:166-220`).

The extractor needs a weights file (the pytorch-fid release, or any
torchvision inception_v3 state dict): there is no random-weight fallback.
`calculate_fid_given_paths` also takes any `extractor(batch_nhwc_float01)
-> (N, 8, 8, 768)` callable.
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import numpy as np

from uncltmo_tpu_torch.ops.resize import pil_bicubic_resize_u8
from uncltmo_tpu_torch.utils.io import decode_ldr

MAX_IMAGES = 900


def _as_pil_rgb(im: np.ndarray) -> np.ndarray:
    """Decoded samples -> uint8 RGB or RGBA as PIL opens them and
    `load_fid_image` converts the modes it does not keep: L and LA to RGB
    (alpha dropped), 16-bit samples to their high byte (PIL's 48- and
    64-bit RGB(A) modes) or, for 16-bit gray, clipped at 255 (PIL's I;16 ->
    RGB)."""
    if im.dtype == np.uint16:
        im = (np.minimum(im, 255) if im.ndim == 2 else im >> 8)
    im = im.astype(np.uint8)
    if im.ndim == 3 and im.shape[2] == 2:
        im = im[..., 0]
    if im.ndim == 2:
        im = np.repeat(im[..., None], 3, axis=2)
    return im


def load_fid_image(path: str, fake_side: bool,
                   small_dset: bool = False) -> np.ndarray:
    """Crop a 10-px border, resize to 299^2 with PIL's antialiased bicubic
    (`fid_score.py:65-81`); float32 (299, 299, 3) in [0, 1].

    Values as the reference's uint8 path: real images / 255; main-protocol
    fakes stretched by their own max, then mean-shifted toward 0.45 with
    alpha 0.8 (`fid_score.py:136-141`); small-dset reals min/max-stretched
    `* 1.05 - 0.025` and clipped (`fid_score_small_dset.py:117-119`), fakes
    untouched."""
    im = _as_pil_rgb(decode_ldr(path))
    h, w = im.shape[:2]
    im = pil_bicubic_resize_u8(im[10:h - 10, 10:w - 10], 299, 299)
    im = im[..., :3].astype(np.float32)
    if small_dset:
        if not fake_side:
            # the divisor is the ORIGINAL max, as the reference evaluates
            # `(im - im.min()) / im.max()` on the unshifted array
            im = ((im - im.min()) / (im.max() or 1.0)) * 1.05 - 0.025
            im = np.clip(im, 0.0, 1.0) * 255.0
        return (im / 255.0).astype(np.float32)
    if fake_side:
        im = im / (im.max() or 1.0)
        alpha = 0.8
        im = im + alpha * (0.45 - im.mean())
        return np.clip(im, 0.0, 1.0).astype(np.float32)
    return (im / 255.0).astype(np.float32)


def activations_to_patch_vectors(acts: np.ndarray) -> np.ndarray:
    """(N, 8, 8, D) feature grid -> (N * 64, D) patch vectors
    (`fid_score.py:122-159`)."""
    n, h, w, d = acts.shape
    return acts.reshape(n * h * w, d)


def activation_statistics(patch_vectors: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
    mu = np.mean(patch_vectors, axis=0)
    sigma = np.cov(patch_vectors, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussians (`fid_score.py:166-220`),
    float64 on the host."""
    from scipy import linalg
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def path_statistics(path: str, extractor: Callable, fake_side: bool,
                    batch_size: int = 20, small_dset: bool = False,
                    shuffle_seed: Optional[int] = 10,
                    max_images: Optional[int] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    files = sorted(f for f in os.listdir(path)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    if not files:
        raise ValueError(
            f"no png/jpg/jpeg images found in {path!r} — cannot compute "
            "FID statistics (check the directory path and file formats)")
    if shuffle_seed is not None and not small_dset:
        # the main protocol shuffles with Random(10) before the 900-image
        # cap (`fid_score.py:258-261`); small-dset takes files in order
        import random
        random.Random(shuffle_seed).shuffle(files)
    files = files[:max_images if max_images else MAX_IMAGES]
    all_vecs: List[np.ndarray] = []
    for i in range(0, len(files), batch_size):
        batch = np.stack([
            load_fid_image(os.path.join(path, f), fake_side, small_dset)
            for f in files[i:i + batch_size]])
        all_vecs.append(activations_to_patch_vectors(extractor(batch)))
    return activation_statistics(np.concatenate(all_vecs, axis=0))


def calculate_fid_given_paths(paths, batch_size: int = 20,
                              extractor: Optional[Callable] = None,
                              small_dset: bool = False,
                              weights_path: Optional[str] = None,
                              max_images: Optional[int] = None,
                              device="cuda") -> float:
    """The reference CLI's entry (`fid_score.py:267-291`): paths =
    [real_dir, fake_dir].  `small_dset=True` is the
    `fid_score_small_dset.py` variant (real-side stretch, no fake mean
    shift, no shuffle).  Without a custom `extractor` a `weights_path` is
    required, and the Inception trunk runs on `device` (the card unless
    the caller asks for the CPU)."""
    if extractor is None:
        if not weights_path:
            raise RuntimeError(
                "FID needs an Inception feature extractor: pass "
                "weights_path= (pytorch-fid pt_inception-2015-12-05 "
                "weights or a torchvision inception_v3 state dict; URL in "
                "the reference's fid/inception.py:13), or a custom "
                "extractor=.")
        from uncltmo_tpu_torch.metrics.inception import (
            make_inception_extractor)
        extractor = make_inception_extractor(weights_path, device=device)
    mu1, s1 = path_statistics(paths[0], extractor, fake_side=False,
                              batch_size=batch_size, small_dset=small_dset,
                              max_images=max_images)
    mu2, s2 = path_statistics(paths[1], extractor, fake_side=True,
                              batch_size=batch_size, small_dset=small_dset,
                              max_images=max_images)
    return frechet_distance(mu1, s1, mu2, s2)
