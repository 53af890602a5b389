"""Image transforms of the reference's `tranforms.py`, channels last.

Port of `uncltmo_tpu/data/transforms.py`: numpy in, numpy out.  The
reference's one live transform is `hdr_im_transform = Compose([ToTensor()])`
(`tranforms.py:313-315`); the crops, scales, batch normalisers and display
mappers are its public surface and are kept as plain functions on
(H, W, C) images and (N, ...) batches.
"""
from __future__ import annotations

import numbers
from typing import Tuple, Union

import numpy as np
import torch

from uncltmo_tpu_torch import params as P
from uncltmo_tpu_torch.ops.resize import bicubic_resize


def to_tensor(image: np.ndarray) -> np.ndarray:
    """`ToTensor` (`tranforms.py:35-44`) without the HWC -> CHW transpose:
    a channel axis and float32."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[:, :, None]
    return image.astype(np.float32)


#: the reference's only live transform pipeline (`tranforms.py:313-315`)
hdr_im_transform = to_tensor


def _crop_size(size) -> Tuple[int, int]:
    if isinstance(size, numbers.Number):
        return int(size), int(size)
    th, tw = size
    return int(th), int(tw)


def center_crop(pic: np.ndarray, size) -> np.ndarray:
    """`CenterCrop` (`tranforms.py:51-102`), with the rows and columns the
    right way round (the reference swaps them; equal on square images)."""
    pic = np.asarray(pic)
    if pic.ndim == 2:
        pic = pic[:, :, None]
    th, tw = _crop_size(size)
    h, w = pic.shape[0], pic.shape[1]
    i = int(round((h - th) / 2.0))
    j = int(round((w - tw) / 2.0))
    return pic[i:i + th, j:j + tw, :]


def scale(pic: np.ndarray, size: Union[int, Tuple[int, int]]) -> np.ndarray:
    """`Scale` / `ScaleTensor` (`tranforms.py:158-196`): bicubic resize to
    `size` by `F.interpolate`'s bicubic rule (`ops.resize.bicubic_resize`).
    """
    pic = np.asarray(pic, np.float32)
    squeeze = pic.ndim == 2
    if squeeze:
        pic = pic[:, :, None]
    oh, ow = _crop_size(size)
    x = torch.from_numpy(np.ascontiguousarray(pic)).permute(2, 0, 1)[None]
    out = bicubic_resize(x, oh, ow)[0].permute(1, 2, 0).numpy()
    return out[:, :, 0] if squeeze else out


def normalize(tensor: np.ndarray, mean, std) -> np.ndarray:
    """`Normalize` (`tranforms.py:198-231`): (x - mean) / std per channel,
    channels on the last axis."""
    mean = np.asarray(mean, np.float32).reshape(1, 1, -1)
    std = np.asarray(std, np.float32).reshape(1, 1, -1)
    return (np.asarray(tensor, np.float32) - mean) / std


def _per_item(v: np.ndarray, ndim: int) -> np.ndarray:
    return v.reshape((-1,) + (1,) * (ndim - 1))


def max_normalization(batch: np.ndarray) -> np.ndarray:
    """`MaxNormalization` (`tranforms.py:270-282`): each item over its max."""
    batch = np.asarray(batch, np.float32)
    m = batch.reshape(batch.shape[0], -1).max(axis=1)
    return batch / _per_item(m, batch.ndim)


def minmax_normalization(batch: np.ndarray) -> np.ndarray:
    """`MinMaxNormalization` (`tranforms.py:284-295`): each item
    (x - min) / (max - min + eps)."""
    batch = np.asarray(batch, np.float32)
    flat = batch.reshape(batch.shape[0], -1)
    lo = _per_item(flat.min(axis=1), batch.ndim)
    hi = _per_item(flat.max(axis=1), batch.ndim)
    return (batch - lo) / (hi - lo + P.EPSILON)


def clip_display(x: np.ndarray) -> np.ndarray:
    """`Clip` (`tranforms.py:298-305`): x * 1.05 clamped to [0, 1]."""
    return np.clip(np.asarray(x, np.float32) * 1.05, 0.0, 1.0)


def exp_display(batch: np.ndarray, add_clipping: bool = False) -> np.ndarray:
    """`Exp` (`tranforms.py:234-260`): e^x, optionally * 1.1 clamped to
    [0, 1]."""
    out = np.exp(np.asarray(batch, np.float32))
    if add_clipping:
        out = np.clip(out * 1.1, 0.0, 1.0)
    return out
