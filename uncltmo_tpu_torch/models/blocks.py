"""U-Net building blocks (NCHW), the published configuration.

Port of `uncltmo_tpu/models/blocks.py` (reference `unet_parts.py`).  Module
attribute names follow the reference `.pth` layout, so `state_dict()` keys
are those of a published checkpoint (`inc.conv.conv`,
`down_path.{i}.mpconv.1.conv1`, `up_path.{i}.up`, `outc.conv`, ...).

* The published DoubleConv cells (valid 3x3 conv -> relu, twice) run as one
  call of the fused kernel K2 (`ops/kernels/double_conv.py`).
* The `square_and_square_root` skip concat runs as the kernel K1
  (`ops/kernels/concat_skip.py`).
* The decoder's `ConvTranspose2d(k=3)` and the 2x2 upsample
  `ConvTranspose2d(k=2, s=2)` are torch's own layers on the reference
  weights (the JAX package stores the flipped kernel of a full-pad conv;
  `utils/convert.py` undoes that).
* Other con_operators, norms, `up_mode` and `bilinear` are not part of the
  published configuration and raise NotImplementedError (ROADMAP Queue 1
  item 2).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from uncltmo_tpu_torch import params
from uncltmo_tpu_torch.ops.kernels.concat_skip import fused_concat_skip
from uncltmo_tpu_torch.ops.kernels.double_conv import (
    fused_double_conv3x3, pack_double_conv_weights, weights_key)

_NOT_PORTED = ("not ported yet: the port covers the published generator "
               "configuration (ROADMAP Queue 1 item 2)")


def _pad_mode(padding_mode: str) -> str:
    """torch F.pad mode of a model padding name ('edge'/'replicate' or
    'constant'/'zeros')."""
    mode = {"edge": "replicate", "zeros": "constant"}.get(padding_mode,
                                                         padding_mode)
    if mode not in ("replicate", "constant"):
        raise NotImplementedError(f"padding_mode {padding_mode!r} "
                                  + _NOT_PORTED)
    return mode


def _check_supported(unet_norm: str, activation: str) -> None:
    if unet_norm != "none":
        raise NotImplementedError(f"unet_norm={unet_norm!r} " + _NOT_PORTED)
    if activation != "relu":
        raise NotImplementedError(f"activation={activation!r} " + _NOT_PORTED)


class DoubleConv(nn.Module):
    """(valid conv3x3 => relu) * 2 (reference `unet_parts.py:10-87`), one
    launch of K2 on CUDA.  Parameters `conv`, `conv1` as in the reference."""

    def __init__(self, in_ch: int, out_ch: int, unet_norm: str = "none",
                 activation: str = "relu"):
        super().__init__()
        _check_supported(unet_norm, activation)
        self.conv = nn.Conv2d(in_ch, out_ch, 3)
        self.conv1 = nn.Conv2d(out_ch, out_ch, 3)
        self._packed = None        # (weights_key, PackedDoubleConv)

    def _weights(self):
        return (self.conv.weight, self.conv.bias, self.conv1.weight,
                self.conv1.bias)

    def packed_weights(self):
        """The kernel's weight layout, packed once and again only after a
        reload, a cast, a move or an in-place update of a parameter."""
        key = weights_key(*self._weights())
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, pack_double_conv_weights(*self._weights()))
        return self._packed[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        packed = self.packed_weights() if x.is_cuda else None
        return fused_double_conv3x3(x, *self._weights(), packed=packed)


class InConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, unet_norm: str = "none",
                 activation: str = "relu"):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch, unet_norm, activation)

    def forward(self, x):
        return self.conv(x)


class DoubleLastConv(nn.Module):
    """conv3x3 => relu => ConvTranspose2d(k=3) => relu
    (reference `unet_parts.py:90-141`, doubleConvTranspose)."""

    def __init__(self, in_ch: int, out_ch: int, unet_norm: str = "none",
                 activation: str = "relu"):
        super().__init__()
        _check_supported(unet_norm, activation)
        self.conv = nn.Conv2d(in_ch, out_ch, 3)
        self.conv1 = nn.ConvTranspose2d(out_ch, out_ch, 3)

    def forward(self, x):
        return F.relu(self.conv1(F.relu(self.conv(x))))


class Down(nn.Module):
    """2x2 max pool then a conv cell (`mpconv.1` in the reference layout)."""

    def __init__(self, cell: nn.Module):
        super().__init__()
        self.mpconv = nn.Sequential(nn.MaxPool2d(2, 2), cell)

    def forward(self, x):
        return self.mpconv(x)


class DoubleConvT(nn.Module):
    """(ConvTranspose2d(k=3) => relu) * 2 (reference `unet_parts.py:144-193`);
    grows the spatial size by 4."""

    def __init__(self, in_ch: int, out_ch: int, unet_norm: str = "none",
                 activation: str = "relu"):
        super().__init__()
        _check_supported(unet_norm, activation)
        self.conv = nn.ConvTranspose2d(in_ch, out_ch, 3)
        self.conv1 = nn.ConvTranspose2d(out_ch, out_ch, 3)

    def forward(self, x):
        return F.relu(self.conv1(F.relu(self.conv(x))))


def _pad_or_crop(x1: torch.Tensor, diff_y: int, diff_x: int,
                 padding_mode: str) -> torch.Tensor:
    """torch F.pad semantics on (B, C, H, W) for both signs: negative amounts
    crop, positive amounts pad with `padding_mode`.  Replicate F.pad refuses
    negative pads, so the crop is done first (`blocks.py:298-312`)."""
    lo_y, hi_y = diff_y // 2, diff_y - diff_y // 2
    lo_x, hi_x = diff_x // 2, diff_x - diff_x // 2
    h, w = x1.shape[2], x1.shape[3]
    x1 = x1[:, :, max(0, -lo_y):h - max(0, -hi_y),
            max(0, -lo_x):w - max(0, -hi_x)]
    pads = (max(0, lo_x), max(0, hi_x), max(0, lo_y), max(0, hi_y))
    if any(pads):
        x1 = F.pad(x1, pads, mode=_pad_mode(padding_mode))
    return x1


def concat_skip(x2: torch.Tensor, x1: torch.Tensor,
                con_operator: str) -> torch.Tensor:
    """Skip-connection concat with the nonlinear expansions (reference
    `unet_parts.py:311-332`).  x2: encoder skip, x1: upsampled."""
    if con_operator == params.SQUARE_AND_SQUARE_ROOT:
        return fused_concat_skip(x2, x1)
    raise NotImplementedError(f"con_operator={con_operator!r} " + _NOT_PORTED)


class Up(nn.Module):
    """2x2 ConvT upsample + pad/crop to the skip + skip concat +
    DoubleConvT (reference `unet_parts.py:243-335`)."""

    def __init__(self, up_ch: int, skip_ch: int, out_ch: int,
                 con_operator: str, unet_norm: str = "none",
                 activation: str = "relu", padding_mode: str = "edge"):
        super().__init__()
        if con_operator != params.SQUARE_AND_SQUARE_ROOT:
            raise NotImplementedError(f"con_operator={con_operator!r} "
                                      + _NOT_PORTED)
        self.con_operator = con_operator
        self.padding_mode = padding_mode
        self.up = nn.ConvTranspose2d(up_ch, up_ch, 2, stride=2)
        self.conv = DoubleConvT(3 * skip_ch + up_ch, out_ch, unet_norm,
                                activation)

    def forward(self, x1, x2):
        x1 = self.up(x1)
        diff_y = x2.shape[2] - x1.shape[2]
        diff_x = x2.shape[3] - x1.shape[3]
        if diff_y or diff_x:
            x1 = _pad_or_crop(x1, diff_y, diff_x, self.padding_mode)
        return self.conv(concat_skip(x2, x1, self.con_operator))


class OutConv(nn.Module):
    """1x1 projection head (reference `unet_parts.py:338-345`)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x):
        return self.conv(x)


def last_layer_fn(name: str):
    if name == "sigmoid":
        return torch.sigmoid
    if name == "tanh":
        return torch.tanh
    if name == "msig":
        return lambda x: 1.0 / (1.0 + torch.exp(-3.0 * x))
    if name == "none":
        return lambda x: x
    raise ValueError(f"Unsupported last_layer: {name}")
