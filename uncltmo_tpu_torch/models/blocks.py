"""U-Net building blocks (NCHW): every cell of the JAX module.

Port of `uncltmo_tpu/models/blocks.py` (reference `unet_parts.py`).  Module
attribute names follow the reference `.pth` layout, so `state_dict()` keys
are those of a published checkpoint (`inc.conv.conv`, `inc.conv.norm`,
`down_path.{i}.mpconv.1.conv1`, `up_path.{i}.up`, `outc.conv`, ...).

Where the hand-written kernels run, and nowhere else:

* K2 (`ops/kernels/double_conv.py`) computes one (valid conv3x3 -> bias ->
  relu) x 2 cell, so it runs the `DoubleConv` cells that are exactly that:
  no padding, no post-pad, no norm, relu.  That is every encoder cell of
  the published generator, and of any generator with
  `g_doubleConvTranspose` or `up_mode`, no norm and relu.
* The up cell (`ops/kernels/up_cell.py`) computes K1's concat and the two
  ConvTranspose2d(k=3) + relu of a `DoubleConvT` in one float32 launch, so
  it runs the decoder cells of every float32 generator with
  `square_and_square_root`, doubleConvTranspose, relu, no norm and skip
  channels a multiple of 32 (the published one).  Where such an `Up`
  upsamples by its 2x2 ConvT and pads in a mode the kernel writes (edge or
  zeros), the same launch also runs the upsample, its bias and the pad or
  crop to the skip (`Up.fold_upsample`).
* K1 (`ops/kernels/concat_skip.py`) computes the `square_and_square_root`
  skip concat and runs it for every other generator that has that
  operator, and for a bfloat16 one (under autocast or with bfloat16
  weights), whose decoder keeps torch's layers.

Every other cell -- padded convs, batch or instance norm, leaky ReLU, the
other five skip operators -- is a different function from the TPU kernels
and runs torch's own convolutions, norms and activations, as the JAX model
runs all of its cells through XLA.  The 2x2 upsample `ConvTranspose2d(k=2,
s=2)` outside the up cell, and the decoder's `ConvTranspose2d(k=3)`
outside it, are torch's layers on the reference weights (the JAX package stores the
flipped kernel of a full-pad conv; `utils/convert.py` undoes that).

Norm layers take the mode from the caller: `train=True` normalises by the
batch and updates batch norm's running statistics, `train=False` uses
them, whatever `.train()` / `.eval()` the module was left in (the JAX
model updates them exactly when its forward is not deterministic).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from uncltmo_tpu_torch import params
from uncltmo_tpu_torch.ops.kernels.concat_skip import fused_concat_skip
from uncltmo_tpu_torch.ops.kernels.double_conv import (
    fused_double_conv3x3, pack_double_conv_weights)
from uncltmo_tpu_torch.ops.kernels.packing import weights_key
from uncltmo_tpu_torch.ops.kernels.up_cell import (
    FOLD_MODES, Upsample, channels_ok, fused_up_cell, kernel_takes,
    pack_up_cell_weights, pack_upsample_weights)
from uncltmo_tpu_torch.ops.precision import autocast_dtype, no_autocast
from uncltmo_tpu_torch.parallel.mesh import all_reduce_sum, rank_world
from uncltmo_tpu_torch.utils import profiling


def activation_fn(name: str):
    if name == "relu":
        return F.relu
    if name == "leakyrelu":
        return lambda x: F.leaky_relu(x, 0.2)
    raise ValueError(f"Unsupported activation: {name}")


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with the JAX package's `TorchBatchNorm` semantics
    (`uncltmo_tpu/models/blocks.py:76-115`, reference `unet_parts.py:19-24`):
    eps 1e-5, momentum 0.1, scale 1 and bias 0 at init.  `train=True`
    normalises by the biased batch variance and moves the running variance
    by the unbiased one; `train=False` normalises by the running
    statistics.  Statistics and the normalisation are float32 whatever the
    compute dtype (autocast off, the input as float32); the result has the
    input's dtype.  A bfloat16 serving engine holds bfloat16 running
    statistics, as the JAX engine does, and they are read as float32.

    Under a process group a training forward takes the global batch's
    statistics, as the JAX step's mean over a sharded batch does
    (`nn.SyncBatchNorm` semantics): the sums and the sums of squared
    deviations are all-reduced in float32, differentiably, and the running
    statistics move alike on every rank."""

    def __init__(self, ch: int):
        super().__init__(ch, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        with no_autocast():
            if train:
                self.num_batches_tracked.add_(1)
            if train and rank_world()[1] > 1:
                y = self._global_batch_norm(x.float())
            else:
                y = F.batch_norm(x.float(), self.running_mean.float(),
                                 self.running_var.float(),
                                 self.weight.float(), self.bias.float(),
                                 training=train, momentum=self.momentum,
                                 eps=self.eps)
        return y.to(x.dtype)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Training batch norm over every rank's rows, two-pass in
        float32."""
        n = x.numel() // x.shape[1] * rank_world()[1]
        dims = (0, 2, 3)
        mean = all_reduce_sum(x.sum(dims)) / n
        xc = x - mean[None, :, None, None]
        var = all_reduce_sum((xc * xc).sum(dims)) / n
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var * (n / (n - 1)))
        inv = torch.rsqrt(var + self.eps)
        return (xc * (inv * self.weight.float())[None, :, None, None]
                + self.bias.float()[None, :, None, None])


class InstanceNorm(nn.Module):
    """torch `InstanceNorm2d(affine=False, eps=1e-5)`: no parameters, no
    running statistics, the same in both modes
    (`uncltmo_tpu/models/blocks.py:118-129`).  Computed in float32 by the
    JAX package's formula, which also takes a 1x1 map (torch's function
    refuses one; its value is 0)."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        with no_autocast():
            xf = x.float()
            mu = xf.mean(dim=(2, 3), keepdim=True)
            var = (xf - mu).square().mean(dim=(2, 3), keepdim=True)
            y = (xf - mu) * torch.rsqrt(var + 1e-5)
        return y.to(x.dtype)


def make_norm(unet_norm: str, ch: int) -> Optional[nn.Module]:
    if unet_norm == "none":
        return None
    if unet_norm == "batch_norm":
        return BatchNorm(ch)
    if unet_norm == "instance_norm":
        return InstanceNorm()
    raise ValueError(
        f"Unsupported norm: {unet_norm!r} (supported: 'none', "
        "'instance_norm', 'batch_norm')")


def norm_act(norm: Optional[nn.Module], act, x: torch.Tensor,
             train: bool) -> torch.Tensor:
    return act(x if norm is None else norm(x, train))


# ---------------------------------------------------------------- padding
_PAD_ALIASES = {"zeros": "constant", "replicate": "edge", "empty": "constant"}
_PAD_MODES = ("constant", "edge", "reflect", "symmetric", "wrap",
              "linear_ramp", "maximum", "minimum", "mean", "median")


def pad_mode(padding_mode: str) -> str:
    """A padding name as `jnp.pad` reads it: the torch-style 'zeros' /
    'replicate' map to 'constant' / 'edge' (`_jnp_pad_mode`,
    `uncltmo_tpu/models/blocks.py:142-148`), and every mode of `jnp.pad`
    is taken ('empty' pads with zeros, as jax does)."""
    mode = _PAD_ALIASES.get(padding_mode, padding_mode)
    if mode not in _PAD_MODES:
        raise ValueError(f"Unsupported padding mode: {padding_mode!r}")
    return mode


def _pad_axis(x: torch.Tensor, axis: int, lo: int, hi: int,
              mode: str) -> torch.Tensor:
    """`np.pad` of one axis of x by (lo, hi) in `mode` (one of
    `_PAD_MODES`); the statistics of the stat modes are over the whole axis
    as it was."""
    if not lo and not hi:
        return x
    n = x.shape[axis]
    if mode in ("edge", "reflect", "symmetric", "wrap"):
        i = torch.arange(-lo, n + hi, device=x.device)
        if mode == "edge":
            i = i.clamp(0, n - 1)
        elif mode == "wrap":
            i = i % n
        elif mode == "symmetric":
            i = i % (2 * n)
            i = torch.where(i < n, i, 2 * n - 1 - i)
        else:
            p = max(2 * n - 2, 1)
            i = i % p
            i = torch.where(i < n, i, p - i)
        return x.index_select(axis, i)

    def widen(v: torch.Tensor, k: int) -> torch.Tensor:
        shape = list(x.shape)
        shape[axis] = k
        return v.expand(shape)

    if mode == "constant":
        before, after = widen(x.new_zeros(()), lo), widen(x.new_zeros(()), hi)
    elif mode == "linear_ramp":
        # from 0 at the outer end towards the edge sample (end_values 0)
        view = [1] * x.dim()
        view[axis] = -1
        up = torch.arange(lo, device=x.device, dtype=x.dtype) / max(lo, 1)
        down = 1 - torch.arange(1, hi + 1, device=x.device,
                                dtype=x.dtype) / max(hi, 1)
        before = x.narrow(axis, 0, 1) * up.reshape(view)
        after = x.narrow(axis, n - 1, 1) * down.reshape(view)
    else:
        if mode == "maximum":
            stat = x.amax(axis, keepdim=True)
        elif mode == "minimum":
            stat = x.amin(axis, keepdim=True)
        elif mode == "mean":
            stat = x.mean(axis, keepdim=True)
        else:
            # numpy's median: the mean of the two middle samples
            s = x.sort(axis).values
            stat = (s.narrow(axis, (n - 1) // 2, 1)
                    + s.narrow(axis, n // 2, 1)) / 2
        before, after = widen(stat, lo), widen(stat, hi)
    return torch.cat([before, x, after], axis)


def pad2d(x: torch.Tensor, pads: Sequence[int], padding_mode: str
          ) -> torch.Tensor:
    """`jnp.pad` of an NCHW tensor by pads = (top, bottom, left, right) in
    a model padding mode: H first, then W, as numpy pads axis by axis."""
    mode = pad_mode(padding_mode)
    x = _pad_axis(x, 2, pads[0], pads[1], mode)
    return _pad_axis(x, 3, pads[2], pads[3], mode)


# ------------------------------------------------------------------ cells
def _kept_packing(module: nn.Module, weights, pack, span,
                  dtype: Optional[torch.dtype] = None):
    """`pack(*weights)` in `dtype` (the weights' own when None), kept on
    `module` (`_packed`) and packed again only after a reload, a cast, a
    move or an in-place update of a weight, or for another `dtype`; a
    packing opens the span `span()`."""
    key = weights_key(*weights, dtype=dtype)
    if module._packed is None or module._packed[0] != key:
        with span():
            ws = weights if dtype is None else [w.to(dtype) for w in weights]
            module._packed = (key, pack(*ws))
    return module._packed[1]


class _PackedCell(nn.Module):
    """A cell of two 3x3 convolutions, `conv` and `conv1`, whose kernel
    reads their weights packed (`_pack`)."""

    _packed = None             # (weights_key, PackedCell)

    def _weights(self):
        return (self.conv.weight, self.conv.bias, self.conv1.weight,
                self.conv1.bias)

    def packed_weights(self, dtype: Optional[torch.dtype] = None):
        """The kernel's weight layout (`_kept_packing`; the cell's span is
        `_pack_span`)."""
        return _kept_packing(self, self._weights(), self._pack,
                             self._pack_span, dtype)


class DoubleConv(_PackedCell):
    """(conv3x3 => [norm] => act) * 2 (reference `unet_parts.py:10-87`),
    parameters `conv`, `conv1`, `norm`, `norm1` as in the reference.

    `pad=1` pads each conv's input by one pixel in `padding_mode` (the
    generator without doubleConvTranspose); `post_pad_replicate` pads each
    conv's output by one edge pixel (the `up_mode` generator without
    doubleConvTranspose, `unet_parts.py:65-68`).  The valid relu cell
    without norm is one launch of K2 on CUDA."""

    def __init__(self, in_ch: int, out_ch: int, unet_norm: str = "none",
                 activation: str = "relu", pad: int = 0,
                 post_pad_replicate: bool = False,
                 padding_mode: str = "edge"):
        super().__init__()
        activation_fn(activation)
        self.conv = nn.Conv2d(in_ch, out_ch, 3)
        self.conv1 = nn.Conv2d(out_ch, out_ch, 3)
        self.norm = make_norm(unet_norm, out_ch)
        self.norm1 = make_norm(unet_norm, out_ch)
        self.activation = activation
        self.pad = pad
        self.post_pad_replicate = post_pad_replicate
        self.padding_mode = pad_mode(padding_mode)
        self.fused = (not pad and not post_pad_replicate
                      and unet_norm == "none" and activation == "relu")

    _pack = staticmethod(pack_double_conv_weights)

    @staticmethod
    def _pack_span():
        return profiling.trace("uncltmo.k2.pack")

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.fused:
            packed = (self.packed_weights(autocast_dtype(x.device.type))
                      if x.is_cuda else None)
            return fused_double_conv3x3(x, *self._weights(), packed=packed)
        act = activation_fn(self.activation)
        for conv, norm in ((self.conv, self.norm), (self.conv1, self.norm1)):
            if self.pad:
                x = pad2d(x, (1, 1, 1, 1), self.padding_mode)
            x = conv(x)
            if self.post_pad_replicate:
                x = pad2d(x, (1, 1, 1, 1), "edge")
            x = norm_act(norm, act, x, train)
        return x


class InConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, unet_norm: str = "none",
                 activation: str = "relu", **cell):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch, unet_norm, activation, **cell)

    def forward(self, x, train: bool = False):
        return self.conv(x, train)


class DoubleLastConv(nn.Module):
    """conv3x3 => [norm] => act [=> ConvTranspose2d(k=3) => [norm] => act
    with doubleConvTranspose] (reference `unet_parts.py:90-141`)."""

    def __init__(self, in_ch: int, out_ch: int, unet_norm: str = "none",
                 activation: str = "relu", pad: int = 0,
                 double_conv_transpose: bool = True,
                 post_pad_replicate: bool = False,
                 padding_mode: str = "edge"):
        super().__init__()
        activation_fn(activation)
        self.conv = nn.Conv2d(in_ch, out_ch, 3)
        self.norm = make_norm(unet_norm, out_ch)
        if double_conv_transpose:
            self.conv1 = nn.ConvTranspose2d(out_ch, out_ch, 3)
            self.norm1 = make_norm(unet_norm, out_ch)
        self.double_conv_transpose = double_conv_transpose
        self.activation = activation
        self.pad = pad
        self.post_pad_replicate = post_pad_replicate
        self.padding_mode = pad_mode(padding_mode)

    def forward(self, x, train: bool = False):
        act = activation_fn(self.activation)
        if self.pad:
            x = pad2d(x, (1, 1, 1, 1), self.padding_mode)
        x = self.conv(x)
        if self.post_pad_replicate:
            x = pad2d(x, (1, 1, 1, 1), "edge")
        x = norm_act(self.norm, act, x, train)
        if self.double_conv_transpose:
            x = norm_act(self.norm1, act, self.conv1(x), train)
        return x


class Down(nn.Module):
    """2x2 max pool then a conv cell (`mpconv.1` in the reference layout)."""

    def __init__(self, cell: nn.Module):
        super().__init__()
        self.mpconv = nn.Sequential(nn.MaxPool2d(2, 2), cell)

    def forward(self, x, train: bool = False):
        pool, cell = self.mpconv
        return cell(pool(x), train)


class DoubleConvT(_PackedCell):
    """(ConvTranspose2d(k=3) => [norm] => act) * 2 (reference
    `unet_parts.py:144-193`); grows the spatial size by 4.  Without norm
    and with relu, the cell behind a `square_and_square_root` concat is one
    launch of the up cell where it takes the call (`Up.forward`)."""

    def __init__(self, in_ch: int, out_ch: int, unet_norm: str = "none",
                 activation: str = "relu"):
        super().__init__()
        activation_fn(activation)
        self.conv = nn.ConvTranspose2d(in_ch, out_ch, 3)
        self.conv1 = nn.ConvTranspose2d(out_ch, out_ch, 3)
        self.norm = make_norm(unet_norm, out_ch)
        self.norm1 = make_norm(unet_norm, out_ch)
        self.activation = activation
        self.fused = unet_norm == "none" and activation == "relu"

    _pack = staticmethod(pack_up_cell_weights)

    @staticmethod
    def _pack_span():
        return profiling.trace("uncltmo.up.pack")

    def forward(self, x, train: bool = False):
        act = activation_fn(self.activation)
        x = norm_act(self.norm, act, self.conv(x), train)
        return norm_act(self.norm1, act, self.conv1(x), train)


def _pad_or_crop(x1: torch.Tensor, diff_y: int, diff_x: int,
                 padding_mode: str) -> torch.Tensor:
    """torch F.pad semantics on (B, C, H, W) for both signs: negative amounts
    crop, positive amounts pad with `padding_mode` (`blocks.py:298-312`)."""
    lo_y, hi_y = diff_y // 2, diff_y - diff_y // 2
    lo_x, hi_x = diff_x // 2, diff_x - diff_x // 2
    h, w = x1.shape[2], x1.shape[3]
    x1 = x1[:, :, max(0, -lo_y):h - max(0, -hi_y),
            max(0, -lo_x):w - max(0, -hi_x)]
    return pad2d(x1, (max(0, lo_y), max(0, hi_y), max(0, lo_x), max(0, hi_x)),
                 padding_mode)


def zero_insert_upsample(x: torch.Tensor) -> torch.Tensor:
    """The `up_mode` fixed-weight upsample (reference `unet_parts.py:
    284-288`): out[2i, 2j] = x[i, j], the rest 0."""
    b, c, h, w = x.shape
    y = x.new_zeros((b, c, h, 2, w, 2))
    y[:, :, :, 0, :, 0] = x
    return y.reshape(b, c, 2 * h, 2 * w)


def _sqrt_eps(x: torch.Tensor) -> torch.Tensor:
    """sqrt(x + eps), the root taken in float32 (`blocks.py:315-325`)."""
    return torch.sqrt((x + params.EPSILON).float()).to(x.dtype)


# skip channels in the concat per channel of x2, and planes in front of it
_SKIP_PLANES = {params.ORIGINAL_UNET: 1, params.SQUARE: 2,
                params.SQUARE_ROOT: 2, params.GAMMA: 2,
                params.SQUARE_AND_SQUARE_ROOT: 3,
                params.SQUARE_AND_SQUARE_ROOT_MANUAL_D: 3}


def concat_channels(con_operator: str, skip_ch: int, up_ch: int) -> int:
    """Channels of the skip concat of `con_operator`."""
    if con_operator not in _SKIP_PLANES:
        raise ValueError(f"Unsupported con_operator: {con_operator}")
    extra = int(con_operator == params.SQUARE_AND_SQUARE_ROOT_MANUAL_D)
    return _SKIP_PLANES[con_operator] * skip_ch + up_ch + extra


def concat_skip(x2: torch.Tensor, x1: torch.Tensor, con_operator: str,
                d_weight_mul: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Skip-connection concat with the nonlinear expansions (reference
    `unet_parts.py:311-332`).  x2: encoder skip, x1: upsampled.
    `square_and_square_root` is the kernel K1; the manual-d operator puts a
    constant plane of `d_weight_mul` (the input's weight channel) first."""
    if con_operator == params.SQUARE_AND_SQUARE_ROOT:
        return fused_concat_skip(x2, x1)
    if con_operator == params.ORIGINAL_UNET:
        return torch.cat([x2, x1], 1)
    if con_operator == params.SQUARE:
        return torch.cat([x2, x1, x2 * x2], 1)
    if con_operator == params.SQUARE_ROOT:
        return torch.cat([x2, x1, _sqrt_eps(x2)], 1)
    if con_operator == params.GAMMA:
        return torch.cat([x2, x1, torch.pow(x2 + params.EPSILON, 0.02)], 1)
    if con_operator == params.SQUARE_AND_SQUARE_ROOT_MANUAL_D:
        b, _, h, w = x2.shape
        plane = d_weight_mul.to(x2.dtype).reshape(1, 1, 1, 1).expand(
            b, 1, h, w)
        return torch.cat([plane, x2, x1, x2 * x2, _sqrt_eps(x2)], 1)
    raise ValueError(f"Unsupported con_operator: {con_operator}")


class Up(nn.Module):
    """Upsample + pad/crop to the skip + skip concat + decoder cell
    (reference `unet_parts.py:243-335`).  The upsample is the 2x2 ConvT
    (`up`), the zero insertion of `up_mode` (no parameters) or, with
    `bilinear`, nearest x2 then a 1x1 conv (`up.1`); the decoder cell is a
    `DoubleConvT` with doubleConvTranspose, else a `DoubleConv` (padded,
    or post-padded under `up_mode`)."""

    def __init__(self, up_ch: int, skip_ch: int, out_ch: int,
                 con_operator: str, unet_norm: str = "none",
                 activation: str = "relu", padding_mode: str = "edge",
                 double_conv_transpose: bool = True, up_mode: bool = False,
                 bilinear: bool = False, pad: int = 0):
        super().__init__()
        self.con_operator = con_operator
        self.padding_mode = pad_mode(padding_mode)
        self.up_mode = up_mode
        if up_mode:
            self.up = None
        elif bilinear:
            self.up = nn.Sequential(nn.Upsample(scale_factor=2,
                                                mode="nearest"),
                                    nn.Conv2d(up_ch, up_ch, 1))
        else:
            self.up = nn.ConvTranspose2d(up_ch, up_ch, 2, stride=2)
        cat_ch = concat_channels(con_operator, skip_ch, up_ch)
        if double_conv_transpose:
            self.conv = DoubleConvT(cat_ch, out_ch, unet_norm, activation)
        else:
            self.conv = DoubleConv(cat_ch, out_ch, unet_norm, activation,
                                   pad=pad, post_pad_replicate=up_mode,
                                   padding_mode=padding_mode)
        # the concat and the DoubleConvT as one kernel (float32 on CUDA)
        self.fused_cell = (double_conv_transpose and self.conv.fused
                           and con_operator == params.SQUARE_AND_SQUARE_ROOT
                           and skip_ch == up_ch and channels_ok(skip_ch))
        # and, with it, the 2x2 ConvT and the pad or crop to the skip
        self.fold_upsample = (isinstance(self.up, nn.ConvTranspose2d)
                              and self.padding_mode in FOLD_MODES)

    _packed = None             # (weights_key, the upsample's packed weight)

    def packed_upsample(self) -> torch.Tensor:
        """The 2x2 ConvT's weight as the up cell's phase 0 reads it
        (`_kept_packing`, under the span `uncltmo.up.pack`)."""
        c1, c2 = self.conv.conv.weight.shape[1], self.conv.conv1.weight.shape[1]
        return _kept_packing(
            self, (self.up.weight,),
            lambda w: pack_upsample_weights(w, c1, c2),
            DoubleConvT._pack_span)

    def forward(self, x1, x2, d_weight_mul=None, train: bool = False):
        if (self.fused_cell and self.fold_upsample and kernel_takes(
                x2, x1, self.up.weight, self.up.bias, *self.conv._weights())):
            return fused_up_cell(
                x2, x1, *self.conv._weights(),
                packed=self.conv.packed_weights(),
                upsample=Upsample(self.up.weight, self.up.bias,
                                  self.padding_mode, self.packed_upsample()))
        x1 = zero_insert_upsample(x1) if self.up_mode else self.up(x1)
        diff_y = x2.shape[2] - x1.shape[2]
        diff_x = x2.shape[3] - x1.shape[3]
        if diff_y or diff_x:
            x1 = _pad_or_crop(x1, diff_y, diff_x, self.padding_mode)
        if self.fused_cell and kernel_takes(x2, x1, *self.conv._weights()):
            return fused_up_cell(x2, x1, *self.conv._weights(),
                                 packed=self.conv.packed_weights())
        return self.conv(concat_skip(x2, x1, self.con_operator,
                                     d_weight_mul), train)


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
