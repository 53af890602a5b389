"""The tone-mapping U-Net generator (NCHW), image and video.

Port of `uncltmo_tpu/models/unet.py` (reference `Unet_singleFrame.py` for
images, `Unet.py` for video), every option of `UNetTMO`
(`uncltmo_tpu/models/unet.py:61-117`).  The published configuration: depth
4, 32 filters, `square_and_square_root`, doubleConvTranspose, relu, no
norm, sigmoid, 2x2 ConvT upsample.  Size flow for a 256 tile (valid convs):

    inc   256 -> 252   (skip s0)          K2
    down0 252 -> 122   (skip s1)          K2
    down1 122 -> 57    (skip s2)          K2
    down2 57  -> 24    (skip s3)          K2
    last  24  -> 12    (bottleneck; GCN grid)
    up0   12->24  +s3 -> 28               K1
    up1   28->56 (+1 replicate pad) +s2 -> 61   K1
    up2   61->122 +s1 -> 126              K1
    up3  126->252 +s0 -> 256              K1
    outc -> sigmoid

Without doubleConvTranspose (and without `up_mode`) every conv is padded
by one pixel in the model's `padding_mode` and the decoder cells are
`DoubleConv`s; `up_mode` upsamples by zero insertion and, without
doubleConvTranspose, pads each conv's output by one edge pixel; `bilinear`
upsamples by nearest x2 and a 1x1 conv.  Which cells take K1 and K2 is
said in `models/blocks.py`.

One module serves both: `frame` is the single-frame forward that also
threads the temporal carry.  The carry holds the first 1/32 of the channels
at eight positions (after inc, down0..2, the GCN and up0..2: 1, 2, 4, 8, 8,
4, 2, 1 channels at 32 filters); at frame k > 0 the first 1/32 channels of
what the next layer reads are replaced by the previous frame's slice
(reference `Unet.py:229-272`).  The skips stay unspliced.  `video_apply`
loops `frame` over a (B, T, C, H, W) clip.

A training forward is `deterministic=False`: the GCN's drop path is live
and draws from the caller's `torch.Generator`, fresh for every frame of a
clip (`uncltmo_tpu/models/unet.py:259-267`), batch norm normalises by the
batch and moves its running statistics (`uncltmo_tpu/models/unet.py:
130-132`: exactly when the forward is not deterministic, whatever
`.train()` / `.eval()` says), and under autograd `_splice` builds new
tensors, so the gradient flows through the carry.  `video_apply` moves the
statistics frame by frame in order, as the JAX scan carries them.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from uncltmo_tpu_torch import params
from uncltmo_tpu_torch.models import blocks
from uncltmo_tpu_torch.models.gcn import GCNBlock
from uncltmo_tpu_torch.ops.precision import no_autocast
from uncltmo_tpu_torch.ops.preprocess import crop_center_batch
from uncltmo_tpu_torch.ops.windows import adaptive_avg_pool_1, contrast_map
from uncltmo_tpu_torch.parallel.mesh import global_max

Carry = Optional[List[torch.Tensor]]


def _rec_slice(x: torch.Tensor, ratio: float) -> torch.Tensor:
    """The first int(C * ratio) channels of x, as a copy: the tensor it is
    cut from may be overwritten by `_splice` later in the same frame, and a
    view would also keep the whole activation alive until the next frame."""
    return x[:, :int(x.shape[1] * ratio)].clone()


def _splice(x: torch.Tensor, rec: torch.Tensor) -> torch.Tensor:
    """x with its first rec.shape[1] channels replaced by rec.  Written in
    place where autograd does not need x as it was (inference): x is always
    a fresh activation that nothing else reads, and the copy of a whole
    activation is saved.  Under autograd a new tensor is built."""
    if torch.is_grad_enabled() and x.requires_grad:
        return torch.cat([rec, x[:, rec.shape[1]:]], 1)
    x[:, :rec.shape[1]] = rec
    return x


class UNetTMO(nn.Module):
    """Generator.  forward: (B, C, H, W) -> (tone-mapped (B, 1, H, W), last
    decoder feature map).  `to_crop` is the add_frame protocol's output
    crop (reference `Unet_singleFrame.py:106,210-211`)."""

    def __init__(self, n_channels: int = 1, output_dim: int = 1,
                 last_layer: str = "sigmoid", depth: int = 4,
                 con_operator: str = params.SQUARE_AND_SQUARE_ROOT,
                 filters: int = 32, unet_norm: str = "none",
                 activation: str = "relu", padding_mode: str = "edge",
                 double_conv_transpose: bool = True, up_mode: bool = False,
                 bilinear: bool = False,
                 stretch_g: str = "none", gcn_grid: int = params.GCN_GRID,
                 recurrent_ch_ratio: float = params.RECURRENT_CH_RATIO,
                 to_crop: bool = False):
        super().__init__()
        if stretch_g not in ("none", "batchMax", "instanceMinMax"):
            raise ValueError(f"Unsupported stretch_g: {stretch_g}")
        self.depth = depth
        self.last_layer = last_layer
        self.stretch_g = stretch_g
        self.recurrent_ch_ratio = recurrent_ch_ratio
        self.to_crop = to_crop
        self.manual_d = con_operator == params.SQUARE_AND_SQUARE_ROOT_MANUAL_D
        f = filters
        # the cells' padding (`uncltmo_tpu/models/unet.py:86-88`)
        pad = 0 if (double_conv_transpose or up_mode) else 1
        cell = dict(pad=pad, post_pad_replicate=up_mode and not
                    double_conv_transpose, padding_mode=padding_mode)
        self.inc = blocks.InConv(n_channels, f, unet_norm, activation,
                                 **cell)
        ch = f
        downs = []
        for _ in range(depth - 1):
            downs.append(blocks.Down(blocks.DoubleConv(
                ch, ch * 2, unet_norm, activation, **cell)))
            ch *= 2
        downs.append(blocks.Down(blocks.DoubleLastConv(
            ch, ch, unet_norm, activation,
            double_conv_transpose=double_conv_transpose, **cell)))
        self.down_path = nn.ModuleList(downs)
        self.gcn = GCNBlock(ch, grid=gcn_grid)
        skip_ch = [f * 2 ** i for i in range(depth)]
        ups = []
        for i in range(depth):
            out_ch = f if i >= depth - 2 else ch // 2
            ups.append(blocks.Up(ch, skip_ch[depth - 1 - i], out_ch,
                                 con_operator, unet_norm, activation,
                                 padding_mode, double_conv_transpose,
                                 up_mode, bilinear, pad))
            ch = out_ch
        self.up_path = nn.ModuleList(ups)
        self.outc = blocks.OutConv(ch, output_dim)

    def frame(self, x: torch.Tensor, carry: Carry = None,
              deterministic: bool = True, generator=None, drop_masks=None
              ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
        """Single-frame forward (`unet.py:120-168`).  carry: the previous
        frame's eight slices, or None (first frame, image mode).
        `deterministic=False` turns the GCN's drop path on, drawn from
        `generator` (or taken from the iterator `drop_masks`, see
        `gcn.drop_path`), and puts batch norm in training mode.  Returns
        (x_out, up_x, new_carry)."""
        r = self.recurrent_ch_ratio
        train = not deterministic
        # the manual-d operator's weight plane: the input's weight channel
        # (`uncltmo_tpu/models/unet.py:133-135`)
        d_weight_mul = x[0, 1, 0, 0] if self.manual_d else None
        next_x = self.inc(x, train)
        skips = [next_x]
        new_carry = [_rec_slice(next_x, r)]
        for i, layer in enumerate(self.down_path):
            pool, cell = layer.mpconv
            fea = pool(next_x)
            if carry is not None and carry[i].shape[1]:
                # the max pool works channel by channel, so splicing its
                # output with the pooled slice equals pooling the spliced
                # input, and the skip stays as it was without a copy
                # (below 32 channels the slice is empty)
                fea = _splice(fea, pool(carry[i]))
            next_x = cell(fea, train)
            skips.append(next_x)
            if i < self.depth - 1:
                new_carry.append(_rec_slice(next_x, r))
        up_x = self.gcn(skips[self.depth], deterministic, generator,
                        drop_masks)
        new_carry.append(_rec_slice(up_x, r))
        for i, layer in enumerate(self.up_path):
            if carry is not None:
                up_x = _splice(up_x, carry[self.depth + i])
            up_x = layer(up_x, skips[self.depth - (i + 1)], d_weight_mul,
                         train)
            if i < self.depth - 1:
                new_carry.append(_rec_slice(up_x, r))
        # the output head in the weights' dtype, float32 under autocast:
        # the structural loss standardises the fake by local stds of
        # ~1e-3, below a bfloat16 step of the output (2^-9 at 0.5)
        with no_autocast():
            x_out = blocks.last_layer_fn(self.last_layer)(
                self.outc(up_x.to(self.outc.conv.weight.dtype)))
        if self.stretch_g == "batchMax":
            # over the global batch in a training forward under a process
            # group, as the JAX step's max over a sharded batch
            x_out = x_out / (global_max(x_out) if train else x_out.max())
        elif self.stretch_g == "instanceMinMax":
            flat = x_out.reshape(x_out.shape[0], -1)
            xmax = flat.max(dim=1).values.reshape(-1, 1, 1, 1)
            xmin = flat.min(dim=1).values.reshape(-1, 1, 1, 1)
            x_out = (x_out - xmin) / (xmax - xmin + params.EPSILON)
        return x_out, up_x, new_carry

    def forward(self, x: torch.Tensor, apply_crop: bool = False,
                diffY: int = 0, diffX: int = 0, deterministic: bool = True,
                generator=None, drop_masks=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Image-mode forward (reference `Unet_singleFrame.py:177-213`).
        apply_crop / diffY / diffX: the add_frame output crop, active only
        in a module built with `to_crop`.  deterministic / generator /
        drop_masks: as `frame`."""
        out, up_x, _ = self.frame(x, None, deterministic, generator,
                                  drop_masks)
        if apply_crop and self.to_crop and (diffY or diffX):
            out = crop_center_batch(out, diffY, diffX)
        return out, up_x

    def feature_head(self, up_x: torch.Tensor) -> torch.Tensor:
        """Per-frame contrastive feature, avgpool(up_x) ++ avgpool(contrast
        map of up_x) (reference `Unet.py:274-278`): (B, F, H, W) -> (B, 2F)."""
        fea1 = adaptive_avg_pool_1(up_x)
        fea2 = adaptive_avg_pool_1(contrast_map(up_x))
        return torch.cat([fea1, fea2], 1).reshape(up_x.shape[0], -1)


def video_apply(model: UNetTMO, x_btchw: torch.Tensor,
                with_features: bool = True, deterministic: bool = True,
                generator=None, drop_masks=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, C, H, W) -> ((B, T, 1, H, W) outputs, (B, T, 2F) features):
    the reference's frame loop (`Unet.py:218-286`).  Frame 0 builds the
    carry, every later frame reads the one before it.  `with_features`
    toggles the contrastive feature head (an 11x11 depthwise conv per
    frame that tiled inference does not need); without it the features are
    (B, T, 0).  With `deterministic=False` every frame draws its own drop
    path masks from `generator` (or takes the next two of `drop_masks`)."""
    carry = None
    outs, feats = [], []
    # a serving forward calls `frame(x, carry)` alone, so that any module
    # with that signature can stand in for the generator
    train = {} if deterministic else dict(
        deterministic=False, generator=generator, drop_masks=drop_masks)
    for k in range(x_btchw.shape[1]):
        out, up_x, carry = model.frame(x_btchw[:, k], carry, **train)
        outs.append(out)
        feats.append(model.feature_head(up_x) if with_features
                     else out.new_zeros((out.shape[0], 0)))
    return torch.stack(outs, 1), torch.stack(feats, 1)


def seeded_init_(model: nn.Module, seed: int) -> nn.Module:
    """The reference's initialisation (`utils/model_save_util.py:41-47`):
    xavier-normal with gain sqrt(2) on every conv weight (and on the
    discriminator's linear head, as the JAX package initialises it), zero
    biases, zero pos_embed; drawn from an explicit `torch.Generator`.
    Batch norm keeps torch's scale 1 and bias 0, as the JAX package's
    `TorchBatchNorm` initialises them."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                nn.init.xavier_normal_(m.weight, gain=2 ** 0.5, generator=g)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, GCNBlock):
                nn.init.zeros_(m.pos_embed)
    return model


def reference_normal_init_(model: nn.Module, seed: int) -> nn.Module:
    """The reference's other initialisation (`--use_xaviar 0`,
    `utils/model_save_util.py:26-38`): every conv and linear weight drawn
    from N(0, 0.02^2), batch norm's scales from N(1, 0.02^2) with zero
    biases (`:32-38`; instance norm has no parameters), the rest left as
    built."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                nn.init.normal_(m.weight, 0.0, 0.02, generator=g)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.normal_(m.weight, 1.0, 0.02, generator=g)
                nn.init.zeros_(m.bias)
    return model


def bottleneck_grid(input_size: int, depth: int = 4) -> int:
    """Bottleneck spatial size for a valid-conv U-Net input (the GCN
    pos-embed grid): 256 -> 12, 128 -> 4."""
    n = input_size - 4                       # inc: two valid 3x3 convs
    for _ in range(depth - 1):
        n = n // 2 - 4                       # down: maxpool + double conv
    n = n // 2                               # last_down: conv + convT(3,1)
    if n < 2:
        raise ValueError(f"input_size {input_size} too small for depth "
                         f"{depth} (bottleneck would be {n})")
    return n


def min_input_size(depth: int = 4) -> int:
    """The smallest H or W the valid-conv U-Net can take: the last Down's
    3x3 conv needs 3 pixels after its pool (depth 4: 108).  Below it torch
    refuses the conv; XLA's valid conv returns an empty array instead, and
    the JAX package goes on to a frame made of biases alone."""
    n = 2 * 3                                # last_down: pool, then conv3x3
    for _ in range(depth - 1):
        n = 2 * (n + 4)                      # down: pool, then double conv
    return n + 4                             # inc


def make_generator(opt=None, **overrides) -> UNetTMO:
    """Build a generator from a config object with reference flag names
    (`config.Options`)."""
    kw: dict = {}
    if opt is not None:
        if int(getattr(opt, "convtranspose_kernel", 2)) != 2:
            raise ValueError("convtranspose_kernel != 2 is not supported "
                             "(published configs use 2)")
        kw = dict(
            n_channels=opt.input_dim, output_dim=opt.output_dim,
            last_layer=opt.last_layer, depth=opt.unet_depth,
            con_operator=opt.con_operator, filters=opt.filters,
            unet_norm=opt.unet_norm, activation=opt.g_activation,
            double_conv_transpose=bool(opt.g_doubleConvTranspose),
            up_mode=bool(opt.up_mode), bilinear=bool(opt.bilinear),
            padding_mode="edge" if opt.padding == "replicate" else opt.padding,
            stretch_g=opt.stretch_g, to_crop=bool(opt.add_frame))
    kw.update(overrides)
    return UNetTMO(**kw)
