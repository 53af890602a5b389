"""The tone-mapping U-Net generator (NCHW), image forward.

Port of `uncltmo_tpu/models/unet.py:61-234` (reference
`Unet_singleFrame.py`), published configuration: depth 4, 32 filters,
`square_and_square_root`, doubleConvTranspose, relu, no norm, sigmoid, 2x2
ConvT upsample.  Size flow for a 256 tile (valid convs):

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

The video recurrence (`frame` with a carry, `feature_head`) is not ported
yet (ROADMAP Queue 1 item 2): `frame` takes no carry.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from uncltmo_tpu_torch import params
from uncltmo_tpu_torch.models import blocks
from uncltmo_tpu_torch.models.gcn import GCNBlock


class UNetTMO(nn.Module):
    """Generator.  forward: (B, C, H, W) -> (tone-mapped (B, 1, H, W), last
    decoder feature map)."""

    def __init__(self, n_channels: int = 1, output_dim: int = 1,
                 last_layer: str = "sigmoid", depth: int = 4,
                 con_operator: str = params.SQUARE_AND_SQUARE_ROOT,
                 filters: int = 32, unet_norm: str = "none",
                 activation: str = "relu", padding_mode: str = "edge",
                 stretch_g: str = "none", gcn_grid: int = params.GCN_GRID):
        super().__init__()
        if stretch_g not in ("none", "batchMax", "instanceMinMax"):
            raise ValueError(f"Unsupported stretch_g: {stretch_g}")
        self.depth = depth
        self.last_layer = last_layer
        self.stretch_g = stretch_g
        f = filters
        self.inc = blocks.InConv(n_channels, f, unet_norm, activation)
        ch = f
        downs = []
        for _ in range(depth - 1):
            downs.append(blocks.Down(blocks.DoubleConv(
                ch, ch * 2, unet_norm, activation)))
            ch *= 2
        downs.append(blocks.Down(blocks.DoubleLastConv(
            ch, ch, unet_norm, activation)))
        self.down_path = nn.ModuleList(downs)
        self.gcn = GCNBlock(ch, grid=gcn_grid)
        skip_ch = [f * 2 ** i for i in range(depth)]
        ups = []
        for i in range(depth):
            out_ch = f if i >= depth - 2 else ch // 2
            ups.append(blocks.Up(ch, skip_ch[depth - 1 - i], out_ch,
                                 con_operator, unet_norm, activation,
                                 padding_mode))
            ch = out_ch
        self.up_path = nn.ModuleList(ups)
        self.outc = blocks.OutConv(ch, output_dim)

    def frame(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Single-frame forward without a recurrence carry
        (`unet.py:120-168` with carry=None).  Returns (x_out, up_x)."""
        next_x = self.inc(x)
        skips = [next_x]
        for layer in self.down_path:
            next_x = layer(next_x)
            skips.append(next_x)
        up_x = self.gcn(skips[self.depth])
        for i, layer in enumerate(self.up_path):
            up_x = layer(up_x, skips[self.depth - (i + 1)])
        x_out = blocks.last_layer_fn(self.last_layer)(self.outc(up_x))
        if self.stretch_g == "batchMax":
            x_out = x_out / x_out.max()
        elif self.stretch_g == "instanceMinMax":
            flat = x_out.reshape(x_out.shape[0], -1)
            xmax = flat.max(dim=1).values.reshape(-1, 1, 1, 1)
            xmin = flat.min(dim=1).values.reshape(-1, 1, 1, 1)
            x_out = (x_out - xmin) / (xmax - xmin + params.EPSILON)
        return x_out, up_x

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Image-mode forward (reference `Unet_singleFrame.py:177-213`)."""
        return self.frame(x)


def seeded_init_(model: nn.Module, seed: int) -> nn.Module:
    """The reference's initialisation (`utils/model_save_util.py:41-47`):
    xavier-normal with gain sqrt(2) on every conv weight, zero biases,
    zero pos_embed; drawn from an explicit `torch.Generator`."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                nn.init.xavier_normal_(m.weight, gain=2 ** 0.5, generator=g)
                nn.init.zeros_(m.bias)
            elif isinstance(m, GCNBlock):
                nn.init.zeros_(m.pos_embed)
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


def make_generator(opt=None, **overrides) -> UNetTMO:
    """Build a generator from a config object with reference flag names
    (`config.Options`)."""
    kw: dict = {}
    if opt is not None:
        if int(getattr(opt, "convtranspose_kernel", 2)) != 2:
            raise ValueError("convtranspose_kernel != 2 is not supported "
                             "(published configs use 2)")
        if (not opt.g_doubleConvTranspose or opt.up_mode or opt.bilinear
                or opt.add_frame):
            raise NotImplementedError(
                "only the published doubleConvTranspose / 2x2-ConvT / "
                "add_frame=0 generator is ported (ROADMAP Queue 1)")
        kw = dict(
            n_channels=opt.input_dim, output_dim=opt.output_dim,
            last_layer=opt.last_layer, depth=opt.unet_depth,
            con_operator=opt.con_operator, filters=opt.filters,
            unet_norm=opt.unet_norm, activation=opt.g_activation,
            padding_mode="edge" if opt.padding == "replicate" else opt.padding,
            stretch_g=opt.stretch_g)
    kw.update(overrides)
    return UNetTMO(**kw)
