"""Discriminators (NCHW): the published `SimpleDiscriminator` and the legacy
DCGAN, PatchGAN and multiscale variants.

Port of `uncltmo_tpu/models/discriminator.py` (reference
`models/Discriminator.py`).  `SimpleDiscriminator`'s attribute names follow
the reference `.pth` layout: `model.0`, `model.2` (the two 4x4 stride-2
convs), `model.4` (the 1x1 conv to one channel) and `tail.1` (the linear
head without bias), so its `state_dict()` keys are those of a reference
checkpoint.  The multiscale discriminator registers each scale's trunk as
`layer{i}` (the reference stores `netD.model`, `Discriminator.py:203`).
The DCGAN and PatchGAN variants keep their layers in one `model`
sequence, a norm slot after every normalised conv (`nn.Identity` without
a norm); no reference checkpoint of either exists to check that layout
against.

Only `SimpleDiscriminator` trains: the contrastive GAN losses consume its
(logit, feature) pair, and the trainer refuses GAN training with any other
`d_model` (`uncltmo_tpu/training/trainer.py:101-110`).  The others return
score maps; their batch norm (`d_norm`, the PatchGAN's reference default)
normalises by the batch and moves its running statistics when `train=True`
and by the running statistics otherwise.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from uncltmo_tpu_torch.models.blocks import BatchNorm, InstanceNorm, make_norm
from uncltmo_tpu_torch.ops.precision import no_autocast
from uncltmo_tpu_torch.ops.resize import bicubic_half
from uncltmo_tpu_torch.ops.windows import adaptive_avg_pool_1, contrast_map


def _conv4(in_ch: int, out_ch: int, stride: int, padding: int,
           bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, 4, stride=stride, padding=padding,
                     bias=bias)


def _run(model: nn.Sequential, x: torch.Tensor, train: bool) -> torch.Tensor:
    """A layer sequence whose norms take the mode from the caller."""
    for m in model:
        x = m(x, train) if isinstance(m, (BatchNorm, InstanceNorm)) else m(x)
    return x


class SimpleDTrunk(nn.Sequential):
    """SimpleDiscriminator's conv trunk (`Discriminator.py:95-109`,
    `self.model`): conv4s2 -> LReLU -> conv4s2 [-> LReLU -> 1x1 conv], or a
    global max pool after the second conv with `simpleD_maxpool`."""

    def __init__(self, dim: int = 16, simpleD_maxpool: bool = False,
                 padding: int = 0, in_ch: int = 1):
        layers = [_conv4(in_ch, dim, 2, padding), nn.LeakyReLU(0.2),
                  _conv4(dim, dim * 2, 2, padding)]
        if simpleD_maxpool:
            layers.append(nn.AdaptiveMaxPool2d(1))
        else:
            layers += [nn.LeakyReLU(0.2), nn.Conv2d(dim * 2, 1, 1)]
        super().__init__(*layers)


class SimpleDiscriminator(nn.Module):
    """conv4s2 -> LReLU -> conv4s2 [-> LReLU -> 1x1 conv] -> flatten+linear.

    (B, in_ch, S, S) -> (logit (B, 1), feature (B, 2F, 1, 1)) with the
    feature avgpool(fea) ++ avgpool(contrast map of fea), F = 1 (or 2*dim
    with `simpleD_maxpool`, where the 1x1 map has no contrast statistics
    and the second half is zero).  `norm` is accepted and unused, as in the
    JAX module."""

    def __init__(self, input_size: int = 256, dim: int = 16,
                 norm: str = "none", last_activation: str = "none",
                 simpleD_maxpool: bool = False, padding: int = 0,
                 in_ch: int = 1):
        super().__init__()
        self.last_activation = last_activation
        self.model = SimpleDTrunk(dim, simpleD_maxpool, padding, in_ch)
        if simpleD_maxpool:
            last_dim = dim * 2
        elif padding:
            last_dim = (input_size // 4) ** 2
        else:
            last_dim = ((input_size // 2 - 1) // 2 - 1) ** 2
        self.tail = nn.Sequential(nn.Flatten(),
                                  nn.Linear(last_dim, 1, bias=False))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        fea = self.model(x)
        # the logit in float32 under autocast, as XLA's float32
        # accumulation gives it: the relativistic loss compares logits
        # closer than a bfloat16 step of their size
        with no_autocast():
            out = self.tail(fea.to(self.tail[1].weight.dtype))
        if self.last_activation == "sigmoid":
            out = torch.sigmoid(out)
        fea1 = adaptive_avg_pool_1(fea)
        if fea.shape[2] >= 11 and fea.shape[3] >= 11:
            fea2 = adaptive_avg_pool_1(contrast_map(fea))
        else:
            fea2 = torch.zeros_like(fea1)
        return out, torch.cat([fea1, fea2], 1)


def _norm_slot(norm: str, ch: int) -> nn.Module:
    module = make_norm(norm, ch)
    return nn.Identity() if module is None else module


class DCGANDiscriminator(nn.Module):
    """Legacy DCGAN-style discriminator (reference `Discriminator.py:8-48`,
    d_model 'original' / 'dcgan'): conv4s2p1 stack halving the map until
    8 px (channels doubling, capped at 512), then a valid 4x4 conv to one
    channel; optional fully-connected head (`fc`).  Every conv is without
    bias (the reference's `Conv2dBlock`, `Blocks.py:9-11`)."""

    def __init__(self, input_size: int = 256, dim: int = 16,
                 norm: str = "none", last_activation: str = "none",
                 d_fully_connected: bool = False, d_nlayers: int = 3,
                 in_ch: int = 1):
        super().__init__()
        self.last_activation = last_activation
        layers = [_conv4(in_ch, dim, 2, 1, bias=False), nn.LeakyReLU(0.2)]
        if d_fully_connected:
            n_down = d_nlayers
        else:
            n_down, size = 0, input_size
            while size > 8:
                size //= 2
                n_down += 1
        ch = dim
        for _ in range(n_down):
            nxt = min(ch * 2, 512)
            layers += [_conv4(ch, nxt, 2, 1, bias=False),
                       _norm_slot(norm, nxt), nn.LeakyReLU(0.2)]
            ch = nxt
        layers.append(_conv4(ch, 1, 1, 0, bias=False))
        self.model = nn.Sequential(*layers)
        self.fc = None
        if d_fully_connected:
            side = input_size // 2 ** (n_down + 1) - 3
            self.fc = nn.Linear(side * side, 1, bias=False)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = _run(self.model, x, train)
        if self.fc is not None:
            x = self.fc(x.reshape(x.shape[0], -1))
        if self.last_activation == "sigmoid":
            x = torch.sigmoid(x)
        return x


class NLayerDiscriminator(nn.Module):
    """PatchGAN discriminator (reference `Discriminator.py:129-167`): a
    conv4s2p1 with bias, `n_layers - 1` conv4s2p1 blocks with a norm, a
    stride-1 block with the same norm (`:154-158`), and a conv4s1p1 to one
    channel."""

    def __init__(self, ndf: int = 64, n_layers: int = 3, norm: str = "none",
                 last_activation: str = "none", in_ch: int = 1):
        super().__init__()
        self.last_activation = last_activation
        layers = [_conv4(in_ch, ndf, 2, 1), nn.LeakyReLU(0.2)]
        ch = ndf
        for n in range(1, n_layers):
            nxt = ndf * min(2 ** n, 8)
            layers += [_conv4(ch, nxt, 2, 1, bias=False),
                       _norm_slot(norm, nxt), nn.LeakyReLU(0.2)]
            ch = nxt
        nxt = ndf * min(2 ** n_layers, 8)
        layers += [_conv4(ch, nxt, 1, 1, bias=False), _norm_slot(norm, nxt),
                   nn.LeakyReLU(0.2), _conv4(nxt, 1, 1, 1)]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = _run(self.model, x, train)
        if self.last_activation == "sigmoid":
            x = torch.sigmoid(x)
        return x


class MultiscaleDiscriminator(nn.Module):
    """`num_D` sub-discriminators over a bicubic half-resolution pyramid
    (reference `Discriminator.py:170-206`); the sub-type follows the
    d_model name ('dcgan' / 'patchD' / else the simpleD trunk).  Returns
    the score map of every scale; the sub-discriminators run with their
    running statistics, as the JAX module calls them."""

    def __init__(self, input_size: int = 256, dim: int = 16, num_D: int = 3,
                 norm: str = "none", last_activation: str = "none",
                 simpleD_maxpool: bool = False, padding: int = 0,
                 d_model: str = "multiLayerD_simpleD", d_nlayers: int = 3,
                 d_fully_connected: bool = False, in_ch: int = 1):
        super().__init__()
        self.num_D = num_D
        size = input_size
        for i in range(num_D):
            if "dcgan" in d_model:
                d = DCGANDiscriminator(size, dim, norm, last_activation,
                                       d_fully_connected, d_nlayers, in_ch)
                size //= 2
            elif "patchD" in d_model:
                d = NLayerDiscriminator(dim, d_nlayers, norm,
                                        last_activation, in_ch)
            else:
                d = SimpleDTrunk(dim, simpleD_maxpool, padding, in_ch)
                size //= 2
            self.add_module(f"layer{i}", d)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        results = []
        for i in range(self.num_D):
            results.append(getattr(self, f"layer{i}")(x))
            if i != self.num_D - 1:
                x = bicubic_half(x)
        return results


def make_discriminator(opt=None, **overrides) -> nn.Module:
    """The discriminator the reference factory would build
    (`utils/model_save_util.py:97-118`) from a config object with reference
    flag names (`config.Options`): d_model 'simpleD', 'original' / 'dcgan',
    'patchD' or 'multiLayerD_*'."""
    if opt is None:
        return SimpleDiscriminator(**overrides)
    d_model = opt.d_model
    if d_model == "simpleD":
        kw = dict(input_size=256, dim=opt.d_down_dim, norm=opt.d_norm,
                  last_activation=opt.d_last_activation,
                  simpleD_maxpool=bool(opt.simpleD_maxpool),
                  padding=opt.d_padding)
        cls = SimpleDiscriminator
    elif d_model in ("original", "dcgan"):
        kw = dict(input_size=256, dim=opt.d_down_dim, norm=opt.d_norm,
                  last_activation=opt.d_last_activation,
                  d_fully_connected=bool(opt.d_fully_connected),
                  d_nlayers=opt.d_nlayers)
        cls = DCGANDiscriminator
    elif d_model == "patchD":
        kw = dict(ndf=opt.d_down_dim, n_layers=opt.d_nlayers,
                  norm=opt.d_norm, last_activation=opt.d_last_activation)
        cls = NLayerDiscriminator
    elif "multiLayerD" in d_model:
        kw = dict(input_size=256, dim=opt.d_down_dim, num_D=opt.num_D,
                  norm=opt.d_norm, last_activation=opt.d_last_activation,
                  simpleD_maxpool=bool(opt.simpleD_maxpool),
                  padding=opt.d_padding, d_model=d_model,
                  d_nlayers=opt.d_nlayers,
                  d_fully_connected=bool(opt.d_fully_connected))
        cls = MultiscaleDiscriminator
    else:
        raise ValueError(
            f"Unsupported d_model: {d_model!r} (reference factory supports "
            "'simpleD', 'original'/'dcgan', 'patchD', 'multiLayerD_*' -- "
            "`utils/model_save_util.py:97-118`)")
    kw.update(overrides)
    return cls(**kw)
