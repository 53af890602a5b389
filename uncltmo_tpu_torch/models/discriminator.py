"""The discriminator of the published configuration (NCHW).

Port of `uncltmo_tpu/models/discriminator.py:26-71` (reference
`models/Discriminator.py:87-126`).  Attribute names follow the reference
`.pth` layout: `model.0`, `model.2` (the two 4x4 stride-2 convs), `model.4`
(the 1x1 conv to one channel) and `tail.1` (the linear head without bias),
so `state_dict()` keys are those of a reference checkpoint.

The contrastive GAN losses consume `SimpleDiscriminator`'s (logit, feature)
pair, and the trainer refuses every other `d_model`
(`uncltmo_tpu/training/trainer.py:101-110`), so the DCGAN, PatchGAN and
multiscale variants are not ported: `make_discriminator` raises for them
by name.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from uncltmo_tpu_torch.ops.windows import adaptive_avg_pool_1, contrast_map


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
        layers = [nn.Conv2d(in_ch, dim, 4, stride=2, padding=padding),
                  nn.LeakyReLU(0.2),
                  nn.Conv2d(dim, dim * 2, 4, stride=2, padding=padding)]
        if simpleD_maxpool:
            layers.append(nn.AdaptiveMaxPool2d(1))
            last_dim = dim * 2
        else:
            layers += [nn.LeakyReLU(0.2), nn.Conv2d(dim * 2, 1, 1)]
            if padding:
                last_dim = (input_size // 4) ** 2
            else:
                last_dim = ((input_size // 2 - 1) // 2 - 1) ** 2
        self.model = nn.Sequential(*layers)
        self.tail = nn.Sequential(nn.Flatten(),
                                  nn.Linear(last_dim, 1, bias=False))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        fea = self.model(x)
        out = self.tail(fea)
        if self.last_activation == "sigmoid":
            out = torch.sigmoid(out)
        fea1 = adaptive_avg_pool_1(fea)
        if fea.shape[2] >= 11 and fea.shape[3] >= 11:
            fea2 = adaptive_avg_pool_1(contrast_map(fea))
        else:
            fea2 = torch.zeros_like(fea1)
        return out, torch.cat([fea1, fea2], 1)


def make_discriminator(opt=None, **overrides) -> SimpleDiscriminator:
    """The discriminator the reference factory would build
    (`utils/model_save_util.py:97-118`) from a config object with reference
    flag names (`config.Options`); `simpleD` only."""
    if opt is None:
        return SimpleDiscriminator(**overrides)
    if opt.d_model != "simpleD":
        raise NotImplementedError(
            f"d_model={opt.d_model!r} is not ported: the training step "
            "needs SimpleDiscriminator's (logit, feature) pair, and the "
            "DCGAN, PatchGAN and multiscale variants are never trained "
            "(ROADMAP Queue 1, later slices)")
    kw = dict(input_size=256, dim=opt.d_down_dim, norm=opt.d_norm,
              last_activation=opt.d_last_activation,
              simpleD_maxpool=bool(opt.simpleD_maxpool),
              padding=opt.d_padding)
    kw.update(overrides)
    return SimpleDiscriminator(**kw)
