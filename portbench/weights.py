"""Seeded weights, made on the device in one draw a model: every tensor of
the reference `.pth` layouts (`reference.unet.param_shapes`,
`reference.gan.disc_shapes`).  Conv, transposed-conv and linear weights
are xavier-normal with gain sqrt(2) (the published `--use_xaviar 1`),
biases N(0, 0.01^2) and the GCN's position embedding N(0, 0.02^2), so
that every bias path carries a value; the GCN's fixed distance table is
the sine-cosine geometry's.  Both the program and the reference are
handed these dicts."""
from __future__ import annotations

import math

import torch

from .reference import unet


def generator_state(seed: int, device, grid: int = unet.GCN_GRID) -> dict:
    return _draw(unet.param_shapes(grid=grid), seed, device)


def discriminator_state(seed: int, device, size: int = 256) -> dict:
    """`SimpleDiscriminator(input_size=size)`'s parameters, drawn alike."""
    from .reference import gan
    return _draw(gan.disc_shapes(size), seed, device)


def _draw(shapes, seed: int, device) -> dict:
    drawn = {k: s for k, s in shapes.items() if not k.endswith("relative_pos")}
    total = sum(math.prod(s) for s in drawn.values())
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for k, s in shapes.items():
        if k not in drawn:
            _, ch, grid, _ = shapes["gcn.pos_embed"]
            out[k] = torch.from_numpy(unet.sincos_table(ch, grid))[None].to(
                device)
            continue
        n = math.prod(s)
        v = z[off:off + n].view(s)
        off += n
        if k.endswith(".weight"):
            v = v * unet.xavier_std(s)
        elif k == "gcn.pos_embed":
            v = v * 0.02
        else:
            v = v * 0.01
        out[k] = v.contiguous()
    return out
