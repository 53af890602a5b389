"""ViG-style GCN bottleneck (NCHW).

Port of `uncltmo_tpu/models/gcn.py` (reference `gcn_lib/` and
`Unet.py:20-99`).  Attribute names follow the reference `.pth` layout:
`gcn.pos_embed`, `gcn.module.0.0.{fc1.0, graph_conv.gconv.nn.0, fc2.0,
relative_pos}`, `gcn.module.0.1.{fc1.0, fc2.0}`.

Numerics as in the JAX package:
* KNN distances on L2-normalised features (`+1e-24`), in float32 whatever
  the compute dtype, plus the fixed sincos relative-position bias (a
  buffer regenerated from geometry, not a learned parameter);
* max-relative aggregation, then the channel interleave `[x, rel]`
  (`gcn.py:166`) before the groups=4 1x1 conv;
* exact-erf GELU;
* drop path (per-sample stochastic depth, rate 0.05) on the Grapher's and
  the FFN's residual branches when a forward is not `deterministic`
  (`gcn.py:120-128`, `:170`, `:178`): two draws per block call, from an
  explicit `torch.Generator`, or from the caller's own masks.
`topk` may order tied neighbours differently from `lax.top_k`; the max over
neighbours only sees which set is chosen.

A bottleneck that is not gcn_grid x gcn_grid (whole-image inference) gets
the pos-embed bicubic-resized to its (h, w) and the relative-position bias
regenerated for the rectangular layout, as the JAX package does
(`gcn.py:143-156`, `:203-216`).  The regenerated table is no buffer: it
never enters `state_dict()`, so reference `.pth` files go on loading with
strict=True.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from uncltmo_tpu_torch.ops.precision import float32_island
from uncltmo_tpu_torch.ops.resize import bicubic_resize
from uncltmo_tpu_torch.parallel.mesh import rank_world


def sincos_pos_embed_2d(embed_dim: int, grid_size) -> np.ndarray:
    """2-D sine-cosine positional embedding, (H*W, embed_dim), float64
    (reference `gcn_lib/pos_embed.py:38-85`)."""
    assert embed_dim % 4 == 0
    gh_n, gw_n = ((grid_size, grid_size) if isinstance(grid_size, int)
                  else grid_size)

    def emb_1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(gh_n, dtype=np.float32)
    grid_w = np.arange(gw_n, dtype=np.float32)
    # meshgrid(w, h): grid[0] varies along w (fastest axis), grid[1] along h.
    gw, gh = np.meshgrid(grid_w, grid_h)
    emb_h = emb_1d(embed_dim // 2, gw)
    emb_w = emb_1d(embed_dim // 2, gh)
    return np.concatenate([emb_h, emb_w], axis=1)


def relative_pos_bias(embed_dim: int, grid_size) -> np.ndarray:
    """-(2 * P P^T / dim): the additive KNN distance bias, (n, n) float32
    (reference `gcn_lib/pos_embed.py:21-28` negated at
    `torch_vertex.py:227`)."""
    p = sincos_pos_embed_2d(embed_dim, grid_size)
    rel = 2.0 * (p @ p.T) / p.shape[1]
    return (-rel).astype(np.float32)


@float32_island
def dense_knn(nodes: torch.Tensor, k: int, rel_pos: torch.Tensor
              ) -> torch.Tensor:
    """k nearest neighbours of every node, (B, N, k) int64.

    nodes: (B, N, C); rel_pos: (N, N) float32.  Distances in float32 on the
    L2-normalised features, with autocast off (a float32 island,
    `ops/precision.py`: a bfloat16 distance would reorder neighbours and
    change the graph), without gradient (`gcn.py:67-88`)."""
    with torch.no_grad():
        x = nodes
        x = x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-24)
        sq = torch.sum(x * x, dim=-1, keepdim=True)            # (B, N, 1)
        dist = sq - 2.0 * torch.bmm(x, x.transpose(1, 2)) + sq.transpose(1, 2)
        dist = dist + rel_pos[None]
        return torch.topk(-dist, min(k, dist.shape[-1]), dim=-1).indices


def drop_path(x: torch.Tensor, rate: float, deterministic: bool,
              generator: torch.Generator | None = None,
              masks=None) -> torch.Tensor:
    """Per-sample stochastic depth (timm DropPath): x * mask / keep with one
    Bernoulli(keep) draw per sample.  The draw comes from `generator` (on
    the generator's device, then moved to x's), or, when `masks` is given,
    is the next item of that iterator: a (B,) tensor of zeros and ones, so
    that a caller can replay fixed masks.  Under a process group every rank
    draws the global batch's mask from its generator (the same on every
    rank) and keeps its own rows, so a rank drops what the one-process run
    drops in those rows; replayed masks are the rank's own."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    b = x.shape[0]
    if masks is not None:
        mask = next(masks)
    else:
        if generator is None:
            raise ValueError("drop_path: a training forward needs a "
                             "torch.Generator (or masks)")
        rank, world = rank_world()
        mask = torch.rand(b * world, generator=generator,
                          device=generator.device)[rank * b:(rank + 1) * b]
        mask = mask < keep
    mask = mask.to(device=x.device, dtype=x.dtype)
    return x * mask.reshape(b, 1, 1, 1) / keep


def _conv1x1(in_ch: int, out_ch: int, groups: int = 1) -> nn.Sequential:
    """Conv2d 1x1 wrapped as the reference's `Seq(Conv2d, ...)` (`.0`)."""
    return nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, groups=groups))


class _GraphConv(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.nn = _conv1x1(2 * ch, 2 * ch, groups=4)


class _MRConv(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.gconv = _GraphConv(ch)


class Grapher(nn.Module):
    """Grapher_noBN (`gcn_lib/torch_vertex.py:181-227`): fc1, max-relative
    graph conv, GELU, fc2, residual."""

    def __init__(self, ch: int, grid: int, k: int = 9,
                 drop_path_rate: float = 0.05):
        super().__init__()
        self.k = k
        self.drop_path_rate = drop_path_rate
        self.fc1 = _conv1x1(ch, ch)
        self.graph_conv = _MRConv(ch)
        self.fc2 = _conv1x1(2 * ch, ch)
        self.ch = ch
        self.grid = grid
        self.register_buffer(
            "relative_pos",
            torch.from_numpy(relative_pos_bias(ch, grid))[None])
        self._regenerated = None     # ((h, w, device), (N, N) float32 table)

    def _relative_pos_for(self, h: int, w: int, device) -> torch.Tensor:
        """The (N, N) bias of an (h, w) bottleneck: the stored buffer on the
        grid, else regenerated from the sincos geometry.  The product is
        taken in float64 on the tensor's device and rounded once, so the
        table equals the JAX package's host-built one to float32 rounding.
        A whole 1080p frame has 64 x 117 = 7,488 nodes and a 224 MB table,
        so only the last shape is kept."""
        if (h, w) == (self.grid, self.grid):
            return self.relative_pos[0]
        key = (h, w, torch.device(device))
        if self._regenerated is None or self._regenerated[0] != key:
            p = torch.from_numpy(sincos_pos_embed_2d(self.ch, (h, w))).to(
                device)
            table = (p @ p.T).mul_(2.0).div_(p.shape[1]).neg_().float()
            self._regenerated = (key, table)
        return self._regenerated[1]

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator=None, drop_masks=None) -> torch.Tensor:
        b, c, h, w = x.shape
        n = h * w
        shortcut = x
        nodes = self.fc1(x).reshape(b, c, n)                   # (B, C, N)
        idx = dense_knn(nodes.transpose(1, 2), self.k,
                        self._relative_pos_for(h, w, x.device))  # (B, N, k)
        kk = idx.shape[-1]
        x_j = torch.gather(
            nodes[:, :, None, :].expand(b, c, n, n), 3,
            idx[:, None].expand(b, c, n, kk))                  # (B, C, N, k)
        rel = torch.max(x_j - nodes[..., None], dim=-1).values  # (B, C, N)
        # channel interleave [x, rel] -> 2C (`torch_vertex.py:28-29`)
        mr = torch.stack([nodes, rel], dim=2).reshape(b, 2 * c, h, w)
        mr = F.gelu(self.graph_conv.gconv.nn(mr))
        return drop_path(self.fc2(mr), self.drop_path_rate, deterministic,
                         generator, drop_masks) + shortcut


class FFN(nn.Module):
    """`Unet.py:20-42`: fc1, GELU, fc2, residual."""

    def __init__(self, ch: int, drop_path_rate: float = 0.05):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.fc1 = _conv1x1(ch, ch)
        self.fc2 = _conv1x1(ch, ch)

    def forward(self, x, deterministic: bool = True, generator=None,
                drop_masks=None):
        y = self.fc2(F.gelu(self.fc1(x)))
        return drop_path(y, self.drop_path_rate, deterministic, generator,
                         drop_masks) + x


class GCNBlock(nn.Module):
    """pos_embed add + Grapher + FFN (reference `Unet.py:44-99`).  With
    `deterministic=False` (a training forward) both residual branches go
    through `drop_path`: first the Grapher's draw, then the FFN's."""

    def __init__(self, ch: int, grid: int = 12, k: int = 9,
                 drop_path_rate: float = 0.05):
        super().__init__()
        self.grid = grid
        self.pos_embed = nn.Parameter(torch.zeros(1, ch, grid, grid))
        self.module = nn.Sequential(nn.Sequential(
            Grapher(ch, grid, k, drop_path_rate), FFN(ch, drop_path_rate)))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator=None, drop_masks=None) -> torch.Tensor:
        pos = self.pos_embed
        if tuple(x.shape[2:]) != (self.grid, self.grid):
            # the reference adds the fixed grid by broadcast and fails on
            # any other bottleneck; the JAX package resizes the embedding
            pos = bicubic_resize(pos.to(x.dtype), x.shape[2], x.shape[3])
        grapher, ffn = self.module[0]
        x = grapher(x + pos, deterministic, generator, drop_masks)
        return ffn(x, deterministic, generator, drop_masks)
