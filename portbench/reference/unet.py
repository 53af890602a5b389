"""Plain PyTorch reference of the published UnCLTMO generator, NCHW.

The published configuration (`scripts/run_imageTMO_train.sh` of the
reference repository): depth 4, 32 filters, valid 3x3 convolutions with
relu and no norm, the `square_and_square_root` skip concat
`[x2, x1, x2^2, sqrt(x2 + 1e-8)]`, doubleConvTranspose decoder cells
(two ConvTranspose2d(k=3) with relu), a 2x2 stride-2 ConvTranspose2d
upsample, replicate padding where an upsample falls short of its skip, a
ViG graph bottleneck (k = 9 neighbours on a 12 x 12 grid, max-relative
graph conv, GELU, an FFN) and a sigmoid head.  Video runs the same
single-frame network with a temporal carry: the first 1/32 of the channels
at eight positions are replaced by the previous frame's (reference
`Unet.py:229-272`).

Parameters are a flat dict in the reference `.pth` layout
(`param_shapes`).  Every convolution and matrix product goes through a
`Precision`, whose `tf32=True` computes them with TF32 operands: on a CUDA
device by the library's TF32 mode, on the CPU by rounding both operands to
TF32's 10-bit mantissa.  That is the output check's control.
"""
from __future__ import annotations

import contextlib
import math
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-8
DEPTH = 4
FILTERS = 32
GCN_GRID = 12
KNN = 9
CARRY_RATIO = 1 / 32


def param_shapes(filters: int = FILTERS, depth: int = DEPTH,
                 grid: int = GCN_GRID) -> "OrderedDict[str, tuple]":
    """Name -> shape of every tensor of the generator's state dict (the
    reference `.pth` layout), parameters and the GCN's fixed table."""
    s = OrderedDict()

    def conv(name, cout, cin, k):
        s[name + ".weight"] = (cout, cin, k, k)
        s[name + ".bias"] = (cout,)

    def convt(name, cin, cout, k):
        s[name + ".weight"] = (cin, cout, k, k)
        s[name + ".bias"] = (cout,)

    f = filters
    conv("inc.conv.conv", f, 1, 3)
    conv("inc.conv.conv1", f, f, 3)
    ch = f
    for i in range(depth - 1):
        conv(f"down_path.{i}.mpconv.1.conv", 2 * ch, ch, 3)
        conv(f"down_path.{i}.mpconv.1.conv1", 2 * ch, 2 * ch, 3)
        ch *= 2
    conv(f"down_path.{depth - 1}.mpconv.1.conv", ch, ch, 3)
    convt(f"down_path.{depth - 1}.mpconv.1.conv1", ch, ch, 3)
    g = "gcn.module.0."
    s["gcn.pos_embed"] = (1, ch, grid, grid)
    s[g + "0.relative_pos"] = (1, grid * grid, grid * grid)
    conv(g + "0.fc1.0", ch, ch, 1)
    s[g + "0.graph_conv.gconv.nn.0.weight"] = (2 * ch, 2 * ch // 4, 1, 1)
    s[g + "0.graph_conv.gconv.nn.0.bias"] = (2 * ch,)
    conv(g + "0.fc2.0", ch, 2 * ch, 1)
    conv(g + "1.fc1.0", ch, ch, 1)
    conv(g + "1.fc2.0", ch, ch, 1)
    skips = [f * 2 ** i for i in range(depth)]
    for i in range(depth):
        out = f if i >= depth - 2 else ch // 2
        convt(f"up_path.{i}.up", ch, ch, 2)
        convt(f"up_path.{i}.conv.conv", 3 * skips[depth - 1 - i] + ch, out, 3)
        convt(f"up_path.{i}.conv.conv1", out, out, 3)
        ch = out
    conv("outc.conv", 1, ch, 1)
    return s


def sincos_table(dim: int, grid: int) -> np.ndarray:
    """The GCN's fixed distance bias -(2 P P^T / dim) of the 2-D sine-cosine
    position embedding P (reference `gcn_lib/pos_embed.py`), float32."""
    def emb_1d(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2))
        out = np.outer(pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    ax = np.arange(grid, dtype=np.float32)
    gw, gh = np.meshgrid(ax, ax)
    p = np.concatenate([emb_1d(dim // 2, gw), emb_1d(dim // 2, gh)], axis=1)
    return (-2.0 * (p @ p.T) / dim).astype(np.float32)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, to nearest; the gradient
    passes as through the identity."""
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return x + (bits.view(torch.float32) - x.detach())


class Precision:
    """How the reference's convolutions and products are computed: float32
    with TF32 off (`tf32=False`), or with TF32 operands."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    @contextlib.contextmanager
    def _mode(self, x: torch.Tensor):
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.tf32 and x.is_cuda
        torch.backends.cuda.matmul.allow_tf32 = self.tf32 and x.is_cuda
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags

    def _operands(self, *ts):
        if self.tf32 and not ts[0].is_cuda:
            return [_round_tf32(t) for t in ts]
        return list(ts)

    def conv2d(self, x, w, b, groups: int = 1, stride: int = 1):
        x, w = self._operands(x, w)
        with self._mode(x):
            return F.conv2d(x, w, b, stride=stride, groups=groups)

    def conv_t(self, x, w, b, stride: int = 1):
        x, w = self._operands(x, w)
        with self._mode(x):
            return F.conv_transpose2d(x, w, b, stride=stride)

    def bmm(self, a, b):
        a, b = self._operands(a, b)
        with self._mode(a):
            return torch.bmm(a, b)


def _double_conv(prec, p, pre, x):
    x = F.relu(prec.conv2d(x, p[pre + "conv.weight"], p[pre + "conv.bias"]))
    return F.relu(prec.conv2d(x, p[pre + "conv1.weight"],
                              p[pre + "conv1.bias"]))


def _splice(x, rec):
    """x with its first rec.shape[1] channels replaced by rec."""
    if rec is None or rec.shape[1] == 0:
        return x
    return torch.cat([rec, x[:, rec.shape[1]:]], 1)


def _head(x):
    return x[:, :int(x.shape[1] * CARRY_RATIO)]


def _dropped(x, mask):
    """A residual branch under drop path: x * mask / keep, per sample."""
    if mask is None:
        return x
    return x * mask.to(x.dtype).reshape(-1, 1, 1, 1) / 0.95


def _graph_bottleneck(prec, p, x, drop=None):
    """pos_embed + Grapher (max-relative graph conv over the k nearest
    neighbours) + FFN, with their residuals; `drop` is the two branches'
    drop-path keep masks in a training forward."""
    drop = list(drop) if drop is not None else [None, None]
    g = "gcn.module.0."
    x = x + p["gcn.pos_embed"]
    b, c, h, w = x.shape
    n = h * w
    nodes = prec.conv2d(x, p[g + "0.fc1.0.weight"],
                        p[g + "0.fc1.0.bias"]).reshape(b, c, n)
    with torch.no_grad():
        v = nodes.transpose(1, 2)
        v = v / torch.sqrt((v * v).sum(-1, keepdim=True) + 1e-24)
        sq = (v * v).sum(-1, keepdim=True)
        dist = sq - 2.0 * prec.bmm(v, v.transpose(1, 2)) + sq.transpose(1, 2)
        dist = dist + p[g + "0.relative_pos"].reshape(1, n, n)
        idx = torch.topk(-dist, KNN, dim=-1).indices           # (B, N, k)
    neigh = torch.stack([nodes[i][:, idx[i]] for i in range(b)])  # (B,C,N,k)
    rel = (neigh - nodes[..., None]).max(-1).values
    mixed = torch.stack([nodes, rel], 2).reshape(b, 2 * c, h, w)
    y = F.gelu(prec.conv2d(mixed, p[g + "0.graph_conv.gconv.nn.0.weight"],
                           p[g + "0.graph_conv.gconv.nn.0.bias"], groups=4))
    x = _dropped(prec.conv2d(y, p[g + "0.fc2.0.weight"],
                             p[g + "0.fc2.0.bias"]), drop[0]) + x
    y = F.gelu(prec.conv2d(x, p[g + "1.fc1.0.weight"], p[g + "1.fc1.0.bias"]))
    return _dropped(prec.conv2d(y, p[g + "1.fc2.0.weight"],
                                p[g + "1.fc2.0.bias"]), drop[1]) + x


def _fit_to(x1, x2):
    """Replicate-pad (or crop) x1 to x2's spatial size, the smaller half of
    the difference before."""
    dy, dx = x2.shape[2] - x1.shape[2], x2.shape[3] - x1.shape[3]
    if dy < 0 or dx < 0:
        y0, x0 = (-dy) // 2, (-dx) // 2
        x1 = x1[:, :, y0:y0 + min(x1.shape[2], x2.shape[2]),
                x0:x0 + min(x1.shape[3], x2.shape[3])]
        dy, dx = max(dy, 0), max(dx, 0)
    if dy or dx:
        x1 = F.pad(x1, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2),
                   mode="replicate")
    return x1


def generator_frame(p, x, carry=None, prec: Precision | None = None,
                    drop=None):
    """One frame (B, 1, H, W) -> (sigmoid output (B, 1, H, W), new carry,
    or, with `drop` (a training forward's two drop-path masks), the last
    decoder feature map in the carry's place).  `carry` is the previous
    frame's eight slices, or None."""
    prec = prec or Precision()
    x = _double_conv(prec, p, "inc.conv.", x)
    skips, new = [x], [_head(x)]
    for i in range(DEPTH):
        pre = f"down_path.{i}.mpconv.1."
        x = F.max_pool2d(x, 2)
        if carry is not None:
            x = _splice(x, F.max_pool2d(carry[i], 2) if carry[i].shape[1]
                        else None)
        if i < DEPTH - 1:
            x = _double_conv(prec, p, pre, x)
            skips.append(x)
            new.append(_head(x))
        else:
            x = F.relu(prec.conv2d(x, p[pre + "conv.weight"],
                                   p[pre + "conv.bias"]))
            x = F.relu(prec.conv_t(x, p[pre + "conv1.weight"],
                                   p[pre + "conv1.bias"]))
    x = _graph_bottleneck(prec, p, x, drop)
    new.append(_head(x))
    for i in range(DEPTH):
        pre = f"up_path.{i}."
        if carry is not None:
            x = _splice(x, carry[DEPTH + i])
        x1 = prec.conv_t(x, p[pre + "up.weight"], p[pre + "up.bias"], 2)
        x2 = skips[DEPTH - 1 - i]
        x1 = _fit_to(x1, x2)
        x = torch.cat([x2, x1, x2 * x2, torch.sqrt(x2 + EPS)], 1)
        x = F.relu(prec.conv_t(x, p[pre + "conv.conv.weight"],
                               p[pre + "conv.conv.bias"]))
        x = F.relu(prec.conv_t(x, p[pre + "conv.conv1.weight"],
                               p[pre + "conv.conv1.bias"]))
        if i < DEPTH - 1:
            new.append(_head(x))
    out = torch.sigmoid(prec.conv2d(x, p["outc.conv.weight"],
                                    p["outc.conv.bias"]))
    return (out, x) if drop is not None else (out, new)


def generator_scene(p, x_btchw, prec: Precision | None = None):
    """(B, T, 1, H, W) clips -> (B, T, 1, H, W): frame 0 without a carry,
    each later frame with the one before's."""
    carry, outs = None, []
    for k in range(x_btchw.shape[1]):
        out, carry = generator_frame(p, x_btchw[:, k], carry, prec)
        outs.append(out)
    return torch.stack(outs, 1)


def bottleneck(size: int, depth: int = DEPTH) -> int:
    """The GCN grid of a size x size input: two valid convs, then per Down
    a pool and two more (the last: a conv and a ConvT(3) back)."""
    n = size - 4
    for _ in range(depth - 1):
        n = n // 2 - 4
    return n // 2


def xavier_std(shape) -> float:
    """xavier-normal standard deviation with gain sqrt(2) (the reference's
    `--use_xaviar 1` initialisation), fans as torch counts them."""
    rf = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_in, fan_out = shape[1] * rf, shape[0] * rf
    return math.sqrt(2.0) * math.sqrt(2.0 / (fan_in + fan_out))
