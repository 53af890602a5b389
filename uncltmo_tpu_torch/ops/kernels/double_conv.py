"""K2: the U-Net's (valid 3x3 conv -> bias -> relu) x 2 cell, fused.

Replaces the TPU kernel `fused_double_conv3x3` (`uncltmo_tpu/ops/
pallas_kernels.py:88-132`, oracle `double_conv3x3_reference` at `:241-250`).
The CUDA C++ kernels are in `csrc/double_conv3x3.cu` (float32) and
`csrc/double_conv3x3_bf16.cu` (bfloat16), one library each, over what both
share in `csrc/double_conv3x3.cuh` (whose header says what bounds them on
Hopper and how the design answers that); this module holds the plain
PyTorch version, the weight packing and the ctypes wrapper.

Dispatch is by the tensor's device alone: CPU tensors take the plain
version (differentiated by autograd), CUDA tensors go through
`_DoubleConv3x3`, whose forward launches the kernel (a failed build or
launch raises) whether or not a gradient is wanted.  Under `torch.autocast`
(bfloat16 training) the input and the float32 master weights are cast to
the autocast dtype here, before either version, because autocast casts no
input of a custom `autograd.Function`; the casts are differentiable, so
the weight and bias gradients come back to the float32 parameters.  The TPU kernel has no
VJP and the JAX training step never reaches it, so the gradient is no port
of a kernel: `double_conv3x3_backward` recomputes the intermediate with
`F.conv2d` and calls the library's convolution gradients.
The TPU kernel's `W*Cin % 128 == 0` rule is a Mosaic DMA constraint and
does not apply here: any H, W >= 5 and any channel counts are accepted.

The kernel reads the weights packed (`pack_double_conv_weights`): in the
byte image of its shared-memory stages, in the order it consumes them,
under the plan of the configuration that serves the call
(`kernel_plan`).  Packing costs a few small device copies, so a caller
that runs the same weights many times packs once and passes the result as
`packed` (`models/blocks.py:DoubleConv` keeps it, keyed on `weights_key`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from uncltmo_tpu_torch.ops.kernels.build import call, load_library
from uncltmo_tpu_torch.ops.kernels.packing import (
    PackedCell, check_packed, round_up, stage_images, tf32_split)
from uncltmo_tpu_torch.ops.precision import autocast_dtype

# one source and library per element type
_SOURCES = {torch.float32: "double_conv3x3.cu",
            torch.bfloat16: "double_conv3x3_bf16.cu"}


class Plan(NamedTuple):
    """What the packing and the kernel agree on for one call
    (`uncltmo_double_conv3x3_plan`, `csrc/double_conv3x3.cuh:plan_out`)."""
    cinp: int      # input channels, padded (1: Cin == 1, conv1 on CUDA cores)
    cinc: int      # input channels staged at a time
    c1p: int       # intermediate channels, padded to whole chunks
    ch: int        # intermediate channels a chunk
    cl: int        # CTAs a cluster (each: ch / cl of conv1, n2 of conv2)
    n2: int        # output channels a CTA
    c2p: int       # output channels, padded
    th: int        # output tile height
    tw: int        # output tile width
    tg: int        # taps a weight stage
    nst: int       # weight stages in the ring
    nwg: int       # consumer warpgroups
    ch1: int       # intermediate channels of one conv1 pass (a cluster's)
    persistent: int  # 1: the persistent float32 kernel


# The defaults of the two sources by element type and output-channel
# width ("inc": Cin == 1, C2 <= 32): bfloat16 (`UNCLTMO_K2_CFG*`) as (TH,
# TW, NWG, CH, C2P, CL, CINC, TG, NST), float32 (`UNCLTMO_K2F_CFG*`, the
# persistent kernel) as (TH, TW, NWG, CH, NB, C2P, CL, CINC, CINS, TG, NST,
# D2).  On a CUDA tensor the plan comes from the built library itself;
# this table serves the packing of CPU tensors.
_CFGS = {
    torch.bfloat16: {"inc": (12, 28, 2, 32, 32, 1, 64, 9, 2),
                     32: (12, 28, 2, 32, 32, 1, 64, 3, 3),
                     64: (7, 31, 2, 32, 64, 1, 64, 9, 2),
                     128: (2, 57, 2, 32, 128, 1, 64, 3, 3),
                     256: (2, 24, 2, 128, 256, 2, 128, 1, 3)},
    torch.float32: {"inc": (12, 28, 3, 16, 16, 32, 1, 32, 32, 3, 3, 1),
                    32: (4, 28, 2, 16, 16, 32, 1, 32, 32, 1, 4, 1),
                    64: (5, 31, 3, 16, 16, 64, 1, 32, 32, 3, 3, 1),
                    128: (2, 57, 2, 16, 32, 128, 1, 64, 64, 3, 2, 0),
                    256: (2, 24, 2, 32, 64, 256, 2, 64, 128, 1, 2, 1)},
}


def padded_c2(c2: int) -> int:
    """C2 padded to the output-channel width of a configuration: 32, 64,
    128 or a multiple of 256 (one pass of the grid's y per 256)."""
    return next((n for n in (32, 64, 128) if c2 <= n), round_up(c2, 256))


def padded_cin(cin: int, es: int) -> int:
    """Cin padded to a whole swizzle row a tap: 16 or 32 channels, else a
    multiple of 128 bytes."""
    return 16 if cin <= 16 else 32 if cin <= 32 else round_up(cin, 128 // es)


def default_plan(cin: int, c1: int, c2: int, dtype: torch.dtype) -> Plan:
    """The plan of the source's default configurations (see `_CFGS`)."""
    c2p = padded_c2(c2)
    cin1 = c2p == 32 and cin == 1
    cfg = _CFGS[dtype]["inc" if cin1 else min(c2p, 256)]
    if dtype == torch.float32:
        th, tw, nwg, ch, nb, c2blk, cl, cinc_max, _, tg, nst, _ = cfg
        ch1, persistent = nb * cl, 1
    else:
        th, tw, nwg, ch, c2blk, cl, cinc_max, tg, nst = cfg
        ch1, persistent = ch, 0
    es = torch.finfo(dtype).bits // 8
    cinp = 1 if cin1 else padded_cin(cin, es)
    return Plan(cinp, 1 if cin1 else min(cinp, cinc_max), round_up(c1, ch1),
                ch, cl, c2blk // cl, c2p, th, tw, tg, nst, nwg, ch1,
                persistent)


def kernel_plan(cin: int, c1: int, c2: int, dtype: torch.dtype,
                device: torch.device) -> Plan:
    """The plan of the configuration that serves the call: the built
    library's own on a CUDA device, `default_plan` elsewhere."""
    if torch.device(device).type != "cuda":
        return default_plan(cin, c1, c2, dtype)
    out = (ctypes.c_int * len(Plan._fields))()
    call(load_library(_SOURCES[dtype]), "uncltmo_double_conv3x3_plan", cin,
         c1, c2, out)
    return Plan(*out)


@functools.lru_cache(maxsize=64)
def _pack_order(plan: Plan, es: int, device: torch.device):
    """Where each element of the packed w1 and w2 comes from: indices into
    the flattened [plane][tap][C1_p][Cin_p] and [plane][tap][C2_p][C1_p]
    arrays (Cin == 1: [tap][C1_p]), in the order in which the kernel's
    producer copies them into its weight stages:

    * w1: [conv1 block of ch1][cluster rank][Cin chunk][tap][plane][image
      of Cin chunk x rank's ch1 / cl channels];
    * w2: [C2 pass of cl * n2][C1 chunk of ch][rank][tap][plane][image of
      ch x n2].
    Computed once per plan, element size and device."""
    planes = 2 if es == 4 else 1
    cl, ch, n1 = plan.cl, plan.ch, plan.ch1 // plan.cl
    n_j, n_b = plan.c1p // ch, plan.c1p // plan.ch1
    if plan.cinp == 1:
        o1 = torch.arange(9 * plan.c1p)
    else:
        src = torch.arange(planes * 9 * plan.c1p * plan.cinp).reshape(
            planes, 9, n_b, cl, n1, plan.cinp)
        # (plane, block, rank, tap, n, cin) per Cin chunk
        src = src.permute(0, 2, 3, 1, 4, 5)
        o1 = torch.cat([
            stage_images(src[..., i:i + plan.cinc], es).reshape(n_b, cl, -1)
            for i in range(0, plan.cinp, plan.cinc)], dim=2).reshape(-1)
    ny = plan.c2p // (cl * plan.n2)
    src = torch.arange(planes * 9 * plan.c2p * plan.c1p).reshape(
        planes, 9, ny, cl, plan.n2, n_j, ch)
    # (plane, pass, j, rank, tap, n, k)
    o2 = stage_images(src.permute(0, 2, 5, 3, 1, 4, 6), es).reshape(-1)
    return o1.to(device), o2.to(device)


def pack_double_conv_weights(w1: torch.Tensor, b1: torch.Tensor,
                             w2: torch.Tensor, b2: torch.Tensor,
                             plan: Plan | None = None) -> PackedCell:
    """Weights OIHW (C1, Cin, 3, 3), (C2, C1, 3, 3) and biases in the order
    and byte image in which the kernel's producer copies them into its
    weight stages (`_pack_order`), channel counts zero-padded as the plan
    says, in the weights' dtype (`kernel_plan` of their device when `plan`
    is None); planes: float32 TF32 hi then lo (`tf32_split`), bfloat16 the
    weights; Cin == 1: w1 as [tap][C1_p], read on the CUDA cores.  A stage
    (`tg` taps of one chunk) is one contiguous block.  Biases are kept as
    they are (contiguous)."""
    w1, w2 = w1.detach(), w2.detach()
    c1, cin = w1.shape[:2]
    c2 = w2.shape[0]
    if plan is None:
        plan = kernel_plan(cin, c1, c2, w1.dtype, w1.device)
    es = w1.element_size()
    o1, o2 = _pack_order(plan, es, w1.device)
    taps1 = w1.new_zeros((9, plan.c1p, plan.cinp))
    taps1[:, :c1, :cin] = w1.permute(2, 3, 0, 1).reshape(9, c1, cin)
    taps2 = w2.new_zeros((9, plan.c2p, plan.c1p))
    taps2[:, :c2, :c1] = w2.permute(2, 3, 0, 1).reshape(9, c2, c1)

    def planes(t):
        return torch.stack(tf32_split(t)) if es == 4 else t

    return PackedCell(
        (taps1 if plan.cinp == 1 else planes(taps1)).reshape(-1)[o1],
        b1.detach().contiguous(), planes(taps2).reshape(-1)[o2],
        b2.detach().contiguous())


def packed_sizes(plan: Plan, es: int):
    """Elements of the packed w1 and w2 under `plan` (float32: two
    planes)."""
    planes = 2 if es == 4 else 1
    return 9 * plan.cinp * planes * plan.c1p if plan.cinp > 1 else \
        9 * plan.c1p, 9 * planes * plan.c2p * plan.c1p


def double_conv3x3_plain(x, w1, b1, w2, b2):
    """The plain PyTorch version: two valid F.conv2d + bias + relu."""
    mid = F.relu(F.conv2d(x, w1, b1))
    return F.relu(F.conv2d(mid, w2, b2))


def double_conv3x3_backward(x, w1, b1, w2, b2, y, gy, need_dx: bool = True):
    """Gradients of `double_conv3x3_plain` at (x, w1, b1, w2, b2) for the
    output gradient gy, given the forward's output y: (dx, dw1, db1, dw2,
    db2), dx None unless `need_dx`.

    The intermediate `relu(conv(x, w1) + b1)` is recomputed (the fused
    forward never writes it).  The second relu's mask comes from the saved
    y, not from a recomputed output: the kernel's sums differ from the
    library's in the last bits, and an entry near zero could otherwise
    fall on the other side of the relu than it did in the forward."""
    mid = F.relu(F.conv2d(x, w1, b1))
    gz2 = gy * (y > 0)
    dw2 = torch.nn.grad.conv2d_weight(mid, w2.shape, gz2)
    db2 = gz2.sum(dim=(0, 2, 3))
    gz1 = torch.nn.grad.conv2d_input(mid.shape, w2, gz2) * (mid > 0)
    dw1 = torch.nn.grad.conv2d_weight(x, w1.shape, gz1)
    db1 = gz1.sum(dim=(0, 2, 3))
    dx = torch.nn.grad.conv2d_input(x.shape, w1, gz1) if need_dx else None
    return dx, dw1, db1, dw2, db2


def fused_double_conv3x3(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor,
                         packed: PackedCell | None = None
                         ) -> torch.Tensor:
    """(B, Cin, H, W) -> (B, C2, H-4, W-4); weights OIHW (C1, Cin, 3, 3) and
    (C2, C1, 3, 3), biases (C1,), (C2,).

    The plain version on a CPU tensor; the CUDA kernel on a CUDA tensor
    (counted in `fused_double_conv3x3.launches`), differentiable through
    `double_conv3x3_backward` (`fused_double_conv3x3.backward_calls`).
    `packed` is `pack_double_conv_weights` of the same four tensors; without
    it the weights are packed in this call; under autocast it must be packed
    in the autocast dtype.  Under autocast the function computes in the
    autocast dtype (see the module docstring)."""
    dtype = autocast_dtype(x.device.type)
    if dtype is not None:
        x, w1, b1, w2, b2 = (t.to(dtype) for t in (x, w1, b1, w2, b2))
    if x.device.type == "cpu":
        return double_conv3x3_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_double_conv3x3: unsupported device {x.device}")
    if x.dtype not in _SOURCES:
        raise ValueError(f"fused_double_conv3x3: unsupported dtype {x.dtype}")
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"fused_double_conv3x3: {name} is {t.dtype} on "
                             f"{t.device}, x is {x.dtype} on {x.device}")
    if packed is not None and packed.w1.dtype != x.dtype:
        raise ValueError(f"fused_double_conv3x3: weights packed in "
                         f"{packed.w1.dtype}, x is {x.dtype}")
    b, cin, h, w = x.shape
    c1, c2 = w1.shape[0], w2.shape[0]
    if (tuple(w1.shape) != (c1, cin, 3, 3) or tuple(w2.shape) != (c2, c1, 3, 3)
            or tuple(b1.shape) != (c1,) or tuple(b2.shape) != (c2,)):
        raise ValueError("fused_double_conv3x3: weight shapes "
                         f"{tuple(w1.shape)}, {tuple(w2.shape)} do not fit "
                         f"input {tuple(x.shape)}")
    if h < 5 or w < 5 or not 1 <= b <= 65535:
        raise ValueError(f"fused_double_conv3x3: unsupported input shape "
                         f"{tuple(x.shape)}")
    return _DoubleConv3x3.apply(x, w1, b1, w2, b2, packed)


def _launch(x, w1, b1, w2, b2, packed):
    x = x.contiguous()
    b, cin, h, w = x.shape
    c1, c2 = w1.shape[0], w2.shape[0]
    if packed is None:
        packed = pack_double_conv_weights(w1, b1, w2, b2)
    plan = kernel_plan(cin, c1, c2, x.dtype, x.device)
    check_packed("fused_double_conv3x3", packed,
                 packed_sizes(plan, x.element_size()), plan)
    y = torch.empty((b, c2, h - 4, w - 4), dtype=x.dtype, device=x.device)
    call(load_library(_SOURCES[x.dtype]), "uncltmo_double_conv3x3", x,
         *packed, y, b, cin, h, w, c1, c2, on=x)
    fused_double_conv3x3.launches += 1
    return y


class _DoubleConv3x3(torch.autograd.Function):
    """K2 on CUDA tensors: the forward is the kernel; the backward is
    `double_conv3x3_backward` (library calls, see the module docstring)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, packed):
        y = _launch(x, w1, b1, w2, b2, packed)
        ctx.save_for_backward(x, w1, b1, w2, b2, y)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy):
        x, w1, b1, w2, b2, y = ctx.saved_tensors
        grads = double_conv3x3_backward(x, w1, b1, w2, b2, y, gy,
                                        need_dx=ctx.needs_input_grad[0])
        fused_double_conv3x3.backward_calls += 1
        return (*grads, None)


fused_double_conv3x3.launches = 0
fused_double_conv3x3.backward_calls = 0
