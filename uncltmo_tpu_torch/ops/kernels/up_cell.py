"""The decoder's up cell, fused: K1's skip concat and the two 3x3
ConvTranspose2d + relu of a `DoubleConvT` in one float32 kernel.

`models/blocks.py:Up` with `square_and_square_root`, doubleConvTranspose,
relu and no norm computes, after its 2x2 upsample and `_pad_or_crop`,

    y = relu(convT(relu(convT([x2, x1, x2^2, sqrt(x2 + eps)], W1) + b1),
                   W2) + b2)

The TPU package runs it as K1 (`fused_concat_skip`) and two XLA ConvTs;
this port ran K1 and two cuDNN ConvTs (FFT convolutions in float32, TF32
off).  On the card the cell is one launch of `up_cell_kernel`
(`csrc/up_cell.cu`, its header says how it is built): phase 1
makes the concat's blocks as it stages its input (x2 and x1 are read, the
4C-channel concat is never written) and writes the intermediate `mid`
(B, C1, H+2, W+2, after relu); phase 2 reads it back and writes y (B, C2,
H+4, W+4).  Products are split-TF32, as K2's float32 kernel makes them.

Float32 only (`kernel_takes`): a bfloat16 generator keeps the torch layers
for its decoder cells, and so does every other operator, norm or
activation (`Up.fused_cell`).

Dispatch is by the tensor's device: CPU tensors take `up_cell_plain`, the
cell exactly as `Up` computes it there (K1's plain version, then
`F.conv_transpose2d` + relu twice); CUDA tensors go through `_UpCell`,
whose forward launches the kernel (a failed build or launch raises) and
whose backward takes the library's ConvT gradients with the relu masks of
the saved `mid` and `y`, rebuilding the concat with K1's kernel and
returning dx2 and dx1 through K1's backward kernel.

The kernel reads the weights packed (`pack_up_cell_weights`): each ConvT
weight (Cin, Cout, 3, 3) as the valid convolution it is (flipped in both
spatial axes, in/out swapped), split into TF32 hi and lo planes, in the
byte image of the kernel's weight stages and the order it consumes them,
under the plan of the configuration that serves the cell
(`up_cell_plan`).  `models/blocks.py:DoubleConvT` packs once and keeps the
result, keyed on `packing.weights_key`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from uncltmo_tpu_torch import params
from uncltmo_tpu_torch.ops.kernels.build import call, load_library
from uncltmo_tpu_torch.ops.kernels.concat_skip import (
    concat_skip_plain, fused_concat_skip, fused_concat_skip_backward)
from uncltmo_tpu_torch.ops.kernels.packing import (
    PackedCell, check_packed, round_up, stage_images, tf32_split)
from uncltmo_tpu_torch.ops.precision import autocast_dtype

_SOURCE = "up_cell.cu"


# input channels a weight stage (one tap) and a staged chunk (`UK`)
K = 32


class PhasePlan(NamedTuple):
    """What the packing and the kernel agree on for one phase (one 3x3
    convolution) of the cell."""
    cinp: int      # input channels (phase 2: padded to whole chunks)
    n: int         # output channels a pass (the wgmma N)
    coutp: int     # output channels, padded to whole passes
    th: int        # output tile height
    tw: int        # output tile width
    mw: int        # 64-row tiles a warpgroup


class UpPlan(NamedTuple):
    nwg: int       # consumer warpgroups
    a: PhasePlan   # phase 1: the concat -> mid
    b: PhasePlan   # phase 2: mid -> y


# The defaults of `csrc/up_cell.cu` (`UNCLTMO_UP_CFG*`): NST, then
# per phase TH, TW, MW, N, J, then SQ; three consumer warpgroups.  On a
# CUDA tensor the plan comes from the built library itself; this table
# serves the packing of CPU tensors.
NWG = 3
_CFGS = {"128": (3, 6, 26, 1, 64, 4, 6, 28, 1, 64, 4, 1),
         "64": (4, 3, 59, 1, 64, 4, 3, 61, 1, 64, 4, 1),
         "32A": (4, 6, 62, 2, 32, 2, 3, 126, 2, 32, 2, 0),
         "32B": (4, 4, 85, 2, 32, 2, 4, 86, 2, 32, 2, 0)}


def _cfg_name(cin: int, c1: int) -> str:
    """The instantiation that serves (Cin, C1), as `with_up_cfg` picks it."""
    if c1 > 64:
        return "128"
    if c1 > 32:
        return "64"
    return "32A" if cin > 128 else "32B"


def channels_ok(c: int) -> bool:
    """Skip channels the kernel takes: each block of the concat whole in
    its K-channel chunks and weight stages (`up_channels_ok`)."""
    return c % K == 0


def kernel_takes(x2: torch.Tensor, x1: torch.Tensor,
                 *weights: torch.Tensor) -> bool:
    """Whether the kernel takes a call: x2, x1 and the weights float32 on
    x2's CUDA card, outside autocast (else the cell keeps torch's layers)."""
    return (x2.is_cuda and autocast_dtype("cuda") is None
            and all(t.dtype == torch.float32 and t.device == x2.device
                    for t in (x2, x1, *weights)))


def _phase(cin: int, cout: int, cat: bool, th, tw, mw, n, _j) -> PhasePlan:
    """`up_phase_plan`: phase 1 reads the concat's Cin channels, phase 2
    C1 padded to whole chunks."""
    return PhasePlan(cin if cat else round_up(cin, K), n,
                     round_up(cout, n), th, tw, mw)


def default_up_plan(cin: int, c1: int, c2: int) -> UpPlan:
    """The plan of the source's default configurations (see `_CFGS`)."""
    cfg = _CFGS[_cfg_name(cin, c1)]
    return UpPlan(NWG, _phase(cin, c1, True, *cfg[1:6]),
                  _phase(c1, c2, False, *cfg[6:11]))


def library_plans(lib: ctypes.CDLL, cin: int, c1: int, c2: int) -> UpPlan:
    """The plan of the configuration of `lib` (a built library of
    `csrc/up_cell.cu`) that serves the cell."""
    out = (ctypes.c_int * 13)()
    call(lib, "uncltmo_up_cell_plan", cin, c1, c2, out)
    return UpPlan(out[0], PhasePlan(*out[1:7]), PhasePlan(*out[7:13]))


def up_cell_plan(cin: int, c1: int, c2: int, device) -> UpPlan:
    """The plan of the configuration that serves the call: the built
    library's own on a CUDA device, `default_up_plan` elsewhere."""
    if torch.device(device).type != "cuda":
        return default_up_plan(cin, c1, c2)
    return library_plans(load_library(_SOURCE), cin, c1, c2)


def convt_as_conv(w: torch.Tensor) -> torch.Tensor:
    """A ConvTranspose2d(k=3, stride 1) weight (Cin, Cout, 3, 3) as the
    OIHW weight of the valid convolution over the input zero-padded by 2
    that it is: flipped in both spatial axes, in/out swapped."""
    return w.flip(2, 3).transpose(0, 1)


def stage_channels(ph: PhasePlan, cat: bool):
    """The first input channel of each run of K channels in the order the
    kernel consumes them.  Phase 1 (`cat`) stages chunks of K channels of
    x2, each serving the concat's blocks 0 (x2), 2 (x2^2) and 3 (the
    root), then chunks of x1 (block 1); phase 2 runs in channel order."""
    if not cat:
        return list(range(0, ph.cinp, K))
    cs = ph.cinp // 4
    return ([blk * cs + c0 for c0 in range(0, cs, K) for blk in (0, 2, 3)]
            + [cs + c0 for c0 in range(0, cs, K)])


@functools.lru_cache(maxsize=64)
def _pack_order(ph: PhasePlan, cat: bool, device: torch.device
                ) -> torch.Tensor:
    """Where each element of a packed phase comes from: indices into the
    flattened [plane][tap][Cout_p][Cin_p] array, in the order in which the
    kernel's producer copies them into its weight stages: [pass of N
    output channels][run of K input channels (`stage_channels`)][tap]
    [plane][image of the run x N, `b_image_index`].  Computed once per
    plan and device."""
    passes = ph.coutp // ph.n
    src = torch.arange(2 * 9 * ph.coutp * ph.cinp).reshape(
        2, 9, passes, ph.n, ph.cinp)
    # (plane, pass, tap, n, cin) per run
    src = src.permute(0, 2, 1, 3, 4)
    return torch.cat([
        stage_images(src[..., c:c + K], 4).reshape(passes, -1)
        for c in stage_channels(ph, cat)], dim=1).reshape(-1).to(device)


def pack_phase(w: torch.Tensor, ph: PhasePlan, cat: bool) -> torch.Tensor:
    """A ConvTranspose2d weight (Cin, Cout, 3, 3) packed for one phase
    (`cat`: the first, whose input is the concat)."""
    wc = convt_as_conv(w.detach())
    cout, cin = wc.shape[:2]
    taps = wc.new_zeros((9, ph.coutp, ph.cinp))
    taps[:, :cout, :cin] = wc.permute(2, 3, 0, 1).reshape(9, cout, cin)
    return torch.stack(tf32_split(taps)).reshape(-1)[
        _pack_order(ph, cat, w.device)]


def pack_up_cell_weights(w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor,
                         plan: UpPlan | None = None) -> PackedCell:
    """Both ConvTs' weights (Cin, C1, 3, 3) and (C1, C2, 3, 3) packed under
    `plan` (`up_cell_plan` of their device when None); biases as they are
    (contiguous)."""
    if plan is None:
        plan = up_cell_plan(w1.shape[0], w1.shape[1], w2.shape[1], w1.device)
    return PackedCell(pack_phase(w1, plan.a, True), b1.detach().contiguous(),
                      pack_phase(w2, plan.b, False), b2.detach().contiguous())


def packed_sizes(plan: UpPlan):
    """Elements of the packed w1 and w2 under `plan` (two planes each)."""
    return tuple(2 * 9 * p.cinp * p.coutp for p in (plan.a, plan.b))


def up_cell_plain(x2, x1, w1, b1, w2, b2):
    """The plain PyTorch version: K1's plain concat, then
    `F.conv_transpose2d` + relu twice, as `Up` computes the cell on the
    CPU."""
    mid = F.relu(F.conv_transpose2d(concat_skip_plain(x2, x1), w1, b1))
    return F.relu(F.conv_transpose2d(mid, w2, b2))


def _convt_backward(gz, x, w, need_x: bool):
    """(dx, dw, db) of `F.conv_transpose2d(x, w, b)` (k=3, stride 1) for
    the output gradient gz: the library's gradients, as autograd takes
    them."""
    return torch.ops.aten.convolution_backward(
        gz, x, w, [w.shape[1]], [1, 1], [0, 0], [1, 1], True, [0, 0], 1,
        [need_x, True, True])


def up_cell_backward(x2, x1, w1, w2, mid, y, gy, need_dx: bool = True):
    """Gradients of `up_cell_plain` at (x2, x1, w1, b1, w2, b2) for the
    output gradient gy, given the forward's intermediate `mid` and output y:
    (dx2, dx1, dw1, db1, dw2, db2), dx2 and dx1 None unless `need_dx`.

    The relu masks come from the saved `mid` and `y`, not from a
    recomputation: the kernel's sums differ from the library's in the
    last bits, and an entry near zero could otherwise fall on the other
    side of the relu than it did in the forward.  The concat is rebuilt
    (K1's kernel on CUDA tensors) for the first ConvT's weight gradient."""
    gz2 = gy * (y > 0)
    dmid, dw2, db2 = _convt_backward(gz2, mid, w2, True)
    gz1 = dmid * (mid > 0)
    with torch.no_grad():
        cat = fused_concat_skip(x2, x1)
    dcat, dw1, db1 = _convt_backward(gz1, cat, w1, need_dx)
    dx2 = dx1 = None
    if need_dx:
        dx2, dx1 = fused_concat_skip_backward(x2, dcat)
    return dx2, dx1, dw1, db1, dw2, db2


def launch_with(lib: ctypes.CDLL, x2, x1, packed: PackedCell, y, mid,
                c1: int, c2: int) -> torch.Tensor:
    """One launch of `lib`'s up cell on contiguous float32 CUDA tensors
    into y (B, C2, H+4, W+4); `mid` (B, C1, H+2, W+2) or None for a
    temporary.  Returns mid."""
    b, cs, h, w = x2.shape
    if mid is None:
        mid = torch.empty((b, c1, h + 2, w + 2), device=x2.device)
    ctr = torch.zeros(1, dtype=torch.int32, device=x2.device)
    call(lib, "uncltmo_up_cell", x2, x1, *packed, mid, y, ctr, b, cs, h, w,
         c1, c2, params.EPSILON, on=x2)
    return mid


def _launch(x2, x1, w1, b1, w2, b2, packed):
    lib = load_library(_SOURCE)
    x2, x1 = x2.contiguous(), x1.contiguous()
    b, cs, h, w = x2.shape
    c1, c2 = w1.shape[1], w2.shape[1]
    if packed is None:
        packed = pack_up_cell_weights(w1, b1, w2, b2)
    plan = library_plans(lib, 4 * cs, c1, c2)
    check_packed("fused_up_cell", packed, packed_sizes(plan), plan)
    y = torch.empty((b, c2, h + 4, w + 4), device=x2.device)
    mid = launch_with(lib, x2, x1, packed, y, None, c1, c2)
    fused_up_cell.launches += 1
    return y, mid


class _UpCell(torch.autograd.Function):
    """The up cell on CUDA tensors: the forward is the kernel; the backward
    is `up_cell_backward` (library calls and K1's kernels)."""

    @staticmethod
    def forward(ctx, x2, x1, w1, b1, w2, b2, packed):
        y, mid = _launch(x2, x1, w1, b1, w2, b2, packed)
        ctx.save_for_backward(x2, x1, w1, w2, mid, y)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy):
        x2, x1, w1, w2, mid, y = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        dx2, dx1, dw1, db1, dw2, db2 = up_cell_backward(
            x2, x1, w1, w2, mid, y, gy.contiguous(), need_dx)
        fused_up_cell.backward_calls += 1
        return dx2, dx1, dw1, db1, dw2, db2, None


def fused_up_cell(x2: torch.Tensor, x1: torch.Tensor, w1: torch.Tensor,
                  b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                  packed: PackedCell | None = None) -> torch.Tensor:
    """x2, x1 (B, C, H, W) -> (B, C2, H+4, W+4); ConvTranspose2d weights
    (4C, C1, 3, 3) and (C1, C2, 3, 3), biases (C1,), (C2,).

    The plain version on a CPU tensor; the CUDA kernel where it takes the
    call (`kernel_takes`, counted in `fused_up_cell.launches`),
    differentiable through `up_cell_backward`
    (`fused_up_cell.backward_calls`); any other call raises.  `packed` is
    `pack_up_cell_weights` of the same four tensors; without it the weights
    are packed in this call."""
    if x2.device.type == "cpu":
        return up_cell_plain(x2, x1, w1, b1, w2, b2)
    if not kernel_takes(x2, x1, w1, b1, w2, b2):
        raise ValueError("fused_up_cell: float32 tensors on one CUDA card, "
                         "outside autocast, only (x2, x1, w1, b1, w2, b2: " +
                         ", ".join(f"{t.dtype} on {t.device}" for t in (
                             x2, x1, w1, b1, w2, b2)) + ")")
    if x2.dim() != 4 or x1.shape != x2.shape:
        raise ValueError(f"fused_up_cell: x2 {tuple(x2.shape)} and x1 "
                         f"{tuple(x1.shape)} must be one (B, C, H, W) shape")
    b, c, h, w = x2.shape
    c1, c2 = w1.shape[1], w2.shape[1]
    if (tuple(w1.shape) != (4 * c, c1, 3, 3)
            or tuple(w2.shape) != (c1, c2, 3, 3)
            or tuple(b1.shape) != (c1,) or tuple(b2.shape) != (c2,)):
        raise ValueError("fused_up_cell: weight shapes "
                         f"{tuple(w1.shape)}, {tuple(w2.shape)} do not fit "
                         f"the skip {tuple(x2.shape)}")
    if b < 1 or h < 1 or w < 1 or not channels_ok(c):
        raise ValueError(f"fused_up_cell: unsupported input shape "
                         f"{tuple(x2.shape)} (skip channels: a multiple "
                         "of 32)")
    return _UpCell.apply(x2, x1, w1, b1, w2, b2, packed)


fused_up_cell.launches = 0
fused_up_cell.backward_calls = 0
