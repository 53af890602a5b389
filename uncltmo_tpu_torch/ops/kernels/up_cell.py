"""The decoder's up cell, fused: K1's skip concat and the two 3x3
ConvTranspose2d + relu of a `DoubleConvT` in one float32 kernel, and
where `Up` upsamples by its 2x2 stride-2 ConvTranspose2d, that upsample
with its bias and pad or crop too.

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
With `upsample` (`Upsample`), x1 is the upsample's input x (B, C, h, w):
the launch (`uncltmo_up_cell_folded`) runs a phase 0 first, the 2x2
ConvT as one GEMM a position of x (N = 4C columns, one per output channel
and parity), whose epilogue adds the bias and writes the upsampled plane
padded or cropped to the skip's (`pad_or_crop`: edge or zero pads, as
`models/blocks.py:_pad_or_crop`) into a buffer that phase 1 stages and
the backward keeps; `fused_up_cell.upsample_folded` counts such launches.

Float32 only (`kernel_takes`): a bfloat16 generator keeps the torch layers
for its decoder cells, and so does every other operator, norm or
activation (`Up.fused_cell`).

Dispatch is by the tensor's device: CPU tensors take `up_cell_plain`, the
cell exactly as `Up` computes it there (K1's plain version, then
`F.conv_transpose2d` + relu twice); CUDA tensors go through `_UpCell`,
whose forward launches the kernel (a failed build or launch raises) and
whose backward takes the library's ConvT gradients with the relu masks of
the saved `mid` and `y`, rebuilding the concat with K1's kernel and
returning dx2 and dx1 through K1's backward kernel; with `upsample`,
`_UpCellFolded` adds the pad or crop's backward and the 2x2 ConvT's
library gradients from the saved x (`up_fold_backward`).

The kernel reads the weights packed (`pack_up_cell_weights`): each ConvT
weight (Cin, Cout, 3, 3) as the valid convolution it is (flipped in both
spatial axes, in/out swapped), split into TF32 hi and lo planes, in the
byte image of the kernel's weight stages and the order it consumes them,
under the plan of the configuration that serves the cell
(`up_cell_plan`).  `models/blocks.py:DoubleConvT` packs once and keeps the
result, keyed on `packing.weights_key`; the 2x2 ConvT's weight packs as
phase 0 reads it (`pack_upsample_weights`), and `Up` keeps that.
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
def _pack_order(ph: PhasePlan, cat: bool, device: torch.device,
                taps: int = 9) -> torch.Tensor:
    """Where each element of a packed phase comes from: indices into the
    flattened [plane][tap][Cout_p][Cin_p] array, in the order in which the
    kernel's producer copies them into its weight stages: [pass of N
    output channels][run of K input channels (`stage_channels`)][tap]
    [plane][image of the run x N, `b_image_index`].  Computed once per
    plan and device."""
    passes = ph.coutp // ph.n
    src = torch.arange(2 * taps * ph.coutp * ph.cinp).reshape(
        2, taps, passes, ph.n, ph.cinp)
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


def fold_plan(plan: UpPlan, c: int) -> PhasePlan:
    """Phase 0 of a cell of C skip channels under `plan`: C input channels,
    4C columns (n = 4 co + 2 a + b) in passes of phase 1's N, tiles of its
    64-row wgmma tiles as flat positions of x (one row of M)."""
    m = 64 * plan.nwg * plan.a.mw
    return PhasePlan(c, plan.a.n, 4 * c, 1, m, plan.a.mw)


def pack_upsample_weights(w_up: torch.Tensor, c1: int, c2: int,
                          plan: UpPlan | None = None) -> torch.Tensor:
    """The 2x2 stride-2 ConvTranspose2d weight (C, C, 2, 2) of an up cell
    with C1 and C2 output channels, packed for phase 0 under `plan`
    (`up_cell_plan` of its device when None): the GEMM operand
    B[ci][4 co + 2 a + b] = w_up[ci, co, a, b] as one tap, in TF32 hi and
    lo planes, in the producer's stage order."""
    c = w_up.shape[0]
    if plan is None:
        plan = up_cell_plan(4 * c, c1, c2, w_up.device)
    ph = fold_plan(plan, c)
    taps = w_up.detach().permute(1, 2, 3, 0).reshape(1, 4 * c, c)
    return torch.stack(tf32_split(taps)).reshape(-1)[
        _pack_order(ph, False, w_up.device, taps=1)]


class Upsample(NamedTuple):
    """What `fused_up_cell` folds into its launch: the 2x2 stride-2
    ConvTranspose2d (weight (C, C, 2, 2), bias (C,)), the padding mode of
    the pad to the skip (`FOLD_MODES`) and, optionally, the weight packed
    (`pack_upsample_weights`)."""
    weight: torch.Tensor
    bias: torch.Tensor
    padding_mode: str
    packed: torch.Tensor | None = None


# padding modes (as `models/blocks.py:pad_mode` names them) that phase 0's
# epilogue writes: the edge repeated, or zeros
FOLD_MODES = ("edge", "constant")


def pad_or_crop(u: torch.Tensor, size, padding_mode: str) -> torch.Tensor:
    """u (B, C, hu, wu) padded or cropped to `size` = (H, W) as
    `models/blocks.py:_pad_or_crop` does in the `FOLD_MODES`: u's first
    entry of an axis lands at lo = (size - n) // 2 (negative: cropped), and
    entry Y is u's Y - lo, clamped to u (edge) or zero outside it."""
    for axis, n_out in ((2, size[0]), (3, size[1])):
        n = u.shape[axis]
        if n == n_out:
            continue
        i = torch.arange(n_out, device=u.device) - (n_out - n) // 2
        u = u.index_select(axis, i.clamp(0, n - 1))
        if padding_mode != "edge" and n_out > n:
            shape = [1, 1, 1, 1]
            shape[axis] = n_out
            u = torch.where(((i >= 0) & (i < n)).reshape(shape), u, 0.0)
    return u


def pad_or_crop_backward(g: torch.Tensor, n_up, padding_mode: str
                         ) -> torch.Tensor:
    """The gradient of `pad_or_crop` at u of plane n_up = (hu, wu) for the
    output gradient g: a crop's rows and columns zero, a pad's summed into
    the edge (edge) or dropped (zeros)."""
    for axis, n in ((2, n_up[0]), (3, n_up[1])):
        size = g.shape[axis]
        if n == size:
            continue
        lo = (size - n) // 2
        if size < n:                     # a crop (both sides <= 0)
            shape = list(g.shape)
            shape[axis] = n
            out = g.new_zeros(shape)
            out.narrow(axis, -lo, size).copy_(g)
            g = out
            continue
        body = g.narrow(axis, lo, n).clone()
        if padding_mode == "edge":
            hi = size - lo - n
            body.narrow(axis, 0, 1).add_(
                g.narrow(axis, 0, lo).sum(axis, keepdim=True))
            if hi:
                body.narrow(axis, n - 1, 1).add_(
                    g.narrow(axis, lo + n, hi).sum(axis, keepdim=True))
        g = body
    return g


def upsample_plain(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
                   size, padding_mode: str) -> torch.Tensor:
    """`Up`'s torch path to x1: the 2x2 stride-2 ConvT, then
    `pad_or_crop` to the skip's plane `size`."""
    return pad_or_crop(F.conv_transpose2d(x, w_up, b_up, stride=2), size,
                       padding_mode)


def up_cell_plain(x2, x1, w1, b1, w2, b2):
    """The plain PyTorch version: K1's plain concat, then
    `F.conv_transpose2d` + relu twice, as `Up` computes the cell on the
    CPU."""
    mid = F.relu(F.conv_transpose2d(concat_skip_plain(x2, x1), w1, b1))
    return F.relu(F.conv_transpose2d(mid, w2, b2))


def up_fold_plain(x2, x, w_up, b_up, w1, b1, w2, b2, padding_mode: str):
    """The plain version of the three-phase cell: `upsample_plain` to x2's
    plane, then `up_cell_plain`."""
    x1 = upsample_plain(x, w_up, b_up, x2.shape[2:], padding_mode)
    return up_cell_plain(x2, x1, w1, b1, w2, b2)


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


def up_fold_backward(x2, x, w_up, x1, w1, w2, mid, y, gy, padding_mode: str,
                     need_dx2: bool = True, need_dx: bool = True):
    """Gradients of `up_fold_plain` at (x2, x, w_up, b_up, w1, b1, w2, b2)
    for gy, given the forward's x1, mid and y: `up_cell_backward`'s, then
    dx1 through the pad or crop's backward (`pad_or_crop_backward`) and the
    2x2 ConvT's library gradients from the saved x (the upsample is not
    recomputed).  dx2 None unless `need_dx2`, dx None unless `need_dx`."""
    dx2, dx1, dw1, db1, dw2, db2 = up_cell_backward(x2, x1, w1, w2, mid, y,
                                                     gy)
    du = pad_or_crop_backward(dx1, (2 * x.shape[2], 2 * x.shape[3]),
                              padding_mode)
    dx, dw_up, db_up = torch.ops.aten.convolution_backward(
        du, x, w_up, [w_up.shape[1]], [2, 2], [0, 0], [1, 1], True, [0, 0],
        1, [need_dx, True, True])
    return (dx2 if need_dx2 else None, dx, dw_up, db_up, dw1, db1, dw2, db2)


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


def _launch(x2, x1, w1, b1, w2, b2, packed, upsample=None):
    """The kernel on CUDA tensors: (y, mid, x1), x1 phase 0's output where
    `upsample` folds it in (x1 is then the upsample's input), else the
    input as given."""
    lib = load_library(_SOURCE)
    x2, x1 = x2.contiguous(), x1.contiguous()
    b, cs, h, w = x2.shape
    c1, c2 = w1.shape[1], w2.shape[1]
    if packed is None:
        packed = pack_up_cell_weights(w1, b1, w2, b2)
    plan = library_plans(lib, 4 * cs, c1, c2)
    check_packed("fused_up_cell", packed, packed_sizes(plan), plan)
    y = torch.empty((b, c2, h + 4, w + 4), device=x2.device)
    if upsample is None:
        mid = launch_with(lib, x2, x1, packed, y, None, c1, c2)
        fused_up_cell.launches += 1
        return y, mid, x1
    w0p = upsample.packed
    if w0p is None:
        w0p = pack_upsample_weights(upsample.weight, c1, c2, plan)
    if w0p.numel() != 2 * 4 * cs * cs:
        raise ValueError("fused_up_cell: the upsample's `packed` was not "
                         f"packed under the kernel's plan {plan}")
    x = x1
    x1 = torch.empty_like(x2)
    mid = torch.empty((b, c1, h + 2, w + 2), device=x2.device)
    ctr = torch.zeros(1, dtype=torch.int32, device=x2.device)
    call(lib, "uncltmo_up_cell_folded", x, w0p,
         upsample.bias.detach().contiguous(), x1, x2, *packed, mid, y, ctr,
         b, cs, x.shape[2], x.shape[3], h, w, c1, c2,
         int(upsample.padding_mode == "edge"), params.EPSILON, on=x2)
    fused_up_cell.launches += 1
    fused_up_cell.upsample_folded += 1
    return y, mid, x1


class _UpCell(torch.autograd.Function):
    """The up cell on CUDA tensors: the forward is the kernel; the backward
    is `up_cell_backward` (library calls and K1's kernels)."""

    @staticmethod
    def forward(ctx, x2, x1, w1, b1, w2, b2, packed):
        y, mid, x1 = _launch(x2, x1, w1, b1, w2, b2, packed)
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


class _UpCellFolded(torch.autograd.Function):
    """The three-phase cell on CUDA tensors: the forward is the kernel with
    phase 0; the backward is `up_fold_backward` from the saved x, x1, mid
    and y."""

    @staticmethod
    def forward(ctx, x2, x, w_up, b_up, w1, b1, w2, b2, packed, packed_up,
                padding_mode):
        y, mid, x1 = _launch(x2, x, w1, b1, w2, b2, packed,
                             Upsample(w_up, b_up, padding_mode, packed_up))
        ctx.save_for_backward(x2, x, w_up, x1, w1, w2, mid, y)
        ctx.padding_mode = padding_mode
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy):
        x2, x, w_up, x1, w1, w2, mid, y = ctx.saved_tensors
        grads = up_fold_backward(x2, x, w_up, x1, w1, w2, mid, y,
                                 gy.contiguous(), ctx.padding_mode,
                                 ctx.needs_input_grad[0],
                                 ctx.needs_input_grad[1])
        fused_up_cell.backward_calls += 1
        return grads + (None, None, None)


def fused_up_cell(x2: torch.Tensor, x1: torch.Tensor, w1: torch.Tensor,
                  b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                  packed: PackedCell | None = None,
                  upsample: Upsample | None = None) -> torch.Tensor:
    """x2, x1 (B, C, H, W) -> (B, C2, H+4, W+4); ConvTranspose2d weights
    (4C, C1, 3, 3) and (C1, C2, 3, 3), biases (C1,), (C2,).  With
    `upsample`, x1 is the 2x2 ConvT's input (B, C, h, w) and the cell reads
    `upsample_plain` of it (phase 0 of the launch,
    `fused_up_cell.upsample_folded`).

    The plain version on a CPU tensor; the CUDA kernel where it takes the
    call (`kernel_takes`, counted in `fused_up_cell.launches`),
    differentiable through `up_cell_backward` or `up_fold_backward`
    (`fused_up_cell.backward_calls`); any other call raises.  `packed` is
    `pack_up_cell_weights` of the same four tensors; without it the weights
    are packed in this call, and so are the upsample's without
    `upsample.packed`."""
    up_args = () if upsample is None else (upsample.weight, upsample.bias)
    if x2.device.type == "cpu":
        if upsample is None:
            return up_cell_plain(x2, x1, w1, b1, w2, b2)
        return up_fold_plain(x2, x1, *up_args, w1, b1, w2, b2,
                             upsample.padding_mode)
    if not kernel_takes(x2, x1, w1, b1, w2, b2, *up_args):
        raise ValueError("fused_up_cell: float32 tensors on one CUDA card, "
                         "outside autocast, only (x2, x1, w1, b1, w2, b2"
                         f"{', w_up, b_up' if up_args else ''}: " +
                         ", ".join(f"{t.dtype} on {t.device}" for t in (
                             x2, x1, w1, b1, w2, b2, *up_args)) + ")")
    if x2.dim() != 4 or x1.dim() != 4 or (upsample is None
                                          and x1.shape != x2.shape):
        raise ValueError(f"fused_up_cell: x2 {tuple(x2.shape)} and x1 "
                         f"{tuple(x1.shape)} must be one (B, C, H, W) shape")
    b, c, h, w = x2.shape
    if upsample is not None and (
            x1.shape[:2] != (b, c) or min(x1.shape[2:]) < 1
            or tuple(upsample.weight.shape) != (c, c, 2, 2)
            or tuple(upsample.bias.shape) != (c,)
            or upsample.padding_mode not in FOLD_MODES):
        raise ValueError(f"fused_up_cell: the upsample of x {tuple(x1.shape)}"
                         f" (weight {tuple(upsample.weight.shape)}, "
                         f"{upsample.padding_mode!r} pad) does not fit the "
                         f"skip {tuple(x2.shape)}")
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
    if upsample is None:
        return _UpCell.apply(x2, x1, w1, b1, w2, b2, packed)
    return _UpCellFolded.apply(x2, x1, *up_args, w1, b1, w2, b2, packed,
                               upsample.packed, upsample.padding_mode)


fused_up_cell.launches = 0
fused_up_cell.upsample_folded = 0
fused_up_cell.backward_calls = 0
