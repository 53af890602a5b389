"""K2: the U-Net's (valid 3x3 conv -> bias -> relu) x 2 cell, fused.

Replaces the TPU kernel `fused_double_conv3x3` (`uncltmo_tpu/ops/
pallas_kernels.py:88-132`, oracle `double_conv3x3_reference` at `:241-250`).
The CUDA C++ kernels are in `csrc/double_conv3x3.cu` (its header says what
bounds them on Hopper and how the design answers that); this module holds
the plain PyTorch version, the weight packing and the ctypes wrapper.

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

The kernels read the weights in a packed layout (`pack_double_conv_weights`).
Packing costs two small device copies, so a caller that runs the same
weights many times packs once and passes the result as `packed`
(`models/blocks.py:DoubleConv` keeps it, keyed on `weights_key`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from uncltmo_tpu_torch.ops.kernels.build import load_library
from uncltmo_tpu_torch.ops.precision import autocast_dtype

_SOURCE = "double_conv3x3.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MMA_K = 16          # depth of one bfloat16 tensor-core product (float32: 8)


class PackedDoubleConv(NamedTuple):
    """Weights in the layout the kernel reads."""
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def padded_channels(cin: int, c1: int, c2: int):
    """(Cin, C1, C2) as the kernel pads them: Cin to the bfloat16 MMA depth,
    C1 to a multiple of 32 (the intermediate is walked in chunks of 32 or
    64 channels), C2 to the output-channel width of a block (32, 64, 128 or
    multiples of 256).  `csrc/double_conv3x3.cu` applies the same rule and refuses
    anything else."""
    c2p = next((n for n in (32, 64, 128) if c2 <= n), _round_up(c2, 256))
    return _round_up(cin, MMA_K), _round_up(c1, 32), c2p


def _pack_taps(w: torch.Tensor, kp: int, np_: int) -> torch.Tensor:
    """OIHW (N, K, 3, 3) -> [tap = 3*ky + kx][K padded to kp][N padded to
    np_], zero in the padding: row `k` of tap `t` is the B operand row of
    the implicit GEMM."""
    n, k = w.shape[:2]
    out = w.new_zeros((9, kp, np_))
    out[:, :k, :n] = w.permute(2, 3, 1, 0).reshape(9, k, n)
    return out


def pack_double_conv_weights(w1: torch.Tensor, b1: torch.Tensor,
                             w2: torch.Tensor,
                             b2: torch.Tensor) -> PackedDoubleConv:
    """Weights OIHW (C1, Cin, 3, 3), (C2, C1, 3, 3) and biases in the layout
    the kernel reads: `[tap][Cin_p][C1_p]` and `[tap][C1_p][C2_p]`, channel
    counts zero-padded as `padded_channels` says, in the weights' dtype.
    Biases are kept as they are (contiguous)."""
    c1, cin = w1.shape[:2]
    cinp, c1p, c2p = padded_channels(cin, c1, w2.shape[0])
    return PackedDoubleConv(_pack_taps(w1.detach(), cinp, c1p),
                            b1.detach().contiguous(),
                            _pack_taps(w2.detach(), c1p, c2p),
                            b2.detach().contiguous())


def weights_key(*params: torch.Tensor, dtype: torch.dtype | None = None):
    """What a cached packing depends on: a reload, a cast, a move or an
    in-place update of any parameter changes the key, and so does the dtype
    the weights are packed in (`dtype`, None for their own)."""
    return tuple((p.data_ptr(), p.dtype, p.device, p._version)
                 for p in params) + (dtype,)


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


def _library() -> ctypes.CDLL:
    lib = load_library(_SOURCE)
    fn = lib.uncltmo_double_conv3x3
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.uncltmo_cuda_error_string.argtypes = [ctypes.c_int]
        lib.uncltmo_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_double_conv3x3(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor,
                         packed: PackedDoubleConv | None = None
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
    if x.dtype not in _DTYPE_CODE:
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
    lib = _library()
    x = x.contiguous()
    b, cin, h, w = x.shape
    c1, c2 = w1.shape[0], w2.shape[0]
    if packed is None:
        packed = pack_double_conv_weights(w1, b1, w2, b2)
    y = torch.empty((b, c2, h - 4, w - 4), dtype=x.dtype, device=x.device)
    # the launch and its shared-memory attribute go to the current card:
    # make it x's, whichever card the caller had current
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.uncltmo_double_conv3x3(
            x.data_ptr(), packed.w1.data_ptr(), packed.b1.data_ptr(),
            packed.w2.data_ptr(), packed.b2.data_ptr(), y.data_ptr(), b,
            cin, h, w, c1, c2, _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError("fused_double_conv3x3 launch failed: "
                           + lib.uncltmo_cuda_error_string(err).decode())
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
