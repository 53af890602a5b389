"""K2: the U-Net's (valid 3x3 conv -> bias -> relu) x 2 cell, fused.

Replaces the TPU kernel `fused_double_conv3x3` (`uncltmo_tpu/ops/
pallas_kernels.py:88-132`, oracle `double_conv3x3_reference` at `:241-250`).
The CUDA C++ kernel is `csrc/double_conv3x3.cu` (its header says what bounds
it on Hopper and how its design answers that); this module holds its plain
PyTorch version and the ctypes wrapper.

Dispatch is by the tensor's device alone: CPU tensors take the plain
version, CUDA tensors launch the kernel (a failed build or launch raises).
The TPU kernel's `W*Cin % 128 == 0` rule is a Mosaic DMA constraint and
does not apply here: any H, W >= 5 and any channel counts are accepted.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from uncltmo_tpu_torch.ops.kernels.build import load_library

_SOURCE = "double_conv3x3.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def double_conv3x3_plain(x, w1, b1, w2, b2):
    """The plain PyTorch version: two valid F.conv2d + bias + relu."""
    mid = F.relu(F.conv2d(x, w1, b1))
    return F.relu(F.conv2d(mid, w2, b2))


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
                         w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """(B, Cin, H, W) -> (B, C2, H-4, W-4); weights OIHW (C1, Cin, 3, 3) and
    (C2, C1, 3, 3), biases (C1,), (C2,).

    The plain version on a CPU tensor; the CUDA kernel on a CUDA tensor
    (counted in `fused_double_conv3x3.launches`)."""
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
    lib = _library()
    x = x.contiguous()
    # [Cin][3][3][C1] and [C1][3][3][C2]: coalesced weight staging
    w1t = w1.permute(1, 2, 3, 0).contiguous()
    w2t = w2.permute(1, 2, 3, 0).contiguous()
    b1 = b1.contiguous()
    b2 = b2.contiguous()
    y = torch.empty((b, c2, h - 4, w - 4), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.uncltmo_double_conv3x3(
        x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
        b2.data_ptr(), y.data_ptr(), b, cin, h, w, c1, c2,
        _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError("fused_double_conv3x3 launch failed: "
                           + lib.uncltmo_cuda_error_string(err).decode())
    fused_double_conv3x3.launches += 1
    return y


fused_double_conv3x3.launches = 0
