"""K1: the `square_and_square_root` skip concat, `[x2, x1, x2^2, sqrt(x2+eps)]`.

Replaces the TPU kernel `fused_concat_skip` (`uncltmo_tpu/ops/pallas_kernels.py:
180-232`, oracle `concat_skip_reference` at `:235-238`), forward only.

On Hopper the op is bound by bytes: it reads x2 and x1 once and writes the
4C-channel output once (6 element-bytes moved per input element pair), with
a few flops per element.  The Triton kernel (`_concat_skip_triton.py`) is one
elementwise pass over the (batch, C*H*W) planes: in NCHW each of the four
output channel slabs of an image is one contiguous plane, so every load and
store is a coalesced vector access.  The square root is taken in float32
for bfloat16 inputs, like the TPU kernel.

Dispatch is by the tensor's device alone: CPU tensors take the plain
version, CUDA tensors launch the kernel (a failed build or launch raises).
"""
from __future__ import annotations

import torch

from uncltmo_tpu_torch import params


def concat_skip_plain(x2: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: (B, C, H, W) x2 -> (B, 4C, H, W)."""
    rt = torch.sqrt((x2 + params.EPSILON).float()).to(x2.dtype)
    return torch.cat([x2, x1, x2 * x2, rt], 1)


def fused_concat_skip(x2: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """`[x2, x1, x2^2, sqrt(x2 + eps)]` along channels, NCHW.

    The plain version on a CPU tensor; the Triton kernel on a CUDA tensor
    (counted in `fused_concat_skip.launches`)."""
    if x2.device.type == "cpu":
        return concat_skip_plain(x2, x1)
    if x2.device.type != "cuda":
        raise ValueError(f"fused_concat_skip: unsupported device {x2.device}")
    if x1.shape != x2.shape or x1.dtype != x2.dtype or x1.device != x2.device:
        raise ValueError("fused_concat_skip: x1 and x2 must match in shape, "
                         f"dtype and device ({tuple(x1.shape)} {x1.dtype} vs "
                         f"{tuple(x2.shape)} {x2.dtype})")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_concat_skip: unsupported dtype {x2.dtype}")
    from uncltmo_tpu_torch.ops.kernels import _concat_skip_triton
    x2 = x2.contiguous()
    x1 = x1.contiguous()
    b, c, h, w = x2.shape
    out = torch.empty((b, 4 * c, h, w), dtype=x2.dtype, device=x2.device)
    _concat_skip_triton.launch(x2, x1, out, params.EPSILON)
    fused_concat_skip.launches += 1
    return out


fused_concat_skip.launches = 0
