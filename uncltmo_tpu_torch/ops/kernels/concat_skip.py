"""K1: the `square_and_square_root` skip concat, `[x2, x1, x2^2, sqrt(x2+eps)]`
and its gradient.

Replaces the TPU kernel `fused_concat_skip` (`uncltmo_tpu/ops/pallas_kernels.py:
180-232`, oracle `concat_skip_reference` at `:235-238`) and its hand-derived
VJP `_fused_concat_skip_bwd` (`:221-229`).

On Hopper both directions are bound by bytes.  The forward reads x2 and x1
once and writes the 4C-channel output once (6 element-sizes per element of
x2), with a few flops per element.  The backward reads x2 and three of the
four slabs of the incoming gradient and writes dx2 (5 element-sizes per
element); dx1 is the second slab itself and is returned as a view, so it
costs nothing.  The Triton kernels (`_concat_skip_triton.py`) are one
elementwise pass over the (batch, C*H*W) planes: in NCHW each of the four
channel slabs of an image is one contiguous plane, so every load and store
is a coalesced vector access.  The square root is taken in float32 for
bfloat16 inputs, like the TPU kernel; the backward rounds `rt` and
`0.5 / rt` to the input dtype as the JAX VJP does.  At `x2 = 0` (common:
the skips are post-relu) `0.5 / rt` is 5000; that is the function's
gradient there and is not clamped.

Dispatch is by the tensor's device alone: CPU tensors take the plain
version (differentiated by autograd), CUDA tensors go through
`_ConcatSkip`, whose forward and backward launch the kernels (a failed
build or launch raises).
"""
from __future__ import annotations

import torch

from uncltmo_tpu_torch import params


def concat_skip_plain(x2: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: (B, C, H, W) x2 -> (B, 4C, H, W)."""
    rt = torch.sqrt((x2 + params.EPSILON).float()).to(x2.dtype)
    return torch.cat([x2, x1, x2 * x2, rt], 1)


def concat_skip_backward_plain(x2: torch.Tensor, g: torch.Tensor):
    """The plain PyTorch version of the gradient: x2 (B, C, H, W) and the
    gradient g (B, 4C, H, W) of the concat -> (dx2, dx1), with
    dx2 = g[:, :C] + 2 x2 g[:, 2C:3C] + g[:, 3C:] (0.5 / rt) and dx1 the
    slab g[:, C:2C] (a view)."""
    c = x2.shape[1]
    rt = torch.sqrt((x2 + params.EPSILON).float()).to(x2.dtype)
    dx2 = (g[:, :c] + 2.0 * x2 * g[:, 2 * c:3 * c]
           + g[:, 3 * c:] * (0.5 / rt).to(x2.dtype))
    return dx2, g[:, c:2 * c]


def fused_concat_skip_backward(x2: torch.Tensor, g: torch.Tensor):
    """(dx2, dx1) of `fused_concat_skip` at x2 for the output gradient g.

    The plain version on CPU tensors; the Triton kernel on CUDA tensors
    (counted in `fused_concat_skip.backward_launches`).  g may arrive
    non-contiguous; it is made contiguous here, because the kernel indexes
    whole planes.  dx1 is a view of g."""
    if x2.device.type == "cpu":
        return concat_skip_backward_plain(x2, g)
    b, c, h, w = x2.shape
    if (x2.device.type != "cuda" or g.device != x2.device
            or g.dtype != x2.dtype or tuple(g.shape) != (b, 4 * c, h, w)
            or x2.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError("fused_concat_skip_backward: x2 "
                         f"{tuple(x2.shape)} {x2.dtype} on {x2.device} and g "
                         f"{tuple(g.shape)} {g.dtype} on {g.device} do not "
                         "fit")
    from uncltmo_tpu_torch.ops.kernels import _concat_skip_triton
    x2 = x2.contiguous()
    g = g.contiguous()
    dx2 = torch.empty_like(x2)
    _concat_skip_triton.launch_backward(x2, g, dx2, params.EPSILON)
    fused_concat_skip.backward_launches += 1
    return dx2, g[:, c:2 * c]


class _ConcatSkip(torch.autograd.Function):
    """K1 on CUDA tensors: both directions are kernel launches."""

    @staticmethod
    def forward(ctx, x2, x1):
        from uncltmo_tpu_torch.ops.kernels import _concat_skip_triton
        x2 = x2.contiguous()
        x1 = x1.contiguous()
        b, c, h, w = x2.shape
        out = torch.empty((b, 4 * c, h, w), dtype=x2.dtype, device=x2.device)
        _concat_skip_triton.launch(x2, x1, out, params.EPSILON)
        fused_concat_skip.launches += 1
        ctx.save_for_backward(x2)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (x2,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            c = x2.shape[1]
            return None, g[:, c:2 * c]
        return fused_concat_skip_backward(x2, g)


def fused_concat_skip(x2: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """`[x2, x1, x2^2, sqrt(x2 + eps)]` along channels, NCHW.

    The plain version on a CPU tensor; the Triton kernels on a CUDA tensor,
    forward (counted in `fused_concat_skip.launches`) and, under autograd,
    backward (`fused_concat_skip.backward_launches`)."""
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
    return _ConcatSkip.apply(x2, x1)


fused_concat_skip.launches = 0
fused_concat_skip.backward_launches = 0
