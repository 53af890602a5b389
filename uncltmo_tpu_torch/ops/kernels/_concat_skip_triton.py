"""Triton kernel of K1 (see `concat_skip.py`).  Imported only by the CUDA
branch of `fused_concat_skip`, so that CPU-only installs never import
triton."""
import triton
import triton.language as tl

_BLOCK = 1024


@triton.jit
def _concat_skip_kernel(x2_ptr, x1_ptr, out_ptr, plane, eps,
                        BLOCK: tl.constexpr):
    # grid: (cdiv(plane, BLOCK), batch); plane = C*H*W of one image
    pid = tl.program_id(0)
    b = tl.program_id(1).to(tl.int64)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < plane
    src = b * plane + offs
    x2 = tl.load(x2_ptr + src, mask=mask)
    x1 = tl.load(x1_ptr + src, mask=mask)
    dst = b * 4 * plane + offs
    tl.store(out_ptr + dst, x2, mask=mask)
    tl.store(out_ptr + dst + plane, x1, mask=mask)
    x2f = x2.to(tl.float32)
    # a bf16 product of two bf16 values is exact in f32: one rounding, as
    # the plain version's bf16 multiply
    tl.store(out_ptr + dst + 2 * plane, (x2f * x2f).to(x2.dtype), mask=mask)
    # x2 + eps rounds to the input dtype first (as the plain version and
    # the TPU kernel add in that dtype), then a correctly rounded f32 sqrt
    s = (x2f + eps).to(x2.dtype).to(tl.float32)
    tl.store(out_ptr + dst + 3 * plane, tl.sqrt_rn(s).to(x2.dtype),
             mask=mask)


def launch(x2, x1, out, eps: float) -> None:
    b = x2.shape[0]
    plane = x2.numel() // b
    grid = (triton.cdiv(plane, _BLOCK), b)
    _concat_skip_kernel[grid](x2, x1, out, plane, eps, BLOCK=_BLOCK,
                              num_warps=4)
