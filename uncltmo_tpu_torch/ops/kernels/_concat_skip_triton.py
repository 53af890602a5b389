"""Triton kernels of K1, forward and backward (see `concat_skip.py`).
Imported only by the CUDA branch of `fused_concat_skip`, so that CPU-only
installs never import triton."""
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


@triton.jit
def _concat_skip_bwd_kernel(x2_ptr, g_ptr, dx2_ptr, plane, eps,
                            BLOCK: tl.constexpr):
    # same grid as the forward.  g is the (B, 4C, H, W) gradient of the
    # concat: slabs 0, 2 and 3 of an image feed dx2, slab 1 is dx1 and is
    # not read here.
    pid = tl.program_id(0)
    b = tl.program_id(1).to(tl.int64)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < plane
    src = b * plane + offs
    gsrc = b * 4 * plane + offs
    # `other=1.0` keeps the masked lanes' 0.5 / rt finite
    x2 = tl.load(x2_ptr + src, mask=mask, other=1.0)
    g2 = tl.load(g_ptr + gsrc, mask=mask)
    gsq = tl.load(g_ptr + gsrc + 2 * plane, mask=mask)
    grt = tl.load(g_ptr + gsrc + 3 * plane, mask=mask)
    x2f = x2.to(tl.float32)
    # every step is rounded to the input dtype where the plain version (and
    # the JAX VJP) rounds: rt, then 0.5 / rt, then each product and sum.
    # In float32 the casts are no-ops and the launch forbids contraction
    # into fused multiply-adds, so the result is the plain version's bit
    # for bit.
    rt = tl.sqrt_rn((x2f + eps).to(x2.dtype).to(tl.float32)).to(x2.dtype)
    half = tl.full([BLOCK], 0.5, tl.float32)
    inv = tl.div_rn(half, rt.to(tl.float32)).to(x2.dtype)
    sq_term = ((2.0 * x2f) * gsq.to(tl.float32)).to(x2.dtype)
    acc = (g2.to(tl.float32) + sq_term.to(tl.float32)).to(x2.dtype)
    rt_term = (grt.to(tl.float32) * inv.to(tl.float32)).to(x2.dtype)
    dx2 = (acc.to(tl.float32) + rt_term.to(tl.float32)).to(x2.dtype)
    tl.store(dx2_ptr + src, dx2, mask=mask)


def _grid(x2):
    b = x2.shape[0]
    plane = x2.numel() // b
    return plane, (triton.cdiv(plane, _BLOCK), b)


def launch(x2, x1, out, eps: float) -> None:
    plane, grid = _grid(x2)
    _concat_skip_kernel[grid](x2, x1, out, plane, eps, BLOCK=_BLOCK,
                              num_warps=4)


def launch_backward(x2, g, dx2, eps: float) -> None:
    plane, grid = _grid(x2)
    _concat_skip_bwd_kernel[grid](x2, g, dx2, plane, eps, BLOCK=_BLOCK,
                                  num_warps=4, enable_fp_fusion=False)
