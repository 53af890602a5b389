// K2: fused (valid 3x3 conv -> bias -> relu) x 2 on NCHW tensors, Hopper.
//
// Replaces the TPU kernel `fused_double_conv3x3`
// (uncltmo_tpu/ops/pallas_kernels.py:88-132, body `_make_kernel` :68-85).
// It runs the U-Net cells inc (1->32->32 @256^2), down0 (32->64->64 @126^2),
// down1 (64->128->128 @61^2) and down2 (128->256->256 @28^2).
//
// Bound: operations.  The cells do 2*9*Cin*C1 + 2*9*C1*C2 flops per output
// pixel against a few bytes of input and output, far above the card's
// flop:byte ridge.  So the kernel keeps the intermediate activation out of
// device memory (as the TPU kernel keeps it in VMEM), does each product
// once, and does it on Hopper's warpgroup tensor-core instructions.
//
// Two kernels: bfloat16 runs `double_conv3x3_wgmma_kernel`
// (double_conv3x3_bf16.cu), a block a tile; float32 runs
// `double_conv3x3_persistent_kernel` (double_conv3x3.cu), persistent blocks
// with A in registers.  Their libraries have the same C entry points.  What
// they share, beside hopper.cuh's design:
//  * a block (CTA) computes a TH x TW output tile of one image.  Its input
//    tile with a 2-pixel halo is staged once, transposed to
//    [position][channel] with position q = row * P + col and ONE pitch
//    P = TW + 4 for input, intermediate and output.  conv1 is computed at
//    every flattened q of its M1 rows and stored at the same q, conv2 at
//    every q of its M2 rows (both multiples of wgmma's 64): tap (ky, kx) of
//    either is the same array shifted by ky * P + kx positions, so the A
//    operand of the implicit GEMM (M = positions, N = output channels,
//    K = 9 taps x channels) is a plain pointer.  The last 2 (conv1) / 4
//    (conv2) columns of a row hold wrapped values that feed no valid output
//    and are never stored;
//  * the [position][channel] arrays are kept as 8-position x 16-byte core
//    matrices ([channel / (16 / size)][position][16 bytes], no swizzle), in
//    which a tap's shift of s positions is s * 16 bytes;
//  * the intermediate: conv1 accumulators -> bias + relu -> rounded to the
//    element type (as the TPU kernel's `mid.astype(x.dtype)`) -> shared
//    memory, then folded into the conv2 accumulators, which stay in
//    registers over all of C1.  The intermediate never touches device
//    memory;
//  * thread-block clusters of CL CTAs (down2: 2) share one spatial tile:
//    CTA rank r computes conv1 for its 1 / CL of each block of intermediate
//    channels and pushes them into its own and its peers' intermediate
//    buffers (`st.shared::cluster`), then signals each peer's `mbarrier`
//    with release semantics at cluster scope; each CTA then runs conv2 for
//    its C2P / CL output channels over all of C1.  conv1 is still computed
//    once per tile;
//  * Cin == 1 (inc): conv1 is 9 FMAs a value, done on the CUDA cores
//    straight into the intermediate; only conv2 uses the tensor cores;
//  * conv2's epilogue goes through a per-warpgroup scratch in shared memory
//    so that the NCHW stores run along W.
//
// Tile shape, warpgroups, chunks and blocks, cluster, stages and Cin
// staging width are template parameters per output-channel width (`Cfg`,
// `PCfg`); `uncltmo_double_conv3x3_plan` tells the packing which were
// chosen.

#pragma once

#include "hopper.cuh"

namespace {

// The padded input channels: a whole swizzle row per tap.
__host__ __device__ constexpr int padded_cin(int cin, int es) {
  return cin <= 16 ? 16 : cin <= 32 ? 32 : round_up(cin, 128 / es);
}

// What the packing and the launch share (see `uncltmo_double_conv3x3_plan`)
struct Plan {
  int cinp, cinc, c1p, ch, cl, n2, c2p, th, tw, tg, nst, nwg, ch1,
      persistent;
};

template <class C, typename T> Plan make_plan(int cin, int c1, int c2p) {
  Plan p;
  p.cinp = C::CIN1 ? 1 : padded_cin(cin, Elem<T>::ES);
  p.cinc = C::CIN1 ? 1 : imin(p.cinp, C::CINC);
  p.c1p = round_up(c1, C::CH1);
  p.ch = C::CH;
  p.cl = C::CL;
  p.n2 = C::N2;
  p.c2p = c2p;
  p.th = C::TH;
  p.tw = C::TW;
  p.tg = C::TG;
  p.nst = C::NST;
  p.nwg = C::NWG;
  p.ch1 = C::CH1;
  p.persistent = C::PERSISTENT;
  return p;
}

// The plan as the 14 ints of `uncltmo_double_conv3x3_plan`: padded Cin,
// Cin staged at a time, padded C1, the C1 chunk, the cluster size, output
// channels a CTA, padded C2, tile height and width, taps a weight stage,
// stages, consumer warpgroups, conv1's block of intermediate channels (a
// cluster's) and 1 for the persistent kernel.  Returns 0.
int plan_out(const Plan& p, int* out) {
  const int v[14] = {p.cinp, p.cinc, p.c1p, p.ch,  p.cl,  p.n2,
                     p.c2p,  p.th,   p.tw,  p.tg,  p.nst, p.nwg,
                     p.ch1,  p.persistent};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
  return 0;
}

// C2 padded to the output-channel width of a configuration: 32, 64, 128 or
// a multiple of 256 (one pass of the grid's y per 256)
int padded_c2(int c2) {
  return c2 <= 32 ? 32 : c2 <= 64 ? 64 : c2 <= 128 ? 128 : round_up(c2, 256);
}

// f(C()) for the configuration of a source's five that serves (cin, c2p).
template <class Inc, class C32, class C64, class C128, class C256, class F>
int with_cfg(int cin, int c2p, F f) {
  if (c2p == 32) return cin == 1 ? f(Inc()) : f(C32());
  if (c2p == 64) return f(C64());
  if (c2p == 128) return f(C128());
  return f(C256());
}

// The arguments K2 takes (the bfloat16 grid's y: C2's passes of 256).
bool args_ok(int batch, int cin, int h, int w, int c1, int c2) {
  return h >= 5 && w >= 5 && batch >= 1 && batch <= 65535 && cin >= 1 &&
         c1 >= 1 && c2 >= 1 && padded_c2(c2) <= 256 * 65535;
}

}  // namespace
