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
// Two kernels, both accumulating in float32: bfloat16 runs
// `double_conv3x3_wgmma_kernel`, a block a tile; float32 runs
// `double_conv3x3_persistent_kernel`, persistent blocks with A in
// registers.  What they share:
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
//  * warp specialisation: one producer thread moves the weights, NWG
//    consumer warpgroups run the products (setmaxnreg gives them the
//    producer warpgroup's registers).  The weights are packed once on the
//    device (`pack_double_conv_weights` in ops/kernels/double_conv.py) into
//    the exact byte image of a shared-memory stage as a `wgmma` descriptor
//    reads it (K-major, rows of 32 / 64 / 128 swizzled bytes), in the order
//    the kernel consumes them, so that each stage is ONE
//    `cp.async.bulk ... mbarrier::complete_tx` of contiguous bytes into a
//    ring of NST stages, with full / empty `mbarrier` pairs between the
//    producer and the consumers;
//  * products are `wgmma.mma_async` with B from the stage through a
//    swizzled descriptor.  The [position][channel] arrays are kept as
//    8-position x 16-byte core matrices ([channel / (16 / size)][position]
//    [16 bytes], no swizzle), in which a tap's shift of s positions is
//    s * 16 bytes;
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
//    so that the NCHW stores run along W;
//  * a wait on an `mbarrier` that makes no progress for 20 s traps (a
//    launch error) instead of hanging the card.
// bfloat16, a block a tile: A from shared memory through the descriptor
// too, so a warpgroup issues all products of a stage for all its 64-row
// tiles back to back and waits once; the intermediate walked in chunks of
// CH channels, double-buffered.
// float32 is split-TF32: the weights are split into hi = tf32(w) and lo =
// tf32(w - hi) at packing time (two planes a stage), every A value as it
// is loaded, and a product is three wgmmas, lo*hi + hi*lo + hi*hi.  The
// tensor cores round their own adds with a bias, so each k-step's products
// go to partial accumulators that join the float32 one by ordinary adds
// (`stage_mma_rs`), whose order fixes every output's rounding.  What bounds
// it on Hopper, measured by ablation: a per-k-step join with one group of
// products in flight (latency, not the adds), conv1 products of N = 16 too
// small to hide that latency, two planes of every A operand in shared
// memory (which pinned short tiles) and a block's set-up and staging
// repeated for every tile.  The design answers:
//  * A in registers: each k-step loads the lane's four float32 values of
//    its wgmma fragment from ONE plane in shared memory and splits them
//    there, so the input tile and the intermediate take half the bytes and
//    A is read from shared memory once a k-step instead of three times;
//  * conv1 in blocks of NB channels a CTA (32 or 64 where the registers
//    hold them: down1, down2): each k-step's three products are N = NB wide
//    for the same latency, and conv2 folds a block as the same CH-channel
//    sub-chunks in the same order as a chunk at a time would;
//  * persistent blocks: as many CTAs (clusters) as are resident, each
//    walking the work items (image, C2 pass, tile) in steps of the grid, so
//    that the producer streams the next item's first weight stages during
//    an item's epilogue, each CTA is set up once and the whole input tile
//    is staged once an item (down2's 128 channels fit now);
//  * one warpgroup per 64-row tile of conv2 where three fit the registers
//    (inc, down0: 3 consumer warpgroups), the intermediate in one buffer
//    where two do not fit (down2), a `mbarrier` then holding the next
//    block's write until every consumer of the cluster has read it.
// Every float32 output is bit for bit what the earlier two-plane kernel
// gave: the same products into the same partials, joined in the same
// order (tests/test_torch_kernels_cuda.py `K2_DIGESTS`).
//
// Tile shape, warpgroups, chunks and blocks, cluster, stages and Cin
// staging width are template parameters per element type and
// output-channel width (`Cfg`, `PCfg`); `uncltmo_double_conv3x3_plan`
// tells the packing which were chosen.  Plain C interface, loaded with
// ctypes: no PyTorch headers, so nvcc builds it in seconds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ constexpr int round_up(int a, int b) {
  return ceil_div(a, b) * b;
}
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

constexpr int SMEM_LIMIT = 232448;     // bytes a block may use on sm_90
constexpr int SCR_LD = 64 + 4;         // epilogue scratch: [16][SCR_LD]

// What differs between the element types: bytes, the depth of one wgmma
// (KS), planes of the weights (float32: TF32 hi and lo) and elements per
// 16 bytes (a core matrix row).
template <typename T> struct Elem;
template <> struct Elem<bf16> {
  static constexpr int ES = 2, KS = 16, PLANES = 1, VEC = 8;
};
template <> struct Elem<float> {
  static constexpr int ES = 4, KS = 8, PLANES = 2, VEC = 4;
};

// Bytes of one row of a weight image whose taps hold K channels: the
// swizzle width (32, 64 or 128); a K beyond 128 bytes is several 128-byte
// column blocks.  The descriptor's layout code of each width.
__host__ __device__ constexpr int swizzle_bytes(int k_bytes) {
  return k_bytes < 128 ? k_bytes : 128;
}
__host__ __device__ constexpr int layout_code(int s) {
  return s == 128 ? 1 : s == 64 ? 2 : 3;
}
// The padded input channels: a whole swizzle row per tap.
__host__ __device__ constexpr int padded_cin(int cin, int es) {
  return cin <= 16 ? 16 : cin <= 32 ? 32 : round_up(cin, 128 / es);
}

// One instantiation: an output tile of TH x TW pixels; NWG consumer
// warpgroups; the intermediate in chunks of CH channels; C2P (padded)
// output channels for a cluster of CL CTAs (each CTA: CH / CL channels of
// conv1, C2P / CL of conv2); input channels staged CINC at a time; TG taps
// (1, 3 or 9) a weight stage and NST stages in the ring.  CIN1: Cin == 1,
// conv1 on the CUDA cores.
template <int TH_, int TW_, int NWG_, int CH_, int C2P_, int CL_, int CINC_,
          int TG_, int NST_, bool CIN1_>
struct Cfg {
  static constexpr int TH = TH_, TW = TW_, NWG = NWG_, CH = CH_, C2P = C2P_,
                       CL = CL_, CINC = CINC_, TG = TG_, NST = NST_,
                       G = 9 / TG_;
  static constexpr bool CIN1 = CIN1_, PERSISTENT = false;
  static constexpr int CH1 = CH;                        // conv1's block
  static constexpr int P = TW + 4;                      // the one pitch
  static constexpr int M2 = round_up(TH * P, 64);       // conv2 positions
  static constexpr int M2T = M2 / 64;
  // conv1 positions: far enough for conv2's last shift (2P + 2)
  static constexpr int M1 = round_up(M2 + 2 * P + 2, CIN1 ? 8 : 64);
  static constexpr int M1T = M1 / 64;
  // input positions: far enough for conv1's last shift
  static constexpr int NPOS = M1 + 2 * P + 2;
  // consumers + one producer warpgroup (one thread of it copies; the
  // rest give their registers to the consumers with setmaxnreg)
  static constexpr int NC = NWG * 128, NT = NC + 128;
  static constexpr int REG_PRODUCER = 40;
  static constexpr int REG_CONSUMER =
      imin(((65536 - 128 * REG_PRODUCER) / NC) / 8 * 8, 240);
  static constexpr int N1 = CH / CL, N2 = C2P / CL;
  // conv2: WM2 warpgroups along positions x WN2 along channels
  static constexpr int WM2 = M2T < NWG ? M2T : NWG, WN2 = NWG / WM2;
  static constexpr int N2W = N2 / WN2;                  // a warpgroup's N
  static constexpr int M2W = ceil_div(M2T, WM2);        // its 64-row tiles
  static constexpr int M1W = ceil_div(M1T, NWG);        // conv1's
  static_assert(TG == 1 || TG == 3 || TG == 9, "taps per weight stage");
  static_assert(CL == 1 || CL == 2 || CL == 4, "cluster size");
  static_assert(CH % (8 * CL) == 0 && N1 <= 128, "conv1's wgmma N");
  static_assert(NWG % WM2 == 0 && N2 % (16 * WN2) == 0 && N2W <= 128,
                "conv2's wgmma N");
  static_assert(!CIN1 || (CL == 1 && CH % 8 == 0), "Cin == 1");
  static_assert(NWG >= 1 && NWG <= 4, "warpgroups");
};

// Shared memory of a block, byte offsets from a 1024-aligned base (the
// swizzle pattern repeats every 1024 bytes).  The epilogue's scratch lies
// over the input tile, which is dead by then.
template <class C, typename T> struct Smem {
  using E = Elem<T>;
  static constexpr int ES = E::ES, PL = E::PLANES;
  static constexpr int SLOT = round_up(
      C::TG * PL * ES * imax(C::CIN1 ? 0 : C::CINC * C::N1, C::CH * C::N2),
      1024);
  static constexpr int RING = 0;
  static constexpr int IN = C::NST * SLOT;
  static constexpr int IN_BYTES = round_up(
      imax(C::CIN1 ? C::NPOS * ES : PL * C::NPOS * C::CINC * ES,
           C::NWG * 16 * SCR_LD * 4),
      128);
  static constexpr int MID = IN + IN_BYTES;
  static constexpr int MID_BUF = round_up(PL * C::M1 * C::CH * ES, 128);
  static constexpr int BAR = MID + 2 * MID_BUF;
  static constexpr int W1S = BAR + round_up((2 * C::NST + 2) * 8, 128);
  static constexpr int END = W1S + (C::CIN1 ? 10 * C::CH * 4 : 0);
  static constexpr int TOTAL = END + 1024;      // room to align the base
  static_assert(TOTAL <= SMEM_LIMIT, "shared memory of a block");
  static_assert(C::CIN1 || C::CINC * ES == 32 || C::CINC * ES == 64 ||
                    C::CINC * ES % 128 == 0,
                "Cin chunks are whole swizzle rows");
};

// ---- PTX wrappers ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// x rounded to tf32 (10 mantissa bits), as the bits of a float
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of wgmma's accumulators
// across the asynchronous products
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// A K-major shared-memory matrix descriptor: start address, the stride of
// core matrices along K (LBO; unused in the swizzled layouts), of 8-row
// groups (SBO) and the swizzle (0: none, 1: 128, 2: 64, 3: 32 bytes).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int code) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(code) << 62);
}
// orders this thread's generic-proxy writes to shared memory before the
// async proxy's reads (wgmma operands); `_shared`: this thread's view of
// shared memory before its own later wgmmas
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// arrive where `pred` holds (a predicated instruction, not a branch:
// ptxas serialises the wgmmas that follow a branch it cannot prove uniform)
__device__ __forceinline__ void mbar_arrive(uint32_t bar, bool pred = true) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(static_cast<int>(pred))
      : "memory");
}
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
// arrive on the barrier at the same offset in CTA `rank` of the cluster;
// the writes this thread has made (or observed) before are released to it
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, int rank,
                                                    bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n}\n"
      ::"r"(mapa(bar, rank)), "r"(static_cast<int>(pred))
      : "memory");
}
// wait until phase `parity` of the barrier has completed (acquire at CTA or
// cluster scope); trap after 20 s without progress.  The loop is PTX's own,
// so that the compiler sees no divergent exit.
#define UNCLTMO_MBAR_WAIT(SCOPE)                                           \
  "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"                                   \
  "mov.u64 t0, %%globaltimer;\n"                                           \
  "WAIT:\n"                                                                \
  "mbarrier.try_wait.parity" SCOPE ".shared::cta.b64 p, [%0], %1;\n"       \
  "@p bra.uni DONE;\n"                                                     \
  "mov.u64 t1, %%globaltimer;\n"                                           \
  "sub.u64 t1, t1, t0;\n"                                                  \
  "setp.gt.u64 p, t1, 20000000000;\n"                                      \
  "@p trap;\n"                                                             \
  "bra.uni WAIT;\n"                                                        \
  "DONE:\n}\n"
template <bool CLUSTER>
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (CLUSTER)
    asm volatile(UNCLTMO_MBAR_WAIT(".acquire.cluster")::"r"(bar), "r"(parity)
                 : "memory");
  else
    asm volatile(UNCLTMO_MBAR_WAIT("")::"r"(bar), "r"(parity) : "memory");
}
#undef UNCLTMO_MBAR_WAIT
// `bytes` of contiguous global memory into this CTA's shared memory,
// completing as transactions on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// d (64 x N, f32, this warpgroup's) (+)= a (64 x K-step) x b (K-step x N),
// both in shared memory through descriptors; `scale_d` 0 ignores d's old
// value.  Warp w of the warpgroup holds rows 16w..16w+15 of d; d[4j..4j+3]
// are lane (g, t)'s [g][8j+2t], [g][8j+2t+1], [g+8][8j+2t],
// [g+8][8j+2t+1].
template <typename T, int N> struct Wgmma;
template <> struct Wgmma<bf16, 8> {
  __device__ __forceinline__ static void mma(float (&d)[4], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<bf16, 16> {
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<bf16, 32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<bf16, 64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<bf16, 128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
// ---- end PTX wrappers ----

__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16(v);
}

// The B operand of one product: the stage holds, per tap u and plane p, a
// K x N_img image, K-major in rows of S = swizzle_bytes(K * ES) bytes, 8-row
// groups S * 8 apart, K beyond one row in column blocks N_img * S apart.
// `desc` is that of tap 0, plane 0, k-step 0, rows n0..; the others are
// offsets (in 16-byte units) on its address field, walked as the products
// go: + plane, + tap, and per k-step 32 bytes along the row, or to the next
// column block.
struct BWalk {
  uint64_t desc;
  uint32_t tap, plane, blk, row_steps;
};
template <typename T>
__device__ __forceinline__ BWalk b_walk(uint32_t stage, int k, int n_img,
                                        int n0) {
  using E = Elem<T>;
  const int s = swizzle_bytes(k * E::ES);
  BWalk w;
  w.desc = make_desc(stage + n0 * s, 16, 8 * s, layout_code(s));
  w.plane = (k * n_img * E::ES) >> 4;
  w.tap = E::PLANES * w.plane;
  w.blk = (n_img * s) >> 4;
  w.row_steps = s / 32;                    // k-steps (32 bytes) in a row
  return w;
}

// The A operand: 64 positions from `row` of a [chunk][position][16 bytes]
// array of `rows` positions a chunk (no swizzle: core matrices of 8
// positions x 16 bytes, 128 bytes apart along positions and rows * 16
// along K); a k-step (two core matrices along K) adds 2 * rows * 16 bytes.
__device__ __forceinline__ uint64_t a_desc(uint32_t base, int rows, int row) {
  return make_desc(base + row * 16, rows * 16, 128, 0);
}

// acc[mm] (this warpgroup's 64-row tiles mt = mt0 + mm * mstep < mtn, N
// columns) += sum over the stage's TG taps from tap0 and the K channels of
// each: A = the array at `a` (`rows` positions a chunk, planes `plane`
// bytes apart) shifted by the tap, B = the stage's image of the tap, rows
// n0.. of N_img.  All products are issued back to back and waited for
// once, the tiles innermost, so that consecutive products go to different
// accumulators; a narrow tile (N <= 32) also alternates its k-steps
// between two accumulators.  Descriptors advance by adds only.
// bfloat16: one wgmma a k-step.
template <class C, int N, int MW>
__device__ __forceinline__ void stage_mma(float (&acc)[MW][N / 2], bf16*,
                                          int mt0, int mstep, int mtn,
                                          uint32_t a, int rows, int plane,
                                          int tap0, int k, uint32_t stage,
                                          int n_img, int n0) {
  constexpr bool DUAL = N <= 32;
  const int ksteps = k / 16;
  const BWalk bw = b_walk<bf16>(stage, k, n_img, n0);
  const uint32_t a_step = (2 * rows * 16) >> 4;
  float alt[MW][DUAL ? N / 2 : 1];
#pragma unroll
  for (int mm = 0; mm < MW; ++mm) {
    fence_regs(acc[mm]);
    if constexpr (DUAL) {
#pragma unroll
      for (int e = 0; e < N / 2; ++e) alt[mm][e] = 0.f;
      fence_regs(alt[mm]);
    }
  }
  wgmma_fence();
#pragma unroll 1
  for (int u = 0; u < C::TG; ++u) {
    const int tap = tap0 + u;
    const int shift = (tap / 3) * C::P + tap % 3;
    uint64_t ad[MW];
#pragma unroll
    for (int mm = 0; mm < MW; ++mm)
      ad[mm] = a_desc(a, rows, (mt0 + mm * mstep) * 64 + shift);
    uint64_t bd = bw.desc + u * bw.tap;
    int col = 0;
    for (int kk = 0; kk < ksteps; ++kk) {
#pragma unroll
      for (int mm = 0; mm < MW; ++mm) {
        if (mt0 + mm * mstep >= mtn) continue;
        if constexpr (DUAL) {
          if (kk & 1)
            Wgmma<bf16, N>::mma(alt[mm], ad[mm], bd, u > 0 || kk > 1);
          else
            Wgmma<bf16, N>::mma(acc[mm], ad[mm], bd, 1);
        } else {
          Wgmma<bf16, N>::mma(acc[mm], ad[mm], bd, 1);
        }
        ad[mm] += a_step;
      }
      // next k-step: 32 bytes along the row, or the next column block
      if (++col == bw.row_steps) {
        col = 0;
        bd += bw.blk - (bw.row_steps - 1) * 2;
      } else {
        bd += 2;
      }
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int mm = 0; mm < MW; ++mm) {
    fence_regs(acc[mm]);
    if constexpr (DUAL) {
      fence_regs(alt[mm]);
      if (mt0 + mm * mstep < mtn && ksteps > 1)
#pragma unroll
        for (int e = 0; e < N / 2; ++e) acc[mm][e] += alt[mm][e];
    }
  }
}

// Stores of the [chunk][position][16 bytes] arrays: a pair (v0, v1) at an
// even channel into this CTA's shared memory (`addr` generic) or a peer's
// (`addr` cluster); VEC values.
__device__ __forceinline__ void put_pair(bf16* p, int, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void put_pair_cluster(bf16*, uint32_t addr, int,
                                                 float v0, float v1) {
  __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
  asm volatile("st.shared::cluster.b32 [%0], %1;\n" ::"r"(addr),
               "r"(*reinterpret_cast<unsigned*>(&v))
               : "memory");
}
// VEC values (16 bytes) at p in every plane
__device__ __forceinline__ void put_vec(bf16* p, int, const bf16* v) {
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v);
}
template <class C, typename T>
__global__ void __launch_bounds__(C::NT, 1)
double_conv3x3_wgmma_kernel(const T* __restrict__ x, const T* __restrict__ w1p,
                            const T* __restrict__ b1, const T* __restrict__ w2p,
                            const T* __restrict__ b2, T* __restrict__ y,
                            int cin, int h, int w, int c1, int c2, int cinp,
                            int c1p, int cinc, int tiles_x) {
  using E = Elem<T>;
  using L = Smem<C, T>;
  constexpr int P = C::P, PL = E::PLANES, VEC = E::VEC;
  // the intermediate: [plane][CH / VEC][M1][VEC]
  constexpr int MID_PLANE = C::CH * C::M1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  T* in_s = reinterpret_cast<T*>(smem + L::IN);

  const int tid = threadIdx.x, lane = tid & 31;
  // the warp's index, broadcast: uniform in the compiler's eyes, so that
  // branches on it do not serialise the wgmmas
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int rank = C::CL > 1 ? cluster_rank() : 0;
  const int tile = blockIdx.x / C::CL;
  const int ty0 = (tile / tiles_x) * C::TH;
  const int tx0 = (tile % tiles_x) * C::TW;
  const int img = blockIdx.z;
  const int ho = h - 4, wo = w - 4;
  const int n_i = C::CIN1 ? 0 : ceil_div(cinp, cinc);      // Cin chunks
  const int n_j = c1p / C::CH;                              // C1 chunks
  const int per_j = (n_i + 1) * C::G;    // weight stages of one C1 chunk
  const int n_stages = n_j * per_j;
  const uint32_t full0 = sbase + L::BAR, empty0 = full0 + 8 * C::NST;
  const uint32_t midf0 = empty0 + 8 * C::NST;    // intermediate written

  if (tid == 0) {
    for (int i = 0; i < C::NST; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, C::NC / 32);
    }
    mbar_init(midf0, C::CL * C::NC / 32);
    mbar_init(midf0 + 8, C::CL * C::NC / 32);
    mbar_fence_init();
  }
  if (C::CL > 1)
    cluster_sync();        // the peers' barriers exist before any arrive
  else
    __syncthreads();

  if (warp >= C::NC / 32) {
    // The producer: stage `s` of the weight stream is TG taps of one
    // chunk: conv1's stages ([Cin chunk][tap group]) then conv2's tap
    // groups, for each C1 chunk in turn, each one contiguous block of the
    // packed weights (see `pack_double_conv_weights`).  The two roles
    // never reconverge (setmaxnreg needs that).
    setmaxnreg_dec<C::REG_PRODUCER>();
    if (warp == C::NC / 32 && lane == 0) {
      for (int s = 0; s < n_stages; ++s) {
        const int slot = s % C::NST;
        if (s >= C::NST)
          mbar_wait<false>(empty0 + 8 * slot, (s / C::NST - 1) & 1);
        const int j = s / per_j, r = s % per_j;
        const T* src;
        int elems;
        if (r < n_i * C::G) {
          const int i = r / C::G, tap = (r % C::G) * C::TG;
          const int k = min(cinc, cinp - i * cinc);
          src = w1p + ((size_t)(j * C::CL + rank) * 9 * cinp + 9 * i * cinc +
                       tap * k) * PL * C::N1;
          elems = C::TG * k * PL * C::N1;
        } else {
          const int tap = (r - n_i * C::G) * C::TG;
          src = w2p + ((size_t)((blockIdx.y * n_j + j) * C::CL + rank) * 9 +
                       tap) * C::CH * PL * C::N2;
          elems = C::TG * C::CH * PL * C::N2;
        }
        mbar_expect_tx(full0 + 8 * slot, elems * E::ES);
        bulk_copy(sbase + L::RING + slot * L::SLOT, src, elems * E::ES,
                  full0 + 8 * slot);
      }
    }
    // no CTA leaves while a peer may still write into its shared memory
    if (C::CL > 1) cluster_sync();
    return;
  } else {
    setmaxnreg_inc<C::REG_CONSUMER>();
    const int wg = warp >> 2;                  // the consumer warpgroup
    const int g = lane >> 2, t4 = lane & 3;    // a lane's place in a tile
    const int row_w = (warp & 3) * 16 + g;     // its first row in a tile
    const int wm2 = wg % C::WM2, wn2 = wg / C::WM2;

    // The input tile with its halo, [plane][channel / VEC][position][VEC],
    // zero beyond the image, below the tile's rows and in the padded
    // channels.  Global reads run along W.
    auto stage_input = [&](int i) {
      const T* xb = x + (size_t)img * cin * h * w;
      if constexpr (C::CIN1) {
        for (int pos = tid; pos < C::NPOS; pos += C::NC) {
          const int gy = ty0 + pos / P, gx = tx0 + pos % P;
          in_s[pos] = (pos < (C::TH + 4) * P && gy < h && gx < w)
                          ? xb[(size_t)gy * w + gx]
                          : from_float<T>(0.f);
        }
      } else {
        // one thread: VEC channels of one position (16 bytes), the loads
        // in flight together; lanes run along positions
        const int k = min(cinc, cinp - i * cinc), cvn = k / VEC;
#pragma unroll 4
        for (int idx = tid; idx < cvn * C::NPOS; idx += C::NC) {
          const int cv = idx / C::NPOS, pos = idx % C::NPOS;
          const int gy = ty0 + pos / P, gx = tx0 + pos % P;
          const int c0 = i * cinc + cv * VEC;
          const bool in = pos < (C::TH + 4) * P && gy < h && gx < w;
          const T* src = xb + ((size_t)c0 * h + gy) * w + gx;
          __align__(16) T v[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            v[e] = (in && c0 + e < cin) ? src[(size_t)e * h * w]
                                        : from_float<T>(0.f);
          put_vec(in_s + (cv * C::NPOS + pos) * VEC, k * C::NPOS, v);
        }
      }
      fence_proxy_async();          // for the products' reads
    };
    // a consumer warp is done with a stage / has written its part of the
    // intermediate (in every CTA of the cluster)
    auto release = [&](uint32_t bar) {
      __syncwarp();
      mbar_arrive(bar, lane == 0);
    };
    auto announce = [&](int b) {
      fence_proxy_async();
      __syncwarp();
      if (C::CL == 1)
        mbar_arrive(midf0 + 8 * b, lane == 0);
      else
#pragma unroll
        for (int d = 0; d < C::CL; ++d)
          mbar_arrive_cluster(midf0 + 8 * b, d, lane == 0);
    };

    float acc2[C::M2W][C::N2W / 2];
#pragma unroll
    for (int mm = 0; mm < C::M2W; ++mm)
#pragma unroll
      for (int e = 0; e < C::N2W / 2; ++e) acc2[mm][e] = 0.f;
    constexpr int N1T = C::CIN1 ? 8 : C::N1;    // conv1's wgmma N
    float acc1[C::CIN1 ? 1 : C::M1W][N1T / 2];

    if (C::CIN1 || n_i == 1) {
      stage_input(0);
      named_sync(1, C::NC);
    }
    for (int s = 0; s < n_stages; ++s) {
      const int slot = s % C::NST, j = s / per_j, r = s % per_j, b = j & 1;
      const uint32_t stage = sbase + L::RING + slot * L::SLOT;
      T* mid = reinterpret_cast<T*>(smem + L::MID + b * L::MID_BUF);
      if (r < n_i * C::G) {             // never with Cin == 1 (n_i = 0)
        if constexpr (!C::CIN1) {
          // conv1: this CTA's N1 channels of chunk j, over Cin chunk i
          const int i = r / C::G, tg = r % C::G;
          if (n_i > 1 && tg == 0) {
            named_sync(1, C::NC);       // every warpgroup is done with it
            stage_input(i);
            named_sync(1, C::NC);
          }
          if (i == 0 && tg == 0) {
#pragma unroll
            for (int mm = 0; mm < C::M1W; ++mm)
#pragma unroll
              for (int e = 0; e < C::N1 / 2; ++e) acc1[mm][e] = 0.f;
          }
          const int k = min(cinc, cinp - i * cinc);
          mbar_wait<false>(full0 + 8 * slot, (s / C::NST) & 1);
          stage_mma<C, N1T>(acc1, in_s, wg, C::NWG, C::M1T,
                            smem_u32(in_s), C::NPOS, k * C::NPOS * E::ES,
                            tg * C::TG, k, stage, C::N1, 0);
          release(empty0 + 8 * slot);
          if (i == n_i - 1 && tg == C::G - 1) {
            // conv1's chunk is complete: bias + relu + round to the
            // element type, from the accumulator registers into the
            // intermediate of every CTA of the cluster
#pragma unroll
            for (int mm = 0; mm < C::M1W; ++mm) {
              const int mt = wg + mm * C::NWG;
              if (mt >= C::M1T) continue;
              const int row = mt * 64 + row_w;
#pragma unroll
              for (int nb = 0; nb < C::N1 / 8; ++nb) {
                const int n = rank * C::N1 + nb * 8 + 2 * t4;
                const int gc1 = j * C::CH + n;
                const float bias0 = gc1 < c1 ? to_float(b1[gc1]) : 0.f;
                const float bias1 =
                    gc1 + 1 < c1 ? to_float(b1[gc1 + 1]) : 0.f;
                const float* a = &acc1[mm][nb * 4];
                // (n / VEC, row, n % VEC) and 8 rows below
                T* p0 = mid + ((n / VEC) * C::M1 + row) * VEC + n % VEC;
                T* p1 = p0 + 8 * VEC;
                const float v00 = fmaxf(a[0] + bias0, 0.f);
                const float v01 = fmaxf(a[1] + bias1, 0.f);
                const float v10 = fmaxf(a[2] + bias0, 0.f);
                const float v11 = fmaxf(a[3] + bias1, 0.f);
                if (C::CL == 1) {
                  put_pair(p0, MID_PLANE, v00, v01);
                  put_pair(p1, MID_PLANE, v10, v11);
                } else {
#pragma unroll
                  for (int d = 0; d < C::CL; ++d) {
                    put_pair_cluster(p0, mapa(smem_u32(p0), d), MID_PLANE,
                                     v00, v01);
                    put_pair_cluster(p1, mapa(smem_u32(p1), d), MID_PLANE,
                                     v10, v11);
                  }
                }
              }
            }
            announce(b);
          }
        }
      } else {
        const int tg = r - n_i * C::G;
        if (tg == 0) {
          if constexpr (C::CIN1) {
            // conv1 of this chunk on the CUDA cores (9 FMAs a value)
            float* w1s = reinterpret_cast<float*>(smem + L::W1S);
            named_sync(1, C::NC);       // every warp is done with w1s
            for (int idx = tid; idx < 10 * C::CH; idx += C::NC) {
              const int t = idx / C::CH, c = idx % C::CH, gc1 = j * C::CH + c;
              w1s[idx] = t < 9 ? to_float(w1p[(size_t)t * c1p + gc1])
                               : (gc1 < c1 ? to_float(b1[gc1]) : 0.f);
            }
            named_sync(1, C::NC);
            constexpr int C8 = C::CH / 8;
            for (int idx = tid; idx < C::M1 * C8; idx += C::NC) {
              const int qq = idx % C::M1, c0 = (idx / C::M1) * 8;
              float v[8];
#pragma unroll
              for (int e = 0; e < 8; ++e) v[e] = w1s[9 * C::CH + c0 + e];
#pragma unroll
              for (int t = 0; t < 9; ++t) {
                const float xv = to_float(in_s[qq + (t / 3) * P + t % 3]);
                const float4 wa =
                    *reinterpret_cast<const float4*>(w1s + t * C::CH + c0);
                const float4 wb =
                    *reinterpret_cast<const float4*>(w1s + t * C::CH + c0 + 4);
                const float wv[8] = {wa.x, wa.y, wa.z, wa.w,
                                     wb.x, wb.y, wb.z, wb.w};
#pragma unroll
                for (int e = 0; e < 8; ++e) v[e] = fmaf(xv, wv[e], v[e]);
              }
              __align__(16) T r8[8];
#pragma unroll
              for (int e = 0; e < 8; ++e) r8[e] = from_float<T>(fmaxf(v[e], 0.f));
#pragma unroll
              for (int h0 = 0; h0 < 8; h0 += VEC)
                put_vec(mid + (((c0 + h0) / VEC) * C::M1 + qq) * VEC,
                        MID_PLANE, r8 + h0);
            }
            announce(b);
          }
          // chunk j of the intermediate is whole, in this CTA
          mbar_wait<(C::CL > 1)>(midf0 + 8 * b, (j >> 1) & 1);
          fence_proxy_async_shared();
        }
        // conv2: fold this stage's taps into the accumulators (registers)
        mbar_wait<false>(full0 + 8 * slot, (s / C::NST) & 1);
        stage_mma<C, C::N2W>(acc2, mid, wm2, C::WM2, C::M2T, smem_u32(mid),
                             C::M1, MID_PLANE * E::ES, tg * C::TG, C::CH,
                             stage, C::N2, wn2 * C::N2W);
        release(empty0 + 8 * slot);
      }
    }

    // Epilogue, 16 channels at a time: a warpgroup's accumulators -> its
    // scratch (over the dead input tile), [channel][position] -> bias +
    // relu + cast -> NCHW with the lanes along W, masked at the image edge
    // and the wrapped columns.
    float* scr = reinterpret_cast<float*>(smem + L::IN) + wg * 16 * SCR_LD;
    T* yb = y + (size_t)img * c2 * ho * wo;
    const int c2_0 = blockIdx.y * C::C2P + rank * C::N2 + wn2 * C::N2W;
    const int wtid = tid & 127;
#pragma unroll
    for (int mm = 0; mm < C::M2W; ++mm) {
      const int mt = wm2 + mm * C::WM2;
      if (mt >= C::M2T) continue;
#pragma unroll
      for (int ns = 0; ns < C::N2W / 16; ++ns) {
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const float* a = &acc2[mm][(ns * 2 + nb) * 4];
          float* dst = scr + (nb * 8 + 2 * t4) * SCR_LD + row_w;
          dst[0] = a[0];
          dst[SCR_LD] = a[1];
          dst[8] = a[2];
          dst[SCR_LD + 8] = a[3];
        }
        named_sync(2 + wg, 128);
#pragma unroll 2
        for (int it = 0; it < 8; ++it) {
          const int idx = it * 128 + wtid, c = idx >> 6, m = idx & 63;
          const int qq = mt * 64 + m, rr = qq / P, cc = qq % P;
          const int gy = ty0 + rr, gx = tx0 + cc, ch = c2_0 + ns * 16 + c;
          if (rr < C::TH && cc < C::TW && gy < ho && gx < wo && ch < c2)
            yb[((size_t)ch * ho + gy) * wo + gx] = from_float<T>(
                fmaxf(scr[c * SCR_LD + m] + to_float(b2[ch]), 0.f));
        }
        named_sync(2 + wg, 128);
      }
    }
    if (C::CL > 1) cluster_sync();
  }
}

// ---- float32: the persistent kernel ----

// d (64 x N, f32, this warpgroup's) (+)= a (64 x 8, TF32, in registers) x
// b (8 x N, shared memory through a descriptor).  Lane (g, t) of warp w
// holds a[0..3] = A[16w + g][t], A[16w + g + 8][t], A[16w + g][t + 4],
// A[16w + g + 8][t + 4]; d as in `Wgmma`.
template <int N> struct WgmmaRS;
template <> struct WgmmaRS<16> {
  __device__ __forceinline__ static void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  }
};
template <> struct WgmmaRS<32> {
  __device__ __forceinline__ static void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  }
};
template <> struct WgmmaRS<64> {
  __device__ __forceinline__ static void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  }
};
template <> struct WgmmaRS<128> {
  __device__ __forceinline__ static void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  }
};
template <int N>
__device__ __forceinline__ void fence_regs_u(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// One float32 instantiation: an output tile of TH x TW pixels; NWG
// consumer warpgroups; conv1 in blocks of NB channels a CTA (CL * NB a
// cluster: NB is conv1's wgmma N), each folded into conv2 as sub-chunks
// of CH channels; C2P (padded) output channels for a cluster of CL CTAs;
// input channels packed CINC to a weight stage and held CINS at a time in
// shared memory; TG taps a weight stage and NST stages in the ring.  D2:
// conv2's hi*lo products in a partial of their own (conv1's always are).
// CIN1: Cin == 1, conv1 on the CUDA cores.  CH, CINC and D2 fix every
// output's rounding; the rest only the schedule.
template <int TH_, int TW_, int NWG_, int CH_, int NB_, int C2P_, int CL_,
          int CINC_, int CINS_, int TG_, int NST_, int D2_, bool CIN1_>
struct PCfg {
  static constexpr int TH = TH_, TW = TW_, NWG = NWG_, CH = CH_, NB = NB_,
                       C2P = C2P_, CL = CL_, CINC = CINC_, CINS = CINS_,
                       TG = TG_, NST = NST_, G = 9 / TG_;
  static constexpr bool D2 = D2_ != 0, CIN1 = CIN1_, PERSISTENT = true;
  static constexpr int P = TW + 4;
  static constexpr int M2 = round_up(TH * P, 64), M2T = M2 / 64;
  static constexpr int M1 = round_up(M2 + 2 * P + 2, CIN1 ? 8 : 64);
  static constexpr int M1T = M1 / 64;
  static constexpr int NPOS = M1 + 2 * P + 2;
  // consumers + one producer warpgroup (one thread of it copies; the
  // rest give their registers to the consumers with setmaxnreg)
  static constexpr int NC = NWG * 128, NT = NC + 128;
  static constexpr int REG_PRODUCER = 40;
  static constexpr int REG_CONSUMER =
      imin(((65536 - 128 * REG_PRODUCER) / NC) / 8 * 8, 240);
  static constexpr int CH1 = NB * CL, N2 = C2P / CL;
  static constexpr int WM2 = M2T < NWG ? M2T : NWG, WN2 = NWG / WM2;
  static constexpr int N2W = N2 / WN2, M2W = ceil_div(M2T, WM2);
  static constexpr int M1W = ceil_div(M1T, NWG);
  static_assert(TG == 1 || TG == 3 || TG == 9, "taps per weight stage");
  static_assert(CL == 1 || CL == 2 || CL == 4, "cluster size");
  static_assert(CH % 8 == 0 && CH1 % CH == 0, "conv2's sub-chunks");
  static_assert(CIN1 || NB == 16 || NB == 32 || NB == 64 || NB == 128,
                "conv1's wgmma N");
  static_assert(NWG % WM2 == 0 &&
                    (N2W == 16 || N2W == 32 || N2W == 64 || N2W == 128),
                "conv2's wgmma N");
  static_assert(!CIN1 || (CL == 1 && CH1 % 8 == 0), "Cin == 1");
  static_assert(CIN1 || CINS % CINC == 0, "staged Cin chunks");
  static_assert(NWG >= 1 && NWG <= 3, "warpgroups");
};

// Shared memory of a persistent block: every operand in one plane of
// float32 (the TF32 split is made in registers), the input held CINS
// channels at a time, the intermediate's blocks in MIDB buffers (the
// epilogue's scratch lies over the last one, dead by then).
template <class C> struct PSmem {
  static constexpr int SLOT = round_up(
      C::TG * 2 * 4 * imax(C::CIN1 ? 0 : C::CINC * C::NB, C::CH * C::N2),
      1024);
  static constexpr int RING = 0;
  static constexpr int IN = C::NST * SLOT;
  static constexpr int IN_BYTES =
      round_up(C::NPOS * (C::CIN1 ? 1 : C::CINS) * 4, 128);
  static constexpr int MID = IN + IN_BYTES;
  static constexpr int MID_BUF = round_up(C::M1 * C::CH1 * 4, 128);
  static constexpr int NBAR = 2 * C::NST + 3;
  static constexpr int REST = round_up(NBAR * 8, 128) +
                              (C::CIN1 ? 10 * C::CH1 * 4 : 0) + 1024;
  // two buffers of the intermediate where they fit, else one that the
  // next block waits to write until every consumer is done with it
  static constexpr int MIDB = MID + 2 * MID_BUF + REST <= SMEM_LIMIT ? 2 : 1;
  static constexpr int BAR = MID + MIDB * MID_BUF;
  static constexpr int W1S = BAR + round_up(NBAR * 8, 128);
  static constexpr int END = W1S + (C::CIN1 ? 10 * C::CH1 * 4 : 0);
  static constexpr int TOTAL = END + 1024;
  static_assert(TOTAL <= SMEM_LIMIT, "shared memory of a block");
  static_assert(C::CIN1 || C::CINC == 16 || C::CINC % 32 == 0,
                "Cin chunks are whole swizzle rows");
  static_assert(MID_BUF >= C::NWG * 16 * SCR_LD * 4, "epilogue scratch");
};

// The float32 products of one weight stage with A from registers:
// acc[mm] (tiles mt0 + mm * mstep < mtn, N columns) += the products of the
// stage's TG taps from tap0 over the k channels of each.  `a` is a float32
// array [channel / 4][`rows` positions][4]; a tap shifts it by whole
// positions.  Each k-step loads the lane's four values and splits them into
// TF32 hi and lo (the bits the two-plane kernel stored); its three products
// (lo*hi, hi*lo, hi*hi: the lo*lo term is below float32's rounding) go to
// partial accumulators that join acc by float32 adds (rounded to nearest)
// in k-step order.  The tensor cores round their own adds with a bias
// toward smaller values that grows with the products chained (one k-step:
// -7e-9 to -1.6e-8 of the output scale, `scripts/k2_numerics.py` on an
// H100), and a bias moves every activation near zero the same way, which
// the encoder's gradient through 0.5 / sqrt(x2 + 1e-8) amplifies.  DUAL
// keeps hi*lo in a partial of its own, added to lo*hi + hi*hi first: which
// products share a partial fixes every output's rounding, and with it the
// training step's card-vs-CPU check at the published epsilon (`PCfg::D2`).
// The next k-step's values are read before the wait on this one; two sets
// of partials in flight ran slower than one.
template <class C, int N, int MW, bool DUAL>
__device__ __forceinline__ void stage_mma_rs(float (&acc)[MW][N / 2],
                                             const float* a, int rows,
                                             int mt0, int mstep, int mtn,
                                             int tap0, int k, uint32_t stage,
                                             int n_img, int n0) {
  constexpr int H = DUAL ? 2 : 1;
  const int ksteps = k / 8;
  const BWalk bw = b_walk<float>(stage, k, n_img, n0);
  // tile [mm]: [0] hi*lo (and, unless DUAL, the others), [H-1] lo*hi +
  // hi*hi; fragments [0] hi, [1] lo
  float p[MW][H][N / 2];
  uint32_t f[MW][2][4];
#pragma unroll
  for (int mm = 0; mm < MW; ++mm) {
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) p[mm][h][e] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) f[mm][0][e] = f[mm][1][e] = 0u;
  }
  // the k-step in flight is done: add its partials to acc
  auto add = [&]() {
    wgmma_wait<0>();
#pragma unroll
    for (int mm = 0; mm < MW; ++mm) {
#pragma unroll
      for (int h = 0; h < H; ++h) fence_regs(p[mm][h]);
      fence_regs_u(f[mm][0]);       // the fragments are free only now
      fence_regs_u(f[mm][1]);
      if (mt0 + mm * mstep >= mtn) continue;
#pragma unroll
      for (int e = 0; e < N / 2; ++e)
        acc[mm][e] += DUAL ? p[mm][0][e] + p[mm][H - 1][e] : p[mm][0][e];
    }
  };
  bool live = false;            // a k-step is in flight
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
  a += (16 * w4 + (lane >> 2)) * 4 + (lane & 3);    // the lane's element
#pragma unroll 1
  for (int u = 0; u < C::TG; ++u) {
    const int tap = tap0 + u;
    const int shift = (tap / 3) * C::P + tap % 3;
    const float* ap[MW];
#pragma unroll
    for (int mm = 0; mm < MW; ++mm)
      ap[mm] = a + ((mt0 + mm * mstep) * 64 + shift) * 4;
    uint64_t b_hi = bw.desc + u * bw.tap;
    int col = 0;
    for (int kk = 0; kk < ksteps; ++kk) {
      // this k-step's channels kk * 8 + {t, t + 4} at the lane's rows
      float v[MW][4];
#pragma unroll
      for (int mm = 0; mm < MW; ++mm) {
        if (mt0 + mm * mstep >= mtn) continue;
        v[mm][0] = ap[mm][0];
        v[mm][1] = ap[mm][32];
        v[mm][2] = ap[mm][rows * 4];
        v[mm][3] = ap[mm][rows * 4 + 32];
        ap[mm] += 2 * rows * 4;
      }
      if (live) add();
#pragma unroll
      for (int mm = 0; mm < MW; ++mm) {
        if (mt0 + mm * mstep < mtn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            f[mm][0][e] = to_tf32(v[mm][e]);
            f[mm][1][e] = to_tf32(v[mm][e] - __uint_as_float(f[mm][0][e]));
          }
        }
#pragma unroll
        for (int h = 0; h < H; ++h) fence_regs(p[mm][h]);
        fence_regs_u(f[mm][0]);
        fence_regs_u(f[mm][1]);
      }
      wgmma_fence();
      const uint64_t b_lo = b_hi + bw.plane;
#pragma unroll
      for (int mm = 0; mm < MW; ++mm) {
        if (mt0 + mm * mstep >= mtn) continue;
        WgmmaRS<N>::mma(p[mm][H - 1], f[mm][1], b_hi, 0);
        WgmmaRS<N>::mma(p[mm][0], f[mm][0], b_lo, DUAL ? 0 : 1);
        WgmmaRS<N>::mma(p[mm][H - 1], f[mm][0], b_hi, 1);
      }
      wgmma_commit();
      live = true;
      if (++col == bw.row_steps) {     // the next k-step's weights
        col = 0;
        b_hi += bw.blk - (bw.row_steps - 1) * 2;
      } else {
        b_hi += 2;
      }
    }
  }
  add();
}

// The input tile at (ty0, tx0) of image `xb` with its halo, [channel / 4]
// [position][4] from channel c0 (`nc` channels), zero beyond the image,
// below the tile's rows and in the padded channels: thread t of nt, the
// global reads along W.
template <class C>
__device__ __forceinline__ void stage_tile(float* in_s, const float* xb,
                                           int ty0, int tx0, int c0, int nc,
                                           int cin, int h, int w, int t,
                                           int nt) {
  constexpr int P = C::P;
  if constexpr (C::CIN1) {
    for (int pos = t; pos < C::NPOS; pos += nt) {
      const int gy = ty0 + pos / P, gx = tx0 + pos % P;
      in_s[pos] = (pos < (C::TH + 4) * P && gy < h && gx < w)
                      ? xb[(size_t)gy * w + gx]
                      : 0.f;
    }
  } else {
    const int cvn = nc / 4;
#pragma unroll 2
    for (int idx = t; idx < cvn * C::NPOS; idx += nt) {
      const int cv = idx / C::NPOS, pos = idx % C::NPOS;
      const int gy = ty0 + pos / P, gx = tx0 + pos % P;
      const int ci = c0 + cv * 4;
      const bool in = pos < (C::TH + 4) * P && gy < h && gx < w;
      const float* src = xb + ((size_t)ci * h + gy) * w + gx;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = (in && ci + e < cin) ? src[(size_t)e * h * w] : 0.f;
      *reinterpret_cast<float4*>(in_s + (cv * C::NPOS + pos) * 4) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The float32 kernel: persistent CTAs (clusters), each walking the work
// items (image, C2 pass, tile) from its index in steps of the grid, so
// that the weight ring streams on from one item into the next and each
// CTA is set up once.  The products and their order are those of the
// two-plane kernel; see the design note at the head of the file.
template <class C>
__global__ void __launch_bounds__(C::NT, 1)
double_conv3x3_persistent_kernel(
    const float* __restrict__ x, const float* __restrict__ w1p,
    const float* __restrict__ b1, const float* __restrict__ w2p,
    const float* __restrict__ b2, float* __restrict__ y, int batch, int cin,
    int h, int w, int c1, int c2, int cinp, int c1p, int cinc, int tiles_x,
    int tiles, int passes) {
  using L = PSmem<C>;
  constexpr int P = C::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  float* in_s = reinterpret_cast<float*>(smem + L::IN);

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int rank = C::CL > 1 ? cluster_rank() : 0;
  const int first = blockIdx.x / C::CL, step = gridDim.x / C::CL;
  const int n_items = batch * passes * tiles;
  const int ho = h - 4, wo = w - 4;
  const int n_i = C::CIN1 ? 0 : ceil_div(cinp, cinc);      // Cin chunks
  // the whole input tile stays in shared memory for the item
  const bool resident = !C::CIN1 && cinp <= C::CINS;
  const int n_b = c1p / C::CH1, n_j = c1p / C::CH;          // conv1 blocks
  constexpr int SUB = C::CH1 / C::CH;        // conv2's sub-chunks a block
  const int per_b = (n_i + SUB) * C::G;      // weight stages of a block
  const uint32_t full0 = sbase + L::BAR, empty0 = full0 + 8 * C::NST;
  const uint32_t midf0 = empty0 + 8 * C::NST;    // intermediate written
  const uint32_t mide = midf0 + 16;       // one buffer: every read is done
  constexpr int MIDB = L::MIDB;

  if (tid == 0) {
    for (int i = 0; i < C::NST; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, C::NC / 32);
    }
    mbar_init(midf0, C::CL * C::NC / 32);
    mbar_init(midf0 + 8, C::CL * C::NC / 32);
    mbar_init(mide, C::CL * C::NC / 32);
    mbar_fence_init();
  }
  if (C::CL > 1)
    cluster_sync();
  else
    __syncthreads();

  if (warp >= C::NC / 32) {
    // The producer: for each item, each block's conv1 stages ([Cin
    // chunk][tap group]) then its conv2 stages ([sub-chunk][tap group]),
    // each one contiguous block of the packed weights.  The two roles
    // never reconverge (setmaxnreg needs that).
    setmaxnreg_dec<C::REG_PRODUCER>();
    if (warp == C::NC / 32 && lane == 0) {
      int s = 0;
      for (int item = first; item < n_items; item += step) {
        const int pass = (item / tiles) % passes;
        for (int jb = 0; jb < n_b; ++jb)
          for (int r = 0; r < per_b; ++r, ++s) {
            const int slot = s % C::NST;
            if (s >= C::NST)
              mbar_wait<false>(empty0 + 8 * slot, (s / C::NST - 1) & 1);
            const float* src;
            int elems;
            if (r < n_i * C::G) {
              const int i = r / C::G, tap = (r % C::G) * C::TG;
              const int k = min(cinc, cinp - i * cinc);
              src = w1p + ((size_t)(jb * C::CL + rank) * 9 * cinp +
                           9 * i * cinc + tap * k) * 2 * C::NB;
              elems = C::TG * k * 2 * C::NB;
            } else {
              const int rr = r - n_i * C::G, j = jb * SUB + rr / C::G;
              const int tap = (rr % C::G) * C::TG;
              src = w2p + ((size_t)((pass * n_j + j) * C::CL + rank) * 9 +
                           tap) * C::CH * 2 * C::N2;
              elems = C::TG * C::CH * 2 * C::N2;
            }
            mbar_expect_tx(full0 + 8 * slot, elems * 4);
            bulk_copy(sbase + L::RING + slot * L::SLOT, src, elems * 4,
                      full0 + 8 * slot);
          }
      }
    }
    if (C::CL > 1) cluster_sync();
    return;
  }

  setmaxnreg_inc<C::REG_CONSUMER>();
  const int wg = warp >> 2;                  // the consumer warpgroup
  const int g = lane >> 2, t4 = lane & 3;    // a lane's place in a tile
  const int row_w = (warp & 3) * 16 + g;     // its first row in a tile
  const int wm2 = wg % C::WM2, wn2 = wg / C::WM2;
  constexpr int N1T = C::CIN1 ? 16 : C::NB;
  float acc1[C::CIN1 ? 1 : C::M1W][N1T / 2];
  int s = 0, jbg = 0;                        // stages and blocks so far

  auto release = [&](uint32_t bar) {
    __syncwarp();
    mbar_arrive(bar, lane == 0);
  };
  // this warp has written its part of the intermediate / read all of it,
  // in every CTA of the cluster
  auto announce = [&](uint32_t bar) {
    __syncwarp();
    if (C::CL == 1)
      mbar_arrive(bar, lane == 0);
    else
#pragma unroll
      for (int d = 0; d < C::CL; ++d)
        mbar_arrive_cluster(bar, d, lane == 0);
  };
  // with one buffer, block jbg is written once block jbg - 1 is read
  auto wait_free = [&]() {
    if (MIDB == 1 && jbg > 0)
      mbar_wait<(C::CL > 1)>(mide, (jbg - 1) & 1);
  };

  for (int item = first, n = 0; item < n_items; item += step, ++n) {
    const int img = item / (passes * tiles), pass = (item / tiles) % passes;
    const int tile = item % tiles;
    const int ty0 = (tile / tiles_x) * C::TH, tx0 = (tile % tiles_x) * C::TW;
    const float* xb = x + (size_t)img * cin * h * w;

    float acc2[C::M2W][C::N2W / 2];
#pragma unroll
    for (int mm = 0; mm < C::M2W; ++mm)
#pragma unroll
      for (int e = 0; e < C::N2W / 2; ++e) acc2[mm][e] = 0.f;
    // the whole input tile, while the other warpgroups may still be in
    // the previous item's last conv2 stages or epilogue
    if (C::CIN1 || resident) {
      stage_tile<C>(in_s, xb, ty0, tx0, 0, C::CIN1 ? 1 : cinp, cin, h, w,
                    tid, C::NC);
      named_sync(1, C::NC);
    }
    for (int jb = 0; jb < n_b; ++jb, ++jbg) {
      const int b = jbg % MIDB;
      float* mid = reinterpret_cast<float*>(smem + L::MID + b * L::MID_BUF);
      if constexpr (!C::CIN1) {
        // conv1: this CTA's NB channels of block jb, over every Cin chunk
#pragma unroll
        for (int mm = 0; mm < C::M1W; ++mm)
#pragma unroll
          for (int e = 0; e < C::NB / 2; ++e) acc1[mm][e] = 0.f;
        for (int i = 0; i < n_i; ++i) {
          if (!resident) {
            named_sync(1, C::NC);       // every warpgroup is done with it
            stage_tile<C>(in_s, xb, ty0, tx0, i * cinc,
                          min(cinc, cinp - i * cinc), cin, h, w, tid, C::NC);
            named_sync(1, C::NC);
          }
          const int k = min(cinc, cinp - i * cinc);
          const float* a =
              in_s + (resident ? i * cinc * C::NPOS : 0);
          for (int tg = 0; tg < C::G; ++tg, ++s) {
            const int slot = s % C::NST;
            mbar_wait<false>(full0 + 8 * slot, (s / C::NST) & 1);
            stage_mma_rs<C, C::NB, C::M1W, true>(
                acc1, a, C::NPOS, wg, C::NWG, C::M1T, tg * C::TG, k,
                sbase + L::RING + slot * L::SLOT, C::NB, 0);
            release(empty0 + 8 * slot);
          }
        }
        // bias + relu, from the accumulator registers into the block of
        // the intermediate of every CTA of the cluster
        wait_free();
#pragma unroll
        for (int mm = 0; mm < C::M1W; ++mm) {
          const int mt = wg + mm * C::NWG;
          if (mt >= C::M1T) continue;
          const int row = mt * 64 + row_w;
#pragma unroll
          for (int nb = 0; nb < C::NB / 8; ++nb) {
            const int n = rank * C::NB + nb * 8 + 2 * t4;
            const int gc1 = jb * C::CH1 + n;
            const float bias0 = gc1 < c1 ? b1[gc1] : 0.f;
            const float bias1 = gc1 + 1 < c1 ? b1[gc1 + 1] : 0.f;
            const float* av = &acc1[mm][nb * 4];
            float* p0 = mid + ((n / 4) * C::M1 + row) * 4 + n % 4;
            float* p1 = p0 + 8 * 4;
            const float2 v0 = make_float2(fmaxf(av[0] + bias0, 0.f),
                                          fmaxf(av[1] + bias1, 0.f));
            const float2 v1 = make_float2(fmaxf(av[2] + bias0, 0.f),
                                          fmaxf(av[3] + bias1, 0.f));
            if (C::CL == 1) {
              *reinterpret_cast<float2*>(p0) = v0;
              *reinterpret_cast<float2*>(p1) = v1;
            } else {
#pragma unroll
              for (int d = 0; d < C::CL; ++d) {
                asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n"
                             ::"r"(mapa(smem_u32(p0), d)), "f"(v0.x),
                             "f"(v0.y)
                             : "memory");
                asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n"
                             ::"r"(mapa(smem_u32(p1), d)), "f"(v1.x),
                             "f"(v1.y)
                             : "memory");
              }
            }
          }
        }
        announce(midf0 + 8 * b);
      } else {
        // conv1 of this block on the CUDA cores (9 FMAs a value)
        float* w1s = reinterpret_cast<float*>(smem + L::W1S);
        named_sync(1, C::NC);           // every warp is done with w1s
        for (int idx = tid; idx < 10 * C::CH1; idx += C::NC) {
          const int t = idx / C::CH1, c = idx % C::CH1;
          const int gc1 = jb * C::CH1 + c;
          w1s[idx] = t < 9 ? w1p[(size_t)t * c1p + gc1]
                           : (gc1 < c1 ? b1[gc1] : 0.f);
        }
        named_sync(1, C::NC);
        wait_free();
        constexpr int C8 = C::CH1 / 8;
        for (int idx = tid; idx < C::M1 * C8; idx += C::NC) {
          const int qq = idx % C::M1, c0 = (idx / C::M1) * 8;
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = w1s[9 * C::CH1 + c0 + e];
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            const float xv = in_s[qq + (t / 3) * P + t % 3];
            const float4 wa =
                *reinterpret_cast<const float4*>(w1s + t * C::CH1 + c0);
            const float4 wb =
                *reinterpret_cast<const float4*>(w1s + t * C::CH1 + c0 + 4);
            const float wv[8] = {wa.x, wa.y, wa.z, wa.w,
                                 wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = fmaf(xv, wv[e], v[e]);
          }
          *reinterpret_cast<float4*>(mid + ((c0 / 4) * C::M1 + qq) * 4) =
              make_float4(fmaxf(v[0], 0.f), fmaxf(v[1], 0.f),
                          fmaxf(v[2], 0.f), fmaxf(v[3], 0.f));
          *reinterpret_cast<float4*>(mid + ((c0 / 4 + 1) * C::M1 + qq) * 4) =
              make_float4(fmaxf(v[4], 0.f), fmaxf(v[5], 0.f),
                          fmaxf(v[6], 0.f), fmaxf(v[7], 0.f));
        }
        announce(midf0 + 8 * b);
      }
      // block jb of the intermediate is whole, in this CTA
      mbar_wait<(C::CL > 1)>(midf0 + 8 * b, (jbg / MIDB) & 1);
      // conv2: fold its sub-chunks into the accumulators (registers), in
      // the order of the C1 chunks
      for (int jj = 0; jj < SUB; ++jj)
        for (int tg = 0; tg < C::G; ++tg, ++s) {
          const int slot = s % C::NST;
          mbar_wait<false>(full0 + 8 * slot, (s / C::NST) & 1);
          stage_mma_rs<C, C::N2W, C::M2W, C::D2>(
              acc2, mid + jj * C::CH * C::M1, C::M1, wm2, C::WM2,
              C::M2T, tg * C::TG, C::CH, sbase + L::RING + slot * L::SLOT,
              C::N2, wn2 * C::N2W);
          release(empty0 + 8 * slot);
        }
      if (MIDB == 1 && jb < n_b - 1) announce(mide);
    }

    // Epilogue, 16 channels at a time: a warpgroup's accumulators -> its
    // scratch (over the last block of the intermediate, dead once every
    // warpgroup is done with it), [channel][position] -> bias + relu ->
    // NCHW with the lanes along W, masked at the image edge and the
    // wrapped columns.
    named_sync(1, C::NC);
    float* scr = reinterpret_cast<float*>(
                     smem + L::MID + (jbg - 1) % MIDB * L::MID_BUF) +
                 wg * 16 * SCR_LD;
    float* yb = y + (size_t)img * c2 * ho * wo;
    const int c2_0 = pass * C::C2P + rank * C::N2 + wn2 * C::N2W;
    const int wtid = tid & 127;
#pragma unroll
    for (int mm = 0; mm < C::M2W; ++mm) {
      const int mt = wm2 + mm * C::WM2;
      if (mt >= C::M2T) continue;
#pragma unroll
      for (int ns = 0; ns < C::N2W / 16; ++ns) {
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const float* av = &acc2[mm][(ns * 2 + nb) * 4];
          float* dst = scr + (nb * 8 + 2 * t4) * SCR_LD + row_w;
          dst[0] = av[0];
          dst[SCR_LD] = av[1];
          dst[8] = av[2];
          dst[SCR_LD + 8] = av[3];
        }
        named_sync(2 + wg, 128);
#pragma unroll 2
        for (int it = 0; it < 8; ++it) {
          const int idx = it * 128 + wtid, c = idx >> 6, m = idx & 63;
          const int qq = mt * 64 + m, rr = qq / P, cc = qq % P;
          const int gy = ty0 + rr, gx = tx0 + cc, ch = c2_0 + ns * 16 + c;
          if (rr < C::TH && cc < C::TW && gy < ho && gx < wo && ch < c2)
            yb[((size_t)ch * ho + gy) * wo + gx] =
                fmaxf(scr[c * SCR_LD + m] + b2[ch], 0.f);
        }
        named_sync(2 + wg, 128);
      }
    }
    if (MIDB == 1) announce(mide);     // the scratch is free
  }
  if (C::CL > 1) cluster_sync();
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

template <class C, typename T>
int launch(const void* x, const void* w1p, const void* b1, const void* w2p,
           const void* b2, void* y, int batch, int cin, int h, int w, int c1,
           int c2, int c2p, cudaStream_t stream) {
  const Plan p = make_plan<C, T>(cin, c1, c2p);
  auto kernel = double_conv3x3_wgmma_kernel<C, T>;
  constexpr int smem = Smem<C, T>::TOTAL;
  // per card: set under the tensor's card by the wrapper
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = ceil_div(w - 4, C::TW);
  const int tiles_y = ceil_div(h - 4, C::TH);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_x * tiles_y * C::CL, c2p / C::C2P, batch);
  cfg.blockDim = dim3(C::NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C::CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C::CL > 1 ? 1 : 0;
  if (C::CL > 1) {
    // a cluster that cannot be resident anywhere would never launch
    static bool checked[64];
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= 64 || !checked[dev]) {
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (clusters == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
      if (dev < 64) checked[dev] = true;
    }
  }
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                           static_cast<const T*>(w1p),
                           static_cast<const T*>(b1),
                           static_cast<const T*>(w2p),
                           static_cast<const T*>(b2), static_cast<T*>(y), cin,
                           h, w, c1, c2, p.cinp, p.c1p, p.cinc, tiles_x);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The persistent float32 kernel: as many CTAs (clusters) as are resident
// at once, at most one a work item.
template <class C>
int launch_persistent(const void* x, const void* w1p, const void* b1,
                      const void* w2p, const void* b2, void* y, int batch,
                      int cin, int h, int w, int c1, int c2, int c2p,
                      cudaStream_t stream) {
  const Plan p = make_plan<C, float>(cin, c1, c2p);
  auto kernel = double_conv3x3_persistent_kernel<C>;
  constexpr int smem = PSmem<C>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = ceil_div(w - 4, C::TW);
  const int tiles = tiles_x * ceil_div(h - 4, C::TH);
  const int passes = c2p / C::C2P;
  const long long items = (long long)batch * passes * tiles;
  if (items > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C::CL, 1, 1);
  cfg.blockDim = dim3(C::NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C::CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C::CL > 1 ? 1 : 0;
  // CTAs (clusters) resident at once on this card, found once per card
  static int resident[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int fit = dev < 64 ? resident[dev] : 0;
  if (fit == 0) {
    if (C::CL > 1) {
      err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    } else {
      int per_sm = 0, sms = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          C::NT, smem);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      fit = per_sm * sms;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fit == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (dev < 64) resident[dev] = fit;
  }
  cfg.gridDim = dim3((int)(items < fit ? items : fit) * C::CL, 1, 1);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(x),
                           static_cast<const float*>(w1p),
                           static_cast<const float*>(b1),
                           static_cast<const float*>(w2p),
                           static_cast<const float*>(b2),
                           static_cast<float*>(y), batch, cin, h, w, c1, c2,
                           p.cinp, p.c1p, p.cinc, tiles_x, tiles, passes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The instantiations, one per element type and output-channel width, the
// fastest of those timed with `scripts/k2_tune.py` on an H100 80GB HBM3.
// Tile shapes follow the U-Net's cells (outputs of 252, 122, 57 and 24
// pixels a side).  bfloat16: 12 x 28 = 336 of 384 positions (inc), 7 x 31
// with whole 9-tap stages (down0), 2 whole rows of 57 (down1), 2 whole rows
// of 24 with a cluster of 2 and 128-channel chunks (down2: 12 tiles x 2
// CTAs an image, so that B = 8 gives 192 CTAs for 132 SMs).  float32 (the
// persistent kernel): 12 x 28 and 5 x 31 over three warpgroups (inc,
// down0: a 64-row conv2 tile each; conv1 N = 16, as a wider block does not
// fit their 152 registers), 2 whole rows of 57 with conv1 blocks of 32
// (down1: two 64-row conv1 tiles a warpgroup, where 5 x 19 gave one
// warpgroup two and the other one and ran 13% slower), 2 x 24 with a
// cluster of 2, conv1 blocks of 64 a CTA and the whole 128-channel input
// resident (down2).  Its CH (16, down2 32), CINC (the Cin chunk of a
// weight stage) and D2 (down1 0, the rest 1) are those of the two-plane
// kernel it replaced and fix the order of every output's sum, which the
// training step's card-vs-CPU check at the published epsilon is sensitive
// to; the other fields only schedule.  A build may override a shape with a
// `#define UNCLTMO_K2_CFG64 ...` in a force-included header
// (`scripts/k2_tune.py` times such variants).
//      TH, TW, NWG, CH, C2P, CL, CINC, TG, NST
#ifndef UNCLTMO_K2_CFGINC
#define UNCLTMO_K2_CFGINC 12, 28, 2, 32, 32, 1, 64, 9, 2
#endif
#ifndef UNCLTMO_K2_CFG32
#define UNCLTMO_K2_CFG32 12, 28, 2, 32, 32, 1, 64, 3, 3
#endif
#ifndef UNCLTMO_K2_CFG64
#define UNCLTMO_K2_CFG64 7, 31, 2, 32, 64, 1, 64, 9, 2
#endif
#ifndef UNCLTMO_K2_CFG128
#define UNCLTMO_K2_CFG128 2, 57, 2, 32, 128, 1, 64, 3, 3
#endif
#ifndef UNCLTMO_K2_CFG256
#define UNCLTMO_K2_CFG256 2, 24, 2, 128, 256, 2, 128, 1, 3
#endif
//      TH, TW, NWG, CH, NB, C2P, CL, CINC, CINS, TG, NST, D2
#ifndef UNCLTMO_K2F_CFGINC
#define UNCLTMO_K2F_CFGINC 12, 28, 3, 16, 16, 32, 1, 32, 32, 3, 3, 1
#endif
#ifndef UNCLTMO_K2F_CFG32
#define UNCLTMO_K2F_CFG32 4, 28, 2, 16, 16, 32, 1, 32, 32, 1, 4, 1
#endif
#ifndef UNCLTMO_K2F_CFG64
#define UNCLTMO_K2F_CFG64 5, 31, 3, 16, 16, 64, 1, 32, 32, 3, 3, 1
#endif
#ifndef UNCLTMO_K2F_CFG128
#define UNCLTMO_K2F_CFG128 2, 57, 2, 16, 32, 128, 1, 64, 64, 3, 2, 0
#endif
#ifndef UNCLTMO_K2F_CFG256
#define UNCLTMO_K2F_CFG256 2, 24, 2, 32, 64, 256, 2, 64, 128, 1, 2, 1
#endif
template <typename T> struct Cfgs;
template <> struct Cfgs<bf16> {
  using Inc = Cfg<UNCLTMO_K2_CFGINC, true>;      // inc: 1 -> 32 -> 32
  using C32 = Cfg<UNCLTMO_K2_CFG32, false>;
  using C64 = Cfg<UNCLTMO_K2_CFG64, false>;      // down0: 32 -> 64 -> 64
  using C128 = Cfg<UNCLTMO_K2_CFG128, false>;    // down1: 64 -> 128 -> 128
  using C256 = Cfg<UNCLTMO_K2_CFG256, false>;    // down2: 128 -> 256 -> 256
};
template <> struct Cfgs<float> {
  using Inc = PCfg<UNCLTMO_K2F_CFGINC, true>;
  using C32 = PCfg<UNCLTMO_K2F_CFG32, false>;
  using C64 = PCfg<UNCLTMO_K2F_CFG64, false>;
  using C128 = PCfg<UNCLTMO_K2F_CFG128, false>;
  using C256 = PCfg<UNCLTMO_K2F_CFG256, false>;
};

// C2 padded to the output-channel width of a configuration: 32, 64, 128 or
// a multiple of 256 (one pass of the grid's y per 256)
int padded_c2(int c2) {
  return c2 <= 32 ? 32 : c2 <= 64 ? 64 : c2 <= 128 ? 128 : round_up(c2, 256);
}

// Calls `f.template operator()<Cfg>()`-like functor F on the configuration
// that serves (cin, c2p) in element type T.
template <typename T, class F> int with_cfg(int cin, int c2p, F f) {
  if (c2p == 32)
    return cin == 1 ? f(typename Cfgs<T>::Inc()) : f(typename Cfgs<T>::C32());
  if (c2p == 64) return f(typename Cfgs<T>::C64());
  if (c2p == 128) return f(typename Cfgs<T>::C128());
  return f(typename Cfgs<T>::C256());
}

template <typename T>
int dispatch(const void* x, const void* w1p, const void* b1, const void* w2p,
             const void* b2, void* y, int batch, int cin, int h, int w,
             int c1, int c2, cudaStream_t s) {
  const int c2p = padded_c2(c2);
  if (c2p > 256 * 65535) return static_cast<int>(cudaErrorInvalidValue);
  return with_cfg<T>(cin, c2p, [&](auto c) {
    using C = decltype(c);
    if constexpr (C::PERSISTENT)
      return launch_persistent<C>(x, w1p, b1, w2p, b2, y, batch, cin, h, w,
                                  c1, c2, c2p, s);
    else
      return launch<C, T>(x, w1p, b1, w2p, b2, y, batch, cin, h, w, c1, c2,
                          c2p, s);
  });
}

template <typename T> int plan_of(int cin, int c1, int c2, int* out) {
  const int c2p = padded_c2(c2);
  return with_cfg<T>(cin, c2p, [&](auto c) {
    const Plan p = make_plan<decltype(c), T>(cin, c1, c2p);
    const int v[14] = {p.cinp, p.cinc, p.c1p, p.ch,  p.cl,  p.n2,
                       p.c2p,  p.th,   p.tw,  p.tg,  p.nst, p.nwg,
                       p.ch1,  p.persistent};
    for (int i = 0; i < 14; ++i) out[i] = v[i];
    return 0;
  });
}

// A build with -DUNCLTMO_K2_ELEM=0 holds float32 only, =1 bfloat16 only
// (the wrapper builds one library per element type, side by side);
// without it, both.
#ifndef UNCLTMO_K2_ELEM
#define UNCLTMO_K2_ELEM -1
#endif
bool elem_built(int dtype) {
  return (dtype == 0 || dtype == 1) &&
         (UNCLTMO_K2_ELEM < 0 || UNCLTMO_K2_ELEM == dtype);
}

#if UNCLTMO_K2_ELEM != 1
// ---- float32: the decoder's up cell ----
//
// `models/blocks.py:Up` with `square_and_square_root` and doubleConvTranspose
// (relu, no norm) runs, after its 2x2 upsample,
//   y = relu(convT(relu(convT(cat, W1) + b1), W2) + b2),
//   cat = [x2, x1, x2^2, sqrt(x2 + eps)],
// two ConvTranspose2d(k=3, stride 1).  Such a ConvT is a valid 3x3
// convolution over its input zero-padded by 2, with the kernel flipped in
// both axes and its in/out axes swapped: each grows the plane by 2 a side.
// `up_cell_kernel` runs the cell in one persistent, cooperative launch, as
// two phases on the float32 engine above (split-TF32 products with A in
// registers, partials joined into the accumulators by float32 adds, a
// producer thread streaming packed weight stages through an `mbarrier`
// ring):
//  * phase 1: mid = relu(conv(pad2(cat)) + b1), (B, C1, H+2, W+2), written
//    to device memory.  The concat is never built.  Only x2 and x1 are
//    staged, and each staged chunk of x2 serves three blocks of the
//    concat: the A operand is made as it is loaded, x2 as it is, x2 * x2
//    (one float32 multiply) or sqrt.rn(x2 + eps) times a 0/1 mask of the
//    tile's pad, which is zero in the concat (or that root block made
//    once a chunk, where it fits: `UCfg::SQ`), the values K1 writes.  The
//    weights are packed in this order of consumption;
//  * a grid-wide barrier (every CTA is resident: the grid is at most the
//    resident CTAs and the launch is cooperative);
//  * phase 2: y = relu(conv(pad2(mid)) + b2), (B, C2, H+4, W+4).
// What bounds it, measured by ablation on an H100 (`scripts/
// up_cell_tune.py`): the join after every k-step (a wait on the products
// in flight, then N / 2 float32 adds a 64-row tile) took over two thirds
// of the time, register spills most of the rest; staging took 5%.  The
// design answers:
//  * two phases, not K2's intermediate in shared memory: the first ConvT
//    holds 84-96% of a cell's products, and an on-chip intermediate of
//    C1 = 64-128 channels limits a tile to a few rows, so that conv1 would
//    be computed two to three times over its halo and pad on the small
//    planes (up0: 676 useful positions of each 1,792).  One convolution at
//    a time holds the accumulators of one GEMM only, a tile is UNWG * MW
//    64-row wgmma tiles of one pitch P = TW + 2, and `mid` is what the
//    backward needs anyway;
//  * J k-steps chained in the tensor cores' partials before each join
//    (J = 4 at N = 64, 2 at N = 32), each k-step's A fragments kept until
//    the join's wait;
//  * three consumer warpgroups: ptxas reports 128 registers a thread at
//    512 threads (168 at 384) and spills at that count, so N = 64 cells run
//    one 64-row tile a warpgroup and N = 32 cells two, where more spilled;
//    a third warpgroup's products fill the tensor cores while the others
//    join (two warpgroups with more tiles each ran 20-40% slower);
//  * the input tile with a 1-pixel halo staged UK = 32 source channels at
//    a time by `cp.async` with zero fill into two buffers, so that the next
//    chunk (of this item or the next) lands while this one is multiplied,
//    as [channel / 8][position][8] with a lane's two channels t and t + 4
//    adjacent (one 8-byte load).
// A phase's work item is (image, pass of N output channels, tile); the
// producer streams phase 2's first stages while the consumers wait at the
// barrier.

// Input channels a weight stage (one tap of them, 4 k-steps) and a staged
// chunk; consumer warpgroups of a block.
constexpr int UK = 32, UNWG = 3;

// One phase: an output tile of TH x TW pixels, each consumer warpgroup MW
// 64-row tiles of N output channels (the wgmma N).  J: k-steps whose
// products chain in the tensor cores' partials before they join the
// float32 accumulators (1: every k-step, as `stage_mma_rs`); each k-step
// of a chain keeps its own A fragments in registers until the join's wait.
template <int TH_, int TW_, int MW_, int N_, int J_> struct UPhase {
  static constexpr int TH = TH_, TW = TW_, MW = MW_, N = N_, J = J_;
  static constexpr int P = TW + 2;                      // the one pitch
  static_assert(N == 32 || N == 64, "wgmma N");
  static_assert(J == 1 || J == 2 || J == 4, "k-steps a join");
};

// A cell: UNWG consumer warpgroups and a producer warpgroup (one thread of
// it streams the weights), NST weight stages, the two phases.  SQ: phase 1
// makes the root block of each staged chunk of x2 once, into a buffer of
// its own, instead of at every tap's load (where shared memory holds it).
template <int NST_, class A_, class B_, int SQ_> struct UCfg {
  static constexpr int NWG = UNWG, NST = NST_;
  static constexpr bool SQ = SQ_ != 0;
  using A = A_;
  using B = B_;
  static constexpr int NC = NWG * 128, NT = NC + 128;
  static constexpr int REG_PRODUCER = 40;
  static constexpr int REG_CONSUMER =
      imin(((65536 - 128 * REG_PRODUCER) / NC) / 8 * 8, 240);
};

// What a phase's geometry gives: positions of its tile (M = UNWG * MW *
// 64, at least TH * P), staged positions (the last tap's shift further), a
// weight stage's bytes and an input buffer's (UK channels and the pad
// mask).
template <class Ph> struct UGeo {
  static constexpr int MT = UNWG * Ph::MW, M = 64 * MT;
  static constexpr int NPOS = M + 2 * Ph::P + 2;
  static constexpr int SLOT = round_up(2 * 4 * UK * Ph::N, 1024);
  static constexpr int BUF = round_up(NPOS * (UK + 1) * 4, 128);
  static_assert(Ph::TH * Ph::P <= M, "a tile's positions");
};

template <class C> struct USmem {
  using GA = UGeo<typename C::A>;
  using GB = UGeo<typename C::B>;
  static constexpr int SLOT = imax(GA::SLOT, GB::SLOT);
  static constexpr int RING = 0;
  static constexpr int IN = C::NST * SLOT;          // two input buffers
  static constexpr int BUF = imax(GA::BUF, GB::BUF);
  // the root block of a chunk of x2 (SQ), [channel / 8][NPOS][8]
  static constexpr int ROOT = IN + 2 * BUF;
  static constexpr int SCR =
      ROOT + (C::SQ ? round_up(UK * GA::NPOS * 4, 128) : 0);
  static constexpr int BAR = SCR + C::NWG * 16 * SCR_LD * 4;
  static constexpr int END = BAR + round_up(2 * C::NST * 8, 128);
  static constexpr int TOTAL = END + 1024;
  static_assert(TOTAL <= SMEM_LIMIT, "shared memory of a block");
};

// What a phase reads, writes and walks.  Phase 1's input is two sources
// (x2, x1) of cs channels, staged in chunks of UK channels of x2 (each
// serving the concat's blocks 0, 2 and 3) then of x1 (block 1); phase 2's
// is one (mid).
struct UPhaseArgs {
  const float* src[2];
  const float* wp;     // packed weights
  const float* bias;
  float* out;
  int cs;              // channels of a source
  int cat;             // 1: phase 1 (two sources, the concat's blocks)
  int cinp, chunks;    // padded input channels, chunks of an item
  int h, w;            // input plane (the output is h + 2 by w + 2)
  int cout, passes, tiles_x, tiles, items;
  float eps;
};

template <class Ph>
__device__ __forceinline__ UPhaseArgs phase_args(
    const float* s0, const float* s1, const float* wp, const float* bias,
    float* out, int batch, int cs, bool cat, int h, int w, int cout,
    float eps) {
  UPhaseArgs a;
  a.src[0] = s0;
  a.src[1] = s1;
  a.wp = wp;
  a.bias = bias;
  a.out = out;
  a.cs = cs;
  a.cat = cat;
  // phase 1: 4 cs channels (cs % UK == 0, so that every weight stage and
  // chunk holds UK channels of one block); phase 2: C1, padded to UK
  a.cinp = cat ? 4 * cs : round_up(cs, UK);
  a.chunks = (cat ? 2 * cs : a.cinp) / UK;
  a.h = h;
  a.w = w;
  a.cout = cout;
  a.passes = ceil_div(cout, Ph::N);
  a.tiles_x = ceil_div(w + 2, Ph::TW);
  a.tiles = a.tiles_x * ceil_div(h + 2, Ph::TH);
  a.items = batch * a.passes * a.tiles;
  a.eps = eps;
  return a;
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// An item's place: image, pass, tile origin.
struct UItem {
  int img, pass, ty0, tx0;
};
__device__ __forceinline__ UItem up_item(const UPhaseArgs& a, int item) {
  const int tile = item % a.tiles;
  return {item / (a.passes * a.tiles), (item / a.tiles) % a.passes,
          (tile / a.tiles_x), (tile % a.tiles_x)};
}

// Chunk q of an item: source `s`, channels [c0, c0 + UK) of it.
__device__ __forceinline__ void up_chunk(const UPhaseArgs& a, int q, int& s,
                                         int& c0) {
  const int per_src = a.chunks >> a.cat;
  s = q / per_src;
  c0 = (q - s * per_src) * UK;
}

// Chunk q of item `it` into buffer `buf` ([channel / 8][position][8], the
// channels of a group of 8 in the order 0, 4, 1, 5, 2, 6, 3, 7; position
// r * P + c holding input pixel (ty0 + r - 2, tx0 + c - 2)): zero beyond
// the plane, below the tile's rows and in the padded channels, by
// `cp.async` (committed as one group); for a chunk of x2 the pad's 0/1
// mask after it.
template <class Ph>
__device__ __forceinline__ void stage_up_chunk(float* buf, const UPhaseArgs& a,
                                               const UItem& it, int q, int t,
                                               int nt) {
  constexpr int P = Ph::P, NPOS = UGeo<Ph>::NPOS;
  int s, c0;
  up_chunk(a, q, s, c0);
  const int ty0 = it.ty0 * Ph::TH, tx0 = it.tx0 * Ph::TW;
  const size_t plane = (size_t)a.h * a.w;
  const float* base = a.src[s] + ((size_t)it.img * a.cs + c0) * plane;
  const uint32_t dst0 = smem_u32(buf);
#pragma unroll 2
  for (int idx = t; idx < UK / 8 * NPOS; idx += nt) {
    const int cg = idx / NPOS, pos = idx - cg * NPOS;
    const int r = pos / P;
    const int gy = ty0 + r - 2, gx = tx0 + pos - r * P - 2;
    const bool in = r < Ph::TH + 2 && (unsigned)gy < (unsigned)a.h &&
                    (unsigned)gx < (unsigned)a.w;
    const float* p = base + ((size_t)cg * 8 * plane + (size_t)gy * a.w + gx);
    const uint32_t d = dst0 + (cg * NPOS + pos) * 32;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool ok = in && c0 + cg * 8 + e < a.cs;
      cp_async4(d + 4 * (2 * (e & 3) + (e >> 2)), ok ? p + e * plane : a.src[s],
                ok);
    }
  }
  if (a.cat && s == 0) {
    float* mask = buf + UK * NPOS;
    for (int pos = t; pos < NPOS; pos += nt) {
      const int r = pos / P;
      const int gy = ty0 + r - 2, gx = tx0 + pos - r * P - 2;
      mask[pos] = ((unsigned)gy < (unsigned)a.h &&
                   (unsigned)gx < (unsigned)a.w) ? 1.f : 0.f;
    }
  }
  cp_async_commit();
}

// acc[mm] (this warpgroup's tiles mt = wg + mm * UNWG, N columns) += the
// products of one weight stage: tap `tap` over the UK channels of the
// staged chunk at `a` ([channel / 8][NPOS][8], the channels of a group of
// 8 in the order 0, 4, 1, 5, 2, 6, 3, 7, so that a lane's two channels t
// and t + 4 of a k-step are one 8-byte load).  Each k-step makes the
// concat's block of the lane's four values (MODE 0: as staged, 1: x * x,
// 2: sqrt.rn(x + eps) times the pad mask at `mask`), splits them into TF32
// hi and lo, and issues the three products (lo*hi, hi*lo, hi*hi) into the
// partials, which join acc by float32 adds every J k-steps, in k-step
// order.  The next k-step's values are loaded before the wait on the
// products in flight.
template <class Ph, int MODE>
__device__ __forceinline__ void up_stage_mma(float (&acc)[Ph::MW][Ph::N / 2],
                                             const float* a,
                                             const float* mask, int tap,
                                             uint32_t stage, float eps) {
  constexpr int MW = Ph::MW, N = Ph::N, J = Ph::J;
  constexpr int ROWS = UGeo<Ph>::NPOS;
  constexpr int KS = UK / 8;               // k-steps a tap
  static_assert(KS % J == 0, "whole joins a tap");
  const BWalk bw = b_walk<float>(stage, UK, N, 0);
  float p[MW][N / 2];
  uint32_t f[J][MW][2][4];
#pragma unroll
  for (int mm = 0; mm < MW; ++mm) {
#pragma unroll
    for (int e = 0; e < N / 2; ++e) p[mm][e] = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) f[j][mm][0][e] = f[j][mm][1][e] = 0u;
  }
  auto add = [&]() {
    wgmma_wait<0>();
#pragma unroll
    for (int mm = 0; mm < MW; ++mm) {
      fence_regs(p[mm]);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        fence_regs_u(f[j][mm][0]);
        fence_regs_u(f[j][mm][1]);
      }
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[mm][e] += p[mm][e];
    }
  };
  const int tid = threadIdx.x, lane = tid & 31, w4 = (tid >> 5) & 3;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int row = 16 * w4 + (lane >> 2);
  a += row * 8 + 2 * (lane & 3);
  const int shift = (tap / 3) * Ph::P + tap % 3;
  const float* ap[MW];
  float m0[MW], m1[MW];
#pragma unroll
  for (int mm = 0; mm < MW; ++mm) {
    const int q = (wg + mm * UNWG) * 64 + shift;
    ap[mm] = a + q * 8;
    if (MODE == 2) {
      m0[mm] = mask[q + row];
      m1[mm] = mask[q + row + 8];
    }
  }
  uint64_t b_hi = bw.desc;
  int col = 0;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    float v[MW][4];
#pragma unroll
    for (int mm = 0; mm < MW; ++mm) {
      const float2 r0 = *reinterpret_cast<const float2*>(ap[mm]);
      const float2 r1 = *reinterpret_cast<const float2*>(ap[mm] + 64);
      v[mm][0] = r0.x;
      v[mm][1] = r1.x;
      v[mm][2] = r0.y;
      v[mm][3] = r1.y;
      ap[mm] += ROWS * 8;
      if (MODE == 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[mm][e] = __fmul_rn(v[mm][e], v[mm][e]);
      } else if (MODE == 2) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[mm][e] = __fmul_rn(__fsqrt_rn(__fadd_rn(v[mm][e], eps)),
                               e & 1 ? m1[mm] : m0[mm]);
      }
    }
    const int j = kk % J;         // a constant once the k-steps unroll
    if (j == 0 && kk > 0) add();
    const int sc = j == 0 ? 0 : 1;
#pragma unroll
    for (int mm = 0; mm < MW; ++mm) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[j][mm][0][e] = to_tf32(v[mm][e]);
        f[j][mm][1][e] = to_tf32(v[mm][e] - __uint_as_float(f[j][mm][0][e]));
      }
      fence_regs(p[mm]);
      fence_regs_u(f[j][mm][0]);
      fence_regs_u(f[j][mm][1]);
    }
    wgmma_fence();
    const uint64_t b_lo = b_hi + bw.plane;
#pragma unroll
    for (int mm = 0; mm < MW; ++mm) {
      WgmmaRS<N>::mma(p[mm], f[j][mm][1], b_hi, sc);
      WgmmaRS<N>::mma(p[mm], f[j][mm][0], b_lo, 1);
      WgmmaRS<N>::mma(p[mm], f[j][mm][0], b_hi, 1);
    }
    wgmma_commit();
    if (++col == bw.row_steps) {
      col = 0;
      b_hi += bw.blk - (bw.row_steps - 1) * 2;
    } else {
      b_hi += 2;
    }
  }
  add();
}

// The producer's weight stages of one phase for this CTA's items: per item
// every stage of its pass in order, each one contiguous block of the
// packed weights (`pack_up_cell_weights`: [pass][stage in the order of
// consumption][tap][plane][K x N image]).
template <class C, class Ph>
__device__ __forceinline__ void produce_up_phase(const UPhaseArgs& a,
                                                 int first, int step, int& s,
                                                 uint32_t sbase) {
  using L = USmem<C>;
  const uint32_t full0 = sbase + L::BAR, empty0 = full0 + 8 * C::NST;
  const int stages = a.cinp / UK * 9;
  const int bytes = UK * 2 * Ph::N * 4;
  for (int item = first; item < a.items; item += step) {
    const int pass = (item / a.tiles) % a.passes;
    const float* src = a.wp + (size_t)pass * 9 * a.cinp * 2 * Ph::N;
    for (int u = 0; u < stages; ++u, ++s) {
      const int slot = s % C::NST;
      if (s >= C::NST)
        mbar_wait<false>(empty0 + 8 * slot, (s / C::NST - 1) & 1);
      mbar_expect_tx(full0 + 8 * slot, bytes);
      bulk_copy(sbase + L::RING + slot * L::SLOT, src + (size_t)u * bytes / 4,
                bytes, full0 + 8 * slot);
    }
  }
}

// The consumers' side of one phase (CAT: phase 1, the concat's blocks):
// for each of this CTA's items, every chunk's products into registers (the
// next chunk copied meanwhile), then bias + relu through the warpgroup's
// scratch into NCHW with the lanes along W.
template <class C, class Ph, bool CAT>
__device__ __forceinline__ void run_up_phase(const UPhaseArgs& a, int first,
                                             int step, int& s,
                                             unsigned char* smem,
                                             uint32_t sbase) {
  using L = USmem<C>;
  using G = UGeo<Ph>;
  constexpr int P = Ph::P, MW = Ph::MW, N = Ph::N;
  const uint32_t full0 = sbase + L::BAR, empty0 = full0 + 8 * C::NST;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int row_w = (warp & 3) * 16 + g;
  const int ho = a.h + 2, wo = a.w + 2;
  float* scr = reinterpret_cast<float*>(smem + L::SCR) + wg * 16 * SCR_LD;
  const int wtid = tid & 127;
  auto buffer = [&](int b) {
    return reinterpret_cast<float*>(smem + L::IN + b * L::BUF);
  };
  if (first >= a.items) return;
  int nb = 0;                        // chunks staged so far (the buffer)
  stage_up_chunk<Ph>(buffer(0), a, up_item(a, first), 0, tid, C::NC);

  for (int item = first; item < a.items; item += step) {
    const UItem it = up_item(a, item);
    float acc[MW][N / 2];
#pragma unroll
    for (int mm = 0; mm < MW; ++mm)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[mm][e] = 0.f;
    for (int q = 0; q < a.chunks; ++q, ++nb) {
      // this chunk is in (every thread's copies), and every warpgroup is
      // done with the other buffer: copy the next chunk into it
      cp_async_wait_all();
      named_sync(1, C::NC);
      if (q + 1 < a.chunks)
        stage_up_chunk<Ph>(buffer((nb + 1) & 1), a, it, q + 1, tid, C::NC);
      else if (item + step < a.items)
        stage_up_chunk<Ph>(buffer((nb + 1) & 1), a, up_item(a, item + step),
                           0, tid, C::NC);
      const float* in = buffer(nb & 1);
      const float* mask = in + UK * G::NPOS;
      int src, c0;
      up_chunk(a, q, src, c0);
      float* root = reinterpret_cast<float*>(smem + L::ROOT);
      const bool x2s = CAT && src == 0;      // a chunk of x2
      if (C::SQ && x2s) {
        // sqrt.rn(x2 + eps) times the pad mask, once a value
        for (int i = tid; i < UK * G::NPOS / 4; i += C::NC) {
          const int pos = (i >> 1) % G::NPOS;
          const float4 v = reinterpret_cast<const float4*>(in)[i];
          const float m = mask[pos];
          reinterpret_cast<float4*>(root)[i] = make_float4(
              __fmul_rn(__fsqrt_rn(__fadd_rn(v.x, a.eps)), m),
              __fmul_rn(__fsqrt_rn(__fadd_rn(v.y, a.eps)), m),
              __fmul_rn(__fsqrt_rn(__fadd_rn(v.z, a.eps)), m),
              __fmul_rn(__fsqrt_rn(__fadd_rn(v.w, a.eps)), m));
        }
        named_sync(1, C::NC);
      }
      // the concat's blocks of this chunk: x2 -> 0, 2 (x2 * x2), 3 (the
      // root); x1 -> 1
      for (int mode = 0; mode < (x2s ? 3 : 1); ++mode) {
        const float* av = C::SQ && mode == 2 ? root : in;
        for (int tap = 0; tap < 9; ++tap, ++s) {
          const int slot = s % C::NST;
          const uint32_t stage = sbase + L::RING + slot * L::SLOT;
          mbar_wait<false>(full0 + 8 * slot, (s / C::NST) & 1);
          if constexpr (!CAT) {
            up_stage_mma<Ph, 0>(acc, av, mask, tap, stage, a.eps);
          } else if constexpr (C::SQ) {
            if (mode == 1)
              up_stage_mma<Ph, 1>(acc, av, mask, tap, stage, a.eps);
            else
              up_stage_mma<Ph, 0>(acc, av, mask, tap, stage, a.eps);
          } else {
            if (mode == 0)
              up_stage_mma<Ph, 0>(acc, av, mask, tap, stage, a.eps);
            else if (mode == 1)
              up_stage_mma<Ph, 1>(acc, av, mask, tap, stage, a.eps);
            else
              up_stage_mma<Ph, 2>(acc, av, mask, tap, stage, a.eps);
          }
          __syncwarp();
          mbar_arrive(empty0 + 8 * slot, lane == 0);
        }
      }
    }
    const int ty0 = it.ty0 * Ph::TH, tx0 = it.tx0 * Ph::TW;
#pragma unroll
    for (int mm = 0; mm < MW; ++mm) {
      const int mt = wg + mm * UNWG;
#pragma unroll
      for (int ns = 0; ns < N / 16; ++ns) {
#pragma unroll
        for (int nb2 = 0; nb2 < 2; ++nb2) {
          const float* v = &acc[mm][(ns * 2 + nb2) * 4];
          float* dst = scr + (nb2 * 8 + 2 * t4) * SCR_LD + row_w;
          dst[0] = v[0];
          dst[SCR_LD] = v[1];
          dst[8] = v[2];
          dst[SCR_LD + 8] = v[3];
        }
        named_sync(2 + wg, 128);
#pragma unroll 2
        for (int i = 0; i < 8; ++i) {
          const int idx = i * 128 + wtid, c = idx >> 6, m = idx & 63;
          const int qq = mt * 64 + m, rr = qq / P, cc = qq - rr * P;
          const int gy = ty0 + rr, gx = tx0 + cc;
          const int ch = it.pass * N + ns * 16 + c;
          if (rr < Ph::TH && cc < Ph::TW && gy < ho && gx < wo &&
              ch < a.cout)
            a.out[(((size_t)it.img * a.cout + ch) * ho + gy) * wo + gx] =
                fmaxf(scr[c * SCR_LD + m] + a.bias[ch], 0.f);
        }
        named_sync(2 + wg, 128);
      }
    }
  }
  cp_async_wait_all();
}

// Every CTA of the launch has arrived (its stores before it released at
// device scope); trap after 20 s without the last.
__device__ __forceinline__ void grid_barrier(unsigned* ctr, int nc) {
  named_sync(1, nc);
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctr, 1u);
    const unsigned want = gridDim.x;
    unsigned seen;
    long long t_start, now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_start));
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(ctr)
                   : "memory");
      if (seen >= want) break;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (now - t_start > 20000000000LL) __trap();
      __nanosleep(64);
    }
    __threadfence();
  }
  named_sync(1, nc);
}

template <class C>
__global__ void __launch_bounds__(C::NT, 1)
up_cell_kernel(const float* __restrict__ x2, const float* __restrict__ x1,
               const float* __restrict__ w1p, const float* __restrict__ b1,
               const float* __restrict__ w2p, const float* __restrict__ b2,
               float* mid, float* __restrict__ y, unsigned* ctr, int batch,
               int cs, int h, int w, int c1, int c2, float eps) {
  using L = USmem<C>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const int tid = threadIdx.x;
  const int first = blockIdx.x, step = gridDim.x;
  const UPhaseArgs pa = phase_args<typename C::A>(
      x2, x1, w1p, b1, mid, batch, cs, true, h, w, c1, eps);
  const UPhaseArgs pb = phase_args<typename C::B>(
      mid, nullptr, w2p, b2, y, batch, c1, false, h + 2, w + 2, c2, eps);
  const uint32_t full0 = sbase + L::BAR, empty0 = full0 + 8 * C::NST;
  if (tid == 0) {
    for (int i = 0; i < C::NST; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, C::NC / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  int s = 0;                       // weight stages so far, both phases
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  if (warp >= C::NC / 32) {
    // the producer; the two roles never reconverge (setmaxnreg needs that)
    setmaxnreg_dec<C::REG_PRODUCER>();
    if (warp == C::NC / 32 && (tid & 31) == 0) {
      produce_up_phase<C, typename C::A>(pa, first, step, s, sbase);
      produce_up_phase<C, typename C::B>(pb, first, step, s, sbase);
    }
    return;
  }
  setmaxnreg_inc<C::REG_CONSUMER>();
  run_up_phase<C, typename C::A, true>(pa, first, step, s, smem, sbase);
  grid_barrier(ctr, C::NC);
  run_up_phase<C, typename C::B, false>(pb, first, step, s, smem, sbase);
}

// What the packing and the launch share for one phase
// (`uncltmo_up_cell_plan`).
template <class Ph> void up_phase_plan(int cin, int cout, bool cat,
                                       int* out) {
  const int v[6] = {cat ? cin : round_up(cin, UK), Ph::N,
                    round_up(cout, Ph::N), Ph::TH, Ph::TW, Ph::MW};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}

// The cell's channels the kernel takes: each block of the concat whole in
// UK-channel chunks and weight stages
bool up_channels_ok(int cs) { return cs % UK == 0; }

template <class C>
int launch_up_cell(const void* x2, const void* x1, const void* w1p,
                   const void* b1, const void* w2p, const void* b2, void* mid,
                   void* y, void* ctr, int batch, int cs, int h, int w,
                   int c1, int c2, float eps, cudaStream_t stream) {
  auto kernel = up_cell_kernel<C>;
  constexpr int smem = USmem<C>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  using A = typename C::A;
  using B = typename C::B;
  const long long items_a = (long long)batch * ceil_div(c1, A::N) *
                            ceil_div(w + 2, A::TW) * ceil_div(h + 2, A::TH);
  const long long items_b = (long long)batch * ceil_div(c2, B::N) *
                            ceil_div(w + 4, B::TW) * ceil_div(h + 4, B::TH);
  const long long items = items_a > items_b ? items_a : items_b;
  if (items > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  // CTAs resident at once on this card, found once per card
  static int resident[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int fit = dev < 64 ? resident[dev] : 0;
  if (fit == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        C::NT, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    fit = per_sm * sms;
    if (fit == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (dev < 64) resident[dev] = fit;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((int)(items < fit ? items : fit), 1, 1);
  cfg.blockDim = dim3(C::NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  // every CTA resident at once, or no launch: the barrier between the
  // phases waits for all of them
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(x2),
      static_cast<const float*>(x1), static_cast<const float*>(w1p),
      static_cast<const float*>(b1), static_cast<const float*>(w2p),
      static_cast<const float*>(b2), static_cast<float*>(mid),
      static_cast<float*>(y), static_cast<unsigned*>(ctr), batch, cs, h, w,
      c1, c2, eps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The cells' instantiations, picked by (Cin, C1, C2) alone: the decoder's
// four (at a 256^2 tile: up0 1024 -> 128 -> 128 on a 24^2 skip, up1 512 ->
// 64 -> 64 on 57^2, up2 256 -> 32 -> 32 on 122^2, up3 128 -> 32 -> 32 on
// 252^2), the fastest of those timed with `scripts/up_cell_tune.py` on an
// H100 80GB HBM3.  C1 = 128 and 64 in passes of N = 64, one 64-row tile a
// warpgroup (192-position tiles: phase 1 of up0 26 x 6, up1 59 x 3; phase
// 2 28 x 6, 61 x 3), joins every 4 k-steps, the root block made once a
// chunk; C1 = 32 at N = 32, two tiles a warpgroup (384 positions: up2
// 62 x 6 at pitch 64 and 126 x 3 at pitch 128, up3 85 x 4 and 86 x 4,
// which cover 254 and 256 in 3 tiles), joins every 2 k-steps.  A build
// may override a shape with a `#define UNCLTMO_UP_CFG128 ...` in a
// force-included header (`scripts/up_cell_tune.py` times such variants).
//   NST, then per phase TH, TW, MW, N, J, then SQ
#ifndef UNCLTMO_UP_CFG128
#define UNCLTMO_UP_CFG128 3, 6, 26, 1, 64, 4, 6, 28, 1, 64, 4, 1
#endif
#ifndef UNCLTMO_UP_CFG64
#define UNCLTMO_UP_CFG64 4, 3, 59, 1, 64, 4, 3, 61, 1, 64, 4, 1
#endif
#ifndef UNCLTMO_UP_CFG32A
#define UNCLTMO_UP_CFG32A 4, 6, 62, 2, 32, 2, 3, 126, 2, 32, 2, 0
#endif
#ifndef UNCLTMO_UP_CFG32B
#define UNCLTMO_UP_CFG32B 4, 4, 85, 2, 32, 2, 4, 86, 2, 32, 2, 0
#endif
template <int NST, int TH1, int TW1, int MW1, int N1, int J1, int TH2,
          int TW2, int MW2, int N2, int J2, int SQ>
using UpCfg = UCfg<NST, UPhase<TH1, TW1, MW1, N1, J1>,
                   UPhase<TH2, TW2, MW2, N2, J2>, SQ>;
using Up128 = UpCfg<UNCLTMO_UP_CFG128>;
using Up64 = UpCfg<UNCLTMO_UP_CFG64>;
using Up32A = UpCfg<UNCLTMO_UP_CFG32A>;
using Up32B = UpCfg<UNCLTMO_UP_CFG32B>;

template <class F> int with_up_cfg(int cin, int c1, F f) {
  if (c1 > 64) return f(Up128());
  if (c1 > 32) return f(Up64());
  return cin > 128 ? f(Up32A()) : f(Up32B());
}
#endif  // UNCLTMO_K2_ELEM != 1

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
// The weights come packed by `pack_double_conv_weights`
// (ops/kernels/double_conv.py) under the plan below.
int uncltmo_double_conv3x3(const void* x, const void* w1p, const void* b1,
                           const void* w2p, const void* b2, void* y,
                           int batch, int cin, int h, int w, int c1, int c2,
                           int dtype, void* stream) {
  if (h < 5 || w < 5 || batch < 1 || batch > 65535 || cin < 1 || c1 < 1 ||
      c2 < 1 || !elem_built(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#if UNCLTMO_K2_ELEM != 0
  if (dtype == 1)
    return dispatch<bf16>(x, w1p, b1, w2p, b2, y, batch, cin, h, w, c1, c2,
                          s);
#endif
#if UNCLTMO_K2_ELEM != 1
  if (dtype == 0)
    return dispatch<float>(x, w1p, b1, w2p, b2, y, batch, cin, h, w, c1, c2,
                           s);
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}

// The configuration that serves (cin, c1, c2, dtype), as 14 ints: padded
// Cin, Cin staged at a time, padded C1, the C1 chunk, the cluster size,
// output channels a CTA, padded C2, tile height and width, taps a weight
// stage, stages, consumer warpgroups, conv1's block of intermediate
// channels (a cluster's) and 1 for the persistent kernel.  Returns 0, or a
// cudaError_t.
int uncltmo_double_conv3x3_plan(int cin, int c1, int c2, int dtype,
                                int* out) {
  if (cin < 1 || c1 < 1 || c2 < 1 || !elem_built(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
#if UNCLTMO_K2_ELEM != 0
  if (dtype == 1) return plan_of<bf16>(cin, c1, c2, out);
#endif
#if UNCLTMO_K2_ELEM != 1
  if (dtype == 0) return plan_of<float>(cin, c1, c2, out);
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}

#if UNCLTMO_K2_ELEM != 1
// The decoder's up cell in float32 (see `up_cell_kernel`): x2 and x1
// (B, cs, h, w), the packed weights of both ConvTs
// (`pack_up_cell_weights` in ops/kernels/up_cell.py) and their biases;
// writes mid (B, c1, h + 2, w + 2) and y (B, c2, h + 4, w + 4).  `ctr` is
// one zeroed unsigned int of device memory for the barrier between the
// phases.  Returns a cudaError_t (0 = launched).
int uncltmo_up_cell(const void* x2, const void* x1, const void* w1p,
                    const void* b1, const void* w2p, const void* b2,
                    void* mid, void* y, void* ctr, int batch, int cs, int h,
                    int w, int c1, int c2, float eps, void* stream) {
  if (batch < 1 || cs < 1 || h < 1 || w < 1 || c1 < 1 || c2 < 1 ||
      !up_channels_ok(cs))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_up_cfg(4 * cs, c1, [&](auto c) {
    return launch_up_cell<decltype(c)>(x2, x1, w1p, b1, w2p, b2, mid, y, ctr,
                                       batch, cs, h, w, c1, c2, eps, s);
  });
}

// The configuration that serves an up cell of Cin = 4 cs input channels,
// as 13 ints: consumer warpgroups, then for each phase the padded Cin, N,
// the padded output channels, tile height and width and 64-row tiles a
// warpgroup.  Returns 0, or a cudaError_t (channels it does not take).
int uncltmo_up_cell_plan(int cin, int c1, int c2, int* out) {
  if (cin < 1 || cin % 4 || c1 < 1 || c2 < 1 || !up_channels_ok(cin / 4))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_up_cfg(cin, c1, [&](auto c) {
    using C = decltype(c);
    out[0] = C::NWG;
    up_phase_plan<typename C::A>(cin, c1, true, out + 1);
    up_phase_plan<typename C::B>(c1, c2, false, out + 7);
    return 0;
  });
}
#endif

const char* uncltmo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
