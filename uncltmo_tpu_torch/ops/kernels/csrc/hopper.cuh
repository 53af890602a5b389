// Hopper (sm_90a) primitives that more than one of the port's CUDA kernels
// uses: K2 (`double_conv3x3.cu`, float32; `double_conv3x3_bf16.cu`), the up
// cell (`up_cell.cu`).  Each source is one library with a plain C interface,
// loaded with ctypes: no PyTorch headers, so nvcc builds it in seconds.
// What the kernels share:
//  * warp specialisation: one producer thread moves the weights, NWG
//    consumer warpgroups run the products (setmaxnreg gives them the
//    producer warpgroup's registers).  The weights are packed once on the
//    device (ops/kernels/packing.py and each kernel's wrapper) into the
//    exact byte image of a shared-memory stage as a `wgmma` descriptor reads
//    it (K-major, rows of 32 / 64 / 128 swizzled bytes), in the order the
//    kernel consumes them, so that each stage is ONE
//    `cp.async.bulk ... mbarrier::complete_tx` of contiguous bytes into a
//    ring of NST stages, with full / empty `mbarrier` pairs between the
//    producer and the consumers;
//  * products are `wgmma.mma_async`, accumulating in float32, with B from
//    the stage through a swizzled descriptor (`b_walk`);
//  * float32 is split-TF32: the weights are split into hi = tf32(w) and
//    lo = tf32(w - hi) at packing time (two planes a stage), every A value
//    as it is loaded into registers, and a product is three wgmmas, lo*hi +
//    hi*lo + hi*hi (`WgmmaRS`).  The tensor cores round their own adds with
//    a bias, so the products go to partial accumulators that join the
//    float32 one by ordinary adds, whose order fixes every output's
//    rounding;
//  * a wait on an `mbarrier` that makes no progress for 20 s traps (a
//    launch error) instead of hanging the card.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// What differs between the element types: bytes and planes of the weights
// (float32: TF32 hi and lo); bfloat16's is its source's.
template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int ES = 4, PLANES = 2;
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
// d (64 x N, f32, this warpgroup's) (+)= a (64 x 8, TF32, in registers) x
// b (8 x N, shared memory through a descriptor); `scale_d` 0 ignores d's old
// value.  Lane (g, t) of warp w holds a[0..3] = A[16w + g][t],
// A[16w + g + 8][t], A[16w + g][t + 4], A[16w + g + 8][t + 4]; warp w holds
// rows 16w..16w+15 of d, d[4j..4j+3] being lane (g, t)'s [g][8j+2t],
// [g][8j+2t+1], [g+8][8j+2t], [g+8][8j+2t+1].
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
// ---- end PTX wrappers ----

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

// ---- host ----

// A launch of `kernel` in `grid` CTAs of `nt` threads with `smem` bytes of
// dynamic shared memory (set on the current card) on `stream`, in clusters
// of `cl` CTAs along x where cl > 1, or cooperative (every CTA resident at
// once, or no launch).  `err` keeps the first failure; launching returns it.
template <class K> struct Launch {
  K kernel;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1] = {};
  cudaError_t err;

  Launch(K k, dim3 grid, int nt, int smem, cudaStream_t stream, int cl,
         bool cooperative = false)
      : kernel(k) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(nt, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    if (cooperative) {
      attr[0].id = cudaLaunchAttributeCooperative;
      attr[0].val.cooperative = 1;
    } else {
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = cl;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
    }
    cfg.attrs = attr;
    cfg.numAttrs = cooperative || cl > 1 ? 1 : 0;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  Launch(const Launch&) = delete;

  // CTAs (clusters where cl > 1) resident at once on the current card, kept
  // per card in `cache` (one an instantiation); 0 after a failure.
  int resident(int (&cache)[64], int cl) {
    int dev = 0;
    cudaGetDevice(&dev);
    int fit = dev < 64 ? cache[dev] : 0;
    if (fit > 0 || err != cudaSuccess) return err == cudaSuccess ? fit : 0;
    if (cl > 1) {
      err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    } else {
      int per_sm = 0, sms = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, cfg.blockDim.x, cfg.dynamicSmemBytes);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      fit = per_sm * sms;
    }
    if (err == cudaSuccess && fit == 0) err = cudaErrorInvalidConfiguration;
    if (err != cudaSuccess) return 0;
    if (dev < 64) cache[dev] = fit;
    return fit;
  }

  // Launches with `args`; returns a cudaError_t (0 = launched).
  template <class... A> int operator()(A... args) {
    if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, args...);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
};

}  // namespace

extern "C" const char* uncltmo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
