// K2 in bfloat16 (see double_conv3x3.cuh), a block a tile: A from shared
// memory through the descriptor too, so a warpgroup issues all products of
// a stage for all its 64-row tiles back to back and waits once; the
// intermediate walked in chunks of CH channels, double-buffered.

#include <cuda_bf16.h>

#include "double_conv3x3.cuh"

namespace {

typedef __nv_bfloat16 bf16;

template <> struct Elem<bf16> {     // VEC: elements of 16 bytes
  static constexpr int ES = 2, PLANES = 1, VEC = 8;
};

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

// orders this thread's generic-proxy writes to shared memory before the
// async proxy's reads (wgmma operands); `_shared`: this thread's view of
// shared memory before its own later wgmmas
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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


__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16(v);
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


template <class C, typename T>
int launch(const void* x, const void* w1p, const void* b1, const void* w2p,
           const void* b2, void* y, int batch, int cin, int h, int w, int c1,
           int c2, int c2p, cudaStream_t stream) {
  const Plan p = make_plan<C, T>(cin, c1, c2p);
  const int tiles_x = ceil_div(w - 4, C::TW);
  const int tiles_y = ceil_div(h - 4, C::TH);
  Launch run(double_conv3x3_wgmma_kernel<C, T>,
             dim3(tiles_x * tiles_y * C::CL, c2p / C::C2P, batch), C::NT,
             Smem<C, T>::TOTAL, stream, C::CL);
  // a cluster that cannot be resident anywhere would never launch
  static int clusters[64];
  if (C::CL > 1) run.resident(clusters, C::CL);
  return run(static_cast<const T*>(x), static_cast<const T*>(w1p),
             static_cast<const T*>(b1), static_cast<const T*>(w2p),
             static_cast<const T*>(b2), static_cast<T*>(y), cin, h, w, c1, c2,
             p.cinp, p.c1p, p.cinc, tiles_x);
}

// The instantiations, as in double_conv3x3.cu: 12 x 28 = 336 of 384
// positions (inc), 7 x 31 with whole 9-tap stages (down0), 2 whole rows of
// 57 (down1), 2 whole rows of 24 with a cluster of 2 and 128-channel chunks
// (down2: 12 tiles x 2 CTAs an image, so that B = 8 gives 192 CTAs for 132
// SMs).
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
using Inc = Cfg<UNCLTMO_K2_CFGINC, true>;      // inc: 1 -> 32 -> 32
using C32 = Cfg<UNCLTMO_K2_CFG32, false>;
using C64 = Cfg<UNCLTMO_K2_CFG64, false>;      // down0: 32 -> 64 -> 64
using C128 = Cfg<UNCLTMO_K2_CFG128, false>;    // down1: 64 -> 128 -> 128
using C256 = Cfg<UNCLTMO_K2_CFG256, false>;    // down2: 128 -> 256 -> 256

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).  The weights come packed by
// `pack_double_conv_weights` (ops/kernels/double_conv.py) under the plan
// below.
int uncltmo_double_conv3x3(const void* x, const void* w1p, const void* b1,
                           const void* w2p, const void* b2, void* y,
                           int batch, int cin, int h, int w, int c1, int c2,
                           void* stream) {
  if (!args_ok(batch, cin, h, w, c1, c2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int c2p = padded_c2(c2);
  return with_cfg<Inc, C32, C64, C128, C256>(cin, c2p, [&](auto c) {
    return launch<decltype(c), bf16>(x, w1p, b1, w2p, b2, y, batch, cin, h,
                                     w, c1, c2, c2p,
                                     static_cast<cudaStream_t>(stream));
  });
}

// The configuration that serves (cin, c1, c2): `plan_out`, or an error.
int uncltmo_double_conv3x3_plan(int cin, int c1, int c2, int* out) {
  if (cin < 1 || c1 < 1 || c2 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int c2p = padded_c2(c2);
  return with_cfg<Inc, C32, C64, C128, C256>(cin, c2p, [&](auto c) {
    return plan_out(make_plan<decltype(c), bf16>(cin, c1, c2p), out);
  });
}

}  // extern "C"
