// The decoder's up cell in float32.  `models/blocks.py:Up` with
// `square_and_square_root` and doubleConvTranspose (relu, no norm) runs,
// after its 2x2 upsample,
//   y = relu(convT(relu(convT(cat, W1) + b1), W2) + b2),
//   cat = [x2, x1, x2^2, sqrt(x2 + eps)],
// two ConvTranspose2d(k=3, stride 1).  Such a ConvT is a valid 3x3
// convolution over its input zero-padded by 2, with the kernel flipped in
// both axes and its in/out axes swapped: each grows the plane by 2 a side.
// `up_cell_kernel` runs the cell in one persistent, cooperative launch, as
// two phases on K2's float32 engine (double_conv3x3.cu: split-TF32 products
// with A in registers, partials joined into the accumulators by float32
// adds, a producer thread streaming packed weight stages through an
// `mbarrier` ring, hopper.cuh), or three where it also folds the upsample:
//  * phase 0 (`uncltmo_up_cell_folded`): x1 = pad_or_crop(convT2x2(x) + b0)
//    on the skip's plane, the 2x2 stride-2 ConvTranspose2d as one GEMM a
//    half-resolution position (K = C input channels, N = 4C columns, one
//    per output channel and parity, n = 4 co + 2 a + b), with no halo and
//    no taps, on phase 1's geometry (its N, J and 64-row tiles, M flat
//    positions a tile).  Its epilogue adds the bias and writes each value
//    at its place on the skip's plane: a crop skips the stores outside it,
//    an edge pad writes the edge row or column again, a zero pad writes
//    zeros there.  x1 goes to device memory, where phase 1 stages it;
//  * a grid-wide barrier;
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
// producer streams the next phase's first stages while the consumers wait
// at a barrier.  Phase 0 runs at about a fifth of its bytes bound: measured
// by ablation on an H100, its stores, products and staging take about as
// long as their sum (a third staging buffer, 16-byte stores through a lane
// shuffle and streaming stores each gained nothing).

#include "hopper.cuh"

namespace {

// Input channels a weight stage (one tap of them, 4 k-steps) and a staged
// chunk; consumer warpgroups of a block.
constexpr int UK = 32, UNWG = 3;

// One phase: an output tile of TH x TW pixels, each consumer warpgroup MW
// 64-row tiles of N output channels (the wgmma N).  J: k-steps whose
// products chain in the tensor cores' partials before they join the
// float32 accumulators (1: every k-step, as K2's `stage_mma_rs`); each k-step
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
// is one (mid), and so is phase 0's (x, whose tiles are M flat positions of
// the half-resolution plane).
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

// Phase 0's walk: x (batch, c, h0, w0), columns n = 4 co + 2 a + b of the
// packed 2x2 weights in passes of N, tiles of M flat positions, items in
// the order (image, tile, pass) (`fold_item`); no items where h0 is 0 (the
// two-phase launch).
template <class Ph>
__device__ __forceinline__ UPhaseArgs fold_args(const float* x,
                                                const float* wp,
                                                const float* bias, float* x1,
                                                int batch, int c, int h0,
                                                int w0) {
  UPhaseArgs a;
  a.src[0] = a.src[1] = x;
  a.wp = wp;
  a.bias = bias;
  a.out = x1;
  a.cs = c;
  a.cat = 0;
  a.cinp = c;                      // c % UK == 0
  a.chunks = c / UK;
  a.h = h0;
  a.w = w0;
  a.cout = 4 * c;
  a.passes = 4 * c / Ph::N;        // N divides 4 UK
  a.tiles = ceil_div(h0 * w0, UGeo<Ph>::M);
  a.items = batch * a.passes * a.tiles;
  a.eps = 0.f;
  return a;
}

// Where phase 0 writes: x1 (batch, c, ho, wo), the upsampled plane placed
// at (lo_y, lo_x) (negative: cropped), its edge rows and columns repeated
// over the pad (`edge`) or zeros there.
struct FoldOut {
  int ho, wo, lo_y, lo_x, edge;
};

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
// wait until at most n (clamped to 0..4) of this thread's newest groups
// are in flight
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 3)
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 4;\n" ::: "memory");
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

// Phase 0's item: image, pass, tile (as `tx0`).
__device__ __forceinline__ UItem fold_item(const UPhaseArgs& a, int item) {
  return {item / (a.tiles * a.passes), item % a.passes, 0,
          (item / a.passes) % a.tiles};
}

// Phase 0's chunks are [channel][fold_ld(M)]: a lane's four A values of a
// k-step in distinct banks (LD = 8 mod 32), a channel's positions
// contiguous, so that 16-byte copies fill them where x keeps them aligned.
__host__ __device__ constexpr int fold_ld(int m) { return m + 8; }

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// Phase 0's chunk q of item `it` into `buf` ([channel][LD]): position m
// holding flat position tile * M + m of x's plane, zero beyond it; 16-byte
// copies where x is 16-byte aligned and its plane's size a multiple of 4
// (each channel's run is then aligned too), else 4-byte ones.
template <class Ph>
__device__ __forceinline__ void stage_fold_chunk(float* buf,
                                                 const UPhaseArgs& a,
                                                 const UItem& it, int q, int t,
                                                 int nt) {
  constexpr int M = UGeo<Ph>::M, LD = fold_ld(M);
  const int plane = a.h * a.w, p0 = it.tx0 * M;
  const float* base =
      a.src[0] + ((size_t)it.img * a.cs + q * UK) * plane + p0;
  const uint32_t dst0 = smem_u32(buf);
  if (plane % 4 == 0 && (reinterpret_cast<uintptr_t>(a.src[0]) & 15) == 0) {
    for (int idx = t; idx < UK * (M / 4); idx += nt) {
      const int ch = idx / (M / 4), pos = 4 * (idx - ch * (M / 4));
      const int valid = imax(imin(plane - p0 - pos, 4), 0);
      cp_async16(dst0 + (ch * LD + pos) * 4,
                 valid ? base + (size_t)ch * plane + pos : a.src[0],
                 4 * valid);
    }
  } else {
#pragma unroll 4
    for (int idx = t; idx < UK * M; idx += nt) {
      const int ch = idx / M, pos = idx - ch * M;
      const bool in = p0 + pos < plane;
      cp_async4(dst0 + (ch * LD + pos) * 4,
                in ? base + (size_t)ch * plane + pos : a.src[0], in);
    }
  }
  cp_async_commit();
}

// acc[mm] (this warpgroup's tiles mt = wg + mm * UNWG, N columns) += the
// products of one weight stage: tap `tap` over the UK channels of the
// staged chunk at `a` ([channel / 8][NPOS][8], the channels of a group of
// 8 in the order 0, 4, 1, 5, 2, 6, 3, 7, so that a lane's two channels t
// and t + 4 of a k-step are one 8-byte load; or, where LD > 0, phase 0's
// [channel][LD], four 4-byte loads).  Each k-step makes the
// concat's block of the lane's four values (MODE 0: as staged, 1: x * x,
// 2: sqrt.rn(x + eps) times the pad mask at `mask`), splits them into TF32
// hi and lo, and issues the three products (lo*hi, hi*lo, hi*hi) into the
// partials, which join acc by float32 adds every J k-steps, in k-step
// order.  The next k-step's values are loaded before the wait on the
// products in flight.
template <class Ph, int MODE, int LD = 0>
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
  a += LD > 0 ? (lane & 3) * LD + row : row * 8 + 2 * (lane & 3);
  const int shift = (tap / 3) * Ph::P + tap % 3;
  const float* ap[MW];
  float m0[MW], m1[MW];
#pragma unroll
  for (int mm = 0; mm < MW; ++mm) {
    const int q = (wg + mm * UNWG) * 64 + shift;
    ap[mm] = a + (LD > 0 ? q : q * 8);
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
      if constexpr (LD > 0) {
        v[mm][0] = ap[mm][0];
        v[mm][1] = ap[mm][8];
        v[mm][2] = ap[mm][4 * LD];
        v[mm][3] = ap[mm][4 * LD + 8];
        ap[mm] += 8 * LD;
      } else {
        const float2 r0 = *reinterpret_cast<const float2*>(ap[mm]);
        const float2 r1 = *reinterpret_cast<const float2*>(ap[mm] + 64);
        v[mm][0] = r0.x;
        v[mm][1] = r1.x;
        v[mm][2] = r0.y;
        v[mm][3] = r1.y;
        ap[mm] += ROWS * 8;
      }
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

// x1's value at upsampled position (u, v) of a hu x wu plane into `plane`
// (ho x wo) at (u + lo_y, v + lo_x) if it lies there, and where (u, v) is
// an edge of the upsampled plane, over the pad beyond that edge: the value
// again (edge) or zeros.  Every element of the plane is written once.
__device__ __forceinline__ void fold_store(float* plane, const FoldOut& o,
                                           int u, int v, int hu, int wu,
                                           float val) {
  const int yc = u + o.lo_y, xc = v + o.lo_x;
  const int y0 = imax(u == 0 ? 0 : yc, 0);
  const int y1 = imin(u == hu - 1 ? o.ho - 1 : yc, o.ho - 1);
  const int x0 = imax(v == 0 ? 0 : xc, 0);
  const int x1 = imin(v == wu - 1 ? o.wo - 1 : xc, o.wo - 1);
  for (int yy = y0; yy <= y1; ++yy)
    for (int xx = x0; xx <= x1; ++xx)
      plane[(size_t)yy * o.wo + xx] =
          o.edge || (yy == yc && xx == xc) ? val : 0.f;
}

// Phase 0's items of this CTA: a contiguous block [lo, hi) of them, so
// that the passes of a tile follow each other (its input staged once where
// it is one chunk).
__device__ __forceinline__ void fold_block(const UPhaseArgs& a, int& lo,
                                           int& hi) {
  lo = (int)((long long)blockIdx.x * a.items / gridDim.x);
  hi = (int)((long long)(blockIdx.x + 1) * a.items / gridDim.x);
}

// The producer's weight stages of phase 0: per item of the block, the
// chunks' stages of its pass (`pack_upsample_weights`: [pass][chunk]
// [plane][K x N image]).
template <class C>
__device__ __forceinline__ void produce_fold_phase(const UPhaseArgs& a,
                                                   int& s, uint32_t sbase) {
  using L = USmem<C>;
  constexpr int N = C::A::N;
  const uint32_t full0 = sbase + L::BAR, empty0 = full0 + 8 * C::NST;
  const int bytes = UK * 2 * N * 4;
  int lo, hi;
  fold_block(a, lo, hi);
  for (int item = lo; item < hi; ++item) {
    const float* src = a.wp + (size_t)(item % a.passes) * a.cinp * 2 * N;
    for (int u = 0; u < a.chunks; ++u, ++s) {
      const int slot = s % C::NST;
      if (s >= C::NST)
        mbar_wait<false>(empty0 + 8 * slot, (s / C::NST - 1) & 1);
      mbar_expect_tx(full0 + 8 * slot, bytes);
      bulk_copy(sbase + L::RING + slot * L::SLOT, src + (size_t)u * bytes / 4,
                bytes, full0 + 8 * slot);
    }
  }
}

// The consumers' side of phase 0: for each of this CTA's items, every
// chunk's products (one weight stage a chunk) into registers, then the
// bias and the stores straight from them: lane (g, t4)'s columns 8 j +
// 2 t4 and + 1 of a row are output channel 2 j + t4 / 2 (of the pass) at
// parity a = t4 % 2 and b = 0, 1, two adjacent entries of x1, and the 8
// lanes of a t4 hold 8 consecutive positions, 64 contiguous bytes where
// the positions share a row.  Positions whose upsampled pixels meet an
// edge of the upsampled plane or fall outside x1 go through `fold_store`.
template <class C>
__device__ __forceinline__ void run_fold_phase(const UPhaseArgs& a,
                                               const FoldOut& o, int& s,
                                               unsigned char* smem,
                                               uint32_t sbase) {
  using Ph = typename C::A;
  using L = USmem<C>;
  using G = UGeo<Ph>;
  constexpr int MW = Ph::MW, N = Ph::N, LD = fold_ld(G::M);
  const uint32_t full0 = sbase + L::BAR, empty0 = full0 + 8 * C::NST;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int row_w = (warp & 3) * 16 + g;
  const int plane = a.h * a.w;
  const size_t plane_out = (size_t)o.ho * o.wo;
  // NB chunk buffers over the input buffers and what follows them (phase
  // 1's root block and the scratch, unused here); staged chunk k in buffer
  // k % NB.  Where a tile's chunks leave a buffer free (`resident`), they
  // are staged once and serve all of its passes, else once an item.
  constexpr int CHUNK = round_up(UK * LD * 4, 128);
  constexpr int NB = imin((L::BAR - L::IN) / CHUNK, 5);
  static_assert(NB >= 2, "phase 0's chunk buffers");
  auto buffer = [&](int k) {
    return reinterpret_cast<float*>(smem + L::IN + (k % NB) * CHUNK);
  };
  int lo, hi;
  fold_block(a, lo, hi);
  if (lo >= hi) return;
  const bool resident = a.chunks < NB;
  // an item with a new input: another tile, or any item where the input is
  // not kept
  auto fresh = [&](int item) {
    return !resident || item == lo || item / a.passes != (item - 1) / a.passes;
  };
  int si = lo, sq = 0, issued = 0;   // the next chunk to stage: item, chunk
  auto stage_next = [&]() {
    stage_fold_chunk<Ph>(buffer(issued++), a, fold_item(a, si), sq, tid,
                         C::NC);
    if (++sq == a.chunks) {
      sq = 0;
      do {
        ++si;
      } while (si < hi && !fresh(si));
    }
  };
  while (si < hi && issued < NB) stage_next();
  int k0 = -a.chunks;              // the staged index of the input's chunk 0

  for (int item = lo; item < hi; ++item) {
    const UItem it = fold_item(a, item);
    const bool first = fresh(item);
    const bool last = item + 1 >= hi || fresh(item + 1);
    if (first) k0 += a.chunks;
    float acc[MW][N / 2];
#pragma unroll
    for (int mm = 0; mm < MW; ++mm)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[mm][e] = 0.f;
    for (int q = 0; q < a.chunks; ++q, ++s) {
      const int k = k0 + q;
      if (first) cp_async_wait_upto(issued - 1 - k);
      // every warpgroup is done with the chunks before `keep`: stage into
      // their buffers
      named_sync(1, C::NC);
      const int keep = last ? k : k0;
      while (si < hi && issued < keep + NB) stage_next();
      const int slot = s % C::NST;
      mbar_wait<false>(full0 + 8 * slot, (s / C::NST) & 1);
      up_stage_mma<Ph, 0, LD>(acc, buffer(k), nullptr, 0,
                              sbase + L::RING + slot * L::SLOT, 0.f);
      __syncwarp();
      mbar_arrive(empty0 + 8 * slot, lane == 0);
    }
    // this lane's first channel (j = 0) and parity
    const int co0 = it.pass * (N / 4) + (t4 >> 1), pa = t4 & 1;
    float* img = a.out + ((size_t)it.img * a.cs + co0) * plane_out;
#pragma unroll
    for (int mm = 0; mm < MW; ++mm) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int p = it.tx0 * G::M + (wg + mm * UNWG) * 64 + row_w + 8 * hr;
        if (p >= plane) continue;
        const int i0 = p / a.w, j0 = p - i0 * a.w;
        const int u = 2 * i0 + pa, v = 2 * j0;
        const int yy = u + o.lo_y, xx = v + o.lo_x;
        const bool inner = u > 0 && u < 2 * a.h - 1 && v > 0 &&
                           v + 1 < 2 * a.w - 1 && yy >= 0 && yy < o.ho &&
                           xx >= 0 && xx + 1 < o.wo;
        float* dst = img + (size_t)yy * o.wo + xx;
        const bool pair = (reinterpret_cast<uintptr_t>(dst) & 7) == 0;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const float bias = a.bias[co0 + 2 * j];
          const float v0 = acc[mm][4 * j + 2 * hr] + bias;
          const float v1 = acc[mm][4 * j + 2 * hr + 1] + bias;
          if (inner) {
            float* d = dst + 2 * j * plane_out;
            if (pair) {
              *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
            } else {
              d[0] = v0;
              d[1] = v1;
            }
          } else {
            float* pl = img + 2 * j * plane_out;
            fold_store(pl, o, u, v, 2 * a.h, 2 * a.w, v0);
            fold_store(pl, o, u, v + 1, 2 * a.h, 2 * a.w, v1);
          }
        }
      }
    }
  }
  cp_async_wait_all();
}

// Every CTA of the launch has arrived here for the `gen`-th time (its
// stores before it released at device scope); trap after 20 s without
// the last.
__device__ __forceinline__ void grid_barrier(unsigned* ctr, int nc, int gen) {
  named_sync(1, nc);
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctr, 1u);
    const unsigned want = gridDim.x * gen;
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

// x1 is phase 0's output where it runs (h0 > 0), else an input.
template <class C>
__global__ void __launch_bounds__(C::NT, 1)
up_cell_kernel(const float* __restrict__ x2, float* x1,
               const float* __restrict__ w1p, const float* __restrict__ b1,
               const float* __restrict__ w2p, const float* __restrict__ b2,
               float* mid, float* __restrict__ y, unsigned* ctr, int batch,
               int cs, int h, int w, int c1, int c2, float eps,
               const float* __restrict__ x0, const float* __restrict__ w0p,
               const float* __restrict__ b0, int h0, int w0, FoldOut fo) {
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
  const UPhaseArgs p0 =
      fold_args<typename C::A>(x0, w0p, b0, x1, batch, cs, h0, w0);
  const bool fold = h0 > 0;
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
      produce_fold_phase<C>(p0, s, sbase);
      produce_up_phase<C, typename C::A>(pa, first, step, s, sbase);
      produce_up_phase<C, typename C::B>(pb, first, step, s, sbase);
    }
    return;
  }
  setmaxnreg_inc<C::REG_CONSUMER>();
  if (fold) {
    run_fold_phase<C>(p0, fo, s, smem, sbase);
    grid_barrier(ctr, C::NC, 1);
  }
  run_up_phase<C, typename C::A, true>(pa, first, step, s, smem, sbase);
  grid_barrier(ctr, C::NC, fold ? 2 : 1);
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

// The launch; h0 = 0 leaves phase 0 out (x0, w0p, b0 unread, x1 an input).
template <class C>
int launch_up_cell(const void* x2, void* x1, const void* w1p, const void* b1,
                   const void* w2p, const void* b2, void* mid, void* y,
                   void* ctr, int batch, int cs, int h, int w, int c1, int c2,
                   float eps, const void* x0, const void* w0p, const void* b0,
                   int h0, int w0, FoldOut fo, cudaStream_t stream) {
  using A = typename C::A;
  using B = typename C::B;
  const long long items_a = (long long)batch * ceil_div(c1, A::N) *
                            ceil_div(w + 2, A::TW) * ceil_div(h + 2, A::TH);
  const long long items_b = (long long)batch * ceil_div(c2, B::N) *
                            ceil_div(w + 4, B::TW) * ceil_div(h + 4, B::TH);
  const long long items_0 = (long long)batch * (4 * cs / A::N) *
                            ceil_div(h0 * w0, UGeo<A>::M);
  long long items = items_a > items_b ? items_a : items_b;
  if (items_0 > items) items = items_0;
  if (items > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  // cooperative: the barrier between the phases waits for every CTA
  Launch run(up_cell_kernel<C>, dim3(1, 1, 1), C::NT, USmem<C>::TOTAL,
             stream, 1, true);
  static int resident[64];
  const int fit = run.resident(resident, 1);
  run.cfg.gridDim = dim3((int)(items < fit ? items : fit), 1, 1);
  return run(static_cast<const float*>(x2), static_cast<float*>(x1),
             static_cast<const float*>(w1p), static_cast<const float*>(b1),
             static_cast<const float*>(w2p), static_cast<const float*>(b2),
             static_cast<float*>(mid), static_cast<float*>(y),
             static_cast<unsigned*>(ctr), batch, cs, h, w, c1, c2, eps,
             static_cast<const float*>(x0), static_cast<const float*>(w0p),
             static_cast<const float*>(b0), h0, w0, fo);
}

// Python's floor division by 2 (a negative margin crops)
int floor_half(int d) { return d >= 0 ? d / 2 : -((1 - d) / 2); }

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

}  // namespace

extern "C" {

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
    return launch_up_cell<decltype(c)>(
        x2, const_cast<void*>(x1), w1p, b1, w2p, b2, mid, y, ctr, batch, cs,
        h, w, c1, c2, eps, nullptr, nullptr, nullptr, 0, 0, FoldOut{}, s);
  });
}

// The up cell with its 2x2 stride-2 ConvTranspose2d folded in as phase 0:
// x (B, cs, h0, w0), its packed weights (`pack_upsample_weights`) and bias;
// x1 (B, cs, h, w) is written by phase 0 (the upsampled plane, padded or
// cropped to the skip's h x w as `models/blocks.py:_pad_or_crop` does:
// `edge` 1 repeats the edge, 0 pads zeros) and read by phase 1.  `ctr` as
// above (the launch's two barriers count on it).
int uncltmo_up_cell_folded(const void* x, const void* w0p, const void* b0,
                           void* x1, const void* x2, const void* w1p,
                           const void* b1, const void* w2p, const void* b2,
                           void* mid, void* y, void* ctr, int batch, int cs,
                           int h0, int w0, int h, int w, int c1, int c2,
                           int edge, float eps, void* stream) {
  if (batch < 1 || cs < 1 || h < 1 || w < 1 || h0 < 1 || w0 < 1 || c1 < 1 ||
      c2 < 1 || !up_channels_ok(cs))
    return static_cast<int>(cudaErrorInvalidValue);
  const FoldOut fo{h, w, floor_half(h - 2 * h0), floor_half(w - 2 * w0),
                   edge != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_up_cfg(4 * cs, c1, [&](auto c) {
    return launch_up_cell<decltype(c)>(x2, x1, w1p, b1, w2p, b2, mid, y, ctr,
                                       batch, cs, h, w, c1, c2, eps, x, w0p,
                                       b0, h0, w0, fo, s);
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

}  // extern "C"
