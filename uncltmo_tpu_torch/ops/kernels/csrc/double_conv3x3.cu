// K2: fused (valid 3x3 conv -> bias -> relu) x 2 on NCHW tensors, Hopper.
//
// Replaces the TPU kernel `fused_double_conv3x3`
// (uncltmo_tpu/ops/pallas_kernels.py:88-132, body `_make_kernel` :68-85).
// It runs the U-Net cells inc (1->32->32 @256^2), down0 (32->64->64 @126^2),
// down1 (64->128->128 @61^2) and down2 (128->256->256 @28^2).
//
// Bound: operations.  The cells do 2*9*Cin*C1 + 2*9*C1*C2 flops per output
// pixel against a few bytes of input and output, far above the card's
// flop:byte ridge.  So the kernel's job is to keep the intermediate
// activation out of device memory (as the TPU kernel keeps it in VMEM), to
// do each product once, and to do it where the card is fastest.
//
// One kernel template, `double_conv3x3_mma_kernel`, runs both element
// types on the tensor cores with float32 accumulation; `Mma<T>` holds what
// differs (the MMA and how its operands are read).
//  * one block owns one TH x TW output tile of one image and ALL output
//    channels (up to 256 a pass), so conv1 is computed once per tile and its
//    halo, not once per output-channel group;
//  * the input tile with its 2-pixel halo is staged once, transposed to
//    [position][channel] with position q = row * P + col and ONE pitch
//    P = TW + 4 for input, intermediate and output.  conv1 is computed at
//    every flattened q of the first TH+2 rows and stored at the same q, conv2
//    at every q of the first TH rows: tap (ky, kx) of either is the same
//    array shifted by ky * P + kx positions, so the A operand of the implicit
//    GEMM (M = positions, N = output channels, K = 9 taps x channels) is a
//    plain pointer.  The last 2 (conv1) / 4 (conv2) columns of a row hold
//    wrapped values: they cost 4/P of the products, feed no valid output
//    (column c < TW reads intermediate columns c..c+2 <= TW+1) and are never
//    stored;
//  * the intermediate is walked in chunks of CH channels: conv1 accumulators
//    -> bias + relu -> rounded to the element type (as the TPU kernel's
//    `mid.astype(x.dtype)`) -> shared memory, then folded into the conv2
//    accumulators, which stay in registers across chunks.  The intermediate
//    never touches device memory;
//  * weights are packed once on the host side as [tap][K][N], zero-padded to
//    the MMA depth, and stream through two shared-memory stages by
//    `cp.async` (16 bytes a thread): the next group of 1, 3 or 9 taps loads
//    while this one feeds the MMAs.  All blocks read the same weights, which
//    stay in L2;
//  * bfloat16: `mma.sync.m16n8k16` fed by `ldmatrix` (A as it lies,
//    [position][k]; B, [k][n], with `.trans`); channel strides of C + 8
//    elements keep rows 16-byte aligned under any position shift and put the
//    eight rows of an `ldmatrix` in eight different bank groups;
//  * float32: split-TF32.  One TF32 pass would lose float32 parity, so every
//    operand is split as it is read into hi = tf32(x), lo = tf32(x - hi) and
//    a product is three `mma.sync.m16n8k8`: lo*hi + hi*lo + hi*hi.  Only
//    those three are chained in the tensor cores; their sum is added to the
//    float32 accumulators on the CUDA cores (see `Mma<float>`);
//  * conv1's bias + relu + rounding runs on the accumulator registers (the
//    m16n8 layout is known); conv2's epilogue goes through a per-warp
//    scratch (over the dead input tile) so that the NCHW stores run along W;
//  * Cin == 1 (inc): conv1 is 9 FMAs a value, done on the CUDA cores straight
//    into the intermediate array; only conv2 uses the MMAs;
//  * tile shape and warp layout are template parameters per element type and
//    output-channel width (`Cfg`), picked for the cells' output sizes;
//    channel counts that are no multiple of 16 / 32 are zero in the packed
//    weights and zero-filled at staging; more than 128 input channels are
//    staged 128 at a time, more than 256 output channels take one pass of the
//    grid's y per 256.
//
// Plain C interface, loaded with ctypes: no PyTorch headers, so nvcc builds
// it in seconds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ constexpr int round_up(int a, int b) {
  return ceil_div(a, b) * b;
}
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

constexpr int CINC_MAX = 128;          // input channels staged at a time
constexpr int SMEM_LIMIT = 232448;     // bytes a block may use on sm_90

// One instantiation of the kernel: an output tile of TH x TW pixels, all
// C2P (padded) output channels, FM x FN tiles of 16 x 16 accumulators per
// warp; the intermediate walked in chunks of CH channels whose conv1 is dealt
// to the warps in F1M x F1N tiles of 16 x 16.  A weight stage holds TG taps
// (1, 3 or 9); MINB blocks should fit an SM (it caps the registers).  CIN1:
// Cin == 1, conv1 on the CUDA cores.
template <int TH_, int TW_, int FM_, int FN_, int C2P_, int CH_, int F1M_,
          int F1N_, int TG_, int MINB_, bool CIN1_>
struct Cfg {
  static constexpr int TH = TH_, TW = TW_, FM = FM_, FN = FN_, C2P = C2P_,
                       CH = CH_, F1M = F1M_, F1N = F1N_, TG = TG_,
                       MINB = MINB_, G = 9 / TG_;
  static constexpr bool CIN1 = CIN1_;
  static constexpr int P = TW + 4;                  // the one pitch
  static constexpr int M2 = round_up(TH * P, 16);   // conv2 positions
  static constexpr int M2F = M2 / 16;
  // conv1 positions: far enough for conv2's last shift (2P + 2)
  static constexpr int M1 = round_up(M2 + 2 * P + 2, 16);
  static constexpr int M1F = M1 / 16;
  // input positions: far enough for conv1's last shift
  static constexpr int NPOS = M1 + 2 * P + 2;
  static constexpr int WM = ceil_div(M2F, FM);      // warps along positions
  static constexpr int WN = C2P / 16 / FN;          // warps along channels
  static constexpr int NW = WM * WN;
  static constexpr int NT = NW * 32;
  static constexpr int T1M = ceil_div(M1F, F1M);    // conv1 warp tiles
  static constexpr int T1N = CH / 16 / F1N;
  static constexpr int TPW1 = CIN1 ? 1 : ceil_div(T1M * T1N, NW);
  static constexpr int MW = FM * 16;      // positions a warp owns in conv2
  static constexpr int SLD = MW + 4;      // its epilogue scratch: [16][SLD]
  static_assert(C2P % (16 * FN) == 0 && CH % (16 * F1N) == 0 && CH % 32 == 0,
                "tiling");
  static_assert(32 % (16 * F1N) == 0, "a 32-channel chunk is whole tiles");
  static_assert(!CIN1 || CH == 32, "Cin == 1 walks whole 32-channel chunks");
  static_assert(TG == 1 || TG == 3 || TG == 9, "taps per weight stage");
};

// ---- PTX wrappers ----
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// Four 8x8 bf16 matrices from shared memory: lane l gives the address of row
// l % 8 of matrix l / 8; lane (g, t) = (l / 4, l % 4) receives elements
// [g][2t], [g][2t+1] of matrix i in r[i] (with `_t`: [2t][g], [2t+1][g]).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(
      __cvta_generic_to_shared(const_cast<bf16*>(p)));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(
      __cvta_generic_to_shared(const_cast<bf16*>(p)));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
// d (16x8, f32) += a (16x16, bf16, row) * b (16x8, bf16, col).  Lane (g, t):
// a = {[g][2t..], [g+8][2t..], [g][2t+8..], [g+8][2t+8..]}, b0 = [2t..][g],
// b1 = [2t+8..][g], d = {[g][2t], [g][2t+1], [g+8][2t], [g+8][2t+1]}.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d (16x8, f32) += a (16x8, tf32, row) * b (8x8, tf32, col).  Lane (g, t):
// a = {[g][t], [g+8][t], [g][t+4], [g+8][t+4]}, b0 = [t][g], b1 = [t+4][g],
// d as above.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d = a * b, the same shapes, nothing added in
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const unsigned (&a)[4],
                                              unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}
// x rounded to tf32 (10 mantissa bits), as the bits of a float
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// ---- end PTX wrappers ----

// x = hi + lo with both in tf32: the split that keeps float32 products right
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16(v);
}

// What differs between the two element types: the MMA and how its operands
// are read from shared memory.  A tile of A is 16 positions x KS channels at
// `tile` (row stride ld), a tile of B is KS channels x 16 outputs; an
// accumulator pair is the two 16x8 halves of a 16x16 output tile.
template <typename T> struct Mma;

// bfloat16: one m16n8k16 per half, operands by ldmatrix.  Channel strides of
// C + 8 elements keep rows 16-byte aligned under any position shift and put
// the eight rows of an ldmatrix in eight different bank groups.
template <> struct Mma<bf16> {
  static constexpr int KS = 16, PAD_A = 8, PAD_B = 8;
  struct A { unsigned r[4]; };
  struct B { unsigned r[4]; };
  __device__ static void load_a(A& a, const bf16* tile, int ld, int lane) {
    ldsm_x4(a.r, tile + (lane & 15) * ld + ((lane >> 4) << 3));
  }
  __device__ static void load_b(B& b, const bf16* tile, int ld, int lane) {
    ldsm_x4_t(b.r, tile + (lane & 15) * ld + ((lane >> 4) << 3));
  }
  __device__ static void mma(float (&d0)[4], float (&d1)[4], const A& a,
                             const B& b) {
    mma_bf16(d0, a.r, b.r[0], b.r[1]);
    mma_bf16(d1, a.r, b.r[2], b.r[3]);
  }
};

// float32: split-TF32.  Every operand is split into hi + lo (two tf32
// values) as it is read, and a product is three m16n8k8: lo*hi + hi*lo +
// hi*hi (the lo*lo term is below float32's rounding).  The tensor cores add
// into their accumulator with less than a full rounding (an error that grows
// with the number of MMAs chained: 2.5e-5 of the output scale at K = 2304),
// so only those three are chained and their sum joins the float32
// accumulators by ordinary adds.  Strides of C + 4 (A) and N + 8 (B) floats
// make the scalar fragment reads conflict-free.
template <> struct Mma<float> {
  static constexpr int KS = 8, PAD_A = 4, PAD_B = 8;
  struct A { unsigned hi[4], lo[4]; };
  struct B { unsigned hi[4], lo[4]; };
  __device__ static void load_a(A& a, const float* tile, int ld, int lane) {
    const float* p = tile + (lane >> 2) * ld + (lane & 3);
    split_tf32(p[0], a.hi[0], a.lo[0]);
    split_tf32(p[8 * ld], a.hi[1], a.lo[1]);
    split_tf32(p[4], a.hi[2], a.lo[2]);
    split_tf32(p[8 * ld + 4], a.hi[3], a.lo[3]);
  }
  __device__ static void load_b(B& b, const float* tile, int ld, int lane) {
    const float* p = tile + (lane & 3) * ld + (lane >> 2);
    split_tf32(p[0], b.hi[0], b.lo[0]);
    split_tf32(p[4 * ld], b.hi[1], b.lo[1]);
    split_tf32(p[8], b.hi[2], b.lo[2]);
    split_tf32(p[4 * ld + 8], b.hi[3], b.lo[3]);
  }
  __device__ static void mma(float (&d0)[4], float (&d1)[4], const A& a,
                             const B& b) {
    float p0[4], p1[4];
    mma_tf32_zero(p0, a.lo, b.hi[0], b.hi[1]);
    mma_tf32_zero(p1, a.lo, b.hi[2], b.hi[3]);
    mma_tf32(p0, a.hi, b.lo[0], b.lo[1]);
    mma_tf32(p1, a.hi, b.lo[2], b.lo[3]);
    mma_tf32(p0, a.hi, b.hi[0], b.hi[1]);
    mma_tf32(p1, a.hi, b.hi[2], b.hi[3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      d0[e] += p0[e];
      d1[e] += p1[e];
    }
  }
};

// Shared memory of a block, byte offsets (each a multiple of 128).  The
// epilogue's scratch lies over the input tile, which is dead by then.
struct Layout {
  int in_off, mid_off, w_off, wstage, w1s_off, total;
};

template <class C, typename T>
__host__ __device__ inline Layout make_layout(int cinc) {
  constexpr int ES = sizeof(T);
  Layout l;
  int off = 0;
  l.in_off = off;
  off += round_up(
      imax((C::CIN1 ? C::NPOS : C::NPOS * (cinc + Mma<T>::PAD_A)) * ES,
           C::NW * 16 * C::SLD * 4),
      128);
  l.mid_off = off;
  off += round_up(C::M1 * (C::CH + Mma<T>::PAD_A) * ES, 128);
  l.w_off = off;
  l.wstage = round_up(imax(C::CIN1 ? 0 : cinc * (C::CH + Mma<T>::PAD_B),
                           C::CH * (C::C2P + Mma<T>::PAD_B)) *
                          C::TG * ES,
                      128);
  off += 2 * l.wstage;
  l.w1s_off = off;
  if (C::CIN1) off += round_up(10 * C::CH * 4, 128);
  l.total = off;
  return l;
}

// relu(v[0..8)) in the element type, stored as 16-byte words
__device__ __forceinline__ void store8_relu(bf16* dst, const float* v) {
  __nv_bfloat162 p[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    p[e] = __floats2bfloat162_rn(fmaxf(v[2 * e], 0.f),
                                 fmaxf(v[2 * e + 1], 0.f));
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<uint4*>(p);
}
__device__ __forceinline__ void store8_relu(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(
      fmaxf(v[0], 0.f), fmaxf(v[1], 0.f), fmaxf(v[2], 0.f), fmaxf(v[3], 0.f));
  reinterpret_cast<float4*>(dst)[1] = make_float4(
      fmaxf(v[4], 0.f), fmaxf(v[5], 0.f), fmaxf(v[6], 0.f), fmaxf(v[7], 0.f));
}
// relu(a), relu(b) in the element type at dst[0], dst[1]
__device__ __forceinline__ void store2_relu(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) =
      __floats2bfloat162_rn(fmaxf(a, 0.f), fmaxf(b, 0.f));
}
__device__ __forceinline__ void store2_relu(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(fmaxf(a, 0.f), fmaxf(b, 0.f));
}

template <class C, typename T>
__global__ void __launch_bounds__(C::NT, C::MINB)
double_conv3x3_mma_kernel(const T* __restrict__ x, const T* __restrict__ w1p,
                          const T* __restrict__ b1, const T* __restrict__ w2p,
                          const T* __restrict__ b2, T* __restrict__ y, int cin,
                          int h, int w, int c1, int c2, int cinp, int c1p,
                          int c2p, int cinc, int tiles_x) {
  using M = Mma<T>;
  constexpr int P = C::P;
  constexpr int KS = M::KS;                  // channels per MMA step
  constexpr int VEC = 16 / sizeof(T);        // elements per 16 bytes
  constexpr int LDM = C::CH + M::PAD_A;      // channel strides in shared
  constexpr int LDW1 = C::CH + M::PAD_B;
  constexpr int LDW2 = C::C2P + M::PAD_B;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = make_layout<C, T>(cinc);
  T* in_s = reinterpret_cast<T*>(smem + lay.in_off);
  T* mid_s = reinterpret_cast<T*>(smem + lay.mid_off);
  float* w1s = reinterpret_cast<float*>(smem + lay.w1s_off);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int g = lane >> 2, t4 = lane & 3;       // a lane's place in an MMA
  const int ty0 = (blockIdx.x / tiles_x) * C::TH;
  const int tx0 = (blockIdx.x % tiles_x) * C::TW;
  const int c2_0 = blockIdx.y * C::C2P;
  const int img = blockIdx.z;
  const int ho = h - 4, wo = w - 4;
  const int lda = C::CIN1 ? 1 : cinc + M::PAD_A;
  const int n_i = C::CIN1 ? 0 : (cinp + cinc - 1) / cinc;   // Cin chunks
  const int n_j = (c1p + C::CH - 1) / C::CH;                // C1 chunks
  const int per_j = (n_i + 1) * C::G;    // weight stages of one C1 chunk
  const int n_stages = n_j * per_j;

  // Stage `s` of the weight stream is TG taps of one chunk: conv1 stages
  // ([Cin chunk][tap group]) then conv2's tap groups, for each C1 chunk in
  // turn.
  auto wbuf = [&](int s) {
    return reinterpret_cast<T*>(smem + lay.w_off + (s & 1) * lay.wstage);
  };
  auto prefetch_stage = [&](int s) {
    const int j = s / per_j, r = s % per_j;
    const int cur = min(C::CH, c1p - j * C::CH);
    const T* src;
    int rows, cols, stride, ld, tap_rows, tap_ld;
    if (r < C::G * n_i) {
      const int i = r / C::G, tap = (r % C::G) * C::TG;
      rows = min(cinc, cinp - i * cinc);
      cols = cur;
      stride = c1p;
      ld = LDW1;
      tap_rows = cinp;                   // rows from one tap to the next
      tap_ld = cinc;
      src = w1p + ((size_t)tap * cinp + i * cinc) * c1p + j * C::CH;
    } else {
      const int tap = (r - C::G * n_i) * C::TG;
      rows = cur;
      cols = C::C2P;
      stride = c2p;
      ld = LDW2;
      tap_rows = c1p;
      tap_ld = C::CH;
      src = w2p + ((size_t)tap * c1p + j * C::CH) * c2p + c2_0;
    }
    T* dst = wbuf(s);
    const int cpr = cols / VEC;          // 16-byte pieces per row
    for (int u = 0; u < C::TG; ++u)
      for (int p = tid; p < rows * cpr; p += C::NT) {
        const int rr = p / cpr, cv = (p % cpr) * VEC;
        cp_async16(dst + (u * tap_ld + rr) * ld + cv,
                   src + ((size_t)u * tap_rows + rr) * stride + cv);
      }
    cp_async_commit();
  };

  // The input tile with its halo, [position][channel], zero beyond the
  // image, below the tile's rows and in the padded channels.  Global reads
  // run along W.
  auto stage_input = [&](int i) {
    const T* xb = x + (size_t)img * cin * h * w;
    if (C::CIN1) {
      for (int pos = tid; pos < C::NPOS; pos += C::NT) {
        const int gy = ty0 + pos / P, gx = tx0 + pos % P;
        in_s[pos] = (pos < (C::TH + 4) * P && gy < h && gx < w)
                        ? xb[(size_t)gy * w + gx]
                        : from_float<T>(0.f);
      }
    } else {
      // one thread: 16 bytes of channels of one position, the loads in
      // flight together and one store; lanes run along positions
      const int cvn = min(cinc, cinp - i * cinc) / VEC;
      for (int idx = tid; idx < cvn * C::NPOS; idx += C::NT) {
        const int c0 = (idx / C::NPOS) * VEC, pos = idx % C::NPOS;
        const int gy = ty0 + pos / P, gx = tx0 + pos % P;
        const bool in = pos < (C::TH + 4) * P && gy < h && gx < w;
        const T* src = xb + ((size_t)(i * cinc + c0) * h + gy) * w + gx;
        __align__(16) T v[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          v[e] = (in && i * cinc + c0 + e < cin) ? src[(size_t)e * h * w]
                                                 : from_float<T>(0.f);
        *reinterpret_cast<uint4*>(in_s + pos * lda + c0) =
            *reinterpret_cast<const uint4*>(v);
      }
    }
  };

  // accumulators: [16x16 tile][its two 16x8 halves][4 floats a lane]; lane
  // (g, t) holds rows g and g + 8, columns 2t and 2t + 1 of a half
  float acc2[C::FM][C::FN * 2][4];
  float acc1[C::TPW1][C::F1M][C::F1N * 2][4];
#pragma unroll
  for (int fm = 0; fm < C::FM; ++fm)
#pragma unroll
    for (int nb = 0; nb < C::FN * 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[fm][nb][e] = 0.f;

  prefetch_stage(0);
  if (C::CIN1 || n_i == 1) stage_input(0);

  for (int s = 0; s < n_stages; ++s) {
    const int j = s / per_j, r = s % per_j;
    const int cur = min(C::CH, c1p - j * C::CH);
    const bool is_conv1 = r < C::G * n_i;
    const int tg = is_conv1 ? r % C::G : r - C::G * n_i;   // tap group
    const int ci = is_conv1 ? r / C::G : 0;
    // (all warps are past the previous stage's trailing barrier here)
    if (!C::CIN1 && n_i > 1 && is_conv1 && tg == 0) stage_input(ci);
    if (s + 1 < n_stages) {
      prefetch_stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* wb = wbuf(s);

    if (is_conv1) {
      if (!C::CIN1) {
        if (ci == 0 && tg == 0) {
#pragma unroll
          for (int t = 0; t < C::TPW1; ++t)
#pragma unroll
            for (int fm = 0; fm < C::F1M; ++fm)
#pragma unroll
              for (int nb = 0; nb < C::F1N * 2; ++nb)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc1[t][fm][nb][e] = 0.f;
        }
        const int kk_n = min(cinc, cinp - ci * cinc) / KS;
#pragma unroll
        for (int t = 0; t < C::TPW1; ++t) {
          const int tile = warp + t * C::NW;
          const int tm = tile / C::T1N, tn = tile % C::T1N;
          if (tm < C::T1M && tn * C::F1N * 16 < cur) {
#pragma unroll 1
            for (int u = 0; u < C::TG; ++u) {
              const int tap = tg * C::TG + u;
              // a tap is a pointer shift
              const T* a_base =
                  in_s + (tm * C::F1M * 16 + (tap / 3) * P + tap % 3) * lda;
              const T* b_base = wb + u * cinc * LDW1 + tn * C::F1N * 16;
#pragma unroll 2
              for (int kk = 0; kk < kk_n; ++kk) {
                typename M::B fb[C::F1N];
#pragma unroll
                for (int fn = 0; fn < C::F1N; ++fn)
                  M::load_b(fb[fn], b_base + kk * KS * LDW1 + fn * 16, LDW1,
                            lane);
#pragma unroll
                for (int fm = 0; fm < C::F1M; ++fm) {
                  if (tm * C::F1M + fm < C::M1F) {
                    typename M::A fa;
                    M::load_a(fa, a_base + fm * 16 * lda + kk * KS, lda,
                              lane);
#pragma unroll
                    for (int fn = 0; fn < C::F1N; ++fn)
                      M::mma(acc1[t][fm][2 * fn], acc1[t][fm][2 * fn + 1],
                             fa, fb[fn]);
                  }
                }
              }
            }
          }
        }
        if (ci == n_i - 1 && tg == C::G - 1) {
          // conv1's chunk is complete: bias + relu + round to the element
          // type -> mid_s, straight from the accumulator registers
#pragma unroll
          for (int t = 0; t < C::TPW1; ++t) {
            const int tile = warp + t * C::NW;
            const int tm = tile / C::T1N, tn = tile % C::T1N;
            if (tm < C::T1M && tn * C::F1N * 16 < cur) {
#pragma unroll
              for (int nb = 0; nb < C::F1N * 2; ++nb) {
                const int n = tn * C::F1N * 16 + nb * 8 + 2 * t4;
                const int gc1 = j * C::CH + n;
                const float bias0 = gc1 < c1 ? to_float(b1[gc1]) : 0.f;
                const float bias1 =
                    gc1 + 1 < c1 ? to_float(b1[gc1 + 1]) : 0.f;
#pragma unroll
                for (int fm = 0; fm < C::F1M; ++fm) {
                  const int mf = tm * C::F1M + fm;
                  if (mf < C::M1F) {
                    const float* a = acc1[t][fm][nb];
                    T* dst = mid_s + (mf * 16 + g) * LDM + n;
                    store2_relu(dst, a[0] + bias0, a[1] + bias1);
                    store2_relu(dst + 8 * LDM, a[2] + bias0, a[3] + bias1);
                  }
                }
              }
            }
          }
        }
      }
    } else {
      if (C::CIN1 && tg == 0) {
        // conv1 of this chunk on the CUDA cores (Cin == 1: 9 FMAs a value)
        for (int idx = tid; idx < 10 * C::CH; idx += C::NT) {
          const int t = idx / C::CH, c = idx % C::CH, gc1 = j * C::CH + c;
          w1s[idx] = t < 9 ? to_float(w1p[(size_t)t * cinp * c1p + gc1])
                           : (gc1 < c1 ? to_float(b1[gc1]) : 0.f);
        }
        __syncthreads();
        constexpr int C8 = C::CH / 8;
        for (int idx = tid; idx < C::M1 * C8; idx += C::NT) {
          const int q = idx / C8, c0 = (idx % C8) * 8;
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = 0.f;
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            const float xv = to_float(in_s[q + (t / 3) * P + t % 3]);
            const float4 wa =
                *reinterpret_cast<const float4*>(w1s + t * C::CH + c0);
            const float4 wb4 =
                *reinterpret_cast<const float4*>(w1s + t * C::CH + c0 + 4);
            const float wv[8] = {wa.x,  wa.y,  wa.z,  wa.w,
                                 wb4.x, wb4.y, wb4.z, wb4.w};
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = fmaf(xv, wv[e], v[e]);
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += w1s[9 * C::CH + c0 + e];
          store8_relu(mid_s + q * LDM + c0, v);
        }
        __syncthreads();
      }
      // fold this chunk's taps into the conv2 accumulators (registers)
#pragma unroll 1
      for (int u = 0; u < C::TG; ++u) {
        const int tap = tg * C::TG + u;
        const T* a_base =
            mid_s + (wm * C::MW + (tap / 3) * P + tap % 3) * LDM;
        const T* b_base = wb + u * C::CH * LDW2 + wn * C::FN * 16;
#pragma unroll
        for (int kk = 0; kk < C::CH / KS; ++kk) {
          if (kk * KS < cur) {
            typename M::B fb[C::FN];
#pragma unroll
            for (int fn = 0; fn < C::FN; ++fn)
              M::load_b(fb[fn], b_base + kk * KS * LDW2 + fn * 16, LDW2,
                        lane);
#pragma unroll
            for (int fm = 0; fm < C::FM; ++fm) {
              if (wm * C::FM + fm < C::M2F) {
                typename M::A fa;
                M::load_a(fa, a_base + fm * 16 * LDM + kk * KS, LDM, lane);
#pragma unroll
                for (int fn = 0; fn < C::FN; ++fn)
                  M::mma(acc2[fm][2 * fn], acc2[fm][2 * fn + 1], fa, fb[fn]);
              }
            }
          }
        }
      }
    }
    __syncthreads();   // this stage's buffers may be overwritten
  }

  // Epilogue, 16 channels at a time: a warp's accumulators -> its scratch
  // (over the dead input tile), position-major per channel -> bias + relu +
  // cast -> NCHW with the lanes along W, masked at the image edge and the
  // wrapped columns.
  float* scr = reinterpret_cast<float*>(smem + lay.in_off) +
               warp * 16 * C::SLD;
  T* yb = y + (size_t)img * c2 * ho * wo;
#pragma unroll
  for (int fn = 0; fn < C::FN; ++fn) {
#pragma unroll
    for (int fm = 0; fm < C::FM; ++fm)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const float* a = acc2[fm][2 * fn + nb];
        float* dst = scr + (nb * 8 + 2 * t4) * C::SLD + fm * 16 + g;
        dst[0] = a[0];
        dst[C::SLD] = a[1];
        dst[8] = a[2];
        dst[C::SLD + 8] = a[3];
      }
    __syncwarp();
    for (int n = 0; n < 16; ++n) {
      const int ch = c2_0 + (wn * C::FN + fn) * 16 + n;
      if (ch >= c2) break;
      const float bias = to_float(b2[ch]);
      for (int m = lane; m < C::MW; m += 32) {
        const int q = wm * C::MW + m;
        const int rr = q / P, cc = q % P;
        const int gy = ty0 + rr, gx = tx0 + cc;
        if (rr < C::TH && cc < C::TW && gy < ho && gx < wo)
          yb[((size_t)ch * ho + gy) * wo + gx] =
              from_float<T>(fmaxf(scr[n * C::SLD + m] + bias, 0.f));
      }
    }
    __syncwarp();
  }
}

template <class C, typename T>
int launch(const void* x, const void* w1p, const void* b1, const void* w2p,
           const void* b2, void* y, int batch, int cin, int h, int w, int c1,
           int c2, int cinp, int c1p, int c2p, cudaStream_t stream) {
  // the widest Cin chunk (a multiple of 16) whose tile fits a block
  int cinc = cinp < CINC_MAX ? cinp : CINC_MAX;
  while (cinc > 16 && make_layout<C, T>(cinc).total > SMEM_LIMIT) cinc -= 16;
  const Layout lay = make_layout<C, T>(cinc);
  if (lay.total > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      double_conv3x3_mma_kernel<C, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (w - 4 + C::TW - 1) / C::TW;
  const int tiles_y = (h - 4 + C::TH - 1) / C::TH;
  const dim3 grid(tiles_x * tiles_y, c2p / C::C2P, batch);
  double_conv3x3_mma_kernel<C, T><<<grid, C::NT, lay.total, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1p),
      static_cast<const T*>(b1), static_cast<const T*>(w2p),
      static_cast<const T*>(b2), static_cast<T*>(y), cin, h, w, c1, c2, cinp,
      c1p, c2p, cinc, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

// The instantiations, one per element type and output-channel width.  Tile
// shapes follow the U-Net's cells: outputs of 252 = 21*12 = 9*28,
// 122 ~ 16*8 = 4*31, 57 ~ 6*10 = 3*19 and 24 = 2*12 = 3*8 pixels a side.
// Warp layouts and tap groups are the fastest of those timed with
// `scripts/k2_tune.py` on an H100 (8 to 12 warps a block; more warps with
// smaller tiles per warp and whole 9-tap stages were slower, and so were
// tiles that spill registers).  float32 elements take twice the shared
// memory, hence its shorter chunks and tap groups.  A build may override a
// shape with a `#define UNCLTMO_K2_CFG64 ...` in a force-included header
// (`scripts/k2_tune.py` times such variants).
//      TH, TW, FM, FN, C2P, CH, F1M, F1N, TG, MINB
#ifndef UNCLTMO_K2_CFGINC
#define UNCLTMO_K2_CFGINC 12, 28, 3, 2, 32, 32, 2, 2, 3, 2
#endif
#ifndef UNCLTMO_K2_CFG32
#define UNCLTMO_K2_CFG32 12, 28, 3, 2, 32, 32, 2, 2, 3, 1
#endif
#ifndef UNCLTMO_K2_CFG64
#define UNCLTMO_K2_CFG64 8, 31, 3, 2, 64, 32, 2, 2, 3, 1
#endif
#ifndef UNCLTMO_K2_CFG128
#define UNCLTMO_K2_CFG128 10, 19, 5, 2, 128, 32, 2, 2, 3, 1
#endif
#ifndef UNCLTMO_K2_CFG256
#define UNCLTMO_K2_CFG256 12, 8, 3, 4, 256, 64, 2, 2, 1, 1
#endif
#ifndef UNCLTMO_K2F_CFGINC
#define UNCLTMO_K2F_CFGINC 12, 28, 3, 2, 32, 32, 2, 2, 9, 1
#endif
#ifndef UNCLTMO_K2F_CFG32
#define UNCLTMO_K2F_CFG32 12, 28, 3, 2, 32, 32, 2, 2, 3, 1
#endif
#ifndef UNCLTMO_K2F_CFG64
#define UNCLTMO_K2F_CFG64 8, 31, 3, 2, 64, 32, 2, 2, 3, 1
#endif
#ifndef UNCLTMO_K2F_CFG128
#define UNCLTMO_K2F_CFG128 8, 19, 4, 2, 128, 32, 2, 2, 3, 1
#endif
#ifndef UNCLTMO_K2F_CFG256
#define UNCLTMO_K2F_CFG256 12, 8, 3, 4, 256, 32, 2, 1, 1, 1
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
  using Inc = Cfg<UNCLTMO_K2F_CFGINC, true>;
  using C32 = Cfg<UNCLTMO_K2F_CFG32, false>;
  using C64 = Cfg<UNCLTMO_K2F_CFG64, false>;
  using C128 = Cfg<UNCLTMO_K2F_CFG128, false>;
  using C256 = Cfg<UNCLTMO_K2F_CFG256, false>;
};

template <typename T>
int dispatch(const void* x, const void* w1p, const void* b1, const void* w2p,
             const void* b2, void* y, int batch, int cin, int h, int w,
             int c1, int c2, cudaStream_t s) {
  // the padding `pack_double_conv_weights` applied
  const int cinp = round_up(cin, 16), c1p = round_up(c1, 32);
  const int c2p = c2 <= 32 ? 32 : c2 <= 64 ? 64 : c2 <= 128 ? 128
                                                            : round_up(c2, 256);
  if (c2p > 256 * 65535) return static_cast<int>(cudaErrorInvalidValue);
#define UNCLTMO_K2_LAUNCH(CFG)                                            \
  launch<typename Cfgs<T>::CFG, T>(x, w1p, b1, w2p, b2, y, batch, cin, h, \
                                   w, c1, c2, cinp, c1p, c2p, s)
  if (c2p == 32) return cin == 1 ? UNCLTMO_K2_LAUNCH(Inc)
                                 : UNCLTMO_K2_LAUNCH(C32);
  if (c2p == 64) return UNCLTMO_K2_LAUNCH(C64);
  if (c2p == 128) return UNCLTMO_K2_LAUNCH(C128);
  return UNCLTMO_K2_LAUNCH(C256);
#undef UNCLTMO_K2_LAUNCH
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
// The weights come packed as [tap][Cin_p][C1_p] and [tap][C1_p][C2_p], zero
// in the padding, with Cin_p = Cin rounded up to 16, C1_p = C1 to 32,
// C2_p = 32, 64, 128 or C2 rounded up to 256 (`pack_double_conv_weights` in
// ops/kernels/double_conv.py).
int uncltmo_double_conv3x3(const void* x, const void* w1p, const void* b1,
                           const void* w2p, const void* b2, void* y,
                           int batch, int cin, int h, int w, int c1, int c2,
                           int dtype, void* stream) {
  if (h < 5 || w < 5 || batch < 1 || batch > 65535 || cin < 1 || c1 < 1 ||
      c2 < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w1p, b1, w2p, b2, y, batch, cin, h,
                                       w, c1, c2, s);
  return dispatch<float>(x, w1p, b1, w2p, b2, y, batch, cin, h, w, c1,
                             c2, s);
}

const char* uncltmo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
