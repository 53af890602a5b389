// K2: fused (valid 3x3 conv -> bias -> relu) x 2 on NCHW tensors, Hopper.
//
// Replaces the TPU kernel `fused_double_conv3x3`
// (uncltmo_tpu/ops/pallas_kernels.py:88-132, body `_make_kernel` :68-85).
// It runs the U-Net cells inc (1->32->32 @256^2), down0 (32->64->64 @126^2),
// down1 (64->128->128 @61^2) and down2 (128->256->256 @28^2).
//
// Bound: operations.  The cells do 2*9*Cin*C1 + 2*9*C1*C2 flops per output
// pixel against a few bytes of input and output, far above the card's
// flop:byte ridge, so the kernel's job is to keep the intermediate
// activation out of device memory (as the TPU kernel keeps it in VMEM) and
// to feed the FMA units from shared memory.
//
// Design (a first, simple kernel on the CUDA cores; tensor cores come later):
//  * one block of 128 threads per (image, 8x16 output tile, group of G2
//    output channels);
//  * the intermediate channels are walked in chunks of CG = 8: for each
//    chunk the block stages the input tile plus its 2-pixel halo (12x20,
//    CI = 8 input channels at a time) and the chunk's conv1 weights in
//    shared memory, computes conv1 + bias + relu for the 10x18
//    intermediate tile into shared memory, then adds that chunk's share of
//    conv2 into per-thread register accumulators (one output pixel x G2
//    channels per thread).  The intermediate never touches device memory;
//  * conv1 is recomputed once per output-channel group (C2 / G2 times) and
//    on the tile halo: the price of needing no block-to-block exchange;
//  * weights arrive pre-transposed ([Cin][3][3][C1] and [C1][3][3][C2]) so
//    staging loads are coalesced and shared-memory reads are float4
//    broadcasts;
//  * float32 accumulation.  With bfloat16 inputs the intermediate is rounded
//    to bfloat16 as in the TPU kernel (`mid.astype(x.dtype)`).
//
// Plain C interface, loaded with ctypes: no PyTorch headers, so nvcc builds
// it in seconds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int OH = 8;                 // output tile rows
constexpr int OW = 16;                // output tile columns
constexpr int MH = OH + 2;            // intermediate tile
constexpr int MW = OW + 2;
constexpr int IH = OH + 4;            // input tile
constexpr int IW = OW + 4;
constexpr int MPIX = MH * MW;         // 180
constexpr int IPIX = IH * IW;         // 240
constexpr int THREADS = OH * OW;      // 128: one output pixel per thread
constexpr int MPT = (MPIX + THREADS - 1) / THREADS;  // intermediate px/thread
constexpr int CG = 8;                 // intermediate channels per chunk
constexpr int CI = 8;                 // input channels staged at a time

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int G2>
__global__ void __launch_bounds__(THREADS)
double_conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w1t,
                      const T* __restrict__ b1, const T* __restrict__ w2t,
                      const T* __restrict__ b2, T* __restrict__ y, int cin,
                      int h, int w, int c1, int c2, int tiles_x) {
  __shared__ float in_s[CI][IPIX];
  __shared__ __align__(16) float w1_s[CI][9][CG];
  __shared__ float mid_s[CG][MPIX];
  __shared__ __align__(16) float w2_s[CG][9][G2];

  const int tid = threadIdx.x;
  const int ty0 = (blockIdx.x / tiles_x) * OH;
  const int tx0 = (blockIdx.x % tiles_x) * OW;
  const int c2_0 = blockIdx.y * G2;
  const int ho = h - 4, wo = w - 4;
  const T* xb = x + (size_t)blockIdx.z * cin * h * w;
  const int oy = tid / OW, ox = tid % OW;

  float acc2[G2];
#pragma unroll
  for (int g = 0; g < G2; ++g) acc2[g] = 0.f;

  for (int c1_0 = 0; c1_0 < c1; c1_0 += CG) {
    float acc1[MPT][CG];
#pragma unroll
    for (int j = 0; j < MPT; ++j)
#pragma unroll
      for (int c = 0; c < CG; ++c) acc1[j][c] = 0.f;

    for (int ci_0 = 0; ci_0 < cin; ci_0 += CI) {
      __syncthreads();  // the previous chunk's reads of in_s / w1_s are done
      for (int i = tid; i < CI * IPIX; i += THREADS) {
        const int ci = i / IPIX, p = i % IPIX;
        const int gy = ty0 + p / IW, gx = tx0 + p % IW, gc = ci_0 + ci;
        float v = 0.f;
        if (gc < cin && gy < h && gx < w)
          v = to_f(xb[((size_t)gc * h + gy) * w + gx]);
        in_s[ci][p] = v;
      }
      for (int i = tid; i < CI * 9 * CG; i += THREADS) {
        const int c = i % CG, r = i / CG;
        const int ci = r / 9, k = r % 9;
        const int gc1 = c1_0 + c, gci = ci_0 + ci;
        float v = 0.f;
        if (gc1 < c1 && gci < cin)
          v = to_f(w1t[((size_t)gci * 9 + k) * c1 + gc1]);
        w1_s[ci][k][c] = v;
      }
      __syncthreads();
#pragma unroll 1
      for (int ci = 0; ci < CI; ++ci) {
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const int ky = k / 3, kx = k % 3;
          const float4 wa = *reinterpret_cast<const float4*>(&w1_s[ci][k][0]);
          const float4 wb = *reinterpret_cast<const float4*>(&w1_s[ci][k][4]);
          const float wv[CG] = {wa.x, wa.y, wa.z, wa.w,
                                wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < MPT; ++j) {
            const int p = tid + j * THREADS;
            if (p < MPIX) {
              const float xv =
                  in_s[ci][(p / MW + ky) * IW + p % MW + kx];
#pragma unroll
              for (int c = 0; c < CG; ++c) acc1[j][c] += xv * wv[c];
            }
          }
        }
      }
    }

    __syncthreads();  // the previous chunk's conv2 reads of mid_s / w2_s
#pragma unroll
    for (int j = 0; j < MPT; ++j) {
      const int p = tid + j * THREADS;
      if (p < MPIX) {
#pragma unroll
        for (int c = 0; c < CG; ++c) {
          const int gc1 = c1_0 + c;
          const float bias = gc1 < c1 ? to_f(b1[gc1]) : 0.f;
          // round through the storage dtype (a no-op for float32)
          mid_s[c][p] = to_f(from_f<T>(fmaxf(acc1[j][c] + bias, 0.f)));
        }
      }
    }
    for (int i = tid; i < CG * 9 * G2; i += THREADS) {
      const int g = i % G2, r = i / G2;
      const int c = r / 9, k = r % 9;
      const int gc2 = c2_0 + g, gc1 = c1_0 + c;
      float v = 0.f;
      if (gc2 < c2 && gc1 < c1) v = to_f(w2t[((size_t)gc1 * 9 + k) * c2 + gc2]);
      w2_s[c][k][g] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < CG; ++c) {
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float mv = mid_s[c][(oy + k / 3) * MW + ox + k % 3];
        const float4* wp = reinterpret_cast<const float4*>(&w2_s[c][k][0]);
#pragma unroll
        for (int g4 = 0; g4 < G2 / 4; ++g4) {
          const float4 wv = wp[g4];
          acc2[4 * g4 + 0] += mv * wv.x;
          acc2[4 * g4 + 1] += mv * wv.y;
          acc2[4 * g4 + 2] += mv * wv.z;
          acc2[4 * g4 + 3] += mv * wv.w;
        }
      }
    }
  }

  const int gy = ty0 + oy, gx = tx0 + ox;
  if (gy < ho && gx < wo) {
    T* yb = y + (size_t)blockIdx.z * c2 * ho * wo;
#pragma unroll
    for (int g = 0; g < G2; ++g) {
      const int gc2 = c2_0 + g;
      if (gc2 < c2)
        yb[((size_t)gc2 * ho + gy) * wo + gx] =
            from_f<T>(fmaxf(acc2[g] + to_f(b2[gc2]), 0.f));
    }
  }
}

template <typename T, int G2>
int launch(const void* x, const void* w1t, const void* b1, const void* w2t,
           const void* b2, void* y, int batch, int cin, int h, int w, int c1,
           int c2, cudaStream_t stream) {
  const int tiles_x = (w - 4 + OW - 1) / OW;
  const int tiles_y = (h - 4 + OH - 1) / OH;
  const dim3 grid(tiles_x * tiles_y, (c2 + G2 - 1) / G2, batch);
  double_conv3x3_kernel<T, G2><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1t),
      static_cast<const T*>(b1), static_cast<const T*>(w2t),
      static_cast<const T*>(b2), static_cast<T*>(y), cin, h, w, c1, c2,
      tiles_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
int uncltmo_double_conv3x3(const void* x, const void* w1t, const void* b1,
                           const void* w2t, const void* b2, void* y,
                           int batch, int cin, int h, int w, int c1, int c2,
                           int dtype, void* stream) {
  if (h < 5 || w < 5 || batch < 1 || batch > 65535 || cin < 1 || c1 < 1 ||
      c2 < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = c2 <= 32;
  if (dtype == 0)
    return narrow ? launch<float, 32>(x, w1t, b1, w2t, b2, y, batch, cin, h,
                                      w, c1, c2, s)
                  : launch<float, 64>(x, w1t, b1, w2t, b2, y, batch, cin, h,
                                      w, c1, c2, s);
  return narrow ? launch<__nv_bfloat16, 32>(x, w1t, b1, w2t, b2, y, batch,
                                            cin, h, w, c1, c2, s)
                : launch<__nv_bfloat16, 64>(x, w1t, b1, w2t, b2, y, batch,
                                            cin, h, w, c1, c2, s);
}

const char* uncltmo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
