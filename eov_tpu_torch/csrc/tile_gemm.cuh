// Device code shared by the fused stack kernels (bottleneck_stack.cu,
// basic_stack.cu) and the stem max-pool (maxpool_s2.cu): the FFMA block
// GEMM with its operands staged in shared memory, the f32 <-> T
// conversions, and the 3x3/s2 max-pool of one pooled pixel. Each .cu that
// includes it is still one self-contained library with a plain C launcher.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileP = 128;  // output pixels per GEMM tile (16 x 8 / thread)
constexpr int kTileN = 64;   // output channels per GEMM tile (16 x 4 / thread)
constexpr int kChunk = 16;   // K per staged chunk
constexpr int kLdA = kChunk + 1;
// Shared memory of the A and B staging tiles of block_gemm.
constexpr size_t kGemmSmem = sizeof(float) * (kTileP * kLdA + kChunk * kTileN);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// acc[i][j] += sum_k A(p, k) * B[k, n0 + c] for the thread's pixels
// p = ty + 16 i (p < P <= 128) and channels c = 4 tx + j (n0 + c < n_cols).
// A(p, k) is a_at(p, k); B is row-major with leading dimension ldb.
template <typename T, typename AFn>
__device__ __forceinline__ void block_gemm(float (&acc)[8][4], int P, int K,
                                           AFn a_at, const T* __restrict__ B,
                                           int ldb, int n_cols, int n0,
                                           float* As, float* Bs) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    for (int e = tid; e < kTileP * kChunk; e += kThreads) {
      const int p = e / kChunk, kk = e % kChunk, k = k0 + kk;
      As[p * kLdA + kk] = (p < P && k < K) ? a_at(p, k) : 0.f;
    }
    for (int e = tid; e < kChunk * kTileN; e += kThreads) {
      const int kk = e / kTileN, c = e % kTileN;
      const int k = k0 + kk, n = n0 + c;
      Bs[e] = (k < K && n < n_cols) ? to_f(B[(size_t)k * ldb + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk * kTileN + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = As[(ty + 16 * i) * kLdA + kk];
        acc[i][0] += a * b.x;
        acc[i][1] += a * b.y;
        acc[i][2] += a * b.z;
        acc[i][3] += a * b.w;
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// Pooled pixel (r, c), channel k, of the 3x3 / stride-2 / pad-1 max-pool of
// one NHWC image img [H2, W2, C] (H2, W2 even). The pad is 0, which equals
// the -inf pad of nn.MaxPool2d(3, 2, 1) on input >= 0 (the post-ReLU stem
// map; not checked). For even H2, W2 only the taps at row 2r-1 = -1 and
// column 2c-1 = -1 fall outside the image, so 0 joins the max exactly
// where the zero-padded map has a pad tap in the window. The max of T
// values is a T value: returned as f32, it converts back exactly.
template <typename T>
__device__ __forceinline__ float pool3x3s2_at(const T* __restrict__ img,
                                              int W2, int C, int r, int c,
                                              int k) {
  float m = to_f(img[((size_t)(2 * r) * W2 + 2 * c) * C + k]);
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    const int y = 2 * r + dy;
    if (y < 0) continue;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int x = 2 * c + dx;
      if (x < 0 || (dy == 0 && dx == 0)) continue;
      m = fmaxf(m, to_f(img[((size_t)y * W2 + x) * C + k]));
    }
  }
  return (r == 0 || c == 0) ? fmaxf(m, 0.f) : m;
}

}  // namespace
