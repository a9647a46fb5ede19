// One stride-1 ResNet bottleneck block, fused: conv1 1x1 -> conv2 3x3 ->
// conv3 1x1 + residual (projected on a stage's entry block), with the folded
// BatchNorm biases and ReLUs. The wrapper (ops/bottleneck.py) launches it
// once per block of the stack.
//
// Replaces the Pallas TPU kernel eov_tpu/ops/pallas_bottleneck.py
// fused_bottleneck_stack (_stack_kernel / _run_chain). The TPU design keeps
// a whole 56x56 map in 128 MiB of VMEM with no spatial tiling; a Hopper SM
// has 227 KB of shared memory, so here one thread block owns TR output rows
// of one image through one block:
//   phase A: conv1 (+bias, ReLU, rounded to T) over the TR rows plus a one
//            row halo above and below, recomputed per tile, into shared
//            memory with a zero column at each edge (the zero padding of the
//            3x3, in place of the TPU's column masks; rows outside the image
//            are zero too);
//   phase B: the 3x3 as one GEMM with K = 9*Cmid whose A operand reads the 9
//            taps straight from that buffer (+bias, ReLU, rounded to T);
//   phase C: conv3, plus the projection x*wd + bd (or x widened to f32),
//            summed in f32, ReLU, one rounding, stored.
// Only the block's input and output touch device memory; the intermediate
// maps (y1, y2) stay in shared memory.
//
// Bound on the H100: operations. ResNet-50 stage 1 is ~1.34 GFLOP per image
// against ~2 MB of input and output, far above the card's ~295 flops/byte
// balance point, so the least time is the flops over the bf16 tensor-core
// peak. This first version is the simple, right one: every GEMM is a tiled
// FFMA loop (A and weight chunks staged in shared memory as f32, a 128x64
// output tile per block, 8x4 outputs per thread), it recomputes conv1 on the
// halo rows, and it does not use the tensor cores. wgmma with TMA-fed
// weight tiles is the way to the bound and is later work.
//
// Rounding follows _run_chain: products of T values accumulate in f32, y1
// and y2 round to T after bias+ReLU, and y3 + b3 + residual is summed in f32
// before the final ReLU and the one rounding.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileP = 128;  // output pixels per GEMM tile (16 x 8 / thread)
constexpr int kTileN = 64;   // output channels per GEMM tile (16 x 4 / thread)
constexpr int kChunk = 16;   // K per staged chunk
constexpr int kLdA = kChunk + 1;

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

struct Dims {
  int n, h, w, cin, cmid, cout, tile_rows;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
bottleneck_block_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                        const float* __restrict__ b1, const T* __restrict__ w2,
                        const float* __restrict__ b2, const T* __restrict__ w3,
                        const float* __restrict__ b3,
                        const T* __restrict__ wd,
                        const float* __restrict__ bd, T* __restrict__ out,
                        Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = d.w, H = d.h, cin = d.cin, cmid = d.cmid, cout = d.cout;
  const int TR = d.tile_rows;
  const int img = blockIdx.y;
  const int r0 = blockIdx.x * TR;
  const int rows = min(TR, H - r0);  // output rows of this tile
  const int halo_rows = rows + 2;
  const int ldy1 = W + 2;            // halo buffer pixels per row

  float* As = reinterpret_cast<float*>(smem_raw);
  float* Bs = As + kTileP * kLdA;
  T* y1s = reinterpret_cast<T*>(Bs + kChunk * kTileN);   // [TR+2][W+2][cmid]
  T* y2s = y1s + (size_t)(TR + 2) * ldy1 * cmid;         // [TR*W][cmid]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const T* ximg = x + (size_t)img * H * W * cin;

  // Zero padding of the 3x3: edge columns and off-image rows stay zero.
  for (int e = tid; e < halo_rows * ldy1 * cmid; e += kThreads)
    y1s[e] = from_f<T>(0.f);
  __syncthreads();

  float acc[8][4];

  // Phase A: y1 = relu(x w1 + b1) over the halo rows, into y1s.
  const int halo_px = halo_rows * W;
  for (int pb = 0; pb < halo_px; pb += kTileP) {
    const int P = min(kTileP, halo_px - pb);
    for (int n0 = 0; n0 < cmid; n0 += kTileN) {
      zero(acc);
      block_gemm<T>(
          acc, P, cin,
          [&](int p, int k) {
            const int hp = pb + p, row = r0 - 1 + hp / W;
            if (row < 0 || row >= H) return 0.f;
            return to_f(ximg[((size_t)row * W + hp % W) * cin + k]);
          },
          w1, cmid, cmid, n0, As, Bs);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = ty + 16 * i;
        if (p >= P) continue;
        const int hp = pb + p, lr = hp / W, col = hp % W;
        const int row = r0 - 1 + lr;
        if (row < 0 || row >= H) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + tx * 4 + j;
          if (c < cmid)
            y1s[((size_t)lr * ldy1 + col + 1) * cmid + c] =
                from_f<T>(fmaxf(acc[i][j] + b1[c], 0.f));
        }
      }
    }
  }
  __syncthreads();

  // Phase B: y2 = relu(conv3x3(y1) + b2); the 9 taps read y1s in place.
  const int P = rows * W;
  for (int n0 = 0; n0 < cmid; n0 += kTileN) {
    zero(acc);
    block_gemm<T>(
        acc, P, 9 * cmid,
        [&](int p, int k) {
          const int tap = k / cmid, ci = k - tap * cmid;
          const int ky = tap / 3, kx = tap - ky * 3;
          const int lr = p / W, col = p - lr * W;
          return to_f(y1s[((size_t)(lr + ky) * ldy1 + col + kx) * cmid + ci]);
        },
        w2, cmid, cmid, n0, As, Bs);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty + 16 * i;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + tx * 4 + j;
        if (c < cmid)
          y2s[(size_t)p * cmid + c] = from_f<T>(fmaxf(acc[i][j] + b2[c], 0.f));
      }
    }
  }
  __syncthreads();

  // Phase C: out = relu((y2 w3 + b3) + residual), residual in f32.
  const T* xtile = ximg + (size_t)r0 * W * cin;
  T* otile = out + ((size_t)img * H * W + (size_t)r0 * W) * cout;
  for (int n0 = 0; n0 < cout; n0 += kTileN) {
    float res[8][4];
    zero(res);
    if (wd != nullptr) {
      block_gemm<T>(
          res, P, cin,
          [&](int p, int k) { return to_f(xtile[(size_t)p * cin + k]); },
          wd, cout, cout, n0, As, Bs);
    }
    zero(acc);
    block_gemm<T>(
        acc, P, cmid,
        [&](int p, int k) { return to_f(y2s[(size_t)p * cmid + k]); },
        w3, cout, cout, n0, As, Bs);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty + 16 * i;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + tx * 4 + j;
        if (c >= cout) continue;
        const float r = wd != nullptr ? res[i][j] + bd[c]
                                      : to_f(xtile[(size_t)p * cin + c]);
        otile[(size_t)p * cout + c] =
            from_f<T>(fmaxf((acc[i][j] + b3[c]) + r, 0.f));
      }
    }
  }
}

template <typename T>
size_t smem_bytes(const Dims& d) {
  return sizeof(float) * (kTileP * kLdA + kChunk * kTileN) +
         sizeof(T) * ((size_t)(d.tile_rows + 2) * (d.w + 2) * d.cmid +
                      (size_t)d.tile_rows * d.w * d.cmid);
}

template <typename T>
int launch(const void* x, const void* w1, const float* b1, const void* w2,
           const float* b2, const void* w3, const float* b3, const void* wd,
           const float* bd, void* out, Dims d, cudaStream_t s) {
  const size_t smem = smem_bytes<T>(d);
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((d.h + d.tile_rows - 1) / d.tile_rows, d.n);
  bottleneck_block_kernel<T><<<grid, kThreads, smem, s>>>(
      (const T*)x, (const T*)w1, b1, (const T*)w2, b2, (const T*)w3, b3,
      (const T*)wd, bd, (T*)out, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long bottleneck_block_smem_bytes(int bf16, int w, int cmid,
                                                 int tile_rows) {
  Dims d{0, 0, w, 0, cmid, 0, tile_rows};
  return bf16 ? (long long)smem_bytes<__nv_bfloat16>(d)
              : (long long)smem_bytes<float>(d);
}

// wd / bd may be null (identity residual, requires cin == cout).
extern "C" int bottleneck_block_launch(const void* x, const void* w1,
                                       const void* b1, const void* w2,
                                       const void* b2, const void* w3,
                                       const void* b3, const void* wd,
                                       const void* bd, void* out, int n, int h,
                                       int w, int cin, int cmid, int cout,
                                       int tile_rows, int bf16, void* stream) {
  if (n == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
  Dims d{n, h, w, cin, cmid, cout, tile_rows};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(x, w1, (const float*)b1, w2,
                                 (const float*)b2, w3, (const float*)b3, wd,
                                 (const float*)bd, out, d, s);
  return launch<float>(x, w1, (const float*)b1, w2, (const float*)b2, w3,
                       (const float*)b3, wd, (const float*)bd, out, d, s);
}
