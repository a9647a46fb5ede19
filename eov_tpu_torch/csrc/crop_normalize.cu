// Fused center crop + ImageNet normalize: uint8 frames -> bf16/f32.
//
// Replaces the Pallas TPU kernel eov_tpu/ops/pallas_preprocess.py
// crop_normalize (_kernel). Per frame: read the crop window of a
// [H, W*3] uint8 frame, compute x * scale[c] - bias[c] in float32 and store
// in the output dtype.
//
// Bound on the H100: memory. Per 224x224 crop it reads 150,528 bytes and
// writes 301,056 (bf16) against 2 flops per element, so the least time is
// the bytes over 3.35 TB/s (~0.135 us per frame, 0.0345 ms for 256 frames).
// One thread per output element (the first version) issued a 1-byte load,
// an integer j % 3 and a 2-byte store per element: bound by instructions
// and latency at about a quarter of the memory rate.
//
// Design: a block takes a tile of R consecutive crop rows (R ~ 16) of the
// flattened [frames * crop] row sequence.
//  * Stage: every row's 16-byte-aligned envelope (the crop window's L =
//    3 * crop bytes, widened to 16-byte boundaries: at most ceil((L+15)/16)
//    chunks, 43 for L = 672) goes into shared memory by 16-byte loads, four
//    issued per thread before any is stored, so each SM keeps tens of KB in
//    flight over its resident blocks. Real frames are not 16-byte aligned:
//    UCF101 stored at short side 256 is 256x341, a 1023-byte row whose crop
//    window starts at byte 174, so each row keeps its own offset into its
//    envelope. A chunk that would cross either end of the input tensor (a
//    base pointer at an odd storage offset, the last row of the last frame)
//    is read byte by byte, so no byte outside the tensor is touched.
//  * Compute and store: a thread takes VEC consecutive outputs of a row
//    (8 for bf16, 4 for f32: one 16-byte store), reads their bytes from
//    shared memory as aligned 32-bit words joined by a funnel shift at the
//    row's offset, and does one __fmaf_rn per element. Its channel pattern
//    is fixed: the threads along a row step by a multiple of 3 vectors, so
//    each thread's scale and bias come once from three values. An output
//    row is L * sizeof(T) bytes; where that is not a multiple of 16 (an odd
//    crop) VEC is 1 and the stores are scalar.
// No TMA: a tensor map needs global strides that are multiples of 16
// bytes, and a 1023-byte row stride is not.
//
// Rounding: the affine is ONE fused multiply-add (__fmaf_rn), i.e. the exact
// value of x*scale - bias rounded once to f32, then round-to-nearest-even on
// store. That is what the JAX reference computes where XLA contracts the
// multiply and subtract (its CPU backend does), and what the plain PyTorch
// version computes in float64 (exact there: x has 8 significant bits), so
// the kernel is bit-identical to both.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 256;       // rows per tile (static shared arrays)
constexpr int kThreadsTarget = 256;  // threads per block, about
constexpr int kRowsTarget = 16;      // rows per tile, about
constexpr int kMaxRowThreads = 768;  // threads along a row: a multiple of 3
constexpr int kLoadsPerRound = 4;    // 16-byte loads in flight per thread
constexpr int kSmemLimit = 44 * 1024;  // dynamic, beside the static arrays

struct Affine {
  float scale[3];
  float bias[3];
};

__device__ __forceinline__ float pick3(int c, const float (&v)[3]) {
  return c == 0 ? v[0] : (c == 1 ? v[1] : v[2]);
}

// The 16 bytes at aligned address a, each byte outside [lo, hi) read as 0.
__device__ __noinline__ uint4 load_edge(uintptr_t a, uintptr_t lo,
                                        uintptr_t hi) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const uintptr_t p = a + b;
    if (p >= lo && p < hi) {
      w[b >> 2] |= (uint32_t)(*reinterpret_cast<const uint8_t*>(p))
                   << (8 * (b & 3));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// VEC input bytes of a staged row starting at byte offset o, as floats.
template <int VEC>
__device__ __forceinline__ void read_bytes(const uint8_t* row, int o,
                                           float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    x[0] = (float)row[o];
  } else {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(row) + (o >> 2);
    const uint32_t s = 8u * (uint32_t)(o & 3);
    uint32_t v[VEC / 4];
    v[0] = __funnelshift_r(w[0], w[1], s);
    if constexpr (VEC == 8) v[1] = __funnelshift_r(w[1], w[2], s);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      x[i] = (float)((v[i >> 2] >> (8 * (i & 3))) & 0xffu);
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* dst, const float (&y)[VEC]);

template <>
__device__ __forceinline__ void store_vec<float, 1>(float* dst,
                                                    const float (&y)[1]) {
  *dst = y[0];
}

template <>
__device__ __forceinline__ void store_vec<float, 4>(float* dst,
                                                    const float (&y)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
}

template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16, 1>(
    __nv_bfloat16* dst, const float (&y)[1]) {
  *dst = __float2bfloat16_rn(y[0]);
}

template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16, 8>(
    __nv_bfloat16* dst, const float (&y)[8]) {
  uint32_t p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
    p[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(p[0], p[1], p[2], p[3]);
}

// blockDim = (nx, rpp): nx threads along a row (nx * VEC % 3 == 0 unless one
// pass covers the row), rpp rows at a time. Shared memory: the tile's
// rows * nc chunks, plus one chunk that the last row's word reads may touch.
template <typename T, int VEC>
__global__ void crop_normalize_kernel(const uint8_t* __restrict__ in,
                                      unsigned long long in_bytes,
                                      T* __restrict__ out, long long rows,
                                      int crop, int h, long long w3, int top,
                                      int left3, int nc, int tile_rows,
                                      Affine aff) {
  extern __shared__ uint4 stage[];
  __shared__ uintptr_t env_s[kMaxRows];  // aligned envelope start per row
  __shared__ int mis_s[kMaxRows];        // crop window offset in it

  const int nx = blockDim.x, rpp = blockDim.y;
  const int tid = threadIdx.y * nx + threadIdx.x;
  const int nthreads = nx * rpp;
  const int L = 3 * crop;
  const long long r0 = (long long)blockIdx.x * tile_rows;
  const int nrows = (int)min((long long)tile_rows, rows - r0);
  const uintptr_t lo = reinterpret_cast<uintptr_t>(in);
  const uintptr_t hi = lo + in_bytes;

  for (int i = tid; i < nrows; i += nthreads) {
    const long long r = r0 + i;
    const long long f = r / crop;
    const long long rr = r - f * crop;
    const uintptr_t src = lo + (uintptr_t)((f * h + top + rr) * w3 + left3);
    env_s[i] = src & ~(uintptr_t)15;
    mis_s[i] = (int)(src & 15);
  }
  __syncthreads();

  const int total = nrows * nc;
  for (int c0 = tid; c0 < total; c0 += kLoadsPerRound * nthreads) {
    uint4 v[kLoadsPerRound];
#pragma unroll
    for (int u = 0; u < kLoadsPerRound; ++u) {
      const int c = c0 + u * nthreads;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (c < total) {
        const int row = c / nc;
        const int k = c - row * nc;
        if (16 * k < mis_s[row] + L) {  // the chunk holds window bytes
          const uintptr_t a = env_s[row] + 16 * (uintptr_t)k;
          v[u] = (a >= lo && a + 16 <= hi)
                     ? __ldg(reinterpret_cast<const uint4*>(a))
                     : load_edge(a, lo, hi);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadsPerRound; ++u) {
      const int c = c0 + u * nthreads;
      if (c < total) stage[c] = v[u];
    }
  }
  __syncthreads();

  // This thread's channels: output j = v * VEC + i has channel j % 3, and
  // v steps by nx, a multiple of 3 whenever it loops.
  float sc[VEC], nb[VEC];
  const int c_first = (threadIdx.x * VEC) % 3;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = (c_first + i) % 3;
    sc[i] = pick3(c, aff.scale);
    nb[i] = -pick3(c, aff.bias);
  }
  const int nv = L / VEC;
  const uint8_t* staged = reinterpret_cast<const uint8_t*>(stage);
  for (int rs = threadIdx.y; rs < nrows; rs += rpp) {
    const uint8_t* srow = staged + (size_t)rs * nc * 16;
    const int mis = mis_s[rs];
    T* orow = out + (size_t)(r0 + rs) * L;
    for (int v = threadIdx.x; v < nv; v += nx) {
      float x[VEC], y[VEC];
      read_bytes<VEC>(srow, mis + v * VEC, x);
#pragma unroll
      for (int i = 0; i < VEC; ++i) y[i] = __fmaf_rn(x[i], sc[i], nb[i]);
      store_vec<T, VEC>(orow + (size_t)v * VEC, y);
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const uint8_t* in, unsigned long long in_bytes, T* out,
                   long long frames, int h, int w, int crop, const Affine& aff,
                   cudaStream_t s) {
  const int L = 3 * crop;
  const int nv = L / VEC;
  const int nx = nv <= kMaxRowThreads ? nv : kMaxRowThreads;
  const int rpp = nx >= kThreadsTarget ? 1 : kThreadsTarget / nx;
  int tile_rows = rpp * ((kRowsTarget + rpp - 1) / rpp);
  const int nc = (L + 15 + 15) / 16;  // chunks of a row's envelope
  const int row_bytes = nc * 16;
  while (tile_rows > rpp && tile_rows * row_bytes + 16 > kSmemLimit) {
    tile_rows -= rpp;
  }
  if (tile_rows * row_bytes + 16 > kSmemLimit || tile_rows > kMaxRows) {
    return cudaErrorInvalidValue;
  }
  const long long rows = frames * crop;
  const long long blocks = (rows + tile_rows - 1) / tile_rows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int top = (h - crop) / 2;
  const int left3 = 3 * ((w - crop) / 2);
  crop_normalize_kernel<T, VEC>
      <<<(unsigned)blocks, dim3(nx, rpp), tile_rows * row_bytes + 16, s>>>(
          in, in_bytes, out, rows, crop, h, 3LL * w, top, left3, nc,
          tile_rows, aff);
  return cudaGetLastError();
}

}  // namespace

// in: uint8 [frames, h, w, 3] (any base alignment; in_bytes = its numel);
// out: [frames, crop, crop, 3] in bf16 (out_bf16) or f32, 16-byte aligned.
extern "C" int crop_normalize_launch(const void* in,
                                     unsigned long long in_bytes, void* out,
                                     long long frames, int h, int w, int crop,
                                     const float* scale, const float* bias,
                                     int out_bf16, void* stream) {
  Affine aff;
  for (int c = 0; c < 3; ++c) {
    aff.scale[c] = scale[c];
    aff.bias[c] = bias[c];
  }
  if (frames <= 0 || crop <= 0) return (int)cudaGetLastError();
  const uint8_t* src = static_cast<const uint8_t*>(in);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int L = 3 * crop;
  cudaError_t err;
  if (out_bf16) {
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out);
    err = (L % 8 == 0)
              ? launch<__nv_bfloat16, 8>(src, in_bytes, dst, frames, h, w,
                                         crop, aff, s)
              : launch<__nv_bfloat16, 1>(src, in_bytes, dst, frames, h, w,
                                         crop, aff, s);
  } else {
    float* dst = static_cast<float*>(out);
    err = (L % 4 == 0)
              ? launch<float, 4>(src, in_bytes, dst, frames, h, w, crop, aff,
                                 s)
              : launch<float, 1>(src, in_bytes, dst, frames, h, w, crop, aff,
                                 s);
  }
  return (int)err;
}
