// Fused center crop + ImageNet normalize: uint8 frames -> bf16/f32.
//
// Replaces the Pallas TPU kernel eov_tpu/ops/pallas_preprocess.py
// crop_normalize (_kernel). Per frame: read the crop window of a
// [H, W*3] uint8 frame, compute x * scale[c] - bias[c] in float32 and store
// in the output dtype.
//
// Bound on the H100: memory. Per 224x224 crop it reads ~150 KB and writes
// ~301 KB (bf16) against 2 flops per element, so the least time is the
// bytes over 3.35 TB/s (~0.13 us per frame). Design: one thread per output
// element of a crop row, one block row per (frame, output row), so a warp
// reads 32 neighbouring bytes and writes 32 neighbouring outputs; no shared
// memory, no reuse to exploit.
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

template <typename T>
__device__ __forceinline__ T store_cast(float v);

template <>
__device__ __forceinline__ float store_cast<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 store_cast<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Affine {
  float scale[3];
  float bias[3];
};

template <typename T>
__global__ void crop_normalize_kernel(const uint8_t* __restrict__ in,
                                      T* __restrict__ out, int h, int w3,
                                      int top, int left3, int crop,
                                      Affine aff) {
  const int row = blockIdx.x;   // output row inside the frame
  const int frame = blockIdx.y;
  const int row3 = crop * 3;
  const uint8_t* src =
      in + ((size_t)frame * h + top + row) * (size_t)w3 + left3;
  T* dst = out + ((size_t)frame * crop + row) * (size_t)row3;
  for (int j = threadIdx.x; j < row3; j += blockDim.x) {
    const int c = j % 3;
    const float x = (float)src[j];
    dst[j] = store_cast<T>(__fmaf_rn(x, aff.scale[c], -aff.bias[c]));
  }
}

extern "C" int crop_normalize_launch(const void* in, void* out, int frames,
                                     int h, int w3, int top, int left3,
                                     int crop, const float* scale,
                                     const float* bias, int out_bf16,
                                     void* stream) {
  Affine aff;
  for (int c = 0; c < 3; ++c) {
    aff.scale[c] = scale[c];
    aff.bias[c] = bias[c];
  }
  if (frames > 0 && crop > 0) {
    dim3 grid(crop, frames);
    const int threads = 256;
    cudaStream_t s = (cudaStream_t)stream;
    if (out_bf16) {
      crop_normalize_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
          (const uint8_t*)in, (__nv_bfloat16*)out, h, w3, top, left3, crop,
          aff);
    } else {
      crop_normalize_kernel<float><<<grid, threads, 0, s>>>(
          (const uint8_t*)in, (float*)out, h, w3, top, left3, crop, aff);
    }
  }
  return (int)cudaGetLastError();
}
