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
//
// Kernel 5, the pool-at-entry launcher (pool_bottleneck_block_launch), is
// the same kernel with kPool set. It replaces
// eov_tpu/ops/pallas_bottleneck.py fused_pool_bottleneck_stack
// (_pool_stack_kernel): the stem's 3x3/s2 max-pool of the post-ReLU map
// [N, 2H, 2W, 64] runs in the x loader, for the conv1 halo rows and for
// the projection residual alike, each pooled pixel from its 3x3 window of
// the pre-pool map, so the pooled [N, H, W, 64] map is never written or
// read back. The wrapper launches the stage's first block (the projection
// block) through it and the other blocks through kernel 2. Bound: the
// stack's operations, as for kernel 2 (ResNet-50 stage 1 at 256 images bf16:
// 342 GFLOP, 0.346 ms; its 822 MB of input and output take 0.245 ms). The
// pool costs 9 loads per pooled value each time the loader reads it (once
// for conv1, once per 64-channel tile of the projection): they hit L1/L2,
// and the FFMA GEMMs dominate.

#include "tile_gemm.cuh"

namespace {

struct Dims {
  int n, h, w, cin, cmid, cout, tile_rows;
};

// kPool (kernel 5): x is the PRE-pool map [N, 2H, 2W, cin] and the block's
// input is its 3x3/s2 max-pool, built pixel by pixel in the x loader
// (pool3x3s2_at), so the pooled map never reaches device memory. Every
// other line is kernel 2's: the GEMMs see the same operand values in the
// same order, so the block's output equals maxpool -> kernel 2 bit for bit.
template <typename T, bool kPool>
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
  const T* ximg = x + (size_t)img * (kPool ? 4 : 1) * H * W * cin;
  // Channel k of the block input at pixel px = row * W + col of the image.
  auto x_at = [&](int px, int k) -> float {
    if constexpr (kPool) {
      const int row = px / W;
      return pool3x3s2_at(ximg, 2 * W, cin, row, px - row * W, k);
    } else {
      return to_f(ximg[(size_t)px * cin + k]);
    }
  };

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
            return x_at(row * W + hp % W, k);
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
  const int px0 = r0 * W;  // first pixel of the tile
  T* otile = out + ((size_t)img * H * W + (size_t)r0 * W) * cout;
  for (int n0 = 0; n0 < cout; n0 += kTileN) {
    float res[8][4];
    zero(res);
    if (wd != nullptr) {
      block_gemm<T>(
          res, P, cin,
          [&](int p, int k) { return x_at(px0 + p, k); },
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
        const float r = wd != nullptr ? res[i][j] + bd[c] : x_at(px0 + p, c);
        otile[(size_t)p * cout + c] =
            from_f<T>(fmaxf((acc[i][j] + b3[c]) + r, 0.f));
      }
    }
  }
}

template <typename T>
size_t smem_bytes(const Dims& d) {
  return kGemmSmem +
         sizeof(T) * ((size_t)(d.tile_rows + 2) * (d.w + 2) * d.cmid +
                      (size_t)d.tile_rows * d.w * d.cmid);
}

template <typename T, bool kPool>
int launch(const void* x, const void* w1, const float* b1, const void* w2,
           const float* b2, const void* w3, const float* b3, const void* wd,
           const float* bd, void* out, Dims d, cudaStream_t s) {
  const size_t smem = smem_bytes<T>(d);
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_block_kernel<T, kPool>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((d.h + d.tile_rows - 1) / d.tile_rows, d.n);
  bottleneck_block_kernel<T, kPool><<<grid, kThreads, smem, s>>>(
      (const T*)x, (const T*)w1, b1, (const T*)w2, b2, (const T*)w3, b3,
      (const T*)wd, bd, (T*)out, d);
  return (int)cudaGetLastError();
}

template <bool kPool>
int launch_dtype(const void* x, const void* w1, const void* b1,
                 const void* w2, const void* b2, const void* w3,
                 const void* b3, const void* wd, const void* bd, void* out,
                 Dims d, int bf16, cudaStream_t s) {
  if (d.n == 0 || d.h == 0 || d.w == 0) return (int)cudaGetLastError();
  if (bf16)
    return launch<__nv_bfloat16, kPool>(
        x, w1, (const float*)b1, w2, (const float*)b2, w3, (const float*)b3,
        wd, (const float*)bd, out, d, s);
  return launch<float, kPool>(x, w1, (const float*)b1, w2, (const float*)b2,
                              w3, (const float*)b3, wd, (const float*)bd, out,
                              d, s);
}

}  // namespace

extern "C" long long bottleneck_block_smem_bytes(int bf16, int w, int cmid,
                                                 int tile_rows) {
  Dims d{0, 0, w, 0, cmid, 0, tile_rows};
  return bf16 ? (long long)smem_bytes<__nv_bfloat16>(d)
              : (long long)smem_bytes<float>(d);
}

// Kernel 2: one block of the stack. wd / bd may be null (identity
// residual, requires cin == cout).
extern "C" int bottleneck_block_launch(const void* x, const void* w1,
                                       const void* b1, const void* w2,
                                       const void* b2, const void* w3,
                                       const void* b3, const void* wd,
                                       const void* bd, void* out, int n, int h,
                                       int w, int cin, int cmid, int cout,
                                       int tile_rows, int bf16, void* stream) {
  return launch_dtype<false>(x, w1, b1, w2, b2, w3, b3, wd, bd, out,
                             Dims{n, h, w, cin, cmid, cout, tile_rows}, bf16,
                             (cudaStream_t)stream);
}

// Kernel 5: the stem max-pool and one block, from the pre-pool map x
// [n, 2h, 2w, cin]; h, w and tile_rows are of the pooled map.
extern "C" int pool_bottleneck_block_launch(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* w3, const void* b3, const void* wd,
    const void* bd, void* out, int n, int h, int w, int cin, int cmid,
    int cout, int tile_rows, int bf16, void* stream) {
  return launch_dtype<true>(x, w1, b1, w2, b2, w3, b3, wd, bd, out,
                            Dims{n, h, w, cin, cmid, cout, tile_rows}, bf16,
                            (cudaStream_t)stream);
}
