// One stride-1 ResNet basic block, fused (kernel 4): conv1 3x3 -> bias,
// ReLU -> conv2 3x3 -> bias + residual, ReLU, with the folded BatchNorm
// biases; C channels in and out. The wrapper (ops/bottleneck.py
// fused_basic_stack) launches it once per block of the stack.
//
// Replaces the Pallas TPU kernel eov_tpu/ops/pallas_bottleneck.py
// fused_basic_stack (_basic_stack_kernel / _run_basic_chain), which keeps a
// whole map per image in VMEM and runs each 3x3 as nine shifted matmuls
// over one padded scratch with column masks. A Hopper SM has 227 KB of
// shared memory, so here one thread block owns TR output rows of one image
// through one block:
//   phase A: y1 = relu(conv3x3(x) + b1), rounded to T, over the TR rows and
//            a one-row halo above and below (recomputed per tile; halo rows
//            outside the image are skipped, left zero), into shared memory
//            with a zero column at each edge: the 3x3's zero padding. Its
//            A operand reads the nine taps of x straight from device memory;
//   phase B: out = relu((conv3x3(y1) + b2) + x), the sum in f32, one
//            rounding; the nine taps read y1 in shared memory.
// Only x and the block output touch device memory; y1 stays on chip. The
// weights (9*C*C each, 4.5 MiB at C = 512 in bf16) never fit on chip: the
// GEMM streams 16-deep K-chunks of them through shared memory
// (block_gemm, shared with kernel 2).
//
// Tile rows: the wrapper picks the most rows that keep the tile within 512
// output pixels and the shared memory within two blocks per SM, then evens
// the tiles out. ResNet-34 at 224^2 (bf16): TR = 8 at 56^2 (C 64), 10 at
// 28^2 (C 128), 7 at 14^2 (C 256), the whole 7^2 map at C 512. The conv1
// halo then costs 23%, 14%, 14% and 0% more conv1 rows, 7-12% more flops
// per block. In f32 the tiles are about half as tall.
//
// Bound on the H100: operations. Each 3x3 at these shapes is
// 2*H*W*9*C^2 = 231.2 MFLOP per image (every stage alike) against
// 2*H*W*C*2 B of input and output; at 256 images in bf16 the 26 convs of
// stage 1 and the stride-1 tails of stages 2-4 take 1.556 ms at the
// tensor-core peak. This first version is FFMA only (block_gemm's
// 128x64 tiles, 8x4 outputs per thread), so it sits far above that bound;
// wgmma with TMA-fed weight tiles is later work.
//
// Rounding follows _run_basic_chain: f32 sums; y1 rounded to T after
// bias+ReLU; a2 + b2 + x summed in f32, then ReLU and one rounding. The
// unfused forward (models/folded_infer.py) adds the residual in T instead.

#include "tile_gemm.cuh"

namespace {

struct Dims {
  int n, h, w, c, tile_rows;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
basic_block_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                   const float* __restrict__ b1, const T* __restrict__ w2,
                   const float* __restrict__ b2, T* __restrict__ out, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = d.w, H = d.h, C = d.c, TR = d.tile_rows;
  const int img = blockIdx.y;
  const int r0 = blockIdx.x * TR;
  const int rows = min(TR, H - r0);  // output rows of this tile
  const int ldy1 = W + 2;            // halo buffer pixels per row
  // In-image rows of the halo: [lo, hi); buffer row of image row r is
  // r - (r0 - 1).
  const int lo = max(r0 - 1, 0), hi = min(r0 + rows + 1, H);

  float* As = reinterpret_cast<float*>(smem_raw);
  float* Bs = As + kTileP * kLdA;
  T* y1s = reinterpret_cast<T*>(Bs + kChunk * kTileN);  // [TR+2][W+2][C]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const T* ximg = x + (size_t)img * H * W * C;

  for (int e = tid; e < (rows + 2) * ldy1 * C; e += kThreads)
    y1s[e] = from_f<T>(0.f);
  __syncthreads();

  float acc[8][4];

  // Phase A: y1 over the in-image halo rows.
  const int halo_px = (hi - lo) * W;
  for (int pb = 0; pb < halo_px; pb += kTileP) {
    const int P = min(kTileP, halo_px - pb);
    for (int n0 = 0; n0 < C; n0 += kTileN) {
      zero(acc);
      block_gemm<T>(
          acc, P, 9 * C,
          [&](int p, int k) {
            const int tap = k / C, ci = k - tap * C;
            const int ky = tap / 3, kx = tap - ky * 3;
            const int hp = pb + p, hr = hp / W;
            const int row = lo + hr + ky - 1, col = hp - hr * W + kx - 1;
            if (row < 0 || row >= H || col < 0 || col >= W) return 0.f;
            return to_f(ximg[((size_t)row * W + col) * C + ci]);
          },
          w1, C, C, n0, As, Bs);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = ty + 16 * i;
        if (p >= P) continue;
        const int hp = pb + p, hr = hp / W, col = hp - hr * W;
        const int lr = lo + hr - (r0 - 1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + tx * 4 + j;
          if (c < C)
            y1s[((size_t)lr * ldy1 + col + 1) * C + c] =
                from_f<T>(fmaxf(acc[i][j] + b1[c], 0.f));
        }
      }
    }
  }
  __syncthreads();

  // Phase B: out = relu((conv3x3(y1) + b2) + x) over the tile's rows.
  const int out_px = rows * W;
  const T* xtile = ximg + (size_t)r0 * W * C;
  T* otile = out + ((size_t)img * H * W + (size_t)r0 * W) * C;
  for (int pb = 0; pb < out_px; pb += kTileP) {
    const int P = min(kTileP, out_px - pb);
    for (int n0 = 0; n0 < C; n0 += kTileN) {
      zero(acc);
      block_gemm<T>(
          acc, P, 9 * C,
          [&](int p, int k) {
            const int tap = k / C, ci = k - tap * C;
            const int ky = tap / 3, kx = tap - ky * 3;
            const int op = pb + p, lr = op / W, col = op - lr * W;
            return to_f(y1s[((size_t)(lr + ky) * ldy1 + col + kx) * C + ci]);
          },
          w2, C, C, n0, As, Bs);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = ty + 16 * i;
        if (p >= P) continue;
        const size_t op = (size_t)(pb + p) * C;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + tx * 4 + j;
          if (c < C)
            otile[op + c] = from_f<T>(
                fmaxf((acc[i][j] + b2[c]) + to_f(xtile[op + c]), 0.f));
        }
      }
    }
  }
}

template <typename T>
size_t smem_bytes(const Dims& d) {
  return kGemmSmem + sizeof(T) * (size_t)(d.tile_rows + 2) * (d.w + 2) * d.c;
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, void* out, Dims d, cudaStream_t s) {
  const size_t smem = smem_bytes<T>(d);
  cudaError_t err = cudaFuncSetAttribute(
      basic_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((d.h + d.tile_rows - 1) / d.tile_rows, d.n);
  basic_block_kernel<T><<<grid, kThreads, smem, s>>>(
      (const T*)x, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)b2, (T*)out, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long basic_block_smem_bytes(int bf16, int w, int c,
                                            int tile_rows) {
  Dims d{0, 0, w, c, tile_rows};
  return bf16 ? (long long)smem_bytes<__nv_bfloat16>(d)
              : (long long)smem_bytes<float>(d);
}

// x, out [n, h*w, c]; w1, w2 [9, c, c] tap-major in T; b1, b2 [c] f32.
extern "C" int basic_block_launch(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, int n, int h,
                                  int w, int c, int tile_rows, int bf16,
                                  void* stream) {
  if (n == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
  Dims d{n, h, w, c, tile_rows};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(x, w1, b1, w2, b2, out, d, s);
  return launch<float>(x, w1, b1, w2, b2, out, d, s);
}
