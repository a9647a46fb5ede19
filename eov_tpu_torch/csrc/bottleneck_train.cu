// The frozen-BN ResNet bottleneck stack of the TRAIN step, forward (kernel 8)
// and backward (kernel 9). The wrapper (ops/bottleneck_train.py) launches
// the forward once per block, and the backward as a sequence of passes per
// block, walking the blocks in reverse.
//
// Replaces the Pallas TPU kernels eov_tpu/ops/pallas_bottleneck_train.py
// _fwd_pallas (_fwd_kernel) and _bwd_pallas (_bwd_kernel). The TPU design
// keeps one whole image and every intermediate of the recomputed chain in
// ~110 MiB of VMEM. A Hopper SM has 227 KB of shared memory, and one 56x56
// map of 256 f32 channels is 3.2 MB, so the chain cannot stay on chip:
//
//   forward (kernel 8, train_block_fwd): one thread block owns TR output
//     rows of one image through one bottleneck block, as the inference
//     kernel (bottleneck_stack.cu) does: conv1 over the rows plus a one-row
//     halo into shared memory, the 3x3 as one K = 9*Cmid GEMM reading its
//     taps there, conv3 and the residual summed in f32. The block input and
//     output are f32; only they touch device memory, unless the backward
//     asks it to save y1 and y2 (the rounded conv2/conv3 inputs).
//   backward (kernel 9), per block, in reverse:
//     1. the wrapper re-runs the forward over every block from the saved
//        stack input, saving y1, y2 and each block's output (global scratch);
//     2. bwd_pre: d_pre = d_out * (out > 0); g3 = T(d_pre*s3), gd = T(d_pre*sd);
//     3. bwd_dy2: g2 = T(((g3 w3^T) * (y2 > 0)) * s2);
//     4. bwd_dy1: the transposed 3x3 -- g2 read at the NEGATED tap offsets,
//        i.e. source pixel (y - ky + 1, x - kx + 1), zero outside the image,
//        which is the TPU kernel's mirrored column masks in 2-D form --
//        then g1 = T((. * (y1 > 0)) * s1);
//     5. bwd_dx: dx = g1 w1^T + (gd wd^T, or d_pre on an identity shortcut);
//     6. wgrad: dW1 = xd^T g1, dW2[t] = tap_t(y1)^T g2, dW3 = y2^T g3,
//        dWd = xd^T gd, each as per-image partials in a workspace summed in
//        image order by reduce_partials. No float atomics: the same inputs
//        give the same dW, bit for bit, run after run.
//
// Rounding follows the reference chain (_block_forward_ref/_block_bwd_ref):
// products of T values accumulate in f32; every conv output rounds to T;
// the frozen affine c*s + b, the ReLUs and the residual sum run in f32 on the
// rounded conv output. The f32 multiply and add are written __fmul_rn /
// __fadd_rn so that nvcc does not contract them into one FMA, which would
// round differently from the plain PyTorch version.
//
// Bound on the H100: operations. Stage 1 of ResNet-50 at 96 images is ~128
// GFLOP forward against ~0.4 GB moved; the backward does about three times
// the forward's flops. This first version is the simple, right one: every
// product is a tiled FFMA loop (operands staged as f32 in shared memory) on
// the CUDA cores, not the tensor cores; wgmma with TMA-fed tiles is the way
// to the bound and is later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileP = 128;  // output rows per GEMM tile (16 x 8 / thread)
constexpr int kTileN = 64;   // output columns per GEMM tile (16 x 4 / thread)
constexpr int kChunk = 16;   // K per staged chunk
constexpr int kLdA = kChunk + 1;
constexpr int kWgTile = 64;  // wgrad output tile (64 x 64, 4 x 4 / thread)

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

// v rounded to T and widened back to f32.
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// c*s + b with two roundings, as the plain version computes it.
__device__ __forceinline__ float affine(float c, float s, float b) {
  return __fadd_rn(__fmul_rn(c, s), b);
}

// acc[i][j] += sum_k A(p, k) * B(k, n0 + c) for the thread's rows
// p = ty + 16 i (p < P <= 128) and columns c = 4 tx + j (n0 + c < n_cols).
template <typename AFn, typename BFn>
__device__ __forceinline__ void block_gemm(float (&acc)[8][4], int P, int K,
                                           AFn a_at, BFn b_at, int n_cols,
                                           int n0, float* As, float* Bs) {
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
      Bs[e] = (k < K && n < n_cols) ? b_at(k, n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 b =
          *reinterpret_cast<const float4*>(&Bs[kk * kTileN + tx * 4]);
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

// Rows of the tile that starts at r0 (at most kTileP).
__device__ __forceinline__ int tile_len(size_t rows, size_t r0) {
  return rows - r0 < (size_t)kTileP ? (int)(rows - r0) : kTileP;
}

struct Dims {
  int n, h, w, cin, cmid, cout, tile_rows;
};

template <typename T>
struct FwdArgs {
  const float* x;  // [N, P, Cin] f32
  const T* w1;     // [Cin, Cmid]
  const float *s1, *b1;
  const T* w2;     // [9, Cmid, Cmid] tap-major
  const float *s2, *b2;
  const T* w3;     // [Cmid, Cout]
  const float *s3, *b3;
  const T* wd;     // [Cin, Cout] or null (identity shortcut)
  const float *sd, *bd;
  float* out;      // [N, P, Cout] f32
  T* y1_save;      // [N, P, Cmid] or null
  T* y2_save;      // [N, P, Cmid] or null
};

// ---------------------------------------------------------------- kernel 8

template <typename T>
__global__ void __launch_bounds__(kThreads)
train_block_fwd(FwdArgs<T> a, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = d.w, H = d.h, cin = d.cin, cmid = d.cmid, cout = d.cout;
  const int TR = d.tile_rows;
  const int img = blockIdx.y;
  const int r0 = blockIdx.x * TR;
  const int rows = min(TR, H - r0);
  const int halo_rows = rows + 2;
  const int ldy1 = W + 2;

  float* As = reinterpret_cast<float*>(smem_raw);
  float* Bs = As + kTileP * kLdA;
  T* y1s = reinterpret_cast<T*>(Bs + kChunk * kTileN);  // [TR+2][W+2][cmid]
  T* y2s = y1s + (size_t)(TR + 2) * ldy1 * cmid;        // [TR*W][cmid]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const float* ximg = a.x + (size_t)img * H * W * cin;
  const size_t tile_px0 = (size_t)img * H * W + (size_t)r0 * W;

  for (int e = tid; e < halo_rows * ldy1 * cmid; e += kThreads)
    y1s[e] = from_f<T>(0.f);
  __syncthreads();

  float acc[8][4];

  // Phase A: y1 = relu(T(xd w1) * s1 + b1) over the halo rows.
  const int halo_px = halo_rows * W;
  for (int pb = 0; pb < halo_px; pb += kTileP) {
    const int P = min(kTileP, halo_px - pb);
    for (int n0 = 0; n0 < cmid; n0 += kTileN) {
      zero(acc);
      block_gemm(
          acc, P, cin,
          [&](int p, int k) {
            const int hp = pb + p, row = r0 - 1 + hp / W;
            if (row < 0 || row >= H) return 0.f;
            return rnd<T>(ximg[((size_t)row * W + hp % W) * cin + k]);
          },
          [&](int k, int n) { return to_f(a.w1[(size_t)k * cmid + n]); },
          cmid, n0, As, Bs);
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
          if (c >= cmid) continue;
          const T y = from_f<T>(
              fmaxf(affine(rnd<T>(acc[i][j]), a.s1[c], a.b1[c]), 0.f));
          y1s[((size_t)lr * ldy1 + col + 1) * cmid + c] = y;
          if (a.y1_save != nullptr && lr >= 1 && lr <= rows)
            a.y1_save[(tile_px0 + (size_t)(lr - 1) * W + col) * cmid + c] = y;
        }
      }
    }
  }
  __syncthreads();

  // Phase B: y2 = relu(T(conv3x3(y1)) * s2 + b2); taps read y1s in place.
  const int P = rows * W;
  for (int n0 = 0; n0 < cmid; n0 += kTileN) {
    zero(acc);
    block_gemm(
        acc, P, 9 * cmid,
        [&](int p, int k) {
          const int tap = k / cmid, ci = k - tap * cmid;
          const int ky = tap / 3, kx = tap - ky * 3;
          const int lr = p / W, col = p - lr * W;
          return to_f(y1s[((size_t)(lr + ky) * ldy1 + col + kx) * cmid + ci]);
        },
        [&](int k, int n) { return to_f(a.w2[(size_t)k * cmid + n]); }, cmid,
        n0, As, Bs);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty + 16 * i;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + tx * 4 + j;
        if (c >= cmid) continue;
        const T y = from_f<T>(
            fmaxf(affine(rnd<T>(acc[i][j]), a.s2[c], a.b2[c]), 0.f));
        y2s[(size_t)p * cmid + c] = y;
        if (a.y2_save != nullptr)
          a.y2_save[(tile_px0 + p) * cmid + c] = y;
      }
    }
  }
  __syncthreads();

  // Phase C: out = relu((T(y2 w3) * s3 + b3) + residual), all f32.
  const float* xtile = ximg + (size_t)r0 * W * cin;
  float* otile = a.out + tile_px0 * cout;
  for (int n0 = 0; n0 < cout; n0 += kTileN) {
    float res[8][4];
    zero(res);
    if (a.wd != nullptr) {
      block_gemm(
          res, P, cin,
          [&](int p, int k) { return rnd<T>(xtile[(size_t)p * cin + k]); },
          [&](int k, int n) { return to_f(a.wd[(size_t)k * cout + n]); },
          cout, n0, As, Bs);
    }
    zero(acc);
    block_gemm(
        acc, P, cmid,
        [&](int p, int k) { return to_f(y2s[(size_t)p * cmid + k]); },
        [&](int k, int n) { return to_f(a.w3[(size_t)k * cout + n]); }, cout,
        n0, As, Bs);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty + 16 * i;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + tx * 4 + j;
        if (c >= cout) continue;
        const float z3 = affine(rnd<T>(acc[i][j]), a.s3[c], a.b3[c]);
        const float r = a.wd != nullptr
                            ? affine(rnd<T>(res[i][j]), a.sd[c], a.bd[c])
                            : xtile[(size_t)p * cin + c];
        otile[(size_t)p * cout + c] = fmaxf(__fadd_rn(z3, r), 0.f);
      }
    }
  }
}

// ---------------------------------------------------------------- kernel 9

// d_pre = d_out * (out > 0); g3 = T(d_pre * s3); gd = T(d_pre * sd).
template <typename T>
__global__ void bwd_pre(const float* __restrict__ out,
                        const float* __restrict__ dy,
                        const float* __restrict__ s3,
                        const float* __restrict__ sd, float* __restrict__ dpre,
                        T* __restrict__ g3, T* __restrict__ gd, size_t total,
                        int cout) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % cout);
    const float v = __fmul_rn(dy[i], out[i] > 0.f ? 1.f : 0.f);
    g3[i] = from_f<T>(__fmul_rn(v, s3[c]));
    if (gd != nullptr) gd[i] = from_f<T>(__fmul_rn(v, sd[c]));
    if (dpre != nullptr) dpre[i] = v;
  }
}

// g2 = T(((g3 w3^T) * (y2 > 0)) * s2); rows are pixels of all images.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dy2(const T* __restrict__ g3, const T* __restrict__ w3,
        const T* __restrict__ y2, const float* __restrict__ s2,
        T* __restrict__ g2, int rows, int cmid, int cout) {
  __shared__ __align__(16) float As[kTileP * kLdA];
  __shared__ __align__(16) float Bs[kChunk * kTileN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t r0 = (size_t)blockIdx.x * kTileP;
  const int P = tile_len(rows, r0);
  const int n0 = blockIdx.y * kTileN;
  float acc[8][4];
  zero(acc);
  block_gemm(
      acc, P, cout,
      [&](int p, int k) { return to_f(g3[(r0 + p) * cout + k]); },
      [&](int k, int n) { return to_f(w3[(size_t)n * cout + k]); }, cmid, n0,
      As, Bs);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = ty + 16 * i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c >= cmid) continue;
      const size_t o = (r0 + p) * cmid + c;
      const float m = to_f(y2[o]) > 0.f ? 1.f : 0.f;
      g2[o] = from_f<T>(__fmul_rn(__fmul_rn(acc[i][j], m), s2[c]));
    }
  }
}

// The transposed 3x3: dy1[q, ci] = sum_t sum_co g2[q - o_t, co] w2[t, ci, co],
// then g1 = T((dy1 * (y1 > 0)) * s1).
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dy1(const T* __restrict__ g2, const T* __restrict__ w2,
        const T* __restrict__ y1, const float* __restrict__ s1,
        T* __restrict__ g1, int n_img, int h, int w, int cmid) {
  __shared__ __align__(16) float As[kTileP * kLdA];
  __shared__ __align__(16) float Bs[kChunk * kTileN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int P_img = h * w;
  const size_t rows = (size_t)n_img * P_img;
  const size_t r0 = (size_t)blockIdx.x * kTileP;
  const int P = tile_len(rows, r0);
  const int n0 = blockIdx.y * kTileN;
  float acc[8][4];
  zero(acc);
  block_gemm(
      acc, P, 9 * cmid,
      [&](int p, int k) {
        const int tap = k / cmid, co = k - tap * cmid;
        const int ky = tap / 3, kx = tap - ky * 3;
        const size_t r = r0 + p;
        const int img = (int)(r / P_img), q = (int)(r % P_img);
        const int sy = q / w - ky + 1, sx = q % w - kx + 1;
        if (sy < 0 || sy >= h || sx < 0 || sx >= w) return 0.f;
        return to_f(g2[((size_t)img * P_img + sy * w + sx) * cmid + co]);
      },
      [&](int k, int n) {
        const int tap = k / cmid, co = k - tap * cmid;
        return to_f(w2[((size_t)tap * cmid + n) * cmid + co]);
      },
      cmid, n0, As, Bs);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = ty + 16 * i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c >= cmid) continue;
      const size_t o = (r0 + p) * cmid + c;
      const float m = to_f(y1[o]) > 0.f ? 1.f : 0.f;
      g1[o] = from_f<T>(__fmul_rn(__fmul_rn(acc[i][j], m), s1[c]));
    }
  }
}

// dx = g1 w1^T + (gd wd^T, or d_pre on an identity shortcut), f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dx(const T* __restrict__ g1, const T* __restrict__ w1,
       const T* __restrict__ gd, const T* __restrict__ wd,
       const float* __restrict__ dpre, float* __restrict__ dx, int rows,
       int cin, int cmid, int cout) {
  __shared__ __align__(16) float As[kTileP * kLdA];
  __shared__ __align__(16) float Bs[kChunk * kTileN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t r0 = (size_t)blockIdx.x * kTileP;
  const int P = tile_len(rows, r0);
  const int n0 = blockIdx.y * kTileN;
  float acc[8][4], accd[8][4];
  zero(acc);
  zero(accd);
  block_gemm(
      acc, P, cmid,
      [&](int p, int k) { return to_f(g1[(r0 + p) * cmid + k]); },
      [&](int k, int n) { return to_f(w1[(size_t)n * cmid + k]); }, cin, n0,
      As, Bs);
  if (wd != nullptr) {
    block_gemm(
        accd, P, cout,
        [&](int p, int k) { return to_f(gd[(r0 + p) * cout + k]); },
        [&](int k, int n) { return to_f(wd[(size_t)n * cout + k]); }, cin,
        n0, As, Bs);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = ty + 16 * i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c >= cin) continue;
      const size_t o = (r0 + p) * cin + c;
      const float r = wd != nullptr ? accd[i][j] : dpre[(r0 + p) * cout + c];
      dx[o] = __fadd_rn(acc[i][j], r);
    }
  }
}

// Weight-gradient partials: part[img][tap][k][n] = sum over the image's
// pixels p of A(p, k) * B[p, n]. A is a T array (mode 0), an f32 array
// rounded to T (mode 1, the block input), or the 3x3 tap `tap` of a T map
// (mode 2: pixel (y + ky - 1, x + kx - 1), zero outside the image).
template <typename T, int AMODE>
__global__ void __launch_bounds__(kThreads)
wgrad_partial(const void* __restrict__ a_ptr, const T* __restrict__ b,
              float* __restrict__ part, int h, int w, int K, int Nc,
              int taps) {
  __shared__ __align__(16) float As[kChunk][kWgTile];
  __shared__ __align__(16) float Bs[kChunk][kWgTile];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kWgTile, n0 = blockIdx.y * kWgTile;
  const int img = blockIdx.z / taps, tap = blockIdx.z % taps;
  const int ky = tap / 3, kx = tap % 3;
  const int P = h * w;
  const size_t px0 = (size_t)img * P;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int p0 = 0; p0 < P; p0 += kChunk) {
    for (int e = tid; e < kChunk * kWgTile; e += kThreads) {
      const int pp = e / kWgTile, c = e % kWgTile;
      const int p = p0 + pp, k = k0 + c, n = n0 + c;
      float av = 0.f, bv = 0.f;
      if (p < P && k < K) {
        if (AMODE == 0) {
          av = to_f(static_cast<const T*>(a_ptr)[(px0 + p) * K + k]);
        } else if (AMODE == 1) {
          av = rnd<T>(static_cast<const float*>(a_ptr)[(px0 + p) * K + k]);
        } else {
          const int sy = p / w + ky - 1, sx = p % w + kx - 1;
          if (sy >= 0 && sy < h && sx >= 0 && sx < w)
            av = to_f(static_cast<const T*>(
                a_ptr)[(px0 + (size_t)sy * w + sx) * K + k]);
        }
      }
      if (p < P && n < Nc) bv = to_f(b[(px0 + p) * Nc + n]);
      As[pp][c] = av;
      Bs[pp][c] = bv;
    }
    __syncthreads();
#pragma unroll
    for (int pp = 0; pp < kChunk; ++pp) {
      const float4 av = *reinterpret_cast<const float4*>(&As[pp][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[pp][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += ar[i] * br[j];
    }
    __syncthreads();
  }
  float* dst = part + ((size_t)blockIdx.z * K) * Nc;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Nc) dst[(size_t)k * Nc + n] = acc[i][j];
    }
  }
}

// out[i] = sum over images, in image order, of part[img][i].
__global__ void reduce_partials(const float* __restrict__ part,
                                float* __restrict__ out, int n_img,
                                size_t m) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int img = 0; img < n_img; ++img) s += part[(size_t)img * m + i];
    out[i] = s;
  }
}

template <typename T>
size_t fwd_smem_bytes(int w, int cmid, int tile_rows) {
  return sizeof(float) * (kTileP * kLdA + kChunk * kTileN) +
         sizeof(T) * ((size_t)(tile_rows + 2) * (w + 2) * cmid +
                      (size_t)tile_rows * w * cmid);
}

template <typename T>
int launch_fwd(const FwdArgs<T>& a, Dims d, cudaStream_t s) {
  const size_t smem = fwd_smem_bytes<T>(d.w, d.cmid, d.tile_rows);
  cudaError_t err = cudaFuncSetAttribute(
      train_block_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((d.h + d.tile_rows - 1) / d.tile_rows, d.n);
  train_block_fwd<T><<<grid, kThreads, smem, s>>>(a, d);
  return (int)cudaGetLastError();
}

int grid_1d(size_t total) {
  const size_t blocks = (total + kThreads - 1) / kThreads;
  return (int)(blocks < 132 * 32 ? blocks : 132 * 32);
}


template <typename T>
int launch_wgrad(int amode, const void* a, const void* b, float* part,
                 float* out, int n_img, int h, int w, int K, int Nc, int taps,
                 cudaStream_t s) {
  dim3 grid((K + kWgTile - 1) / kWgTile, (Nc + kWgTile - 1) / kWgTile,
            n_img * taps);
  const T* bt = static_cast<const T*>(b);
  if (amode == 0)
    wgrad_partial<T, 0><<<grid, kThreads, 0, s>>>(a, bt, part, h, w, K, Nc,
                                                  taps);
  else if (amode == 1)
    wgrad_partial<T, 1><<<grid, kThreads, 0, s>>>(a, bt, part, h, w, K, Nc,
                                                  taps);
  else
    wgrad_partial<T, 2><<<grid, kThreads, 0, s>>>(a, bt, part, h, w, K, Nc,
                                                  taps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t m = (size_t)taps * K * Nc;
  reduce_partials<<<grid_1d(m), kThreads, 0, s>>>(part, out, n_img, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long train_block_fwd_smem_bytes(int bf16, int w, int cmid,
                                                int tile_rows) {
  return bf16 ? (long long)fwd_smem_bytes<__nv_bfloat16>(w, cmid, tile_rows)
              : (long long)fwd_smem_bytes<float>(w, cmid, tile_rows);
}

// Kernel 8, one block. wd/sd/bd may be null (identity shortcut, cin ==
// cout); y1_save/y2_save may be null (the forward of the train step).
extern "C" int train_block_fwd_launch(
    const void* x, const void* w1, const void* s1, const void* b1,
    const void* w2, const void* s2, const void* b2, const void* w3,
    const void* s3, const void* b3, const void* wd, const void* sd,
    const void* bd, void* out, void* y1_save, void* y2_save, int n, int h,
    int w, int cin, int cmid, int cout, int tile_rows, int bf16,
    void* stream) {
  if (n == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
  Dims d{n, h, w, cin, cmid, cout, tile_rows};
  cudaStream_t s = (cudaStream_t)stream;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (bf16) {
    using T = __nv_bfloat16;
    FwdArgs<T> a{f(x),  (const T*)w1, f(s1), f(b1), (const T*)w2,
                 f(s2), f(b2),        (const T*)w3, f(s3), f(b3),
                 (const T*)wd, f(sd), f(bd), (float*)out, (T*)y1_save,
                 (T*)y2_save};
    return launch_fwd<T>(a, d, s);
  }
  using T = float;
  FwdArgs<T> a{f(x),  (const T*)w1, f(s1), f(b1), (const T*)w2,
               f(s2), f(b2),        (const T*)w3, f(s3), f(b3),
               (const T*)wd, f(sd), f(bd), (float*)out, (T*)y1_save,
               (T*)y2_save};
  return launch_fwd<T>(a, d, s);
}

// Kernel 9, step 2. sd/gd null on an identity shortcut; dpre may be null.
extern "C" int train_bwd_pre_launch(const void* out, const void* dy,
                                    const void* s3, const void* sd,
                                    void* dpre, void* g3, void* gd,
                                    long long rows, int cout, int bf16,
                                    void* stream) {
  const size_t total = (size_t)rows * cout;
  if (total == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const float* o = static_cast<const float*>(out);
  const float* d = static_cast<const float*>(dy);
  if (bf16)
    bwd_pre<__nv_bfloat16><<<grid_1d(total), kThreads, 0, s>>>(
        o, d, (const float*)s3, (const float*)sd, (float*)dpre,
        (__nv_bfloat16*)g3, (__nv_bfloat16*)gd, total, cout);
  else
    bwd_pre<float><<<grid_1d(total), kThreads, 0, s>>>(
        o, d, (const float*)s3, (const float*)sd, (float*)dpre, (float*)g3,
        (float*)gd, total, cout);
  return (int)cudaGetLastError();
}

// Kernel 9, step 3.
extern "C" int train_bwd_dy2_launch(const void* g3, const void* w3,
                                    const void* y2, const void* s2, void* g2,
                                    int rows, int cmid, int cout, int bf16,
                                    void* stream) {
  if (rows == 0) return (int)cudaGetLastError();
  dim3 grid((rows + kTileP - 1) / kTileP, (cmid + kTileN - 1) / kTileN);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    bwd_dy2<T><<<grid, kThreads, 0, s>>>((const T*)g3, (const T*)w3,
                                         (const T*)y2, (const float*)s2,
                                         (T*)g2, rows, cmid, cout);
  } else {
    using T = float;
    bwd_dy2<T><<<grid, kThreads, 0, s>>>((const T*)g3, (const T*)w3,
                                         (const T*)y2, (const float*)s2,
                                         (T*)g2, rows, cmid, cout);
  }
  return (int)cudaGetLastError();
}

// Kernel 9, step 4.
extern "C" int train_bwd_dy1_launch(const void* g2, const void* w2,
                                    const void* y1, const void* s1, void* g1,
                                    int n, int h, int w, int cmid, int bf16,
                                    void* stream) {
  const size_t rows = (size_t)n * h * w;
  if (rows == 0) return (int)cudaGetLastError();
  dim3 grid((unsigned)((rows + kTileP - 1) / kTileP),
            (cmid + kTileN - 1) / kTileN);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    bwd_dy1<T><<<grid, kThreads, 0, s>>>((const T*)g2, (const T*)w2,
                                         (const T*)y1, (const float*)s1,
                                         (T*)g1, n, h, w, cmid);
  } else {
    using T = float;
    bwd_dy1<T><<<grid, kThreads, 0, s>>>((const T*)g2, (const T*)w2,
                                         (const T*)y1, (const float*)s1,
                                         (T*)g1, n, h, w, cmid);
  }
  return (int)cudaGetLastError();
}

// Kernel 9, step 5. gd/wd null on an identity shortcut (then dpre is read).
extern "C" int train_bwd_dx_launch(const void* g1, const void* w1,
                                   const void* gd, const void* wd,
                                   const void* dpre, void* dx, int rows,
                                   int cin, int cmid, int cout, int bf16,
                                   void* stream) {
  if (rows == 0) return (int)cudaGetLastError();
  dim3 grid((rows + kTileP - 1) / kTileP, (cin + kTileN - 1) / kTileN);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    bwd_dx<T><<<grid, kThreads, 0, s>>>((const T*)g1, (const T*)w1,
                                        (const T*)gd, (const T*)wd,
                                        (const float*)dpre, (float*)dx, rows,
                                        cin, cmid, cout);
  } else {
    using T = float;
    bwd_dx<T><<<grid, kThreads, 0, s>>>((const T*)g1, (const T*)w1,
                                        (const T*)gd, (const T*)wd,
                                        (const float*)dpre, (float*)dx, rows,
                                        cin, cmid, cout);
  }
  return (int)cudaGetLastError();
}

// Kernel 9, step 6: one weight gradient [taps, K, Nc] f32 into `out`, via
// per-image partials in `part` (n * taps * K * Nc floats).
extern "C" int train_wgrad_launch(int amode, const void* a, const void* b,
                                  void* part, void* out, int n, int h, int w,
                                  int K, int Nc, int taps, int bf16,
                                  void* stream) {
  if (n == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_wgrad<__nv_bfloat16>(amode, a, b, (float*)part,
                                       (float*)out, n, h, w, K, Nc, taps, s);
  return launch_wgrad<float>(amode, a, b, (float*)part, (float*)out, n, h, w,
                             K, Nc, taps, s);
}
