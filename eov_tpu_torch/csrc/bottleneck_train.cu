// The frozen-BN ResNet bottleneck stack of the TRAIN step, forward (kernel 8)
// and backward (kernel 9). The wrapper (ops/bottleneck_train.py) launches
// the forward once per block, and the backward as a sequence of passes per
// block, walking the blocks in reverse.
//
// Replaces the Pallas TPU kernels eov_tpu/ops/pallas_bottleneck_train.py
// _fwd_pallas (_fwd_kernel) and _bwd_pallas (_bwd_kernel). The TPU design
// keeps one whole image and every intermediate of the recomputed chain in
// ~110 MiB of VMEM. A Hopper SM has 227 KB of shared memory, and one 56x56
// map of 256 f32 channels is 3.2 MB, so the chain cannot stay on chip.
//
// bf16 runs every product on the tensor cores (wgmma, over mma_tile.cuh):
//
//   forward (kernel 8, train_fwd_bf16): kernel 2's three-phase block
//     (bottleneck_mma.cuh; tiles from ops/bottleneck_train.py
//     train_tile_plan): conv1 over the block's rows and a one-row halo,
//     the 3x3 as an implicit GEMM over y1 on chip, conv3, all as wgmma
//     passes with B from a cp.async weight ring; y1 and y2 stay in shared
//     memory unless the backward asks for them (y1_save, y2_save). Each
//     k16 product starts a fresh wgmma sum that is added to the pass's
//     f32 sum by an IEEE add (mma_pass kPromote, M passes of 256 rows for
//     the registers): wgmma's own sum along a long K loop rounds several
//     times as many bf16 values off the float64 chain as f32 FFMA sums,
//     and every such flip is a knife edge for a ReLU mask of the backward
//     (PERF.md §6). The weight gradients' long pixel sums are promoted
//     the same way.
//   backward (kernel 9), per block, in reverse:
//     1. recompute: the forward over every block from the saved stack
//        input, saving y1, y2 and each block's output;
//     2. bwd_pre (elementwise): d_pre = d_out * (out > 0); g3 = T(d_pre s3),
//        gd = T(d_pre sd);
//     3. train_dgrad_bf16: the block's input gradient in one launch, kernel
//        2's three phases on the block run backwards: g2 = T(((g3 w3^T) *
//        (y2 > 0)) s2) over the rows and their halo; the transposed 3x3
//        over g2 on chip (the forward's tap reads with the taps' weights
//        flipped and transposed, w2[8 - t]^T), g1 = T((. * (y1 > 0)) s1);
//        dx = g1 w1^T + (gd wd^T, or d_pre). g2 and g1 also go to device
//        memory for the weight gradients;
//     4. wgrad_bf16: dW1 = xd^T g1, dW2[t] = tap_t(y1)^T g2, dW3 = y2^T g3,
//        dWd = xd^T gd, the pixels as K: the activation is the transposed
//        A (ldmatrix.trans), G the MN-major B. A block stages a range of
//        rows once (y1 with its halo) and runs all nine taps over it (three
//        warpgroups, one per tap row); the ranges are a fixed partition
//        taken by a fixed number of blocks in a fixed order, and the
//        blocks' f32 partials are summed in block order by reduce_partials.
//        No float atomics: the same inputs give the same dW, bit for bit.
//
// Bound on the H100. ResNet-50 stage 1 at 96 images is ~128 GFLOP forward
// (0.13 ms at the bf16 peak) against ~1.6 GB of f32 block inputs and
// outputs (0.48 ms at 3.35 TB/s): one launch per block with f32 I/O makes
// the forward's floor the memory's, 4x the operations'. The backward does
// three times the forward's flops and moves the recompute's outputs, the
// g tensors and the partials (~2.5 GB per stage-1 block). Each phase's
// products are 64-deep K steps of a whole M x N pass behind one barrier;
// what the design does about the rest: x is rounded while it is staged
// (no bf16 copy of x in memory), y1 and y2 (g2 and g1) never leave the
// chip between the phases of a block, the projection's r waits in `out`
// (read back by the same thread), and the weight gradients stage each
// activation range once for all taps.
//
// Rounding traps the bf16 path keeps (the plain version's chain,
// _block_forward / _block_backward in the wrapper):
//   1. every conv output rounds to T before its frozen affine,
//      __fadd_rn(__fmul_rn(T(acc), s), b), where kernel 2 adds a folded
//      bias to the raw f32 sum;
//   2. the projection is not K-concatenated with conv3 (kernel 2's form):
//      x wd rounds to T on its own before its affine, so it runs as its
//      own pass (phase kProj) and its r = T(x wd) sd + bd is added to
//      conv3's T(y2 w3) s3 + b3 in f32;
//   3. x comes in f32 and the output leaves f32: conv1 and the projection
//      read T(x), rounded while x is staged; an identity block's residual
//      is the unrounded f32 x;
//   4. with y1_save / y2_save, the same launch writes the rounded y1 and
//      y2 the backward's recompute needs.
// The backward keeps the __fmul_rn order of each mask and scale and g
// rounded to T; its one reordering is dx's single f32 sum of both
// products of an entry block (noted at train_dgrad_bf16).
//
// f32 keeps the first version's FFMA kernels (train_block_fwd, bwd_dy2,
// bwd_dy1, bwd_dx, wgrad_partial: tiles of f32 operands in shared memory
// on the CUDA cores): TF32 would not meet the f32 bars.

#include "bottleneck_mma.cuh"

namespace {

constexpr int kWgTile = 64;  // FFMA wgrad output tile (64 x 64, 4 x 4 / thread)

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
// p = ty + 16 i (p < P <= 128) and columns c = 4 tx + j (n0 + c < n_cols);
// tile_gemm.cuh's block_gemm with B given as a function too (a transposed
// or tap-indexed weight).
template <typename AFn, typename BFn>
__device__ __forceinline__ void block_gemm_fn(float (&acc)[8][4], int P, int K,
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
      block_gemm_fn(
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
    block_gemm_fn(
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
      block_gemm_fn(
          res, P, cin,
          [&](int p, int k) { return rnd<T>(xtile[(size_t)p * cin + k]); },
          [&](int k, int n) { return to_f(a.wd[(size_t)k * cout + n]); },
          cout, n0, As, Bs);
    }
    zero(acc);
    block_gemm_fn(
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
  block_gemm_fn(
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
  block_gemm_fn(
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
  block_gemm_fn(
      acc, P, cmid,
      [&](int p, int k) { return to_f(g1[(r0 + p) * cmid + k]); },
      [&](int k, int n) { return to_f(w1[(size_t)n * cmid + k]); }, cin, n0,
      As, Bs);
  if (wd != nullptr) {
    block_gemm_fn(
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

// ------------------------------------------------ bf16 on the tensor cores

// Kernel 8 in bf16, and the input-gradient pass of kernel 9, are kernel 2's
// three-phase block (bottleneck_mma.cuh: tiles, staging, mma_pass) with the
// train chain's epilogues; the weight gradients are wgrad_bf16 below.

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float rbf(float v) { return rnd<bf16>(v); }

struct TrainFwd {
  const float* x;                 // [N, P, cin] f32
  const bf16 *w1, *w2, *w3, *wd;  // relaid out; wd null on an identity block
  const float *s1, *b1, *s2, *b2, *s3, *b3, *sd, *bd;
  float* out;                     // [N, P, cout] f32
  bf16 *y1_save, *y2_save;        // [N, P, cmid] or null
};

// y1 / y2 / g2 / g1 rows of an epilogue: pixel `ypix` of the on-chip map
// (swizzled, pitch cmidp) gets the bf16 pair (v0, v1) at channel n, and, if
// `save` is set and n is a real channel, the map in device memory too.
__device__ __forceinline__ void put_pair(uint32_t map, int ypix, int cmidp,
                                         int cmid, int n, float v0, float v1,
                                         bf16* save) {
  const uint32_t pk = pack_bf16x2(v0, v1);
  st_shared_b32(map + 2 * swz(ypix, cmidp, n), pk);
  if (save != nullptr && n < cmid)
    *reinterpret_cast<uint32_t*>(save + n) = pk;
}

// The channel pair (n, n + 1) of a bf16 map in device memory, as f32.
__device__ __forceinline__ float2 get_pair(const bf16* __restrict__ p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Phase C's epilogue of kernel 8 (cout % 8 == 0, 16-byte aligned), after a
// quad transpose (a lane holds 8 channels of a row). mode 0, the
// projection: out = T(acc) sd + bd (r, kept in out until conv3's pass);
// mode 1: out = relu(T(acc) s3 + b3 + out), the r above; mode 2: the same
// with x (the identity residual: f32, unrounded).
template <int kMF, int kNW>
__device__ __forceinline__ void store_train_out(
    const float (&acc)[kMF][kNW / 2], const MmaDims& d, const Tile& t,
    const PassGeom<kMF, kNW>& pg, int m0, int np, int M, int mode,
    const float* __restrict__ x, const float* __restrict__ s,
    const float* __restrict__ b, float* out) {
  const int W = d.w, H = d.h, C = d.cout;
#pragma unroll
  for (int f = 0; f < kMF; ++f) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = pg.row(m0, f, half);
      const bool live = m < M;  // quad-uniform; the shuffles run anyway
      const int q = m / W, col = m - q * W;
      const int g = q / t.rows, r = t.r0 + (q - g * t.rows);
      const size_t pix = ((size_t)(t.g0 + g) * H + r) * W + col;
#pragma unroll
      for (int k = 0; k < kNW / 32; ++k) {
        float2 e[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          e[jj] = make_float2(acc[f][4 * (4 * k + jj) + 2 * half],
                              acc[f][4 * (4 * k + jj) + 2 * half + 1]);
        float v[8];
        quad_transpose(e, v);
        const int lq = threadIdx.x & 3;
        const int n0 = pg.chan(np, 4 * k + lq) - 2 * lq;  // group 4k + lq
        if (!live || n0 >= C) continue;
        float z[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          z[i] = affine(rbf(v[i]), __ldg(s + n0 + i), __ldg(b + n0 + i));
        float4* o = reinterpret_cast<float4*>(out + pix * C + n0);
        if (mode != 0) {
          const float4* rp =
              mode == 1 ? o
                        : reinterpret_cast<const float4*>(x + pix * d.cin +
                                                          n0);
          const float4 ra = rp[0], rb = rp[1];
          const float rr[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) z[i] = fmaxf(__fadd_rn(z[i], rr[i]), 0.f);
        }
        o[0] = make_float4(z[0], z[1], z[2], z[3]);
        o[1] = make_float4(z[4], z[5], z[6], z[7]);
      }
    }
  }
}

// Kernel 8 in bf16: one block of the train stack, kernel 2's phases with
// the train chain. Phase A: y1 = T(relu(T(x w1) s1 + b1)) over rows
// [lo, hi), x rounded as it is staged; phase B: y2 = T(relu(T(conv3x3(y1))
// s2 + b2)); both saved (output rows) when asked. Phase C, per M and N
// pass: on an entry block the projection's pass first (r = T(x wd) sd + bd
// into out), then conv3's (K = y2's chunks only): out = relu(T(y2 w3) s3 +
// b3 + (r or x)). d.proj is 0 (conv3 takes no x chunks); a.wd says whether
// the block projects. Weights: w1, w2 as kernel 2's; w3 [coutp/NT3]
// [cmidp/64][NT3][64]; wd [coutp/NT3][cinp/64][NT3][64].
template <int kMF1, int kNW1, int kMF3, int kNW3, bool kPromote>
__global__ void __launch_bounds__(kMmaThreads, 1)
train_fwd_bf16(TrainFwd a, MmaDims d) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int W = d.w, H = d.h;
  const Bufs sb = make_bufs(smem, d);
  const Tile t = make_tile(d);
  if (threadIdx.x < kZeroBytes / 16)
    st_shared_v4(sb.zero + threadIdx.x * 16, 0, 0, 0, 0);
  int cur[5];
  stage_cursor(d, t, cur);
  const bool proj = a.wd != nullptr;
  // At cin <= 64 the one x chunk is staged (rounded) here and stays for
  // the projection.
  const bool resident = d.cinp == 64;
  if (resident)
    stage_x_f32(d, t, a.x, 0, sb.x, cur[0], cur[1], cur[2], cur[3], cur[4]);

  const int NT1 = 64 * d.wn1, NT3 = 64 * d.wn3;
  const int n1 = phase_steps<kConv1>(d), n2 = phase_steps<kConv2>(d),
            n3 = phase_steps<kConv3>(d), nd = phase_steps<kProj>(d);
  int gs = 0;
  bool pre = false;
  const int MB = t.gcount * t.rows * W;
  // Phase C's first weight tile, unless that pass stages x at its first
  // step (the projection with cin > 64).
  const bf16* first3 = proj ? (resident ? a.wd : nullptr) : a.w3;

  // Phase A: y1 over rows [lo, hi), into y1 (and y1_save at output rows).
  {
    const PassGeom<kMF1, kNW1> pg(d.wn1, d.cmidp);
    float acc[kMF1][kNW1 / 2];
    const int RA = t.hi - t.lo;
    const int MA = t.gcount * RA * W;
    for (int m0 = 0; m0 < MA; m0 += pg.MT) {
      for (int np = 0; np < pg.npass; ++np) {
        const int nn = np + 1 < pg.npass ? np + 1 : 0;
        const bf16* wn = np + 1 == pg.npass && m0 + pg.MT >= MA
                             ? a.w2
                         : resident ? a.w1 + (size_t)nn * n1 * 64 * NT1
                                    : nullptr;
        mma_pass<kConv1, kMF1, kNW1, float, kPromote>(
            acc, d, t, sb, a.x, a.w1, m0, np, MA, !resident, cur, gs, pre,
            wn, NT1);
        pre = wn != nullptr;
#pragma unroll
        for (int f = 0; f < kMF1; ++f) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = pg.row(m0, f, half);
            if (m >= MA) continue;
            const int q = m / W, col = m - q * W;
            const int g = q / RA, yr = q - g * RA;
            const int row = t.lo + yr;
            bf16* save =
                a.y1_save != nullptr && row >= t.r0 && row < t.r0 + t.rows
                    ? a.y1_save +
                          (((size_t)(t.g0 + g) * H + row) * W + col) * d.cmid
                    : nullptr;
#pragma unroll
            for (int j = 0; j < kNW1 / 8; ++j) {
              const int n = pg.chan(np, j);
              const float v0 =
                  n < d.cmid ? fmaxf(affine(rbf(acc[f][4 * j + 2 * half]),
                                            a.s1[n], a.b1[n]),
                                     0.f)
                             : 0.f;
              const float v1 =
                  n + 1 < d.cmid
                      ? fmaxf(affine(rbf(acc[f][4 * j + 2 * half + 1]),
                                     a.s1[n + 1], a.b1[n + 1]),
                              0.f)
                      : 0.f;
              put_pair(sb.y1, (g * t.yrows + yr) * W + col, d.cmidp, d.cmid,
                       n, v0, v1, save);
            }
          }
        }
      }
    }
  }

  // Phase B: y2 over the output rows, into y2 (and y2_save).
  {
    const PassGeom<kMF1, kNW1> pg(d.wn1, d.cmidp);
    float acc[kMF1][kNW1 / 2];
    for (int m0 = 0; m0 < MB; m0 += pg.MT) {
      for (int np = 0; np < pg.npass; ++np) {
        const int nn = np + 1 < pg.npass ? np + 1 : 0;
        const bool last = np + 1 == pg.npass && m0 + pg.MT >= MB;
        const bf16* wn = last ? first3 : a.w2 + (size_t)nn * n2 * 64 * NT1;
        mma_pass<kConv2, kMF1, kNW1, float, kPromote>(
            acc, d, t, sb, a.x, a.w2, m0, np, MB, false, cur, gs, pre, wn,
            last ? NT3 : NT1);
        pre = wn != nullptr;
        if (sb.L.overlay) __syncthreads();  // all of y1 read
#pragma unroll
        for (int f = 0; f < kMF1; ++f) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = pg.row(m0, f, half);
            if (m >= MB) continue;
            const int q = m / W, col = m - q * W;
            const int g = q / t.rows, row = t.r0 + (q - g * t.rows);
            bf16* save =
                a.y2_save != nullptr
                    ? a.y2_save +
                          (((size_t)(t.g0 + g) * H + row) * W + col) * d.cmid
                    : nullptr;
#pragma unroll
            for (int j = 0; j < kNW1 / 8; ++j) {
              const int n = pg.chan(np, j);
              const float v0 =
                  n < d.cmid ? fmaxf(affine(rbf(acc[f][4 * j + 2 * half]),
                                            a.s2[n], a.b2[n]),
                                     0.f)
                             : 0.f;
              const float v1 =
                  n + 1 < d.cmid
                      ? fmaxf(affine(rbf(acc[f][4 * j + 2 * half + 1]),
                                     a.s2[n + 1], a.b2[n + 1]),
                              0.f)
                      : 0.f;
              put_pair(sb.y2, m, d.cmidp, d.cmid, n, v0, v1, save);
            }
          }
        }
      }
    }
  }

  // Phase C: per pass, the projection (entry block), then conv3.
  {
    const PassGeom<kMF3, kNW3> pg(d.wn3, d.coutp);
    float acc[kMF3][kNW3 / 2];
    for (int m0 = 0; m0 < MB; m0 += pg.MT) {
      for (int np = 0; np < pg.npass; ++np) {
        const int nn = np + 1 < pg.npass ? np + 1 : 0;
        const bool last = np + 1 == pg.npass && m0 + pg.MT >= MB;
        if (proj) {
          mma_pass<kProj, kMF3, kNW3, float, kPromote>(
              acc, d, t, sb, a.x, a.wd, m0, np, MB, !resident, cur, gs, pre,
              a.w3 + (size_t)np * n3 * 64 * NT3, NT3);
          pre = true;
          store_train_out(acc, d, t, pg, m0, np, MB, 0, a.x, a.sd, a.bd,
                          a.out);
        }
        const bf16* wn = last   ? nullptr
                         : proj ? (resident ? a.wd + (size_t)nn * nd * 64 * NT3
                                            : nullptr)
                                : a.w3 + (size_t)nn * n3 * 64 * NT3;
        mma_pass<kConv3, kMF3, kNW3, float, kPromote>(
            acc, d, t, sb, a.x, a.w3, m0, np, MB, false, cur, gs, pre, wn,
            NT3);
        pre = wn != nullptr;
        store_train_out(acc, d, t, pg, m0, np, MB, proj ? 1 : 2, a.x, a.s3,
                        a.b3, a.out);
      }
    }
  }
}

struct TrainDgrad {
  const bf16* g3;            // [N, P, cout]: phase A's input
  const bf16* gd;            // [N, P, cout], or null (identity block)
  const bf16 *wa, *wb, *wc;  // w3^T, the tap-flipped w2^T, [w1^T; wd^T]
  const bf16 *y1, *y2;       // [N, P, cmid], saved by the recompute
  const float *s1, *s2;
  const float* dpre;         // [N, P, cin] f32 on an identity block
  bf16 *g2, *g1;             // [N, P, cmid]
  float* dx;                 // [N, P, cin]
};

// Kernel 9's input gradient of one block: kernel 2's three phases on the
// block run backwards, d = (cin: the block's cout, cmid, cout: the block's
// cin, proj). Phase A (K = g3's chunks, over rows [lo, hi)): g2 = T(((g3
// w3^T) * (y2 > 0)) * s2) into the on-chip map (and g2 at the output
// rows); phase B, the transposed 3x3: the forward's implicit GEMM over g2
// with the taps' weights flipped and transposed (w2[8 - t]^T: tap t reads
// pixel (y + ky - 1, x + kx - 1), which the flip turns into the mirrored
// read), g1 = T((. * (y1 > 0)) * s1) on chip and in device memory; phase C
// (K = g1's chunks, then gd's): dx = g1 w1^T + gd wd^T, or + d_pre on an
// identity block, f32. One f32 sum holds both products of an entry block:
// the plain version sums each product and then adds them, so the sums run
// in another order, with no rounding to T between them in either.
template <int kMF1, int kNW1, int kMF3, int kNW3, bool kPromote>
__global__ void __launch_bounds__(kMmaThreads, 1)
train_dgrad_bf16(TrainDgrad a, MmaDims d) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int W = d.w, H = d.h;
  const Bufs sb = make_bufs(smem, d);
  const Tile t = make_tile(d);
  if (threadIdx.x < kZeroBytes / 16)
    st_shared_v4(sb.zero + threadIdx.x * 16, 0, 0, 0, 0);
  int cur[5];
  stage_cursor(d, t, cur);
  // g3's one chunk stays when phase C stages no gd chunks.
  const bool resident = d.cinp == 64 && !d.proj;
  if (resident) {
    stage_x<false>(d, t, a.g3, 0, sb.x, cur[0], cur[1], cur[2], cur[3],
                   cur[4]);
    cp_async_commit();
  }

  const int NT1 = 64 * d.wn1, NT3 = 64 * d.wn3;
  const int n1 = phase_steps<kConv1>(d), n2 = phase_steps<kConv2>(d),
            n3 = phase_steps<kConv3>(d);
  int gs = 0;
  bool pre = false;
  const int MB = t.gcount * t.rows * W;

  // Phase A: g2 over rows [lo, hi).
  {
    const PassGeom<kMF1, kNW1> pg(d.wn1, d.cmidp);
    float acc[kMF1][kNW1 / 2];
    const int RA = t.hi - t.lo;
    const int MA = t.gcount * RA * W;
    for (int m0 = 0; m0 < MA; m0 += pg.MT) {
      for (int np = 0; np < pg.npass; ++np) {
        const int nn = np + 1 < pg.npass ? np + 1 : 0;
        const bf16* wn = np + 1 == pg.npass && m0 + pg.MT >= MA
                             ? a.wb
                         : resident ? a.wa + (size_t)nn * n1 * 64 * NT1
                                    : nullptr;
        mma_pass<kConv1, kMF1, kNW1, bf16, kPromote>(
            acc, d, t, sb, a.g3, a.wa, m0, np, MA, !resident, cur, gs, pre,
            wn, NT1);
        pre = wn != nullptr;
#pragma unroll
        for (int f = 0; f < kMF1; ++f) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = pg.row(m0, f, half);
            if (m >= MA) continue;
            const int q = m / W, col = m - q * W;
            const int g = q / RA, yr = q - g * RA;
            const int row = t.lo + yr;
            const size_t pix = ((size_t)(t.g0 + g) * H + row) * W + col;
            const bf16* y2 = a.y2 + pix * d.cmid;
            bf16* save = row >= t.r0 && row < t.r0 + t.rows
                             ? a.g2 + pix * d.cmid
                             : nullptr;
#pragma unroll
            for (int j = 0; j < kNW1 / 8; ++j) {
              const int n = pg.chan(np, j);
              float v0 = 0.f, v1 = 0.f;
              if (n < d.cmid) {
                const float2 y = get_pair(y2 + n);
                v0 = __fmul_rn(__fmul_rn(acc[f][4 * j + 2 * half],
                                         y.x > 0.f ? 1.f : 0.f),
                               a.s2[n]);
                v1 = __fmul_rn(__fmul_rn(acc[f][4 * j + 2 * half + 1],
                                         y.y > 0.f ? 1.f : 0.f),
                               a.s2[n + 1]);
              }
              put_pair(sb.y1, (g * t.yrows + yr) * W + col, d.cmidp, d.cmid,
                       n, v0, v1, save);
            }
          }
        }
      }
    }
  }

  // Phase B: g1 over the output rows, into the y2 map and g1.
  {
    const PassGeom<kMF1, kNW1> pg(d.wn1, d.cmidp);
    float acc[kMF1][kNW1 / 2];
    for (int m0 = 0; m0 < MB; m0 += pg.MT) {
      for (int np = 0; np < pg.npass; ++np) {
        const int nn = np + 1 < pg.npass ? np + 1 : 0;
        const bool last = np + 1 == pg.npass && m0 + pg.MT >= MB;
        mma_pass<kConv2, kMF1, kNW1, bf16, kPromote>(
            acc, d, t, sb, a.g3, a.wb, m0, np, MB, false, cur, gs, pre,
            last ? a.wc : a.wb + (size_t)nn * n2 * 64 * NT1,
            last ? NT3 : NT1);
        pre = true;
        if (sb.L.overlay) __syncthreads();  // all of g2 read
#pragma unroll
        for (int f = 0; f < kMF1; ++f) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = pg.row(m0, f, half);
            if (m >= MB) continue;
            const int q = m / W, col = m - q * W;
            const int g = q / t.rows, row = t.r0 + (q - g * t.rows);
            const size_t pix = ((size_t)(t.g0 + g) * H + row) * W + col;
            const bf16* y1 = a.y1 + pix * d.cmid;
#pragma unroll
            for (int j = 0; j < kNW1 / 8; ++j) {
              const int n = pg.chan(np, j);
              float v0 = 0.f, v1 = 0.f;
              if (n < d.cmid) {
                const float2 y = get_pair(y1 + n);
                v0 = __fmul_rn(__fmul_rn(acc[f][4 * j + 2 * half],
                                         y.x > 0.f ? 1.f : 0.f),
                               a.s1[n]);
                v1 = __fmul_rn(__fmul_rn(acc[f][4 * j + 2 * half + 1],
                                         y.y > 0.f ? 1.f : 0.f),
                               a.s1[n + 1]);
              }
              put_pair(sb.y2, m, d.cmidp, d.cmid, n, v0, v1,
                       a.g1 + pix * d.cmid);
            }
          }
        }
      }
    }
  }

  // Phase C: dx = g1 w1^T (+ gd wd^T) (+ d_pre), f32.
  {
    const PassGeom<kMF3, kNW3> pg(d.wn3, d.coutp);
    float acc[kMF3][kNW3 / 2];
    const int C = d.cout;
    for (int m0 = 0; m0 < MB; m0 += pg.MT) {
      for (int np = 0; np < pg.npass; ++np) {
        const int nn = np + 1 < pg.npass ? np + 1 : 0;
        const bf16* wn = np + 1 == pg.npass && m0 + pg.MT >= MB
                             ? nullptr
                             : a.wc + (size_t)nn * n3 * 64 * NT3;
        mma_pass<kConv3, kMF3, kNW3, bf16, kPromote>(
            acc, d, t, sb, a.gd, a.wc, m0, np, MB, !resident, cur, gs, pre,
            wn, NT3);
        pre = wn != nullptr;
#pragma unroll
        for (int f = 0; f < kMF3; ++f) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = pg.row(m0, f, half);
            const bool live = m < MB;
            const int q = m / W, col = m - q * W;
            const int g = q / t.rows, r = t.r0 + (q - g * t.rows);
            const size_t pix = ((size_t)(t.g0 + g) * H + r) * W + col;
#pragma unroll
            for (int k = 0; k < kNW3 / 32; ++k) {
              float2 e[4];
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                e[jj] = make_float2(acc[f][4 * (4 * k + jj) + 2 * half],
                                    acc[f][4 * (4 * k + jj) + 2 * half + 1]);
              float v[8];
              quad_transpose(e, v);
              const int lq = threadIdx.x & 3;
              const int n0 = pg.chan(np, 4 * k + lq) - 2 * lq;
              if (!live || n0 >= C) continue;
              if (a.dpre != nullptr) {
                const float4* rp =
                    reinterpret_cast<const float4*>(a.dpre + pix * C + n0);
                const float4 ra = rp[0], rb = rp[1];
                const float rr[8] = {ra.x, ra.y, ra.z, ra.w,
                                     rb.x, rb.y, rb.z, rb.w};
#pragma unroll
                for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(v[i], rr[i]);
              }
              float4* o = reinterpret_cast<float4*>(a.dx + pix * C + n0);
              o[0] = make_float4(v[0], v[1], v[2], v[3]);
              o[1] = make_float4(v[4], v[5], v[6], v[7]);
            }
          }
        }
      }
    }
  }
}

// The (kMF1, kNW1, kMF3, kNW3) instance of a plan's pass widths: NT 256
// passes on m64n128 products, NT 64 and 128 on m64n64 (kernel 2's rule);
// M passes of d.mrows / wn rows: 512 (kernel 2's tiles; the input
// gradient), or 256 for the forward, whose promoted sums (mma_pass
// kPromote) hold twice the accumulators. The input gradient's sums feed
// no ReLU mask; promoted, in 256-row passes, it moved none of kernel 9's
// errors and took 14-18% longer (PERF.md §6), so it keeps kernel 2's tiles.
template <template <int, int, int, int, bool> class K, int kMrows,
          typename... A>
int mma_dispatch(const MmaDims& d, A... args) {
  if (d.mrows != kMrows) return (int)cudaErrorInvalidValue;
  if constexpr (kMrows == 256) {
    if (d.wn1 == 4)
      return d.wn3 == 4 ? K<1, 128, 1, 128, true>::run(d, args...)
                        : K<1, 128, 2, 64, true>::run(d, args...);
    return d.wn3 == 4 ? K<2, 64, 1, 128, true>::run(d, args...)
                      : K<2, 64, 2, 64, true>::run(d, args...);
  } else {
    if (d.wn1 == 4)
      return d.wn3 == 4 ? K<2, 128, 2, 128, false>::run(d, args...)
                        : K<2, 128, 4, 64, false>::run(d, args...);
    return d.wn3 == 4 ? K<4, 64, 2, 128, false>::run(d, args...)
                      : K<4, 64, 4, 64, false>::run(d, args...);
  }
}

template <int kMF1, int kNW1, int kMF3, int kNW3, bool kPromote>
struct FwdLaunch {
  static int run(const MmaDims& d, const TrainFwd& a, cudaStream_t s) {
    auto* k = train_fwd_bf16<kMF1, kNW1, kMF3, kNW3, kPromote>;
    const int smem = mma_smem(d).total;
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((d.h + d.tile_rows - 1) / d.tile_rows,
              (d.n + d.images - 1) / d.images);
    k<<<grid, kMmaThreads, smem, s>>>(a, d);
    return (int)cudaGetLastError();
  }
};

template <int kMF1, int kNW1, int kMF3, int kNW3, bool kPromote>
struct DgradLaunch {
  static int run(const MmaDims& d, const TrainDgrad& a, cudaStream_t s) {
    auto* k = train_dgrad_bf16<kMF1, kNW1, kMF3, kNW3, kPromote>;
    const int smem = mma_smem(d).total;
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((d.h + d.tile_rows - 1) / d.tile_rows,
              (d.n + d.images - 1) / d.images);
    k<<<grid, kMmaThreads, smem, s>>>(a, d);
    return (int)cudaGetLastError();
  }
};

// A plan the three-phase kernel takes (bf16_dispatch's checks), with every
// channel count a multiple of 8 (16-byte lines).
bool mma_dims_ok(const MmaDims& d) {
  return d.cinp >= d.cin && d.cmidp >= d.cmid && d.coutp >= d.cout &&
         d.cinp % 64 == 0 && d.cmidp % 64 == 0 && d.coutp % 64 == 0 &&
         d.cin > 0 && d.cmid > 0 && d.cout > 0 && d.cin % 8 == 0 &&
         d.cmid % 8 == 0 && d.cout % 8 == 0 && wn_ok(d.wn1, d.cmidp) &&
         wn_ok(d.wn3, d.coutp) && (d.mrows == 256 || d.mrows == 512) &&
         d.tile_rows >= 1 && d.tile_rows <= d.h &&
         d.images >= 1 && (d.images == 1 || d.tile_rows == d.h) &&
         mma_smem(d).total <= 232448;
}

// ---------------------------------------------------- weight gradients

// dW[tap][k][n] = sum over pixels p of A[p + o_tap][k] G[p][n] (o_tap the
// 3x3 tap's offset; 0 for a 1x1 conv): M = A's channels (64 a warpgroup),
// N = G's channels, K = pixels. A (an activation [N, P, ka], bf16, or f32
// rounded to bf16 as it is staged) is the transposed operand: staged
// [pixel][64 channels] and loaded by ldmatrix.trans into register
// fragments; G [N, P, ng] bf16 is staged [pixel][64 channels], which is
// the MN-major layout of wgmma's B (transpose bit, sw128_desc_mn). A range
// is `rows` image rows (3x3; A staged with its one-row halo) or kWgPix
// pixels (1x1); block x (a slot) takes ranges x, x + slots, ... in order,
// summing in registers, and writes its partial [taps][ka][ng] tile; the
// slots are then summed in slot order (reduce_partials). The partition
// depends on the shapes alone, and nothing is summed by atomics, so the
// same inputs give the same dW bit for bit. 3x3: three warpgroups, one
// per tap row ky, each holding its three taps' 64 x 64 sums over one
// staging of y1 and g2; 1x1: one warpgroup, kNB G chunks.
constexpr int kWgPix = 128;

struct WgArgs {
  const void* a;
  const bf16* g;
  float* part;
  int n, h, w, ka, ng;
  int rows, ranges, kchunks;
};

struct WgSmem {
  int a, g, buf, total;
};

__host__ __device__ inline WgSmem wg_smem(int k3, int knb, int w, int rows) {
  WgSmem s;
  const int apix = k3 ? (rows + 2) * w : kWgPix;
  const int gpix = k3 ? (rows * w + 15) / 16 * 16 : kWgPix;
  s.a = (apix * 128 + 1023) / 1024 * 1024;
  s.g = gpix * 128;
  s.buf = s.a + knb * s.g;
  s.total = 2 * s.buf + kZeroBytes;
  return s;
}

template <bool k3, int kNB, bool kAF32>
__global__ void __launch_bounds__(k3 ? 384 : 128, 1)
wgrad_bf16(WgArgs p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int kT = k3 ? 384 : 128;
  constexpr int kAcc = k3 ? 3 : kNB;
  const WgSmem L = wg_smem(k3, kNB, p.w, p.rows);
  const uint32_t base = smem_u32(smem);
  const uint32_t zero = base + 2 * L.buf;
  if (threadIdx.x < kZeroBytes / 16)
    st_shared_v4(zero + threadIdx.x * 16, 0, 0, 0, 0);
  const int W = p.w, H = p.h, P = H * W;
  const int kc = blockIdx.y % p.kchunks, gc = blockIdx.y / p.kchunks;
  const int a0 = kc * 64, n0 = gc * 64 * kNB;
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int ky = k3 ? threadIdx.x >> 7 : 0;
  const int tiles = k3 ? (H + p.rows - 1) / p.rows : 0;
  const size_t total = (size_t)p.n * P;

  // Range r: its first output pixel, its first row (3x3), its pixels.
  struct Range {
    size_t px0;
    int img, row0, count;
  };
  auto range = [&](int r) {
    Range g;
    if (k3) {
      g.img = r / tiles;
      g.row0 = (r - g.img * tiles) * p.rows;
      g.count = imin(p.rows, H - g.row0) * W;
      g.px0 = (size_t)g.img * P + (size_t)g.row0 * W;
    } else {
      g.img = 0;
      g.row0 = 0;
      g.px0 = (size_t)r * kWgPix;
      g.count = (int)(total - g.px0 < (size_t)kWgPix ? total - g.px0
                                                    : (size_t)kWgPix);
    }
    return g;
  };

  // One 16-byte line of A (channels c .. c + 7 of pixel px) or zeros.
  auto stage_a = [&](uint32_t dst, size_t px, int c) {
    if (c >= p.ka) {
      st_shared_v4(dst, 0, 0, 0, 0);
    } else if (kAF32) {
      const float4* src = reinterpret_cast<const float4*>(
          static_cast<const float*>(p.a) + px * p.ka + c);
      const float4 u = __ldg(src), v = __ldg(src + 1);
      st_shared_v4(dst, pack_bf16x2(u.x, u.y), pack_bf16x2(u.z, u.w),
                   pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
    } else {
      cp_async16(dst, static_cast<const bf16*>(p.a) + px * p.ka + c);
    }
  };

  auto stage = [&](int buf, int r) {
    const uint32_t ab = base + buf * L.buf, gb = ab + L.a;
    const Range g = range(r);
    if (k3) {
      const int nrows = g.count / W;
      for (int e = threadIdx.x; e < (nrows + 2) * W * 8; e += kT) {
        const int bp = e >> 3, seg = e & 7;
        const int br = bp / W, col = bp - br * W;
        const int row = g.row0 - 1 + br;
        if (row < 0 || row >= H) continue;
        stage_a(ab + bp * 128 + ((seg ^ (bp & 7)) << 4),
                (size_t)g.img * P + (size_t)row * W + col, a0 + seg * 8);
      }
    } else {
      for (int e = threadIdx.x; e < g.count * 8; e += kT) {
        const int bp = e >> 3, seg = e & 7;
        stage_a(ab + bp * 128 + ((seg ^ (bp & 7)) << 4), g.px0 + bp,
                a0 + seg * 8);
      }
    }
    const int gpad = (g.count + 15) / 16 * 16;
    for (int e = threadIdx.x; e < gpad * 8 * kNB; e += kT) {
      const int j = e / (gpad * 8), rem = e - j * gpad * 8;
      const int bp = rem >> 3, seg = rem & 7;
      const uint32_t dst = gb + j * L.g + bp * 128 + ((seg ^ (bp & 7)) << 4);
      const int c = n0 + j * 64 + seg * 8;
      if (bp >= g.count || c >= p.ng)
        st_shared_v4(dst, 0, 0, 0, 0);
      else
        cp_async16(dst, p.g + (g.px0 + bp) * p.ng + c);
    }
  };

  constexpr int kPart = k3 ? 1 : kAcc;
  float acc[kAcc][32], part[kPart][32];
#pragma unroll
  for (int i = 0; i < kAcc; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < kPart; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) part[i][e] = 0.f;

  // The lane's pixel of a k16 step and its 16-byte channel line.
  const int kk = (lane & 7) + ((lane >> 4) << 3);
  const int line = 2 * wq + ((lane >> 3) & 1);
  int buf = 0;
  stage(0, blockIdx.x);
  cp_async_commit();
  for (int r = blockIdx.x; r < p.ranges; r += gridDim.x) {
    if (r + (int)gridDim.x < p.ranges) stage(buf ^ 1, r + gridDim.x);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const uint32_t ab = base + buf * L.buf, gb = ab + L.a;
    const Range g = range(r);
    const int nsteps = (g.count + 15) / 16;
    int rr = 0, cc = kk;  // 3x3: the lane pixel's row and column
    if (k3) {
      rr = kk / W;
      cc = kk - rr * W;
    }
    for (int s = 0; s < nsteps; ++s) {
      const int pix = s * 16 + kk;
      uint32_t af[k3 ? 3 : 1][4];
      if (k3) {
        const int ir = g.row0 + rr + ky - 1;
        const bool rok = pix < g.count && ir >= 0 && ir < H;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int ic = cc + kx - 1;
          const bool ok = rok && ic >= 0 && ic < W;
          const int bp = (rr + ky) * W + ic;
          ldsm_x4_t(af[kx], ok ? ab + bp * 128 + ((line ^ (bp & 7)) << 4)
                               : zero);
        }
        cc += 16;
        while (cc >= W) {
          cc -= W;
          ++rr;
        }
      } else {
        const bool ok = pix < g.count;
        ldsm_x4_t(af[0], ok ? ab + pix * 128 + ((line ^ (pix & 7)) << 4)
                            : zero);
      }
      // Each k16 product is a fresh wgmma sum (part), added to acc in f32
      // (round to nearest), as mma_pass kPromote does: a range's long
      // pixel sum left in wgmma's accumulator strays 2.6x as far from
      // float64 as f32 FFMA sums (PERF.md §6). A 3x3 block's registers hold
      // one part (its taps go in turn), a 1x1's one per G chunk.
#pragma unroll
      for (int i0 = 0; i0 < kAcc; i0 += kPart) {
        wg_fence();
#pragma unroll
        for (int j = 0; j < kPart; ++j)
          wgmma_m64n64_tb(
              part[j], af[k3 ? i0 + j : 0],
              sw128_desc_mn(gb + (k3 ? 0 : (i0 + j) * L.g) + s * 2048), 0);
        wg_commit();
        wg_wait0();
#pragma unroll
        for (int j = 0; j < kPart; ++j)
#pragma unroll
          for (int e = 0; e < 32; ++e)
            acc[i0 + j][e] = __fadd_rn(acc[i0 + j][e], part[j][e]);
      }
    }
    __syncthreads();  // every warpgroup is done with buf before it refills
    buf ^= 1;
  }
  cp_async_wait<0>();

  const int taps = k3 ? 9 : 1;
  float* dst = p.part + (size_t)blockIdx.x * taps * p.ka * p.ng;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int tap = k3 ? ky * 3 + i : 0;
    const int nb = k3 ? n0 : n0 + i * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = a0 + 16 * wq + (lane >> 2) + 8 * half;
        const int n = nb + 8 * j + 2 * (lane & 3);
        if (m < p.ka && n < p.ng)
          *reinterpret_cast<float2*>(dst + ((size_t)tap * p.ka + m) * p.ng +
                                     n) =
              make_float2(acc[i][4 * j + 2 * half],
                          acc[i][4 * j + 2 * half + 1]);
      }
    }
  }
}

template <bool k3, int kNB, bool kAF32>
int wgrad_bf16_launch(const WgArgs& p, int slots, int tiles, float* out,
                      cudaStream_t s) {
  const int smem = wg_smem(k3, kNB, p.w, p.rows).total;
  auto* k = wgrad_bf16<k3, kNB, kAF32>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  k<<<dim3(slots, tiles), k3 ? 384 : 128, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t m = (size_t)(k3 ? 9 : 1) * p.ka * p.ng;
  reduce_partials<<<grid_1d(m), kThreads, 0, s>>>(p.part, out, slots, m);
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------ launchers

// f32 (FFMA): kernel 8's shared memory per block.
extern "C" long long train_block_fwd_smem_bytes(int w, int cmid,
                                                int tile_rows) {
  return (long long)fwd_smem_bytes<float>(w, cmid, tile_rows);
}

// Kernel 8 in f32, one block. wd/sd/bd may be null (identity shortcut,
// cin == cout); y1_save/y2_save may be null (the forward of the train
// step).
extern "C" int train_block_fwd_launch(
    const void* x, const void* w1, const void* s1, const void* b1,
    const void* w2, const void* s2, const void* b2, const void* w3,
    const void* s3, const void* b3, const void* wd, const void* sd,
    const void* bd, void* out, void* y1_save, void* y2_save, int n, int h,
    int w, int cin, int cmid, int cout, int tile_rows, void* stream) {
  if (n == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
  Dims d{n, h, w, cin, cmid, cout, tile_rows};
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  FwdArgs<float> a{f(x),  f(w1), f(s1), f(b1), f(w2), f(s2),
                   f(b2), f(w3), f(s3), f(b3), f(wd), f(sd),
                   f(bd), (float*)out, (float*)y1_save, (float*)y2_save};
  return launch_fwd<float>(a, d, (cudaStream_t)stream);
}

// Kernel 9, d_pre, g3 and gd (elementwise; both dtypes). sd/gd null on an
// identity shortcut; dpre may be null.
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

// Kernel 9 in f32: g2 (FFMA).
extern "C" int train_bwd_dy2_launch(const void* g3, const void* w3,
                                    const void* y2, const void* s2, void* g2,
                                    int rows, int cmid, int cout,
                                    void* stream) {
  if (rows == 0) return (int)cudaGetLastError();
  dim3 grid((rows + kTileP - 1) / kTileP, (cmid + kTileN - 1) / kTileN);
  bwd_dy2<float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)g3, (const float*)w3, (const float*)y2, (const float*)s2,
      (float*)g2, rows, cmid, cout);
  return (int)cudaGetLastError();
}

// Kernel 9 in f32: g1 through the transposed 3x3 (FFMA).
extern "C" int train_bwd_dy1_launch(const void* g2, const void* w2,
                                    const void* y1, const void* s1, void* g1,
                                    int n, int h, int w, int cmid,
                                    void* stream) {
  const size_t rows = (size_t)n * h * w;
  if (rows == 0) return (int)cudaGetLastError();
  dim3 grid((unsigned)((rows + kTileP - 1) / kTileP),
            (cmid + kTileN - 1) / kTileN);
  bwd_dy1<float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)g2, (const float*)w2, (const float*)y1, (const float*)s1,
      (float*)g1, n, h, w, cmid);
  return (int)cudaGetLastError();
}

// Kernel 9 in f32: dx (FFMA). gd/wd null on an identity shortcut (then
// dpre is read).
extern "C" int train_bwd_dx_launch(const void* g1, const void* w1,
                                   const void* gd, const void* wd,
                                   const void* dpre, void* dx, int rows,
                                   int cin, int cmid, int cout,
                                   void* stream) {
  if (rows == 0) return (int)cudaGetLastError();
  dim3 grid((rows + kTileP - 1) / kTileP, (cin + kTileN - 1) / kTileN);
  bwd_dx<float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)g1, (const float*)w1, (const float*)gd, (const float*)wd,
      (const float*)dpre, (float*)dx, rows, cin, cmid, cout);
  return (int)cudaGetLastError();
}

// Kernel 9 in f32: one weight gradient [taps, K, Nc] into `out`, via
// per-image partials in `part` (n * taps * K * Nc floats; FFMA).
extern "C" int train_wgrad_launch(int amode, const void* a, const void* b,
                                  void* part, void* out, int n, int h, int w,
                                  int K, int Nc, int taps, void* stream) {
  if (n == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
  return launch_wgrad<float>(amode, a, b, (float*)part, (float*)out, n, h, w,
                             K, Nc, taps, (cudaStream_t)stream);
}

// bf16: the shared memory of the three-phase block (kernel 2's formula,
// mma_smem; the forward's plans (M passes of mrows = 256) and the input
// gradient's (512) both use it).
extern "C" long long train_mma_smem_bytes(int h, int w, int cin, int cmid,
                                          int cout, int cinp, int cmidp,
                                          int coutp, int tile_rows,
                                          int images, int wn1, int wn3,
                                          int mrows) {
  MmaDims d{0, h, w, cin, cmid, cout, cinp, cmidp, coutp,
            tile_rows, images, wn1, wn3, 0, 1, mrows};
  return (long long)mma_smem(d).total;
}

// Kernel 8 in bf16, one block: x f32 [n, h*w, cin], out f32 [n, h*w,
// cout]; w1, w2, w3, wd relaid out (ops/bottleneck_train.py
// _train_fwd_weights); affines f32; wd/sd/bd null on an identity block;
// y1_save/y2_save bf16 [n, h*w, cmid] or null. Tiles from
// bottleneck_tile_plan(h, w, cin, cmid, cout, n, mrows=256); every
// channel count a multiple of 8, x and out 16-byte aligned.
extern "C" int train_block_fwd_bf16_launch(
    const void* x, const void* w1, const void* s1, const void* b1,
    const void* w2, const void* s2, const void* b2, const void* w3,
    const void* s3, const void* b3, const void* wd, const void* sd,
    const void* bd, void* out, void* y1_save, void* y2_save, int n, int h,
    int w, int cin, int cmid, int cout, int cinp, int cmidp, int coutp,
    int tile_rows, int images, int wn1, int wn3, void* stream) {
  if (n == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
  MmaDims d{n, h, w, cin, cmid, cout, cinp, cmidp, coutp,
            tile_rows, images, wn1, wn3, 0, 1, 256};
  if (!mma_dims_ok(d) || (wd == nullptr && cin != cout))
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto b = [](const void* p) { return static_cast<const bf16*>(p); };
  TrainFwd a{f(x),  b(w1), b(w2), b(w3), b(wd), f(s1), f(b1),
             f(s2), f(b2), f(s3), f(b3), f(sd), f(bd), (float*)out,
             (bf16*)y1_save, (bf16*)y2_save};
  return mma_dispatch<FwdLaunch, 256>(d, a, (cudaStream_t)stream);
}

// Kernel 9 in bf16, the input gradient of one block (g2, g1 and dx in one
// launch). cin, cmid, cout and their padded counts are the block's; the
// tiles come from bottleneck_tile_plan(h, w, cout, cmid, cin, n) (the
// block run backwards: wn1 the g2 and g1 passes, wn3 dx's). wa, wb, wc
// relaid out (_train_dgrad_weights); gd null and dpre f32 [n, h*w, cin]
// on an identity block.
extern "C" int train_bwd_dgrad_bf16_launch(
    const void* g3, const void* gd, const void* wa, const void* wb,
    const void* wc, const void* y1, const void* y2, const void* s1,
    const void* s2, const void* dpre, void* g2, void* g1, void* dx, int n,
    int h, int w, int cin, int cmid, int cout, int cinp, int cmidp,
    int coutp, int tile_rows, int images, int wn1, int wn3, void* stream) {
  if (n == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
  const int proj = gd != nullptr;
  MmaDims d{n, h, w, cout, cmid, cin, coutp, cmidp, cinp,
            tile_rows, images, wn1, wn3, proj, 1, 512};
  if (!mma_dims_ok(d) || (!proj && (cin != cout || dpre == nullptr)))
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto b = [](const void* p) { return static_cast<const bf16*>(p); };
  TrainDgrad a{b(g3), b(gd), b(wa), b(wb), b(wc), b(y1), b(y2),
               f(s1), f(s2), proj ? nullptr : f(dpre), (bf16*)g2,
               (bf16*)g1, (float*)dx};
  return mma_dispatch<DgradLaunch, 512>(d, a, (cudaStream_t)stream);
}

// bf16: the shared memory of a weight-gradient block.
extern "C" long long train_wgrad_bf16_smem_bytes(int k3, int knb, int w,
                                                 int rows) {
  return (long long)wg_smem(k3, knb, w, rows).total;
}

// Kernel 9 in bf16, one weight gradient dW [9 or 1, ka, ng] f32 into
// `out`: k3 the 3x3 (a: y1 bf16; knb 1), else a 1x1 (a: y2 bf16, or x f32
// with af32; knb 1 or 2 G chunks a block). rows (3x3), ranges, slots and
// tiles from ops/bottleneck_train.py train_wgrad_plan; part holds slots *
// taps * ka * ng floats. ka, ng multiples of 8.
extern "C" int train_wgrad_bf16_launch(int k3, int knb, int af32,
                                       const void* a, const void* g,
                                       void* part, void* out, int n, int h,
                                       int w, int ka, int ng, int rows,
                                       int ranges, int slots, int tiles,
                                       void* stream) {
  if (n == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
  const int kchunks = (ka + 63) / 64;
  const bool ok =
      ka > 0 && ng > 0 && ka % 8 == 0 && ng % 8 == 0 &&
      tiles == kchunks * ((ng + 64 * knb - 1) / (64 * knb)) && slots >= 1 &&
      slots <= ranges &&
      ranges == (k3 ? n * ((h + rows - 1) / rows)
                    : (int)(((size_t)n * h * w + kWgPix - 1) / kWgPix)) &&
      (k3 ? knb == 1 && !af32 && rows >= 1 && rows <= h
          : knb == 1 || knb == 2) &&
      wg_smem(k3, knb, w, rows).total <= 232448;
  if (!ok) return (int)cudaErrorInvalidValue;
  WgArgs p{a, static_cast<const bf16*>(g), (float*)part, n, h, w, ka, ng,
           rows, ranges, kchunks};
  cudaStream_t s = (cudaStream_t)stream;
  float* o = (float*)out;
  if (k3) return wgrad_bf16_launch<true, 1, false>(p, slots, tiles, o, s);
  if (knb == 2)
    return af32 ? wgrad_bf16_launch<false, 2, true>(p, slots, tiles, o, s)
                : wgrad_bf16_launch<false, 2, false>(p, slots, tiles, o, s);
  return af32 ? wgrad_bf16_launch<false, 1, true>(p, slots, tiles, o, s)
              : wgrad_bf16_launch<false, 1, false>(p, slots, tiles, o, s);
}
