// One stride-1 ResNet bottleneck block, fused: conv1 1x1 -> conv2 3x3 ->
// conv3 1x1 + residual (projected on a stage's entry block), with the folded
// BatchNorm biases and ReLUs. The wrapper (ops/bottleneck.py) launches it
// once per block of the stack.
//
// Replaces the Pallas TPU kernel eov_tpu/ops/pallas_bottleneck.py
// fused_bottleneck_stack (_stack_kernel / _run_chain). The TPU design keeps
// a whole 56x56 map in 128 MiB of VMEM with no spatial tiling; a Hopper SM
// has 227 KB of shared memory, so here one thread block owns TR output rows
// of one image (or G whole images of a small map) through one block:
//   phase A: conv1 (+bias, ReLU, rounded to T) over the TR rows plus a one
//            row halo above and below, recomputed per tile, into shared
//            memory (rows outside the image are never read);
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
// peak (342 GFLOP, 0.346 ms at 256 images). One launch per block moves each
// block's input and output through device memory: 2.16 GB over ResNet-50
// stage 1 at 256 images, a floor of 0.64 ms that only a kernel holding the
// whole stack on chip (the TPU's design; a 56^2 x 256 map is 1.6 MB) avoids.
//
// bf16 (bottleneck_bf16_kernel) runs every product on the tensor cores,
// over mma_tile.cuh, the way kernel 4 (basic_stack.cu) does; the tiles,
// the staging and the pass (mma_pass) are in bottleneck_mma.cuh, which the
// train stack's kernels (bottleneck_train.cu) share:
// - Each phase is an implicit GEMM: M = pixels, N = output channels in
//   passes of NT = 64 wn, K = 64-channel chunks (x 9 taps in phase B) x 4
//   k16 steps. A comes to registers by ldmatrix through per-row addresses
//   (divided once per M pass; a tap adds dy*W + dx and sends a row outside
//   the image, or past M, to a zero line), so no integer division runs per
//   element and widths 7, 14, 28 cost nothing. B, the weights, is a K-major
//   128-byte-swizzled [NT][64] tile that reaches a 3-deep ring by cp.async
//   while the tensor cores work on the step before (one barrier a step;
//   the next pass's first tile loads during a pass's epilogue); the
//   wrapper relays the weights out once per call in the order the K loops
//   read them. Products: wgmma m64n64k16 (NT 64, 128) or m64n128k16
//   (NT 256), f32 sums in registers, every m64 tile issued unconditionally
//   (a branch around wgmma makes ptxas serialize them).
// - Phase A stages each 64-channel chunk of the x rows (tile + halo) once
//   by cp.async into an XOR-swizzled tile (two buffers taking turns, one
//   step ahead, when cin > 64; at cin = 64 the one chunk is staged first
//   and stays for phase C's projection). y1 and y2 are XOR-swizzled too;
//   y2 takes y1's place when phase B is one M pass and one N pass (all of
//   y1 is read before y2 is written).
// - Phase C runs K over y2's chunks, then, on an entry block, the
//   projection's chunks of x; one f32 sum holds both (wd and w3 are one
//   K-concatenated weight). The identity residual is read from x. Its
//   epilogue transposes each quad's accumulators so that a lane loads and
//   stores 16 bytes (8 channels) of a row.
// - Tiles: ops/bottleneck.py bottleneck_tile_plan picks TR, G and the N
//   pass widths that fit the 227 KB and take the fewest K steps per image
//   (bottleneck_bf16_smem_bytes must agree with it).
//
// f32 keeps the FFMA kernel (bottleneck_block_kernel, block_gemm of
// tile_gemm.cuh): TF32 would not meet the f32 bar of 1e-4.
//
// Rounding follows _run_chain: products of T values accumulate in f32, y1
// and y2 round to T after bias+ReLU, and y3 + b3 + residual is summed in f32
// before the final ReLU and the one rounding.
//
// Kernel 5, the pool-at-entry launchers (pool_bottleneck_block_*launch),
// is the same code with kPool set. It replaces
// eov_tpu/ops/pallas_bottleneck.py fused_pool_bottleneck_stack
// (_pool_stack_kernel): the stem's 3x3/s2 max-pool of the post-ReLU map
// [N, 2H, 2W, 64] builds the block's input, so the pooled [N, H, W, 64] map
// is never written or read back. In bf16 (cin <= 64) the pool runs once,
// before phase A, writing the pooled x rows of the tile and its halo into
// the tile kernel 2 stages from the pooled map; in f32 it runs in the FFMA
// kernel's x loader. Each pooled value is the same fmaxf sequence as kernel 6
// (maxpool_s2.cu), and every later line is kernel 2's, so the block equals
// maxpool -> kernel 2 in value. The wrapper launches the stage's first
// block (the projection block) through it and the other blocks through
// kernel 2.

#include "bottleneck_mma.cuh"

namespace {

struct Dims {
  int n, h, w, cin, cmid, cout, tile_rows;
};

// f32 (FFMA). kPool (kernel 5): x is the PRE-pool map [N, 2H, 2W, cin] and
// the block's input is its 3x3/s2 max-pool, built pixel by pixel in the x
// loader (pool3x3s2_at), so the pooled map never reaches device memory.
// Every other line is kernel 2's: the GEMMs see the same operand values in
// the same order, so the block's output equals maxpool -> kernel 2 bit for
// bit.
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

size_t smem_bytes(const Dims& d) {
  return kGemmSmem +
         sizeof(float) * ((size_t)(d.tile_rows + 2) * (d.w + 2) * d.cmid +
                          (size_t)d.tile_rows * d.w * d.cmid);
}

template <bool kPool>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, const void* wd,
           const void* bd, void* out, Dims d, cudaStream_t s) {
  if (d.n == 0 || d.h == 0 || d.w == 0) return (int)cudaGetLastError();
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_block_kernel<float, kPool>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((d.h + d.tile_rows - 1) / d.tile_rows, d.n);
  bottleneck_block_kernel<float, kPool><<<grid, kThreads, smem, s>>>(
      (const float*)x, (const float*)w1, (const float*)b1, (const float*)w2,
      (const float*)b2, (const float*)w3, (const float*)b3,
      (const float*)wd, (const float*)bd, (float*)out, d);
  return (int)cudaGetLastError();
}


// ------------------------------------------------ bf16 on the tensor cores
// (the block's tiles, staging and mma_pass: bottleneck_mma.cuh)

// The 3x3/s2 max-pool of 8 channels of pooled pixel (r, c) of one pre-pool
// image [2h][w2][cin] (16-byte aligned loads), in pool3x3s2_at's order:
// pool8_load issues the nine loads together (a tap above or left of the
// image is clamped onto the window's first row or column, which repeats a
// value of the window and leaves the max unchanged, up to the sign of a
// zero), pool8_max reduces them.
__device__ __forceinline__ void pool8_load(const bf16* __restrict__ img,
                                           int w2, int cin, int r, int c,
                                           int cb, uint4 (&tp)[9]) {
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int y = imax(2 * r + i / 3 - 1, 0), xx = imax(2 * c + i % 3 - 1, 0);
    tp[i] = *reinterpret_cast<const uint4*>(img + ((size_t)y * w2 + xx) * cin +
                                            cb);
  }
}

__device__ __forceinline__ void pool8_max(const uint4 (&tp)[9], int r, int c,
                                          uint32_t (&v)[4]) {
  float m[8];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int k = i == 0 ? 4 : i <= 4 ? i - 1 : i;  // the centre first
    const uint32_t u[4] = {tp[k].x, tp[k].y, tp[k].z, tp[k].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u[j]));
      m[2 * j] = i == 0 ? f.x : fmaxf(m[2 * j], f.x);
      m[2 * j + 1] = i == 0 ? f.y : fmaxf(m[2 * j + 1], f.y);
    }
  }
  const bool pad = r == 0 || c == 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = pad ? pack_bf16x2(fmaxf(m[2 * j], 0.f), fmaxf(m[2 * j + 1], 0.f))
               : pack_bf16x2(m[2 * j], m[2 * j + 1]);
}

__device__ __forceinline__ void pool8(const bf16* __restrict__ img, int w2,
                                      int cin, int r, int c, int cb,
                                      uint32_t (&v)[4]) {
  uint4 tp[9];
  pool8_load(img, w2, cin, r, c, cb, tp);
  pool8_max(tp, r, c, v);
}

// Kernel 5's staged input (cin % 8 == 0, at most 64): the pooled x rows
// [lo, hi) of the block's images, as stage_x lays them out, built before
// phase A with no sums live, so four pixels' 36 loads are in flight at once.
__device__ __forceinline__ void stage_pool(const MmaDims& d, const Tile& t,
                                           const bf16* __restrict__ x,
                                           uint32_t xb, int g, int xr,
                                           int col, int dq, int dr) {
  constexpr int kU = 4;
  const int seg = threadIdx.x & 7, cb = seg * 8;
  const int npix = t.gcount * t.yrows * d.w;
  for (int sp = threadIdx.x >> 3; sp < npix; sp += kU * (kMmaThreads / 8)) {
    uint4 tp[kU][9];
    int rr[kU], cc[kU];
    bool on[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      rr[u] = t.lo + xr;
      cc[u] = col;
      on[u] = sp + u * (kMmaThreads / 8) < npix && rr[u] < t.hi;
      if (on[u] && cb < d.cin)
        pool8_load(x + (size_t)(t.g0 + g) * 4 * d.h * d.w * d.cin, 2 * d.w,
                   d.cin, rr[u], cc[u], cb, tp[u]);
      col += dr;
      xr += dq;
      if (col >= d.w) {
        col -= d.w;
        ++xr;
      }
      while (xr >= t.yrows) {
        xr -= t.yrows;
        ++g;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (!on[u]) continue;
      const int p = sp + u * (kMmaThreads / 8);
      const uint32_t dst = xb + p * 128 + ((seg ^ (p & 7)) << 4);
      uint32_t v[4] = {0, 0, 0, 0};
      if (cb < d.cin) pool8_max(tp[u], rr[u], cc[u], v);
      st_shared_v4(dst, v[0], v[1], v[2], v[3]);
    }
  }
}

// Phase C's epilogue, cout % 8 == 0 and x 16-byte aligned: out =
// relu((acc + b3) + (bd, or x / its pool)), rounded once; each lane loads
// and stores 8 channels (16 bytes) of one row after a quad transpose, so a
// warp's access covers 64 contiguous bytes of each of 8 rows.
template <bool kPool, int kMF, int kNW>
__device__ __forceinline__ void store_out_vec(
    const float (&acc)[kMF][kNW / 2], const MmaDims& d, const Tile& t,
    const PassGeom<kMF, kNW>& pg, int m0, int np, int M,
    const bf16* __restrict__ x, const float* __restrict__ b3,
    const float* __restrict__ bd, bf16* __restrict__ out) {
  const int W = d.w, H = d.h, C = d.cout;
#pragma unroll
  for (int f = 0; f < kMF; ++f) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = pg.row(m0, f, half);
      const bool live = m < M;  // quad-uniform; the shuffles run anyway
      const int q = m / W, col = m - q * W;
      const int g = q / t.rows, r = t.r0 + (q - g * t.rows);
      const size_t o = (((size_t)(t.g0 + g) * H + r) * W + col) * C;
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
        float res[8];
        if (d.proj) {
#pragma unroll
          for (int i = 0; i < 8; ++i) res[i] = bd[n0 + i];
        } else {
          uint32_t xv[4];
          if (kPool) {
            pool8(x + (size_t)(t.g0 + g) * 4 * H * W * d.cin, 2 * W, d.cin,
                  r, col, n0, xv);
          } else {
            const uint4 u = *reinterpret_cast<const uint4*>(x + o + n0);
            xv[0] = u.x, xv[1] = u.y, xv[2] = u.z, xv[3] = u.w;
          }
          unpack8(xv, res);
        }
        uint4 w;
        uint32_t* wp = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wp[i] = pack_bf16x2(
              fmaxf((v[2 * i] + b3[n0 + 2 * i]) + res[2 * i], 0.f),
              fmaxf((v[2 * i + 1] + b3[n0 + 2 * i + 1]) + res[2 * i + 1],
                    0.f));
        *reinterpret_cast<uint4*>(out + o + n0) = w;
      }
    }
  }
}

// Phase C's epilogue for any cout and alignment, 2 channels per lane.
template <bool kPool, int kMF, int kNW>
__device__ __forceinline__ void store_out(
    const float (&acc)[kMF][kNW / 2], const MmaDims& d, const Tile& t,
    const PassGeom<kMF, kNW>& pg, int m0, int np, int M,
    const bf16* __restrict__ x, const float* __restrict__ b3,
    const float* __restrict__ bd, bf16* __restrict__ out) {
  const int W = d.w, H = d.h, C = d.cout;
#pragma unroll
  for (int f = 0; f < kMF; ++f) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = pg.row(m0, f, half);
      if (m >= M) continue;
      const int q = m / W, col = m - q * W;
      const int g = q / t.rows, r = t.r0 + (q - g * t.rows);
      const size_t o = (((size_t)(t.g0 + g) * H + r) * W + col) * C;
      const bf16* ximg =
          x + (size_t)(t.g0 + g) * (kPool ? 4 : 1) * H * W * d.cin;
#pragma unroll
      for (int j = 0; j < kNW / 8; ++j) {
        const int n = pg.chan(np, j);
        if (n >= C) continue;
        const bool two = n + 1 < C;
        const float a0 = acc[f][4 * j + 2 * half] + b3[n];
        const float a1 =
            two ? acc[f][4 * j + 2 * half + 1] + b3[n + 1] : 0.f;
        float r0v, r1v;
        if (d.proj) {
          r0v = bd[n];
          r1v = two ? bd[n + 1] : 0.f;
        } else if (kPool) {
          r0v = pool3x3s2_at(ximg, 2 * W, d.cin, r, col, n);
          r1v = two ? pool3x3s2_at(ximg, 2 * W, d.cin, r, col, n + 1) : 0.f;
        } else {
          r0v = __bfloat162float(x[o + n]);
          r1v = two ? __bfloat162float(x[o + n + 1]) : 0.f;
        }
        out[o + n] = __float2bfloat16_rn(fmaxf(a0 + r0v, 0.f));
        if (two) out[o + n + 1] = __float2bfloat16_rn(fmaxf(a1 + r1v, 0.f));
      }
    }
  }
}

// Kernels 2 (kPool false) and 5 (kPool true, x the pre-pool map): phase A
// with (kMF1, kNW1) tiles, B likewise, C with (kMF3, kNW3). w1 relaid out
// as [cmidp/NT1][cinp/64][NT1][64], w2 as [cmidp/NT1][cmidp/64][9][NT1][64],
// w3 (with wd's rows after w3's on an entry block) as
// [coutp/NT3][cmidp/64 (+ cinp/64)][NT3][64]; zero-padded.
template <bool kPool, int kMF1, int kNW1, int kMF3, int kNW3>
__global__ void __launch_bounds__(kMmaThreads, 1)
bottleneck_bf16_kernel(const bf16* __restrict__ x,
                       const bf16* __restrict__ w1,
                       const float* __restrict__ b1,
                       const bf16* __restrict__ w2,
                       const float* __restrict__ b2,
                       const bf16* __restrict__ w3,
                       const float* __restrict__ b3,
                       const float* __restrict__ bd, bf16* __restrict__ out,
                       MmaDims d) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int W = d.w;
  const Bufs sb = make_bufs(smem, d);
  const Tile t = make_tile(d);
  if (threadIdx.x < kZeroBytes / 16)
    st_shared_v4(sb.zero + threadIdx.x * 16, 0, 0, 0, 0);
  int cur[5];
  stage_cursor(d, t, cur);
  // At cin <= 64 the one x chunk is staged (pooled, for kernel 5) here,
  // with no sums live, and stays for phase C's projection.
  const bool resident = d.cinp == 64;
  if (resident) {
    if (kPool && d.vec)
      stage_pool(d, t, x, sb.x, cur[0], cur[1], cur[2], cur[3], cur[4]);
    else
      stage_x<kPool>(d, t, x, 0, sb.x, cur[0], cur[1], cur[2], cur[3],
                     cur[4]);
    cp_async_commit();
  }

  // The passes of all three phases share the weight ring: gs counts their
  // steps, and each pass loads the next one's first tile (pre) unless that
  // pass stages x at its first step (conv1 with cin > 64).
  const int NT1 = 64 * d.wn1, NT3 = 64 * d.wn3;
  const int n1 = phase_steps<kConv1>(d), n2 = phase_steps<kConv2>(d),
            n3 = phase_steps<kConv3>(d);
  int gs = 0;
  bool pre = false;
  const int MB = t.gcount * t.rows * W;

  // Phase A: y1 = relu(x w1 + b1) over rows [lo, hi), into y1.
  {
    const PassGeom<kMF1, kNW1> pg(d.wn1, d.cmidp);
    float acc[kMF1][kNW1 / 2];
    const int RA = t.hi - t.lo;
    const int MA = t.gcount * RA * W;
    for (int m0 = 0; m0 < MA; m0 += pg.MT) {
      for (int np = 0; np < pg.npass; ++np) {
        const int nn = np + 1 < pg.npass ? np + 1 : 0;
        const bf16* wn = np + 1 == pg.npass && m0 + pg.MT >= MA
                             ? w2
                         : resident ? w1 + (size_t)nn * n1 * 64 * NT1
                                    : nullptr;
        mma_pass<kConv1, kMF1, kNW1>(acc, d, t, sb, x, w1, m0, np, MA,
                                     !resident, cur, gs, pre, wn, NT1);
        pre = wn != nullptr;
#pragma unroll
        for (int f = 0; f < kMF1; ++f) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = pg.row(m0, f, half);
            if (m >= MA) continue;
            const int q = m / W, col = m - q * W;
            const int g = q / RA, yr = q - g * RA;
            const int ypix = (g * t.yrows + yr) * W + col;
#pragma unroll
            for (int j = 0; j < kNW1 / 8; ++j) {
              const int n = pg.chan(np, j);
              const float v0 =
                  n < d.cmid ? fmaxf(acc[f][4 * j + 2 * half] + b1[n], 0.f)
                             : 0.f;
              const float v1 =
                  n + 1 < d.cmid
                      ? fmaxf(acc[f][4 * j + 2 * half + 1] + b1[n + 1], 0.f)
                      : 0.f;
              st_shared_b32(sb.y1 + 2 * swz(ypix, d.cmidp, n),
                            pack_bf16x2(v0, v1));
            }
          }
        }
      }
    }
  }

  // Phase B: y2 = relu(conv3x3(y1) + b2) over the output rows, into y2 at
  // the pass row.
  {
    const PassGeom<kMF1, kNW1> pg(d.wn1, d.cmidp);
    float acc[kMF1][kNW1 / 2];
    for (int m0 = 0; m0 < MB; m0 += pg.MT) {
      for (int np = 0; np < pg.npass; ++np) {
        const int nn = np + 1 < pg.npass ? np + 1 : 0;
        const bool last = np + 1 == pg.npass && m0 + pg.MT >= MB;
        mma_pass<kConv2, kMF1, kNW1>(
            acc, d, t, sb, x, w2, m0, np, MB, false, cur, gs, pre,
            last ? w3 : w2 + (size_t)nn * n2 * 64 * NT1, last ? NT3 : NT1);
        pre = true;
        if (sb.L.overlay) __syncthreads();  // all of y1 read
#pragma unroll
        for (int f = 0; f < kMF1; ++f) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = pg.row(m0, f, half);
            if (m >= MB) continue;
#pragma unroll
            for (int j = 0; j < kNW1 / 8; ++j) {
              const int n = pg.chan(np, j);
              const float v0 =
                  n < d.cmid ? fmaxf(acc[f][4 * j + 2 * half] + b2[n], 0.f)
                             : 0.f;
              const float v1 =
                  n + 1 < d.cmid
                      ? fmaxf(acc[f][4 * j + 2 * half + 1] + b2[n + 1], 0.f)
                      : 0.f;
              st_shared_b32(sb.y2 + 2 * swz(m, d.cmidp, n),
                            pack_bf16x2(v0, v1));
            }
          }
        }
      }
    }
  }

  // Phase C: out = relu((y2 w3 [+ x wd] + b3) + (bd or x)), one rounding.
  {
    const PassGeom<kMF3, kNW3> pg(d.wn3, d.coutp);
    float acc[kMF3][kNW3 / 2];
    for (int m0 = 0; m0 < MB; m0 += pg.MT) {
      for (int np = 0; np < pg.npass; ++np) {
        const int nn = np + 1 < pg.npass ? np + 1 : 0;
        const bf16* wn = np + 1 == pg.npass && m0 + pg.MT >= MB
                             ? nullptr
                             : w3 + (size_t)nn * n3 * 64 * NT3;
        mma_pass<kConv3, kMF3, kNW3>(acc, d, t, sb, x, w3, m0, np, MB,
                                     !resident, cur, gs, pre, wn, NT3);
        pre = wn != nullptr;
        if (d.vec)
          store_out_vec<kPool>(acc, d, t, pg, m0, np, MB, x, b3, bd, out);
        else
          store_out<kPool>(acc, d, t, pg, m0, np, MB, x, b3, bd, out);
      }
    }
  }
}

template <bool kPool, int kMF1, int kNW1, int kMF3, int kNW3>
int bf16_launch(const void* x, const void* w1, const void* b1,
                const void* w2, const void* b2, const void* w3,
                const void* b3, const void* bd, void* out, const MmaDims& d,
                cudaStream_t s) {
  const int smem = mma_smem(d).total;
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_bf16_kernel<kPool, kMF1, kNW1, kMF3, kNW3>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((d.h + d.tile_rows - 1) / d.tile_rows,
            (d.n + d.images - 1) / d.images);
  bottleneck_bf16_kernel<kPool, kMF1, kNW1, kMF3, kNW3>
      <<<grid, kMmaThreads, smem, s>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (const bf16*)w3, (const float*)b3,
      (const float*)bd, (bf16*)out, d);
  return (int)cudaGetLastError();
}

template <bool kPool>
int bf16_dispatch(const void* x, const void* w1, const void* b1,
                  const void* w2, const void* b2, const void* w3,
                  const void* b3, const void* bd, void* out,
                  const MmaDims& d, cudaStream_t s) {
  if (d.n == 0 || d.h == 0 || d.w == 0) return (int)cudaGetLastError();
  const bool ok = d.cinp >= d.cin && d.cmidp >= d.cmid &&
                  d.coutp >= d.cout && d.cinp % 64 == 0 && d.cin > 0 &&
                  d.cmid > 0 && d.cout > 0 && wn_ok(d.wn1, d.cmidp) &&
                  wn_ok(d.wn3, d.coutp) && d.tile_rows >= 1 &&
                  d.tile_rows <= d.h && d.images >= 1 &&
                  (d.images == 1 || d.tile_rows == d.h) &&
                  (d.proj || d.cin == d.cout);
  // Kernel 5 pools its one x chunk once, before phase A: cin <= 64.
  if (!ok || (kPool && d.cinp != 64)) return (int)cudaErrorInvalidValue;
  if (d.wn1 == 4)
    return d.wn3 == 4
               ? bf16_launch<kPool, 2, 128, 2, 128>(x, w1, b1, w2, b2, w3, b3,
                                                    bd, out, d, s)
               : bf16_launch<kPool, 2, 128, 4, 64>(x, w1, b1, w2, b2, w3, b3,
                                                   bd, out, d, s);
  return d.wn3 == 4
             ? bf16_launch<kPool, 4, 64, 2, 128>(x, w1, b1, w2, b2, w3, b3,
                                                 bd, out, d, s)
             : bf16_launch<kPool, 4, 64, 4, 64>(x, w1, b1, w2, b2, w3, b3,
                                                bd, out, d, s);
}

}  // namespace

// f32: the FFMA kernel's shared memory per block.
extern "C" long long bottleneck_block_smem_bytes(int w, int cmid,
                                                 int tile_rows) {
  Dims d{0, 0, w, 0, cmid, 0, tile_rows};
  return (long long)smem_bytes(d);
}

// Kernel 2 in f32: one block of the stack. x [n, h*w, cin], out
// [n, h*w, cout]; w1 [cin, cmid], w2 [9, cmid, cmid], w3 [cmid, cout], wd
// [cin, cout]; biases f32. wd / bd may be null (identity residual, requires
// cin == cout).
extern "C" int bottleneck_block_launch(const void* x, const void* w1,
                                       const void* b1, const void* w2,
                                       const void* b2, const void* w3,
                                       const void* b3, const void* wd,
                                       const void* bd, void* out, int n, int h,
                                       int w, int cin, int cmid, int cout,
                                       int tile_rows, void* stream) {
  return launch<false>(x, w1, b1, w2, b2, w3, b3, wd, bd, out,
                       Dims{n, h, w, cin, cmid, cout, tile_rows},
                       (cudaStream_t)stream);
}

// Kernel 5 in f32: the stem max-pool and one block, from the pre-pool map x
// [n, 2h, 2w, cin]; h, w and tile_rows are of the pooled map.
extern "C" int pool_bottleneck_block_launch(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* w3, const void* b3, const void* wd,
    const void* bd, void* out, int n, int h, int w, int cin, int cmid,
    int cout, int tile_rows, void* stream) {
  return launch<true>(x, w1, b1, w2, b2, w3, b3, wd, bd, out,
                      Dims{n, h, w, cin, cmid, cout, tile_rows},
                      (cudaStream_t)stream);
}

// bf16: the shared memory of the tensor-core kernel's block.
extern "C" long long bottleneck_block_bf16_smem_bytes(
    int h, int w, int cin, int cmid, int cout, int cinp, int cmidp,
    int coutp, int tile_rows, int images, int wn1, int wn3) {
  MmaDims d{0, h, w, cin, cmid, cout, cinp, cmidp, coutp,
            tile_rows, images, wn1, wn3, 0, 0, 512};
  return (long long)mma_smem(d).total;
}

// Kernel 2 in bf16: x [n, h*w, cin], out [n, h*w, cout]; weights relaid out
// as bottleneck_bf16_kernel reads them (ops/bottleneck.py
// _bottleneck_mma_weights); b1, b2, b3, bd f32; bd null without projection.
extern "C" int bottleneck_block_bf16_launch(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* w3, const void* b3, const void* bd,
    void* out, int n, int h, int w, int cin, int cmid, int cout, int cinp,
    int cmidp, int coutp, int tile_rows, int images, int wn1, int wn3,
    int proj, int vec, void* stream) {
  MmaDims d{n, h, w, cin, cmid, cout, cinp, cmidp, coutp,
            tile_rows, images, wn1, wn3, proj, vec, 512};
  return bf16_dispatch<false>(x, w1, b1, w2, b2, w3, b3, bd, out, d,
                              (cudaStream_t)stream);
}

// Kernel 5 in bf16: as kernel 2, from the pre-pool map x [n, 2h, 2w, cin];
// h, w, tile_rows are of the pooled map.
extern "C" int pool_bottleneck_block_bf16_launch(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* w3, const void* b3, const void* bd,
    void* out, int n, int h, int w, int cin, int cmid, int cout, int cinp,
    int cmidp, int coutp, int tile_rows, int images, int wn1, int wn3,
    int proj, int vec, void* stream) {
  MmaDims d{n, h, w, cin, cmid, cout, cinp, cmidp, coutp,
            tile_rows, images, wn1, wn3, proj, vec, 512};
  return bf16_dispatch<true>(x, w1, b1, w2, b2, w3, b3, bd, out, d,
                             (cudaStream_t)stream);
}
