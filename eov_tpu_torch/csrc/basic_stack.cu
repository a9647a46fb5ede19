// One stride-1 ResNet basic block, fused (kernel 4): conv1 3x3 -> bias,
// ReLU -> conv2 3x3 -> bias + residual, ReLU, with the folded BatchNorm
// biases; C channels in and out. The wrapper (ops/bottleneck.py
// fused_basic_stack) launches it once per block of the stack.
//
// Replaces the Pallas TPU kernel eov_tpu/ops/pallas_bottleneck.py
// fused_basic_stack (_basic_stack_kernel / _run_basic_chain), which keeps a
// whole map per image in VMEM and runs each 3x3 as nine shifted matmuls
// over one padded scratch with column masks.
//
// Bound on the H100: operations. Each 3x3 at ResNet-34's shapes is
// 2*H*W*9*C^2 = 231.2 MFLOP per image (every stage alike) against
// 2*H*W*C*2 B of input and output; at 256 images in bf16 the 26 convs of
// stage 1 and the stride-1 tails of stages 2-4 take 1.556 ms at the dense
// bf16 tensor-core peak. So the bf16 kernel runs its products on the
// tensor cores (wgmma) and keeps y1 and the tiles it multiplies on chip:
//
// - One thread block (two warpgroups) owns TR output rows of one image, or
//   G whole images of a small map (7^2: 2 images, 98 rows of a 128-row M
//   tile instead of 49 of 64). Phase A computes y1 = relu(conv3x3(x) + b1),
//   rounded to bf16, over those rows and the one-row halo above and below
//   (recomputed per block) into shared memory, all C channels; phase B
//   computes out = relu((conv3x3(y1) + b2) + x) (f32 sum, one rounding)
//   from it. y1 never reaches device memory.
// - Each 3x3 is an implicit GEMM: M = pixels, N = output channels, K =
//   64-channel chunks (outer) x 9 taps (inner) x 4 k16 steps. Phase A
//   stages each chunk's x halo [rows + 2][W][64] once by cp.async and all
//   nine taps read it. A comes to registers by ldmatrix through per-row
//   addresses: each lane's pixel -> (image, row, column) is divided out
//   once per M pass; a tap adds dy*W + dx and sends a row outside the
//   image to a zero line, which is the convolution's zero padding. So the
//   raster wrap and the widths 7, 14 and 28 (no multiple of 8) cost
//   nothing, and no integer division runs per element.
// - B, the weights, is read by wgmma from shared memory through a
//   descriptor (K-major, 128-byte swizzle). The wrapper relays them out
//   once into [C/NT][C/64][9][NT][64] (zero-padded), so each step's
//   NT x 64 tile is contiguous; it reaches a 3-deep ring by cp.async while
//   the tensor cores work on the step before (one barrier per step). A
//   weight tile feeds every pixel of the block: 504 / 252 / 126 / 98 rows
//   at 56^2 / 28^2 / 14^2 / 7^2 in phase A.
// - Products: wgmma.mma_async m64n64k16 (C 64, 128: each warpgroup 4 m64
//   tiles x 64 channels) or m64n128k16 (C 256, 512: 2 x 128), bf16 with f32
//   sums in registers. The x and y1 tiles are XOR-swizzled by 16-byte line,
//   so ldmatrix and the y1 stores are free of bank conflicts.
// - Tiles: the wrapper (ops/bottleneck.py basic_tile_plan) takes the most
//   rows whose y1 rows fill one M pass (TR = 7 at every ResNet-34 stack)
//   within the 227 KB of shared memory, and G images when a whole map fits.
//
// f32 keeps the FFMA kernel below (block_gemm of tile_gemm.cuh): TF32
// would not meet the f32 bar of 1e-4.
//
// Rounding follows _run_basic_chain: f32 sums; y1 rounded to T after
// bias+ReLU; a2 + b2 + x summed in f32, then ReLU and one rounding. The
// unfused forward (models/folded_infer.py) adds the residual in T instead.

#include "mma_tile.cuh"
#include "tile_gemm.cuh"

// f32: one thread block owns TR output rows of one image through one
// block: phase A writes y1 with its recomputed halo rows (halo rows outside
// the image are skipped, left zero) into shared memory with a zero column
// at each edge, its A operand reading the nine taps of x from device
// memory; phase B reads y1 there. The GEMM streams 16-deep K-chunks of the
// weights through shared memory (block_gemm, shared with kernel 2). The
// wrapper picks the most rows that keep the tile within 512 output pixels
// and two blocks per SM, then evens the tiles out.

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


// ------------------------------------------------ bf16 on the tensor cores

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 256;  // two warpgroups
constexpr int kStages = 3;        // weight tiles in flight
constexpr int kZeroBytes = 128;   // the zero line padding reads point at

struct MmaDims {
  int n, h, w, c;
  int cp;          // c rounded up to 64: the K chunks and y1's pitch
  int tile_rows;   // TR output rows per block (h when images > 1)
  int images;      // G images per block
  int wn;          // NT = 64 wn output channels a pass (wn 1, 2 or 4)
  int vec;         // c % 8 == 0 and 16-byte aligned x, out: vector paths
};

struct MmaSmem {
  int ring;   // one weight tile [NT][64] bf16
  int xbuf;   // one x chunk [G][min(TR+4, h)][w][64] bf16
  int nxbuf;  // 2 when there is a next chunk to stage
  int y1;     // y1 [G][min(TR+2, h)][w][cp] bf16
  int total;
};

__host__ __device__ inline MmaSmem mma_smem(const MmaDims& d) {
  MmaSmem s;
  s.ring = 64 * 64 * d.wn * 2;
  s.xbuf = d.images * imin(d.tile_rows + 4, d.h) * d.w * 128;
  s.nxbuf = d.cp > 64 ? 2 : 1;
  s.y1 = d.images * imin(d.tile_rows + 2, d.h) * d.w * d.cp * 2;
  s.total = kZeroBytes + kStages * s.ring + s.nxbuf * s.xbuf + s.y1;
  return s;
}

// The rows and images of one thread block.
struct Tile {
  int g0, gcount;  // images [g0, g0 + gcount)
  int r0, rows;    // output rows [r0, r0 + rows)
  int lo, hi;      // y1 rows computed: [lo, hi)
  int xlo, xhi;    // x rows staged: [xlo, xhi)
  int xrows, yrows;  // rows per image in the x and y1 buffers
};

// Shared-memory addresses of the block's buffers.
struct Bufs {
  uint32_t zero, ring, x, y1;
  MmaSmem L;
};

// The weight ring first (1024-byte aligned), then the zero line, the x
// chunks and y1.
__device__ __forceinline__ Bufs make_bufs(unsigned char* smem,
                                          const MmaDims& d) {
  Bufs sb;
  sb.L = mma_smem(d);
  sb.ring = smem_u32(smem);
  sb.zero = sb.ring + kStages * sb.L.ring;
  sb.x = sb.zero + kZeroBytes;
  sb.y1 = sb.x + sb.L.nxbuf * sb.L.xbuf;
  return sb;
}

__device__ __forceinline__ Tile make_tile(const MmaDims& d) {
  Tile t;
  t.g0 = blockIdx.y * d.images;
  t.gcount = imin(d.images, d.n - t.g0);
  t.r0 = blockIdx.x * d.tile_rows;
  t.rows = imin(d.tile_rows, d.h - t.r0);
  t.lo = imax(t.r0 - 1, 0);
  t.hi = imin(t.r0 + t.rows + 1, d.h);
  t.xlo = imax(t.lo - 1, 0);
  t.xhi = imin(t.hi + 1, d.h);
  t.xrows = imin(d.tile_rows + 4, d.h);
  t.yrows = imin(d.tile_rows + 2, d.h);
  return t;
}

// x staging cursor: pixel tid/8 as (image, buffer row, column), and the
// rows and columns of a 32-pixel step (divided once here).
__device__ __forceinline__ void stage_cursor(const MmaDims& d, const Tile& t,
                                             int (&cur)[5]) {
  const int p = threadIdx.x >> 3, q = p / d.w;
  cur[2] = p - q * d.w;
  cur[0] = q / t.xrows;
  cur[1] = q - cur[0] * t.xrows;
  cur[3] = (kMmaThreads / 8) / d.w;
  cur[4] = (kMmaThreads / 8) - cur[3] * d.w;
}

// Offset in elements of channel n of pixel pix in a swizzled buffer of
// pitch cp: the 16-byte line (n/8)%8 is XORed with pix%8.
__device__ __forceinline__ int swz(int pix, int cp, int n) {
  return pix * cp + (n & ~63) + ((((n >> 3) & 7) ^ (pix & 7)) << 3) + (n & 7);
}

// Stage 64 channels [c0, c0 + 64) of the block's x rows into xb, pixel by
// pixel in (image, row, column) order; channels >= c are zero. The
// thread's cursor (g, xr, col) walks 32 pixels a step without division.
__device__ __forceinline__ void stage_x(const MmaDims& d, const Tile& t,
                                        const bf16* __restrict__ x, int c0,
                                        uint32_t xb, int g, int xr, int col,
                                        int dq, int dr) {
  const int seg = threadIdx.x & 7;
  const int cb = c0 + seg * 8;
  const int npix = t.gcount * t.xrows * d.w;
  for (int sp = threadIdx.x >> 3; sp < npix; sp += kMmaThreads / 8) {
    const int row = t.xlo + xr;
    if (row < t.xhi) {
      const uint32_t dst = xb + sp * 128 + ((seg ^ (sp & 7)) << 4);
      const size_t pix = ((size_t)(t.g0 + g) * d.h + row) * d.w + col;
      const bf16* src = x + pix * d.c + cb;
      if (d.vec) {
        if (cb < d.c)
          cp_async16(dst, src);
        else
          st_shared_v4(dst, 0, 0, 0, 0);
      } else {
        const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
        uint32_t v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t a = cb + 2 * j < d.c ? s[2 * j] : 0u;
          const uint32_t b = cb + 2 * j + 1 < d.c ? s[2 * j + 1] : 0u;
          v[j] = a | (b << 16);
        }
        st_shared_v4(dst, v[0], v[1], v[2], v[3]);
      }
    }
    col += dr;
    xr += dq;
    if (col >= d.w) {
      col -= d.w;
      ++xr;
    }
    while (xr >= t.xrows) {
      xr -= t.xrows;
      ++g;
    }
  }
}

template <int kNW>
__device__ __forceinline__ void wgmma_tile(float (&d)[kNW / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_tile<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  wgmma_m64n64(d, a, desc);
}
template <>
__device__ __forceinline__ void wgmma_tile<128>(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  wgmma_m64n128(d, a, desc);
}

// acc = one M pass [m0, m0 + MT) x N pass np of one 3x3 conv: phase A (kB
// false) reads the staged x chunks, phase B the y1 buffer. M counts the
// pass's pixels: (image, row in [row0, row0 + R), column) in raster order.
// Warpgroup wg owns kMF m64 tiles x kNW channels: the two warpgroups split
// the pass's NT channels when NT > kNW, else its MT = 2 kMF 64 pixels. A
// comes by ldmatrix from the x or y1 tile, B is the ring's [NT][64]
// K-major swizzled weight tile; one wgmma per m64 tile and k16 step.
template <bool kB, int kMF, int kNW>
__device__ __forceinline__ void conv_pass(
    float (&acc)[kMF][kNW / 2], int& ntile, const MmaDims& d, const Tile& t,
    const Bufs& sb, const bf16* __restrict__ x, const bf16* __restrict__ wt,
    int m0, int np, int M, const int (&cur)[5]) {
  const int W = d.w, H = d.h;
  const int NT = 64 * d.wn;
  const int nchunks = d.cp >> 6;
  const int nsteps = nchunks * 9;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const bool wg_along_n = NT > kNW;
  const int wg_m = wg_along_n ? 0 : wg, wg_n = wg_along_n ? wg : 0;
  const int base0 = m0 + wg_m * kMF * 64;
  ntile = M - base0 <= 0 ? 0 : imin(kMF, (M - base0 + 63) >> 6);

  const int row0 = kB ? t.r0 : t.lo;
  const int R = kB ? t.rows : t.hi - t.lo;
  const int brow0 = kB ? t.lo : t.xlo;
  const int brows = kB ? t.yrows : t.xrows;
  int fr[kMF], fc[kMF], fb[kMF];
#pragma unroll
  for (int f = 0; f < kMF; ++f) {
    const int p = base0 + f * 64 + wq * 16 + (lane & 15);
    fr[f] = -2;
    fc[f] = 0;
    fb[f] = 0;
    if (p < M) {
      const int q = p / W, col = p - q * W;
      const int g = q / R, r = row0 + (q - g * R);
      fr[f] = r;
      fc[f] = col;
      fb[f] = (g * brows + r - brow0) * W + col;
    }
  }
#pragma unroll
  for (int f = 0; f < kMF; ++f)
#pragma unroll
    for (int e = 0; e < kNW / 2; ++e) acc[f][e] = 0.f;

  __syncthreads();

  const bf16* wpass = wt + (size_t)np * nchunks * 9 * 64 * NT;
  auto load = [&](int s, int ch, int tap) {
    const uint32_t dst = sb.ring + (s % kStages) * sb.L.ring;
    const bf16* src = wpass + (size_t)(ch * 9 + tap) * 64 * NT;
    for (int i = threadIdx.x; i < 8 * NT; i += kMmaThreads) {
      const int n = i >> 3, kc = i & 7;
      cp_async16(dst + n * 128 + ((kc ^ (n & 7)) << 4), src + i * 8);
    }
    if (!kB && tap == 0)
      stage_x(d, t, x, ch * 64, sb.x + (ch & (sb.L.nxbuf - 1)) * sb.L.xbuf,
              cur[0], cur[1], cur[2], cur[3], cur[4]);
  };

  int lch = 0, ltap = 0;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) load(s, lch, ltap);
    cp_async_commit();
    if (++ltap == 9) ltap = 0, ++lch;
  }

  const int khalf = lane >> 4;
  int ch = 0, ky = 0, kx = 0;
  for (int s = 0; s < nsteps; ++s) {
    // Step s's tiles have landed (this thread's copies, made visible to
    // wgmma's proxy, then everyone's); step s - 1's slot is free.
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    if (s + kStages - 1 < nsteps) load(s + kStages - 1, lch, ltap);
    cp_async_commit();
    if (++ltap == 9) ltap = 0, ++lch;

    {
      const int dy = ky - 1, dx = kx - 1;
      const uint32_t abuf =
          kB ? sb.y1 + ch * 128 : sb.x + (ch & (sb.L.nxbuf - 1)) * sb.L.xbuf;
      const int pitch = kB ? d.cp * 2 : 128;
      uint32_t aaddr[kMF];
      int akey[kMF];
#pragma unroll
      for (int f = 0; f < kMF; ++f) {
        const bool ok = (unsigned)(fr[f] + dy) < (unsigned)H &&
                        (unsigned)(fc[f] + dx) < (unsigned)W;
        const int pix = fb[f] + dy * W + dx;
        aaddr[f] = ok ? abuf + pix * pitch : sb.zero;
        akey[f] = ok ? (pix & 7) : 0;
      }
      const uint32_t bslot =
          sb.ring + (s % kStages) * sb.L.ring + wg_n * kNW * 128;
      // The next k16 step's A fragments load while this step's products
      // run (one group in flight); all have finished when the step ends,
      // so the ring slot can be refilled after the next barrier. Every m64
      // tile is multiplied, also one past M (its rows read the zero line):
      // a branch around wgmma makes ptxas serialize all of them.
      uint32_t a[2][kMF][4];
#pragma unroll
      for (int f = 0; f < kMF; ++f)
        ldsm_x4(a[0][f], aaddr[f] + ((khalf ^ akey[f]) << 4));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wg_fence();
#pragma unroll
        for (int f = 0; f < kMF; ++f)
          wgmma_tile<kNW>(acc[f], a[kk & 1][f], sw128_desc(bslot + kk * 32));
        wg_commit();
        if (kk < 3) {
          wg_wait1();  // step kk - 1 done: its A registers take kk + 1's
#pragma unroll
          for (int f = 0; f < kMF; ++f)
            ldsm_x4(a[(kk + 1) & 1][f],
                    aaddr[f] + (((((kk + 1) << 1) + khalf) ^ akey[f]) << 4));
        }
      }
      wg_wait0();
    }
    if (++kx == 3) {
      kx = 0;
      if (++ky == 3) ky = 0, ++ch;
    }
  }
  cp_async_wait<0>();
}

template <int kMF, int kNW>
__global__ void __launch_bounds__(kMmaThreads, 1)
basic_block_bf16_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ w1,
                        const float* __restrict__ b1,
                        const bf16* __restrict__ w2,
                        const float* __restrict__ b2, bf16* __restrict__ out,
                        MmaDims d) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int H = d.h, W = d.w, C = d.c;
  const Bufs sb = make_bufs(smem, d);
  const Tile t = make_tile(d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < kZeroBytes / 16) st_shared_v4(sb.zero + tid * 16, 0, 0, 0, 0);
  int cur[5];
  stage_cursor(d, t, cur);

  const int NT = 64 * d.wn;
  const int npass = (d.cp >> 6) / d.wn;
  const int wg = warp >> 2, wq = warp & 3;
  const bool wg_along_n = NT > kNW;
  const int wg_m = wg_along_n ? 0 : wg, wg_n = wg_along_n ? wg : 0;
  const int MT = (wg_along_n ? 1 : 2) * kMF * 64;
  float acc[kMF][kNW / 2];
  int ntile;

  const int RA = t.hi - t.lo;
  const int MA = t.gcount * RA * W;
  for (int m0 = 0; m0 < MA; m0 += MT) {
    for (int np = 0; np < npass; ++np) {
      conv_pass<false, kMF, kNW>(acc, ntile, d, t, sb, x, w1, m0, np, MA,
                                 cur);
#pragma unroll
      for (int f = 0; f < kMF; ++f) {
        if (f >= ntile) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = m0 + wg_m * kMF * 64 + f * 64 + wq * 16 + (lane >> 2) +
                        half * 8;
          if (m >= MA) continue;
          const int q = m / W, col = m - q * W;
          const int g = q / RA, yr = q - g * RA;
          const int ypix = (g * t.yrows + yr) * W + col;
#pragma unroll
          for (int j = 0; j < kNW / 8; ++j) {
            const int n = np * NT + wg_n * kNW + j * 8 + 2 * (lane & 3);
            const float v0 =
                n < C ? fmaxf(acc[f][4 * j + 2 * half] + b1[n], 0.f) : 0.f;
            const float v1 =
                n + 1 < C ? fmaxf(acc[f][4 * j + 2 * half + 1] + b1[n + 1], 0.f)
                          : 0.f;
            st_shared_b32(sb.y1 + 2 * swz(ypix, d.cp, n), pack_bf16x2(v0, v1));
          }
        }
      }
    }
  }

  const int MB = t.gcount * t.rows * W;
  for (int m0 = 0; m0 < MB; m0 += MT) {
    for (int np = 0; np < npass; ++np) {
      conv_pass<true, kMF, kNW>(acc, ntile, d, t, sb, x, w2, m0, np, MB,
                                cur);
#pragma unroll
      for (int f = 0; f < kMF; ++f) {
        if (f >= ntile) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = m0 + wg_m * kMF * 64 + f * 64 + wq * 16 + (lane >> 2) +
                        half * 8;
          if (m >= MB) continue;
          const int q = m / W, col = m - q * W;
          const int g = q / t.rows, orow = q - g * t.rows;
          const size_t o =
              (((size_t)(t.g0 + g) * H + t.r0 + orow) * W + col) * C;
#pragma unroll
          for (int j = 0; j < kNW / 8; ++j) {
            const int n = np * NT + wg_n * kNW + j * 8 + 2 * (lane & 3);
            if (n >= C) continue;
            const float a0 = acc[f][4 * j + 2 * half] + b2[n];
            const float a1 =
                n + 1 < C ? acc[f][4 * j + 2 * half + 1] + b2[n + 1] : 0.f;
            if (d.vec) {  // n + 1 < C
              const float2 r = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(x + o + n));
              *reinterpret_cast<__nv_bfloat162*>(out + o + n) =
                  __floats2bfloat162_rn(fmaxf(a0 + r.x, 0.f),
                                        fmaxf(a1 + r.y, 0.f));
            } else {
              out[o + n] = __float2bfloat16_rn(
                  fmaxf(a0 + __bfloat162float(x[o + n]), 0.f));
              if (n + 1 < C)
                out[o + n + 1] = __float2bfloat16_rn(
                    fmaxf(a1 + __bfloat162float(x[o + n + 1]), 0.f));
            }
          }
        }
      }
    }
  }
}

template <int kMF, int kNW>
int bf16_launch(const void* x, const void* w1, const void* b1,
                const void* w2, const void* b2, void* out, const MmaDims& d,
                cudaStream_t s) {
  const int smem = mma_smem(d).total;
  cudaError_t err = cudaFuncSetAttribute(
      basic_block_bf16_kernel<kMF, kNW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((d.h + d.tile_rows - 1) / d.tile_rows,
            (d.n + d.images - 1) / d.images);
  basic_block_bf16_kernel<kMF, kNW><<<grid, kMmaThreads, smem, s>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (bf16*)out, d);
  return (int)cudaGetLastError();
}

int mma_check(const MmaDims& d) {
  const bool ok = (d.wn == 1 || d.wn == 2 || d.wn == 4) && d.cp % 64 == 0 &&
                  d.cp >= d.c && d.cp % (64 * d.wn) == 0 &&
                  d.tile_rows >= 1 && d.tile_rows <= d.h && d.images >= 1 &&
                  (d.images == 1 || d.tile_rows == d.h);
  return ok ? 0 : (int)cudaErrorInvalidValue;
}
}  // namespace

// f32 only: the FFMA kernel's shared memory per block.
extern "C" long long basic_block_smem_bytes(int w, int c, int tile_rows) {
  Dims d{0, 0, w, c, tile_rows};
  return (long long)smem_bytes<float>(d);
}

// f32: x, out [n, h*w, c]; w1, w2 [9, c, c] tap-major; b1, b2 [c].
extern "C" int basic_block_launch(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, int n, int h,
                                  int w, int c, int tile_rows, void* stream) {
  if (n == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
  Dims d{n, h, w, c, tile_rows};
  return launch<float>(x, w1, b1, w2, b2, out, d, (cudaStream_t)stream);
}

// bf16: the shared memory of the tensor-core kernel's block.
extern "C" long long basic_block_bf16_smem_bytes(int h, int w, int c, int cp,
                                                 int tile_rows, int images,
                                                 int wn) {
  MmaDims d{0, h, w, c, cp, tile_rows, images, wn, 0};
  return (long long)mma_smem(d).total;
}

// bf16: x, out [n, h*w, c]; w1, w2 relaid out as [cp/NT][cp/64][9][NT][64]
// (NT = 64 wn; zero-padded to cp = c rounded up to 64); b1, b2 [c] f32.
extern "C" int basic_block_bf16_launch(const void* x, const void* w1,
                                       const void* b1, const void* w2,
                                       const void* b2, void* out, int n,
                                       int h, int w, int c, int cp,
                                       int tile_rows, int images, int wn,
                                       int vec, void* stream) {
  if (n == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
  MmaDims d{n, h, w, c, cp, tile_rows, images, wn, vec};
  if (int err = mma_check(d)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (wn == 4) return bf16_launch<2, 128>(x, w1, b1, w2, b2, out, d, s);
  return bf16_launch<4, 64>(x, w1, b1, w2, b2, out, d, s);
}
