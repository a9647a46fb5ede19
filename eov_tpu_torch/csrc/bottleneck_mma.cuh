// The tensor-core pass of the fused bottleneck kernels (sm_90a), shared by
// kernels 2 and 5 (bottleneck_stack.cu) and by the train stack's forward
// and input-gradient kernels (bottleneck_train.cu): the block's tile of
// rows and images, the shared-memory layout (weight ring, staged input
// chunks, y1 with its halo, y2), the staging of the input chunks, and
// mma_pass, one M x N pass of conv1, the 3x3 conv2, conv3 or a separate
// projection as wgmma products over mma_tile.cuh. The epilogues are the
// kernels' own. See bottleneck_stack.cu for the design.
#pragma once

#include <type_traits>

#include "mma_tile.cuh"
#include "tile_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 256;  // two warpgroups
constexpr int kStages = 3;        // weight tiles in flight
constexpr int kZeroBytes = 128;   // the zero line padding reads point at

struct MmaDims {
  int n, h, w, cin, cmid, cout;
  int cinp, cmidp, coutp;  // channels rounded up to 64
  int tile_rows;           // TR output rows per block (h when images > 1)
  int images;              // G images per block
  int wn1;                 // N pass of conv1 and conv2: 64 wn1 channels
  int wn3;                 // N pass of conv3: 64 wn3 channels
  int proj;                // projection shortcut (wd, bd)
  int vec;                 // cin, cout % 8 == 0, x 16-byte aligned
  int mrows;               // M pass of 64-channel passes: 512 (the block's
                           // 8 warps x 64 rows), or 256 with kPromote
};

struct MmaSmem {
  int ring;     // one weight tile [64 max(wn1, wn3)][64] bf16
  int xbuf;     // one x chunk [G][min(TR+2, h)][w][64] bf16
  int nxbuf;    // two chunks taking turns when cin > 64, else the one
  int y1;       // y1 [G][min(TR+2, h)][w][cmidp] bf16
  int overlay;  // y2 in y1's place: phase B is one M pass, one N pass
  int y2;       // y2 [G * TR * w][cmidp] bf16, unless overlaid
  int total;
};

__host__ __device__ inline MmaSmem mma_smem(const MmaDims& d) {
  MmaSmem s;
  const int yrows = imin(d.tile_rows + 2, d.h);
  s.ring = 64 * 64 * 2 * imax(d.wn1, d.wn3);
  s.xbuf = d.images * yrows * d.w * 128;
  s.nxbuf = d.cinp > 64 ? 2 : 1;
  s.y1 = d.images * yrows * d.w * d.cmidp * 2;
  s.overlay = d.cmidp == 64 * d.wn1 &&
              d.images * d.tile_rows * d.w <= d.mrows / d.wn1;
  s.y2 = s.overlay ? 0 : d.images * d.tile_rows * d.w * d.cmidp * 2;
  s.total = kZeroBytes + kStages * s.ring + s.nxbuf * s.xbuf + s.y1 + s.y2;
  return s;
}

// The rows and images of one thread block.
struct Tile {
  int g0, gcount;  // images [g0, g0 + gcount)
  int r0, rows;    // output rows [r0, r0 + rows)
  int lo, hi;      // y1 rows computed and x rows staged: [lo, hi)
  int yrows;       // rows per image in the x and y1 buffers
};

struct Bufs {
  uint32_t ring, zero, x, y1, y2;
  MmaSmem L;
};

// The weight ring first (1024-byte aligned), then the zero line, the x
// chunks, y1 and y2.
__device__ __forceinline__ Bufs make_bufs(unsigned char* smem,
                                          const MmaDims& d) {
  Bufs sb;
  sb.L = mma_smem(d);
  sb.ring = smem_u32(smem);
  sb.zero = sb.ring + kStages * sb.L.ring;
  sb.x = sb.zero + kZeroBytes;
  sb.y1 = sb.x + sb.L.nxbuf * sb.L.xbuf;
  sb.y2 = sb.L.overlay ? sb.y1 : sb.y1 + sb.L.y1;
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
  t.yrows = imin(d.tile_rows + 2, d.h);
  return t;
}

// x staging cursor: pixel tid/8 as (image, buffer row, column), and the
// rows and columns of a 32-pixel step (divided once here).
__device__ __forceinline__ void stage_cursor(const MmaDims& d, const Tile& t,
                                             int (&cur)[5]) {
  const int p = threadIdx.x >> 3, q = p / d.w;
  cur[2] = p - q * d.w;
  cur[0] = q / t.yrows;
  cur[1] = q - cur[0] * t.yrows;
  cur[3] = (kMmaThreads / 8) / d.w;
  cur[4] = (kMmaThreads / 8) - cur[3] * d.w;
}

// Stage channels [c0, c0 + 64) of the block input at rows [lo, hi) of each
// of the block's images into xb: pixel (g, r, col) at buffer pixel
// (g yrows + r - lo) w + col, its 16-byte line s at s ^ (pixel % 8);
// channels >= cin are zero. kPool: the input is the 3x3/s2 max-pool of the
// pre-pool map x [n, 2h, 2w, cin], built here channel by channel (any
// cin; stage_pool is the vector form). The thread's cursor (g, xr, col)
// walks 32 pixels a step without division.
template <bool kPool>
__device__ __forceinline__ void stage_x(const MmaDims& d, const Tile& t,
                                        const bf16* __restrict__ x, int c0,
                                        uint32_t xb, int g, int xr, int col,
                                        int dq, int dr) {
  const int seg = threadIdx.x & 7;
  const int cb = c0 + seg * 8;
  const int npix = t.gcount * t.yrows * d.w;
  for (int sp = threadIdx.x >> 3; sp < npix; sp += kMmaThreads / 8) {
    const int row = t.lo + xr;
    if (row < t.hi) {
      const uint32_t dst = xb + sp * 128 + ((seg ^ (sp & 7)) << 4);
      if (cb >= d.cin) {
        st_shared_v4(dst, 0, 0, 0, 0);
      } else if (kPool) {
        const bf16* img = x + (size_t)(t.g0 + g) * 4 * d.h * d.w * d.cin;
        float m[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          m[j] = cb + j < d.cin
                     ? pool3x3s2_at(img, 2 * d.w, d.cin, row, col, cb + j)
                     : 0.f;
        st_shared_v4(dst, pack_bf16x2(m[0], m[1]), pack_bf16x2(m[2], m[3]),
                     pack_bf16x2(m[4], m[5]), pack_bf16x2(m[6], m[7]));
      } else {
        const size_t pix = ((size_t)(t.g0 + g) * d.h + row) * d.w + col;
        const bf16* src = x + pix * d.cin + cb;
        if (d.vec) {
          cp_async16(dst, src);
        } else {
          const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
          uint32_t v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t a = cb + 2 * j < d.cin ? s[2 * j] : 0u;
            const uint32_t b = cb + 2 * j + 1 < d.cin ? s[2 * j + 1] : 0u;
            v[j] = a | (b << 16);
          }
          st_shared_v4(dst, v[0], v[1], v[2], v[3]);
        }
      }
    }
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
}

// stage_x for an f32 input (the train stack's block input x, cin % 8 == 0,
// 16-byte aligned): each 8-channel line is loaded as two float4 and
// rounded to bf16 (round to nearest even, as x.to(bfloat16)) on its way
// into the chunk, so the products read T(x) while x stays f32 in memory.
__device__ __forceinline__ void stage_x_f32(const MmaDims& d, const Tile& t,
                                            const float* __restrict__ x,
                                            int c0, uint32_t xb, int g,
                                            int xr, int col, int dq, int dr) {
  const int seg = threadIdx.x & 7;
  const int cb = c0 + seg * 8;
  const int npix = t.gcount * t.yrows * d.w;
  for (int sp = threadIdx.x >> 3; sp < npix; sp += kMmaThreads / 8) {
    const int row = t.lo + xr;
    if (row < t.hi) {
      const uint32_t dst = xb + sp * 128 + ((seg ^ (sp & 7)) << 4);
      if (cb >= d.cin) {
        st_shared_v4(dst, 0, 0, 0, 0);
      } else {
        const size_t pix = ((size_t)(t.g0 + g) * d.h + row) * d.w + col;
        const float4* src =
            reinterpret_cast<const float4*>(x + pix * d.cin + cb);
        const float4 a = __ldg(src), b = __ldg(src + 1);
        st_shared_v4(dst, pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w),
                     pack_bf16x2(b.x, b.y), pack_bf16x2(b.z, b.w));
      }
    }
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
}

// kProj: the projection x wd on its own (the train forward rounds it to T
// apart from conv3), over the output rows, K = the x chunks, N passes of
// conv3's width.
enum Phase { kConv1, kConv2, kConv3, kProj };

// acc = one M pass [m0, m0 + MT) x N pass np of one phase. M counts the
// phase's pixels in (image, row, column) order: rows [lo, hi) for conv1,
// the output rows for conv2, conv3 and kProj. K steps: conv1 the x chunks;
// conv2 y1's chunks x 9 taps; conv3 y2's chunks, then (projection) the x
// chunks; kProj the x chunks. XT: the input's type in memory (bf16, or
// f32 rounded as it is staged).
// Warpgroup wg owns kMF m64 tiles x kNW channels: the two warpgroups split
// the pass's NT channels when NT > kNW, else its MT = 2 kMF 64 pixels. A
// comes by ldmatrix from the x, y1 or y2 tile, B is the ring's [NT][64]
// K-major swizzled weight tile; one wgmma per m64 tile and k16 step.
// ``stage``: the x chunks are staged by the step loads (else resident;
// kernel 5's pooled input always is). The ring slot of step s is
// (gs + s) % kStages, gs counting the block's steps so far (advanced
// here). ``wnext`` (nt_next channels), when not null, is the next pass's
// first weight tile: loaded at the end of this pass, so that its latency
// hides behind this pass's epilogue; the next pass is then called with
// ``prefetched`` (and must stage no x at its first step).
template <Phase kPh>
__device__ __forceinline__ int phase_steps(const MmaDims& d) {
  const int kmid = d.cmidp >> 6, kin = d.cinp >> 6;
  return kPh == kConv1 || kPh == kProj ? kin
         : kPh == kConv2                 ? kmid * 9
                                         : kmid + (d.proj ? kin : 0);
}

__device__ __forceinline__ void load_tile(const Bufs& sb, int slot,
                                          const bf16* __restrict__ src,
                                          int nt) {
  const uint32_t dst = sb.ring + slot * sb.L.ring;
  for (int i = threadIdx.x; i < 8 * nt; i += kMmaThreads) {
    const int n = i >> 3, kc = i & 7;
    cp_async16(dst + n * 128 + ((kc ^ (n & 7)) << 4), src + i * 8);
  }
}

template <Phase kPh, int kMF, int kNW, typename XT = bf16,
          bool kPromote = false>
__device__ __forceinline__ void mma_pass(
    float (&acc)[kMF][kNW / 2], const MmaDims& d, const Tile& t,
    const Bufs& sb, const XT* __restrict__ x, const bf16* __restrict__ wt,
    int m0, int np, int M, bool stage, const int (&cur)[5], int& gs,
    bool prefetched, const bf16* wnext, int nt_next) {
  const int W = d.w, H = d.h;
  const int NT = 64 * (kPh == kConv3 || kPh == kProj ? d.wn3 : d.wn1);
  const int kmid = d.cmidp >> 6, kin = d.cinp >> 6;
  // x chunks: steps [xs0, xs0 + kx) read chunk s - xs0 of x.
  const int xs0 = kPh == kConv3 ? kmid : 0;
  const int kx =
      kPh == kConv1 || kPh == kProj || (kPh == kConv3 && d.proj) ? kin : 0;
  const int nsteps = phase_steps<kPh>(d);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const bool wg_along_n = NT > kNW;
  const int wg_m = wg_along_n ? 0 : wg, wg_n = wg_along_n ? wg : 0;
  const int base0 = m0 + wg_m * kMF * 64;

  // Row p of the A fragments: image row fr (-2 past M), column fc, pixel
  // fb in the x / y1 buffers; p itself is y2's pixel.
  const int row0 = kPh == kConv1 ? t.lo : t.r0;
  const int R = kPh == kConv1 ? t.hi - t.lo : t.rows;
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
      fb[f] = (g * t.yrows + r - t.lo) * W + col;
    }
  }
#pragma unroll
  for (int f = 0; f < kMF; ++f)
#pragma unroll
    for (int e = 0; e < kNW / 2; ++e) acc[f][e] = 0.f;
  // kPromote: each k16 product starts a fresh sum (part), added to acc in
  // f32 (round to nearest) once it finishes. wgmma's running sums are not
  // those of an IEEE f32 add: along a long K loop they rounded several
  // times as many bf16 values off the float64 chain as f32 FFMA sums do
  // (chip_smoke.py counts them: bf16_flips_vs_f64).
  float part[kPromote ? kMF : 1][kPromote ? kNW / 2 : 1];
#pragma unroll
  for (int f = 0; f < (kPromote ? kMF : 1); ++f)
#pragma unroll
    for (int e = 0; e < (kPromote ? kNW / 2 : 1); ++e) part[f][e] = 0.f;

  __syncthreads();

  const bf16* wpass = wt + (size_t)np * nsteps * 64 * NT;
  // Step s's weight tile, kStages - 1 steps ahead.
  auto load_w = [&](int s) {
    load_tile(sb, (gs + s) % kStages, wpass + (size_t)s * 64 * NT, NT);
  };
  // x chunk c (read at step xs0 + c), one step ahead and in a commit
  // group of its own, so two chunk buffers take turns.
  auto load_x = [&](int c) {
    if (stage && c >= 0 && c < kx) {
      const uint32_t xb = sb.x + (c % sb.L.nxbuf) * sb.L.xbuf;
      if constexpr (std::is_same<XT, float>::value)
        stage_x_f32(d, t, x, c * 64, xb, cur[0], cur[1], cur[2], cur[3],
                    cur[4]);
      else
        stage_x<false>(d, t, x, c * 64, xb, cur[0], cur[1], cur[2], cur[3],
                       cur[4]);
    }
  };

  // Groups: [x 0 (conv1), w 0] (w 0 alone, committed by the pass before,
  // when prefetched), [w 1], then per step s [x s + 1 - xs0], [w s + 2];
  // so at step s all but the newest group have landed.
  load_x(-xs0);
  if (!prefetched) load_w(0);
  cp_async_commit();
  if (1 < nsteps) load_w(1);
  cp_async_commit();

  const int khalf = lane >> 4;
  int ch = 0, ky = 0, kxx = 0;  // conv2: chunk and tap of step s
  for (int s = 0; s < nsteps; ++s) {
    // Step s's tiles have landed (this thread's copies, made visible to
    // wgmma's proxy, then everyone's); step s - 1's slots are free.
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    load_x(s + 1 - xs0);
    cp_async_commit();
    if (s + 2 < nsteps) load_w(s + 2);
    cp_async_commit();

    uint32_t aaddr[kMF];
    int akey[kMF];
    if (kPh == kConv2) {
      const int dy = ky - 1, dx = kxx - 1;
      const uint32_t abuf = sb.y1 + ch * 128;
#pragma unroll
      for (int f = 0; f < kMF; ++f) {
        const bool ok = (unsigned)(fr[f] + dy) < (unsigned)H &&
                        (unsigned)(fc[f] + dx) < (unsigned)W;
        const int pix = fb[f] + dy * W + dx;
        aaddr[f] = ok ? abuf + pix * (d.cmidp * 2) : sb.zero;
        akey[f] = ok ? (pix & 7) : 0;
      }
    } else {
      const int c = s - xs0;
      const bool from_x = c >= 0;
      const uint32_t abuf =
          from_x ? sb.x + (c % sb.L.nxbuf) * sb.L.xbuf : sb.y2 + s * 128;
      const int pitch = from_x ? 128 : d.cmidp * 2;
#pragma unroll
      for (int f = 0; f < kMF; ++f) {
        const bool ok = fr[f] != -2;
        const int pix =
            from_x ? fb[f] : base0 + f * 64 + wq * 16 + (lane & 15);
        aaddr[f] = ok ? abuf + pix * pitch : sb.zero;
        akey[f] = ok ? (pix & 7) : 0;
      }
    }
    const uint32_t bslot =
        sb.ring + ((gs + s) % kStages) * sb.L.ring + wg_n * kNW * 128;
    // The next k16 step's A fragments load while this step's products
    // run (one group in flight); all have finished when the step ends, so
    // the ring slot can be refilled after the next barrier. Every m64 tile
    // is multiplied, also one past M (its rows read the zero line).
    uint32_t a[2][kMF][4];
#pragma unroll
    for (int f = 0; f < kMF; ++f)
      ldsm_x4(a[0][f], aaddr[f] + ((khalf ^ akey[f]) << 4));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wg_fence();
#pragma unroll
      for (int f = 0; f < kMF; ++f) {
        if constexpr (kPromote)
          wgmma_tile<kNW>(part[f], a[kk & 1][f], sw128_desc(bslot + kk * 32),
                          0);
        else
          wgmma_tile<kNW>(acc[f], a[kk & 1][f], sw128_desc(bslot + kk * 32));
      }
      wg_commit();
      if (kk < 3) {
        if constexpr (!kPromote)
          wg_wait1();  // step kk - 1 done: its A registers take kk + 1's
#pragma unroll
        for (int f = 0; f < kMF; ++f)
          ldsm_x4(a[(kk + 1) & 1][f],
                  aaddr[f] + (((((kk + 1) << 1) + khalf) ^ akey[f]) << 4));
      }
      if constexpr (kPromote) {
        wg_wait0();  // this k16's products, then their f32 add
#pragma unroll
        for (int f = 0; f < kMF; ++f)
#pragma unroll
          for (int e = 0; e < kNW / 2; ++e)
            acc[f][e] = __fadd_rn(acc[f][e], part[f][e]);
      }
    }
    wg_wait0();
    if (kPh == kConv2 && ++kxx == 3) {
      kxx = 0;
      if (++ky == 3) ky = 0, ++ch;
    }
  }
  gs += nsteps;
  if (wnext != nullptr) {
    // Its slot's last reader, step nsteps - 3 (or a pass before), is done.
    load_tile(sb, gs % kStages, wnext, nt_next);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
}

// The pass geometry of one phase: N pass width, warpgroup split, M tile.
template <int kMF, int kNW>
struct PassGeom {
  int NT, npass, wg_m, wg_n, MT;
  __device__ __forceinline__ PassGeom(int wn, int chans_p) {
    NT = 64 * wn;
    npass = chans_p / NT;
    const bool along_n = NT > kNW;
    const int wg = threadIdx.x >> 7;
    wg_m = along_n ? 0 : wg;
    wg_n = along_n ? wg : 0;
    MT = (along_n ? 1 : 2) * kMF * 64;
  }
  // The pass row of accumulator row (f, half) and its first channel j = 0.
  __device__ __forceinline__ int row(int m0, int f, int half) const {
    const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
    return m0 + wg_m * kMF * 64 + f * 64 + wq * 16 + (lane >> 2) + half * 8;
  }
  __device__ __forceinline__ int chan(int np, int j) const {
    return np * NT + wg_n * kNW + j * 8 + 2 * (threadIdx.x & 3);
  }
};

// Quad transpose of one accumulator row: lane q (= lane % 4) holds, for
// the four 8-channel groups jj, the channels 8 jj + 2q + {0, 1} (e[jj]);
// afterwards it holds the 8 channels of group q (t[0..7]), for one 16-byte
// load and store per lane where the accumulator layout gives 4 bytes.
__device__ __forceinline__ void quad_transpose(const float2 (&e)[4],
                                               float (&t)[8]) {
  const int q = threadIdx.x & 3;
  float2 u[4];  // u[r]: from lane q ^ r, its channels 2 (q ^ r) + {0, 1}
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q ^ r;
    const float2 v = i == 0 ? e[0] : i == 1 ? e[1] : i == 2 ? e[2] : e[3];
    u[r].x = __shfl_xor_sync(0xffffffffu, v.x, r);
    u[r].y = __shfl_xor_sync(0xffffffffu, v.y, r);
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int r = p ^ q;
    const float2 v = r == 0 ? u[0] : r == 1 ? u[1] : r == 2 ? u[2] : u[3];
    t[2 * p] = v.x;
    t[2 * p + 1] = v.y;
  }
}

__device__ __forceinline__ void unpack8(const uint32_t (&v)[4],
                                        float (&f)[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 p = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v[j]));
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
}

bool wn_ok(int wn, int chans_p) {
  return (wn == 1 || wn == 2 || wn == 4) && chans_p % (64 * wn) == 0;
}

}  // namespace
