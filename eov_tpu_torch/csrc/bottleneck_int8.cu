// One stride-1 int8 ResNet bottleneck block, fused: conv1 1x1 -> conv2 3x3
// -> conv3 1x1 + residual (projected on a stage's entry block), every conv
// quantized. The wrapper (ops/bottleneck_int8.py) launches it once per block
// of the stack.
//
// Replaces the Pallas TPU kernel eov_tpu/ops/pallas_bottleneck_int8.py
// fused_bottleneck_stack_int8 (_stack_kernel_int8 / _run_chain_int8). As in
// kernel 2 (bottleneck_stack.cu), one thread block owns TR output rows of
// one image (or G whole images of a small map) through one block:
//   staging: the x rows of the tile plus a one-row halo above and below are
//            read once with 16-byte loads and requantized at conv1's scale
//            into an int8 tile; on an entry block the output rows are also
//            requantized at the projection's scale into a second one;
//   phase A: conv1 over the staged rows; dequant, bias, ReLU, requantized
//            at conv2's scale into the int8 y1 tile (rows outside the image
//            are never read: the 3x3's zero padding is a zero line);
//   phase B: the 3x3 as one GEMM with K = 9*Cmid whose A operand reads the
//            9 taps straight from y1; dequant, bias, ReLU, requantized at
//            conv3's scale into the int8 y2 tile (in the x tile's place);
//   phase C: on an entry block the projection (its dequantized, biased r
//            written to out), then conv3; y3 + r (r read back from out, or
//            the identity x) in the compute dtype, ReLU, stored.
//
// Bound on the H100: operations for the function (ResNet-50 stage 1 at 256
// images is 3.42e11 int8 ops, 0.173 ms at the 1979 TOPS int8 tensor-core
// peak, against 514 MB of bf16 input and output, 0.153 ms at 3.35 TB/s);
// one launch per block moves each block's input and output through device
// memory, 2.16 GB at stage 1 and 256 images, a floor of 0.644 ms.
//
// Products on the tensor cores, in both compute dtypes (the int8 products
// do not depend on it): wgmma.mma_async m64nNk32.s32.s8.s8 (mma_tile.cuh),
// A from registers by ldmatrix through per-row addresses (a 3x3 tap adds
// dy*W + dx; a row outside the image or past M reads a zero line), B the
// weights from shared memory, int32 sums exact. wgmma was taken over
// mma.sync m16n8k32: its register-A fragment of s8 k32 is byte for byte
// the bf16 k16 one ldmatrix already gives kernels 2, 4, 8 and 9.
// - Every int8 tile is kept in 64-channel planes, a pixel's 64 channels a
//   64-byte line with 64-byte swizzle (16-byte line l of pixel p at
//   l ^ ((p / 2) % 4)): a K step is one plane (two k32 products), the
//   weight tiles [NT][64] are wgmma's K-major SW64 atoms (sw64_desc), and
//   ldmatrix reads 8 consecutive pixels without a bank conflict. 128-byte
//   atoms would make a K step 128 channels and pad ResNet-50's Cmid of 64
//   to 128, doubling conv2 and conv3.
// - Channels are padded with zeros to multiples of 64 (Cin, Cmid, Cout):
//   zero products leave the int32 sums exact, so any channel count runs.
// - x is requantized once, as it is staged (16 channels an item, 16-byte
//   loads where the row allows; the projection's output rows at their own
//   scale in the same pass), not once per K chunk and N pass.
// - The weights are relaid out once per call by the wrapper, in the order
//   the K loops read them, and stream through a 3-deep cp.async ring: the
//   block's passes (all three phases) read one sequence of tiles, each
//   loaded two steps ahead, across pass and phase boundaries.
// - The projection has its own scale, so it cannot share conv3's int32
//   sum: its pass runs first and parks r, rounded to T, in out, which the
//   same threads read back in conv3's epilogue. Phase C's epilogues
//   transpose each quad's sums so that a lane loads and stores 8 channels
//   (16 bytes in bf16) of a row when Cout % 8 == 0.
// - Tiles: ops/bottleneck_int8.py int8_tile_plan picks TR, G and the N
//   pass widths that fit the 227 KB at the least cost per image (K steps,
//   and the staged and stored bytes at a step's worth of memory time);
//   bottleneck_int8_smem_bytes must agree with it. int8 tiles are half of
//   kernel 2's bf16 ones, so at 56^2 a block holds 8 rows (halo 1.25).
// - One block per SM (191-199 KB, 255 registers) runs 8 warps, so a load
//   whose register is read at once stalls its warp for a full memory round
//   trip: the staging issues a round of 8 items' loads before it
//   requantizes any, phase C loads its residual rows as raw words unpacked
//   where they are added (the rows prefetched to L2 while phase B runs),
//   each N pass loads its scales and biases once, and the quad transposes
//   choose their values by selects (a chain of comparisons on a
//   lane-dependent index compiles to branches that split the warp).
//
// Rounding follows the reference chain exactly, so the plain PyTorch version
// gives the same bits: requant is clip(rint(x * inv_a), +-127) (round half
// to even, not roundf); dequant is the int32 sum converted with
// __int2float_rn, multiplied by a*w_scale with __fmul_rn and rounded to the
// compute dtype; the bias (rounded to the compute dtype) and the residual
// are added with __fadd_rn and rounded again. Every multiply and add is an
// explicit _rn intrinsic so nvcc contracts none of them into an FMA.

#include "mma_tile.cuh"

namespace {

constexpr int kThreads = 256;   // two warpgroups
constexpr int kStages = 3;      // weight tiles in flight
constexpr int kZeroBytes = 128; // the zero line padding reads point at
constexpr int kMF1 = 4, kNW1 = 64;  // phases A and B: m64 tiles x channels

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

// v rounded to the compute dtype T, as a float.
template <typename T>
__device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

// Two floats that are bf16 values already, packed (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// clip(round_half_even(v * inv_a), -127, 127): one conversion (round to
// nearest even, saturating), then an integer clip.
__device__ __forceinline__ int quant(float v, float inv_a) {
  return imin(imax(__float2int_rn(__fmul_rn(v, inv_a)), -127), 127);
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (unsigned)(a & 0xff) | ((unsigned)(b & 0xff) << 8) |
         ((unsigned)(c & 0xff) << 16) | ((unsigned)(d & 0xff) << 24);
}

// T(T(acc * scale) + bias_t): dequant rounded to T, then the bias in T.
template <typename T>
__device__ __forceinline__ float dequant_bias(int acc, float scale,
                                              float bias_t) {
  const float y = round_t<T>(__fmul_rn(__int2float_rn(acc), scale));
  return round_t<T>(__fadd_rn(y, bias_t));
}

// Byte offset of 16-byte line l of pixel p in a 64-byte-swizzled plane.
__device__ __forceinline__ int sw64(int p, int l) {
  return p * 64 + ((l ^ ((p >> 1) & 3)) << 4);
}

struct Dims {
  int n, h, w, cin, cmid, cout;
  int cinp, cmidp, coutp;  // channels rounded up to 64
  int tile_rows;           // TR output rows per block (h when images > 1)
  int images;              // G images per block
  int wn1;                 // N pass of conv1 and conv2: 64 wn1 channels
  int wn3;                 // N pass of conv3 and the projection: 64 wn3
  int proj;                // projection shortcut
};

struct Smem {
  int ring;  // one weight tile [64 max(wn1, wn3)][64] int8
  int x;     // x [cinp/64][G][min(TR+2, h)][w][64] int8
  int y1;    // y1 [cmidp/64][G][min(TR+2, h)][w][64] int8
  int y2;    // y2 [cmidp/64][G TR w][64] int8, in x's place
  int xd;    // the projection's x [cinp/64][G TR w][64] int8 (entry block)
  int total;
};

__host__ __device__ inline Smem int8_smem(const Dims& d) {
  Smem s;
  const int yrows = imin(d.tile_rows + 2, d.h);
  const int px_in = d.images * yrows * d.w;
  const int px_out = d.images * d.tile_rows * d.w;
  s.ring = 64 * 64 * imax(d.wn1, d.wn3);
  s.x = px_in * d.cinp;
  s.y1 = px_in * d.cmidp;
  s.y2 = px_out * d.cmidp;
  s.xd = d.proj ? px_out * d.cinp : 0;
  s.total = kStages * s.ring + kZeroBytes + imax(s.x, s.y2) + s.y1 + s.xd;
  return s;
}

// The block's shared buffers (byte addresses) and plane strides: the weight
// ring first (1024-byte aligned), then the zero line, x (and y2), y1, xd.
struct Bufs {
  uint32_t ring, zero, x, y1, xd;
  unsigned char* sp;              // the generic address of ring
  int ring_bytes, px_in, px_out;  // plane strides: px * 64 bytes
};

// The rows and images of one thread block.
struct Tile {
  int g0, gcount;  // images [g0, g0 + gcount)
  int r0, rows;    // output rows [r0, r0 + rows)
  int lo, hi;      // y1 rows computed and x rows staged: [lo, hi)
  int yrows;       // rows per image in the x and y1 tiles
};

// One conv site's parameters: dequant scale a*w_scale [Cout], requant
// multiplier 1/a [1], bias [Cout] (f32).
struct Site {
  const float* __restrict__ s;
  const float* __restrict__ q;
  const float* __restrict__ b;
};

// The weight tiles in the order the block's steps read them: phase A's M
// passes each read w1 [npass1][kin][NT1][64], phase B's w2 [npass1][kmid]
// [9][NT1][64], phase C's w3 [npass3][kin (wd, entry block) + kmid][NT3]
// [64]. Global step g uses ring slot g % kStages.
struct Stream {
  const int8_t* w1;
  const int8_t* w2;
  const int8_t* w3;
  int sa, sab, total;     // steps of phase A, A + B, all
  int per1, per2, per3;   // tiles per M pass of each phase
  int nt1, nt3;           // rows of a tile: NT of phases A / B and C
};

__device__ __forceinline__ void load_tile(const Bufs& sb, const Stream& st,
                                          int g) {
  if (g >= st.total) return;
  const int8_t* src;
  int nt;
  if (g < st.sa) {
    src = st.w1 + (size_t)(g % st.per1) * st.nt1 * 64;
    nt = st.nt1;
  } else if (g < st.sab) {
    src = st.w2 + (size_t)((g - st.sa) % st.per2) * st.nt1 * 64;
    nt = st.nt1;
  } else {
    src = st.w3 + (size_t)((g - st.sab) % st.per3) * st.nt3 * 64;
    nt = st.nt3;
  }
  const uint32_t dst = sb.ring + (g % kStages) * sb.ring_bytes;
  for (int i = threadIdx.x; i < 4 * nt; i += kThreads) {
    const int n = i >> 2, kc = i & 3;
    cp_async16(dst + sw64(n, kc), src + i * 16);
  }
}

// The pass geometry of one phase: N pass width, warpgroup split, M tile
// (the two warpgroups split the pass's NT channels when NT > kNW, else its
// MT = 2 kMF 64 pixels).
template <int kMF, int kNW>
struct Geom {
  int NT, npass, wg_m, wg_n, MT;
  __device__ __forceinline__ Geom(int wn, int chans_p) {
    NT = 64 * wn;
    npass = chans_p / NT;
    const bool along_n = NT > kNW;
    const int wg = threadIdx.x >> 7;
    wg_m = along_n ? 0 : wg;
    wg_n = along_n ? wg : 0;
    MT = (along_n ? 1 : 2) * kMF * 64;
  }
  // The pass row of A fragment row (f) of this lane (ldmatrix addresses).
  __device__ __forceinline__ int arow(int m0, int f) const {
    const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
    return m0 + wg_m * kMF * 64 + f * 64 + wq * 16 + (lane & 15);
  }
  // The pass row of accumulator row (f, half) and its channel j (+ 0, 1).
  __device__ __forceinline__ int row(int m0, int f, int half) const {
    const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
    return m0 + wg_m * kMF * 64 + f * 64 + wq * 16 + (lane >> 2) + half * 8;
  }
  __device__ __forceinline__ int chan(int np, int j) const {
    return np * NT + wg_n * kNW + j * 8 + 2 * (threadIdx.x & 3);
  }
};

// acc = the products of the next nk global steps (gs, advanced here): per
// step one weight tile (the ring slot of gs, whose tile loaded two steps
// before) and one 64-channel A plane; aaddr(f, k, key) gives this lane's
// ldmatrix row address of m64 tile f at step k and its swizzle key. Every
// m64 tile is multiplied, also one past M (its rows read the zero line): a
// branch around wgmma makes ptxas serialize them.
template <int kMF, int kNW, typename AddrFn>
__device__ __forceinline__ void run_steps(int (&acc)[kMF][kNW / 2],
                                          const Bufs& sb, const Stream& st,
                                          int wg_n, int nk, int& gs,
                                          AddrFn aaddr) {
  const int khalf = (threadIdx.x & 31) >> 4;
#pragma unroll
  for (int f = 0; f < kMF; ++f)
#pragma unroll
    for (int e = 0; e < kNW / 2; ++e) acc[f][e] = 0;
  for (int k = 0; k < nk; ++k, ++gs) {
    // Step gs's tile has landed (this thread's copies, made visible to
    // wgmma's proxy, then everyone's); step gs - 1's slot is free.
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    load_tile(sb, st, gs + 2);
    cp_async_commit();
    uint32_t a[2][kMF][4];
#pragma unroll
    for (int f = 0; f < kMF; ++f) {
      int key;
      const uint32_t base = aaddr(f, k, key);
      ldsm_x4(a[0][f], base + ((khalf ^ key) << 4));
      ldsm_x4(a[1][f], base + (((2 + khalf) ^ key) << 4));
    }
    const uint32_t b =
        sb.ring + (gs % kStages) * sb.ring_bytes + wg_n * kNW * 64;
    wg_fence();
#pragma unroll
    for (int f = 0; f < kMF; ++f)
      wgmma_s8_tile<kNW>(acc[f], a[0][f], sw64_desc(b));
#pragma unroll
    for (int f = 0; f < kMF; ++f)
      wgmma_s8_tile<kNW>(acc[f], a[1][f], sw64_desc(b + 32));
    wg_commit();
    wg_wait0();
  }
}

// The 16 channels of kW = sizeof(T) 16-byte words of a row as floats.
__device__ __forceinline__ void unpack16(const uint4 (&w)[2], float (&v)[16]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint32_t u[4] = {w[k].x, w[k].y, w[k].z, w[k].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
      v[8 * k + 2 * i] = f.x;
      v[8 * k + 2 * i + 1] = f.y;
    }
  }
}
__device__ __forceinline__ void unpack16(const uint4 (&w)[4], float (&v)[16]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[4 * k] = __uint_as_float(w[k].x);
    v[4 * k + 1] = __uint_as_float(w[k].y);
    v[4 * k + 2] = __uint_as_float(w[k].z);
    v[4 * k + 3] = __uint_as_float(w[k].w);
  }
}

// 16 values requantized at inv, as one 16-byte line.
__device__ __forceinline__ uint4 quant16(const float (&v)[16], float inv) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = pack4(quant(v[4 * i], inv), quant(v[4 * i + 1], inv),
                 quant(v[4 * i + 2], inv), quant(v[4 * i + 3], inv));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// This lane's dequant scales and biases (rounded to T) of one N pass:
// channels chan(np, j) + e, loaded once for all of the pass's rows (0 past
// the channel count).
template <typename T, int kNW, int kMF>
__device__ __forceinline__ void pass_params(const Site& c, int chans,
                                            const Geom<kMF, kNW>& g, int np,
                                            float (&ps)[kNW / 8][2],
                                            float (&pb)[kNW / 8][2]) {
#pragma unroll
  for (int j = 0; j < kNW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = g.chan(np, j) + e;
      ps[j][e] = n < chans ? __ldg(c.s + n) : 0.f;
      pb[j][e] = n < chans ? __ldg(c.b + n) : 0.f;
    }
#pragma unroll
  for (int j = 0; j < kNW / 8; ++j)  // after every load is issued
#pragma unroll
    for (int e = 0; e < 2; ++e) pb[j][e] = round_t<T>(pb[j][e]);
}

// One round of staging: kU items of 16 channels, item i0 + u * kThreads
// (an item past the end reloads the last one and is not stored).
template <typename T, int kU>
struct StageRound {
  static constexpr int kW = sizeof(T);  // 16-byte words an item
  uint4 raw[kU][kW];
  int pix[kU], grp[kU], dpix[kU];
};

// Issue the loads of a round: every load before any use, none behind a
// branch, and no load's register read before the round is stored (so the
// loads are in flight together; vec: cin % 8 == 0, so a word lies in cin
// or past it, whole).
template <typename T, int kU>
__device__ __forceinline__ void stage_load(const Dims& d, const Tile& t,
                                           const T* __restrict__ x, int i0,
                                           int items, bool vec,
                                           StageRound<T, kU>& s) {
  constexpr int kW = StageRound<T, kU>::kW, kC = 16 / sizeof(T);
  const int groups = d.cinp >> 4, ra = t.hi - t.lo;
  const T* row[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int i = imin(i0 + u * kThreads, items - 1);
    const int p = i / groups;
    s.grp[u] = i - p * groups;
    const int q = p / d.w, col = p - q * d.w;
    const int g = q / ra, r = t.lo + (q - g * ra);
    s.pix[u] = i0 + u * kThreads < items
                   ? (g * t.yrows + r - t.lo) * d.w + col
                   : -1;
    s.dpix[u] = d.proj && r >= t.r0 && r < t.r0 + t.rows
                    ? (g * t.rows + r - t.r0) * d.w + col
                    : -1;
    row[u] = x + (((size_t)(t.g0 + g) * d.h + r) * d.w + col) * d.cin;
  }
  if (vec) {  // a word past cin reads channel 0; stage_store zeroes it
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        const int c = s.grp[u] * 16 + k * kC;
        s.raw[u][k] = __ldg(reinterpret_cast<const uint4*>(
            row[u] + (c < d.cin ? c : 0)));
      }
  } else {
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = s.grp[u] * 16 + k * kC + e * (kC / 4);
          if constexpr (sizeof(T) == 4) {
            w[e] = c < d.cin ? __float_as_uint(__ldg(row[u] + c)) : 0u;
          } else {
            const unsigned short* h =
                reinterpret_cast<const unsigned short*>(row[u]);
            w[e] = (c < d.cin ? (uint32_t)h[c] : 0u) |
                   (c + 1 < d.cin ? (uint32_t)h[c + 1] << 16 : 0u);
          }
        }
        s.raw[u][k] = make_uint4(w[0], w[1], w[2], w[3]);
      }
  }
}

// Requantize a loaded round into the x planes (and the xd planes).
template <typename T, int kU>
__device__ __forceinline__ void stage_store(const Dims& d, const Bufs& sb,
                                            float inv1, float invd,
                                            const StageRound<T, kU>& s) {
  constexpr int kC = 16 / sizeof(T);
  unsigned char* xs = sb.sp + (sb.x - sb.ring);
  unsigned char* xds = sb.sp + (sb.xd - sb.ring);
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    if (s.pix[u] < 0) continue;
    float v[16];
    unpack16(s.raw[u], v);
#pragma unroll
    for (int i = 0; i < 16; ++i)  // channels past cin (a vec word's reload)
      if (s.grp[u] * 16 + (i / kC) * kC >= d.cin) v[i] = 0.f;
    const int plane = s.grp[u] >> 2, l = s.grp[u] & 3;
    *reinterpret_cast<uint4*>(xs + plane * sb.px_in * 64 +
                              sw64(s.pix[u], l)) = quant16(v, inv1);
    if (s.dpix[u] >= 0)
      *reinterpret_cast<uint4*>(xds + plane * sb.px_out * 64 +
                                sw64(s.dpix[u], l)) = quant16(v, invd);
  }
}

// Stage the x rows [lo, hi) of the block's images, requantized at inv1,
// into the x planes (pixel (g yrows + r - lo) w + col), and on an entry
// block the output rows [r0, r0 + rows) at invd into the xd planes (pixel
// (g rows + r - r0) w + col). An item is 16 channels of one pixel;
// neighbouring threads take neighbouring items, kU a round (no sums are
// live yet: the registers are there).
template <typename T>
__device__ __forceinline__ void stage_x(const Dims& d, const Tile& t,
                                        const Bufs& sb,
                                        const T* __restrict__ x, float inv1,
                                        float invd, bool vec) {
  constexpr int kU = sizeof(T) == 2 ? 8 : 4;  // 16 loads of 16 B a round
  const int items = t.gcount * (t.hi - t.lo) * d.w * (d.cinp >> 4);
  for (int i0 = threadIdx.x; i0 < items; i0 += kU * kThreads) {
    StageRound<T, kU> a;
    stage_load(d, t, x, i0, items, vec, a);
    stage_store(d, sb, inv1, invd, a);
  }
}

// Ask L2 for the identity residual's rows (the block's output rows of x,
// contiguous in memory), so that phase C's epilogue finds them there.
template <typename T>
__device__ __forceinline__ void prefetch_residual(const Dims& d,
                                                  const Tile& t,
                                                  const T* __restrict__ x) {
  for (int g = 0; g < t.gcount; ++g) {
    const char* base = reinterpret_cast<const char*>(
        x + ((size_t)(t.g0 + g) * d.h + t.r0) * d.w * d.cin);
    const int bytes = t.rows * d.w * d.cin * (int)sizeof(T);
    for (int o = threadIdx.x * 128; o < bytes; o += kThreads * 128)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(base + o));
  }
}

// y (channels n, n + 1 of one pixel) requantized into an int8 plane line
// (a plain store: the compiler may move the epilogue's loads across it).
__device__ __forceinline__ void store_q2(unsigned char* plane0,
                                         int plane_bytes, int pix, int n,
                                         int q0, int q1) {
  *reinterpret_cast<uint16_t*>(plane0 + (n >> 6) * plane_bytes +
                               sw64(pix, (n & 63) >> 4) + (n & 15)) =
      (uint16_t)((q0 & 0xff) | ((q1 & 0xff) << 8));
}

// Quad transpose of one accumulator row: lane q (= lane % 4) holds, for
// the four 8-channel groups jj, the channels 8 jj + 2q + {0, 1} (e[jj]);
// afterwards it holds the 8 channels of group q (t[0..7]), for one 16-byte
// load and store per lane where the accumulator layout gives 2 values.
// e[i] for a lane-dependent i in [0, 4), by selects on i's two bits: a
// chain of comparisons compiles to branches that split the warp four ways.
__device__ __forceinline__ int pick4(const int (&e)[4], int i) {
  const int a = (i & 1) ? e[1] : e[0];
  const int b = (i & 1) ? e[3] : e[2];
  return (i & 2) ? b : a;
}

__device__ __forceinline__ void quad_transpose(const int2 (&e)[4],
                                               int (&t)[8]) {
  const int q = threadIdx.x & 3;
  const int ex[4] = {e[0].x, e[1].x, e[2].x, e[3].x};
  const int ey[4] = {e[0].y, e[1].y, e[2].y, e[3].y};
  int ux[4], uy[4];  // [r]: from lane q ^ r, its channels 2 (q ^ r) + {0, 1}
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    ux[r] = __shfl_xor_sync(0xffffffffu, pick4(ex, q ^ r), r);
    uy[r] = __shfl_xor_sync(0xffffffffu, pick4(ey, q ^ r), r);
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    t[2 * p] = pick4(ux, p ^ q);
    t[2 * p + 1] = pick4(uy, p ^ q);
  }
}

// 8 channels of a row in T as raw 16-byte words (sizeof(T) / 2 of them),
// unpacked to floats only where they are used: a load whose register is
// read at once would wait there, one load at a time.
template <typename T>
struct Raw8 {
  uint4 w[sizeof(T) / 2];
};
template <typename T>
__device__ __forceinline__ Raw8<T> load8(const T* p) {
  Raw8<T> r;
#pragma unroll
  for (int i = 0; i < (int)sizeof(T) / 2; ++i)
    r.w[i] = reinterpret_cast<const uint4*>(p)[i];
  return r;
}
__device__ __forceinline__ void unpack8(const Raw8<float>& r, float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    v[4 * i] = __uint_as_float(r.w[i].x);
    v[4 * i + 1] = __uint_as_float(r.w[i].y);
    v[4 * i + 2] = __uint_as_float(r.w[i].z);
    v[4 * i + 3] = __uint_as_float(r.w[i].w);
  }
}
__device__ __forceinline__ void unpack8(const Raw8<__nv_bfloat16>& r,
                                        float (&v)[8]) {
  const uint32_t u[4] = {r.w[0].x, r.w[0].y, r.w[0].z, r.w[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(
      pack_bf16_exact(v[0], v[1]), pack_bf16_exact(v[2], v[3]),
      pack_bf16_exact(v[4], v[5]), pack_bf16_exact(v[6], v[7]));
}

// The dequantized, biased 8 channels [n0, n0 + 8): T(T(acc * s) + T(b)).
template <typename T>
__device__ __forceinline__ void dequant8(const int (&acc)[8], const Site& c,
                                         int n0, float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i] = dequant_bias<T>(acc[i], __ldg(c.s + n0 + i),
                           round_t<T>(__ldg(c.b + n0 + i)));
}

// Phase C's epilogue with 8 channels a lane (cout % 8 == 0, out and x
// 16-byte aligned): kProjOut parks the projection's r in out; else out =
// relu(T(y3 + r)), r read back from out (proj) or x. The residual loads of
// kH rows (both rows of an m64 tile at 64 channels a warpgroup, one at 128)
// are issued together, before the first store.
template <typename T, bool kProjOut, int kMF3, int kNW3>
__device__ __forceinline__ void store_c_vec(const int (&acc)[kMF3][kNW3 / 2],
                                            const Geom<kMF3, kNW3>& g3,
                                            const size_t (&opix)[kMF3][2],
                                            int np, const Dims& d,
                                            const Site& c,
                                            const T* __restrict__ x,
                                            T* __restrict__ out) {
  constexpr int kK = kNW3 / 32;  // 8-channel groups of a row a lane holds
  constexpr int kH = kK == 2 ? 2 : 1;
  const int lq = threadIdx.x & 3;
  int n0[kK];
  float sc[kK][8], bt[kK][8];  // the pass's scales and biases, loaded once
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    n0[k] = g3.chan(np, 4 * k + lq) - 2 * lq;
    const int n = n0[k] < d.cout ? n0[k] : 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sc[k][i] = __ldg(c.s + n + i);
      bt[k][i] = __ldg(c.b + n + i);
    }
  }
#pragma unroll
  for (int k = 0; k < kK; ++k)  // after every load is issued
#pragma unroll
    for (int i = 0; i < 8; ++i) bt[k][i] = round_t<T>(bt[k][i]);
#pragma unroll
  for (int f = 0; f < kMF3; ++f) {
#pragma unroll
    for (int h0 = 0; h0 < 2; h0 += kH) {
      int t[kH][kK][8];
      Raw8<T> r[kH][kK];
#pragma unroll
      for (int hh = 0; hh < kH; ++hh)
#pragma unroll
        for (int k = 0; k < kK; ++k) {
          int2 e[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            e[jj] = make_int2(acc[f][4 * (4 * k + jj) + 2 * (h0 + hh)],
                              acc[f][4 * (4 * k + jj) + 2 * (h0 + hh) + 1]);
          quad_transpose(e, t[hh][k]);  // every lane, before any skips
        }
#pragma unroll
      for (int hh = 0; hh < kH; ++hh) {
        const size_t px = opix[f][h0 + hh];
#pragma unroll
        for (int k = 0; k < kK; ++k) {
          if (kProjOut || px == (size_t)-1 || n0[k] >= d.cout) continue;
          r[hh][k] = load8<T>(d.proj ? out + px * d.cout + n0[k]
                                     : x + px * d.cin + n0[k]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < kH; ++hh) {
        const size_t px = opix[f][h0 + hh];
        if (px == (size_t)-1) continue;
#pragma unroll
        for (int k = 0; k < kK; ++k) {
          if (n0[k] >= d.cout) continue;
          float v[8], rv[8];
          if (!kProjOut) unpack8(r[hh][k], rv);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            v[i] = dequant_bias<T>(t[hh][k][i], sc[k][i], bt[k][i]);
            if (!kProjOut)
              v[i] = fmaxf(round_t<T>(__fadd_rn(v[i], rv[i])), 0.f);
          }
          store8(out + px * d.cout + n0[k], v);
        }
      }
    }
  }
}

// Phase C's epilogue for any cout and alignment, 2 channels a lane (a
// pair store when cout is even, so the pair is aligned); as store_c_vec.
template <typename T, bool kProjOut, int kMF3, int kNW3>
__device__ __forceinline__ void store_c_pair(const int (&acc)[kMF3][kNW3 / 2],
                                             const Geom<kMF3, kNW3>& g3,
                                             const size_t (&opix)[kMF3][2],
                                             int np, const Dims& d,
                                             const Site& c,
                                             const T* __restrict__ x,
                                             T* __restrict__ out) {
  const int C = d.cout;
#pragma unroll
  for (int f = 0; f < kMF3; ++f) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (opix[f][half] == (size_t)-1) continue;
      T* o = out + opix[f][half] * C;
#pragma unroll
      for (int j = 0; j < kNW3 / 8; ++j) {
        const int n = g3.chan(np, j);
        if (n >= C) continue;
        const bool two = n + 1 < C;
        float v[2], r[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = e == 0 || two
                     ? dequant_bias<T>(acc[f][4 * j + 2 * half + e],
                                       c.s[n + e], round_t<T>(c.b[n + e]))
                     : 0.f;
        if (!kProjOut) {
          const T* src = d.proj ? o : x + opix[f][half] * d.cin;
          r[0] = to_f(src[n]);
          if (two) r[1] = to_f(src[n + 1]);
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = fmaxf(round_t<T>(__fadd_rn(v[e], r[e])), 0.f);
        }
        if ((C & 1) == 0 && two) {
          if constexpr (sizeof(T) == 4)
            *reinterpret_cast<float2*>(o + n) = make_float2(v[0], v[1]);
          else
            *reinterpret_cast<uint32_t*>(o + n) = pack_bf16_exact(v[0], v[1]);
        } else {
          o[n] = from_f<T>(v[0]);
          if (two) o[n + 1] = from_f<T>(v[1]);
        }
      }
    }
  }
}

// One block (kMF3, kNW3: phase C's m64 tiles x channels). w1, w2, w3 as
// Stream lists them; c3 and cd the dequant and bias of conv3 and the
// projection (cd unused without one).
template <typename T, int kMF3, int kNW3>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_int8_kernel(const T* __restrict__ x, const int8_t* __restrict__ w1,
                       const int8_t* __restrict__ w2,
                       const int8_t* __restrict__ w3, Site c1, Site c2,
                       Site c3, Site cd, T* __restrict__ out, Dims d,
                       int vec, int ovec) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int W = d.w, H = d.h;
  const Smem L = int8_smem(d);
  Bufs sb;
  sb.ring = smem_u32(smem);
  sb.sp = smem;
  sb.ring_bytes = L.ring;
  sb.zero = sb.ring + kStages * L.ring;
  sb.x = sb.zero + kZeroBytes;
  sb.y1 = sb.x + imax(L.x, L.y2);
  sb.xd = sb.y1 + L.y1;

  Tile t;
  t.g0 = blockIdx.y * d.images;
  t.gcount = imin(d.images, d.n - t.g0);
  t.r0 = blockIdx.x * d.tile_rows;
  t.rows = imin(d.tile_rows, H - t.r0);
  t.lo = imax(t.r0 - 1, 0);
  t.hi = imin(t.r0 + t.rows + 1, H);
  t.yrows = imin(d.tile_rows + 2, H);
  sb.px_in = d.images * t.yrows * W;
  sb.px_out = d.images * d.tile_rows * W;

  const Geom<kMF1, kNW1> g1(d.wn1, d.cmidp);
  const Geom<kMF3, kNW3> g3(d.wn3, d.coutp);
  const int kin = d.cinp >> 6, kmid = d.cmidp >> 6;
  const int RA = t.hi - t.lo;
  const int MA = t.gcount * RA * W, MB = t.gcount * t.rows * W;
  const int mpa = (MA + g1.MT - 1) / g1.MT, mpb = (MB + g1.MT - 1) / g1.MT;
  const int mpc = (MB + g3.MT - 1) / g3.MT;

  Stream st;
  st.w1 = w1;
  st.w2 = w2;
  st.w3 = w3;
  st.nt1 = g1.NT;
  st.nt3 = g3.NT;
  st.per1 = g1.npass * kin;
  st.per2 = g1.npass * 9 * kmid;
  st.per3 = g3.npass * ((d.proj ? kin : 0) + kmid);
  st.sa = mpa * st.per1;
  st.sab = st.sa + mpb * st.per2;
  st.total = st.sab + mpc * st.per3;

  // The first two weight tiles fly while x is staged.
  load_tile(sb, st, 0);
  cp_async_commit();
  load_tile(sb, st, 1);
  cp_async_commit();
  if (threadIdx.x < kZeroBytes / 16)
    st_shared_v4(sb.zero + threadIdx.x * 16, 0, 0, 0, 0);
  stage_x<T>(d, t, sb, x, c1.q[0], d.proj ? cd.q[0] : 0.f, vec != 0);

  const float inv2 = c2.q[0], inv3 = c3.q[0];
  unsigned char* y1s = smem + (sb.y1 - sb.ring);
  unsigned char* y2s = smem + (sb.x - sb.ring);  // y2 in x's place
  int gs = 0;

  // Phase A: y1q = quant(relu(T(T(xq w1 * s1) + T(b1))), inv2) over rows
  // [lo, hi), into y1 (pixel (g yrows + r - lo) w + col).
  {
    int acc[kMF1][kNW1 / 2];
    for (int m0 = 0; m0 < MA; m0 += g1.MT) {
      int apix[kMF1];
#pragma unroll
      for (int f = 0; f < kMF1; ++f) {
        const int p = g1.arow(m0, f);
        apix[f] = -1;
        if (p < MA) {
          const int q = p / W, col = p - q * W;
          const int g = q / RA;
          apix[f] = (g * t.yrows + q - g * RA) * W + col;
        }
      }
      for (int np = 0; np < g1.npass; ++np) {
        run_steps<kMF1, kNW1>(acc, sb, st, g1.wg_n, kin, gs,
                              [&](int f, int k, int& key) -> uint32_t {
                                key = (apix[f] >> 1) & 3;
                                return apix[f] < 0
                                           ? sb.zero
                                           : sb.x + k * sb.px_in * 64 +
                                                 apix[f] * 64;
                              });
        float ps[kNW1 / 8][2], pb[kNW1 / 8][2];
        pass_params<T, kNW1>(c1, d.cmid, g1, np, ps, pb);
#pragma unroll
        for (int f = 0; f < kMF1; ++f) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = g1.row(m0, f, half);
            if (m >= MA) continue;
            const int q = m / W, col = m - q * W;
            const int g = q / RA;
            const int ypix = (g * t.yrows + q - g * RA) * W + col;
#pragma unroll
            for (int j = 0; j < kNW1 / 8; ++j) {
              const int n = g1.chan(np, j);
              int v[2];
#pragma unroll
              for (int e = 0; e < 2; ++e)
                v[e] = n + e < d.cmid
                           ? quant(fmaxf(dequant_bias<T>(
                                             acc[f][4 * j + 2 * half + e],
                                             ps[j][e], pb[j][e]),
                                         0.f),
                                   inv2)
                           : 0;
              store_q2(y1s, sb.px_in * 64, ypix, n, v[0], v[1]);
            }
          }
        }
      }
    }
  }

  // Phase B: y2q = quant(relu(T(T(conv3x3(y1q) * s2) + T(b2))), inv3) over
  // the output rows, into y2 (pixel = the pass row), in x's place.
  if (!d.proj) prefetch_residual<T>(d, t, x);
  {
    int acc[kMF1][kNW1 / 2];
    for (int m0 = 0; m0 < MB; m0 += g1.MT) {
      int fr[kMF1], fc[kMF1], fb[kMF1];
#pragma unroll
      for (int f = 0; f < kMF1; ++f) {
        const int p = g1.arow(m0, f);
        fr[f] = -2;
        fc[f] = 0;
        fb[f] = 0;
        if (p < MB) {
          const int q = p / W, col = p - q * W;
          const int g = q / t.rows, r = t.r0 + (q - g * t.rows);
          fr[f] = r;
          fc[f] = col;
          fb[f] = (g * t.yrows + r - t.lo) * W + col;
        }
      }
      for (int np = 0; np < g1.npass; ++np) {
        run_steps<kMF1, kNW1>(
            acc, sb, st, g1.wg_n, 9 * kmid, gs,
            [&](int f, int k, int& key) -> uint32_t {
              const int ch = k / 9, tap = k - ch * 9;
              const int dy = tap / 3 - 1, dx = tap - (tap / 3) * 3 - 1;
              const bool ok = (unsigned)(fr[f] + dy) < (unsigned)H &&
                              (unsigned)(fc[f] + dx) < (unsigned)W;
              const int pix = fb[f] + dy * W + dx;
              key = ok ? (pix >> 1) & 3 : 0;
              return ok ? sb.y1 + ch * sb.px_in * 64 + pix * 64 : sb.zero;
            });
        float ps[kNW1 / 8][2], pb[kNW1 / 8][2];
        pass_params<T, kNW1>(c2, d.cmid, g1, np, ps, pb);
#pragma unroll
        for (int f = 0; f < kMF1; ++f) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = g1.row(m0, f, half);
            if (m >= MB) continue;
#pragma unroll
            for (int j = 0; j < kNW1 / 8; ++j) {
              const int n = g1.chan(np, j);
              int v[2];
#pragma unroll
              for (int e = 0; e < 2; ++e)
                v[e] = n + e < d.cmid
                           ? quant(fmaxf(dequant_bias<T>(
                                             acc[f][4 * j + 2 * half + e],
                                             ps[j][e], pb[j][e]),
                                         0.f),
                                   inv3)
                           : 0;
              store_q2(y2s, sb.px_out * 64, m, n, v[0], v[1]);
            }
          }
        }
      }
    }
  }

  // Phase C: out = relu(T(y3 + r)), y3 = T(T(y2q w3 * s3) + T(b3)), r the
  // projection T(T(xdq wd * sd) + T(bd)) (its own pass, parked in out) or
  // x.
  {
    int acc[kMF3][kNW3 / 2];
    for (int m0 = 0; m0 < MB; m0 += g3.MT) {
      int apix[kMF3];
      size_t opix[kMF3][2];
#pragma unroll
      for (int f = 0; f < kMF3; ++f) {
        const int p = g3.arow(m0, f);
        apix[f] = p < MB ? p : -1;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = g3.row(m0, f, half);
          const int q = m / W, col = m - q * W;
          const int g = q / t.rows, r = t.r0 + (q - g * t.rows);
          opix[f][half] = m < MB ? ((size_t)(t.g0 + g) * H + r) * W + col
                                 : (size_t)-1;
        }
      }
      for (int np = 0; np < g3.npass; ++np) {
        if (d.proj) {
          run_steps<kMF3, kNW3>(acc, sb, st, g3.wg_n, kin, gs,
                                [&](int f, int k, int& key) -> uint32_t {
                                  key = (apix[f] >> 1) & 3;
                                  return apix[f] < 0
                                             ? sb.zero
                                             : sb.xd + k * sb.px_out * 64 +
                                                   apix[f] * 64;
                                });
          if (ovec)
            store_c_vec<T, true>(acc, g3, opix, np, d, cd, x, out);
          else
            store_c_pair<T, true>(acc, g3, opix, np, d, cd, x, out);
        }
        run_steps<kMF3, kNW3>(acc, sb, st, g3.wg_n, kmid, gs,
                              [&](int f, int k, int& key) -> uint32_t {
                                key = (apix[f] >> 1) & 3;
                                return apix[f] < 0
                                           ? sb.zero
                                           : sb.x + k * sb.px_out * 64 +
                                                 apix[f] * 64;
                              });
        if (ovec)
          store_c_vec<T, false>(acc, g3, opix, np, d, c3, x, out);
        else
          store_c_pair<T, false>(acc, g3, opix, np, d, c3, x, out);
      }
    }
  }
  cp_async_wait<0>();
}

template <typename T, int kMF3, int kNW3>
int launch(const void* x, const void* w1, const void* w2, const void* w3,
           Site c1, Site c2, Site c3, Site cd, void* out, const Dims& d,
           int vec, int ovec, cudaStream_t s) {
  const int smem = int8_smem(d).total;
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_int8_kernel<T, kMF3, kNW3>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((d.h + d.tile_rows - 1) / d.tile_rows,
            (d.n + d.images - 1) / d.images);
  bottleneck_int8_kernel<T, kMF3, kNW3><<<grid, kThreads, smem, s>>>(
      (const T*)x, (const int8_t*)w1, (const int8_t*)w2, (const int8_t*)w3,
      c1, c2, c3, cd, (T*)out, d, vec, ovec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w1, const void* w2, const void* w3,
             Site c1, Site c2, Site c3, Site cd, void* out, const Dims& d,
             int vec, int ovec, cudaStream_t s) {
  const bool ok =
      d.cin > 0 && d.cmid > 0 && d.cout > 0 && d.cinp >= d.cin &&
      d.cmidp >= d.cmid && d.coutp >= d.cout && d.cinp % 64 == 0 &&
      (d.wn1 == 1 || d.wn1 == 2) && d.cmidp % (64 * d.wn1) == 0 &&
      (d.wn3 == 1 || d.wn3 == 2 || d.wn3 == 4) &&
      d.coutp % (64 * d.wn3) == 0 && d.tile_rows >= 1 &&
      d.tile_rows <= d.h && d.images >= 1 &&
      (d.images == 1 || d.tile_rows == d.h) && (d.proj || d.cin == d.cout);
  if (!ok || (ovec && d.cout % 8)) return (int)cudaErrorInvalidValue;
  if (d.wn3 == 4)
    return launch<T, 2, 128>(x, w1, w2, w3, c1, c2, c3, cd, out, d, vec,
                             ovec, s);
  return launch<T, 4, 64>(x, w1, w2, w3, c1, c2, c3, cd, out, d, vec, ovec,
                          s);
}

Site site(const void* s, const void* q, const void* b) {
  return Site{(const float*)s, (const float*)q, (const float*)b};
}

}  // namespace

// The shared memory of one block (ops/bottleneck_int8.py _int8_smem).
extern "C" long long bottleneck_int8_smem_bytes(int h, int w, int cinp,
                                                int cmidp, int tile_rows,
                                                int images, int wn1, int wn3,
                                                int proj) {
  Dims d{0, h, w, 0, 0, 0, cinp, cmidp, 0, tile_rows, images, wn1, wn3, proj};
  return (long long)int8_smem(d).total;
}

// One block of the stack: x [n, h*w, cin] and out [n, h*w, cout] in the
// compute dtype (bf16 when bf16, else f32); the weights relaid out as
// bottleneck_int8_kernel reads them (ops/bottleneck_int8.py
// _int8_mma_weights: w3 carries the projection's tiles first on an entry
// block); per site the dequant scale, 1/a and the bias (f32). The
// projection's three pointers are null without one (cin == cout). vec:
// cin % 8 == 0 and x 16-byte aligned (16-byte staging loads); ovec: also
// cout % 8 == 0 and out 16-byte aligned (phase C's 16-byte stores).
extern "C" int bottleneck_int8_block_launch(
    const void* x, const void* w1, const void* s1, const void* q1,
    const void* b1, const void* w2, const void* s2, const void* q2,
    const void* b2, const void* w3, const void* s3, const void* q3,
    const void* b3, const void* sd, const void* qd, const void* bd,
    void* out, int n, int h, int w, int cin, int cmid, int cout, int cinp,
    int cmidp, int coutp, int tile_rows, int images, int wn1, int wn3,
    int proj, int vec, int ovec, int bf16, void* stream) {
  if (n == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
  Dims d{n,     h,     w,         cin,    cmid, cout, cinp,
         cmidp, coutp, tile_rows, images, wn1,  wn3,  proj};
  cudaStream_t s = (cudaStream_t)stream;
  const Site c1 = site(s1, q1, b1), c2 = site(s2, q2, b2),
             c3 = site(s3, q3, b3), cd = site(sd, qd, bd);
  if (bf16)
    return dispatch<__nv_bfloat16>(x, w1, w2, w3, c1, c2, c3, cd, out, d,
                                   vec, ovec, s);
  return dispatch<float>(x, w1, w2, w3, c1, c2, c3, cd, out, d, vec, ovec,
                         s);
}
