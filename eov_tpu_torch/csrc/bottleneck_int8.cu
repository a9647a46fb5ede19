// One stride-1 int8 ResNet bottleneck block, fused: conv1 1x1 -> conv2 3x3
// -> conv3 1x1 + residual (projected on a stage's entry block), every conv
// quantized. The wrapper (ops/bottleneck_int8.py) launches it once per block
// of the stack.
//
// Replaces the Pallas TPU kernel eov_tpu/ops/pallas_bottleneck_int8.py
// fused_bottleneck_stack_int8 (_stack_kernel_int8 / _run_chain_int8). As in
// kernel 2 (bottleneck_stack.cu), one thread block owns TR output rows of
// one image through one block:
//   phase A: conv1 over the TR rows plus a one-row halo above and below,
//            recomputed per tile; its output, after dequant, bias and ReLU,
//            is requantized at conv2's scale straight into shared memory as
//            int8 (a quarter of an f32 tile, half of kernel 2's bf16 one),
//            with a zero column at each edge and zero rows off the image
//            (the 3x3's zero padding);
//   phase B: the 3x3 as one GEMM with K = 9*Cmid reading the 9 taps from
//            that int8 buffer; dequant, bias, ReLU, requantized at conv3's
//            scale into a second int8 tile;
//   phase C: conv3, plus the projection (x requantized at its own scale), or
//            x itself; both dequantized and biased in the compute dtype,
//            summed in it, ReLU, stored.
// Every product is int8 x int8 summed exactly in int32 with __dp4a (four
// products per instruction); operands are packed four to a 32-bit word, so
// Cin and Cmid must be multiples of 4 (the wrapper checks).
//
// Rounding follows the reference chain exactly, so the plain PyTorch version
// gives the same bits: requant is clip(rint(x * inv_a), +-127) (round half
// to even, not roundf); dequant is the int32 sum converted with
// __int2float_rn, multiplied by a*w_scale with __fmul_rn and rounded to the
// compute dtype; the bias (rounded to the compute dtype) and the residual
// are added with __fadd_rn and rounded again. Every multiply and add is an
// explicit _rn intrinsic so nvcc contracts none of them into an FMA.
//
// Bound on the H100: operations. ResNet-50 stage 1 at 256 images is 3.42e11
// int8 ops (multiply-adds x2), 0.173 ms at the 1979 TOPS int8 tensor-core
// peak, against 514 MB of bf16 input and output, 0.153 ms at 3.35 TB/s.
// This first version is the simple, right one: __dp4a on the CUDA cores
// (not the tensor cores), a 128x64 output tile per block with 8x4 outputs
// per thread, conv1 recomputed on the halo rows, and each block's output
// written to device memory between launches (about 1.6 GB more traffic than
// the bound counts). mma/wgmma int8 tiles and a whole-stack launch are the
// way to the bound and are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileP = 128;  // output pixels per GEMM tile (16 x 8 / thread)
constexpr int kTileN = 64;   // output channels per GEMM tile (16 x 4 / thread)
constexpr int kChunkW = 8;   // packed K words (32 int8) per staged chunk
constexpr int kLdA = kChunkW + 1;

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

// clip(round_half_even(v * inv_a), -127, 127).
__device__ __forceinline__ int quant(float v, float inv_a) {
  const float q = rintf(__fmul_rn(v, inv_a));
  return (int)fminf(fmaxf(q, -127.f), 127.f);
}

__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return (int)((unsigned)(a & 0xff) | ((unsigned)(b & 0xff) << 8) |
               ((unsigned)(c & 0xff) << 16) | ((unsigned)(d & 0xff) << 24));
}

// Four channels c..c+3 of a T row, requantized and packed.
template <typename T>
__device__ __forceinline__ int quant4(const T* __restrict__ v, float inv_a) {
  return pack4(quant(to_f(v[0]), inv_a), quant(to_f(v[1]), inv_a),
               quant(to_f(v[2]), inv_a), quant(to_f(v[3]), inv_a));
}

// T(T(acc * scale) + bias_t): dequant rounded to T, then the bias in T.
template <typename T>
__device__ __forceinline__ float dequant_bias(int acc, float scale,
                                              float bias_t) {
  const float y = round_t<T>(__fmul_rn(__int2float_rn(acc), scale));
  return round_t<T>(__fadd_rn(y, bias_t));
}

// acc[i][j] += sum_k A(p, k) * B[k, n0 + c] in int32, for the thread's
// pixels p = ty + 16 i (p < P <= 128) and channels c = 4 tx + j. A is read
// as packed words a_word(p, kw) holding k = 4kw .. 4kw+3 (KW words); B is
// int8 row-major [4 KW][ldb].
template <typename AFn>
__device__ __forceinline__ void block_gemm(int (&acc)[8][4], int P, int KW,
                                           AFn a_word,
                                           const int8_t* __restrict__ B,
                                           int ldb, int n_cols, int n0,
                                           int* As, int* Bs) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  for (int k0 = 0; k0 < KW; k0 += kChunkW) {
    for (int e = tid; e < kTileP * kChunkW; e += kThreads) {
      const int p = e / kChunkW, kk = e % kChunkW, kw = k0 + kk;
      As[p * kLdA + kk] = (p < P && kw < KW) ? a_word(p, kw) : 0;
    }
    for (int e = tid; e < kChunkW * kTileN; e += kThreads) {
      const int kk = e / kTileN, c = e % kTileN;
      const int kw = k0 + kk, n = n0 + c;
      int v = 0;
      if (kw < KW && n < n_cols) {
        const int8_t* b = B + (size_t)(4 * kw) * ldb + n;
        v = pack4(b[0], b[ldb], b[2 * ldb], b[3 * ldb]);
      }
      Bs[e] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunkW; ++kk) {
      const int4 b = *reinterpret_cast<const int4*>(&Bs[kk * kTileN + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int a = As[(ty + 16 * i) * kLdA + kk];
        acc[i][0] = __dp4a(a, b.x, acc[i][0]);
        acc[i][1] = __dp4a(a, b.y, acc[i][1]);
        acc[i][2] = __dp4a(a, b.z, acc[i][2]);
        acc[i][3] = __dp4a(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(int (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
}

struct Dims {
  int n, h, w, cin, cmid, cout, tile_rows;
};

// One conv site's parameters: int8 weights, dequant scale a*w_scale [Cout],
// requant multiplier 1/a [1], bias [Cout] (f32).
struct Site {
  const int8_t* w;
  const float* s;
  const float* q;
  const float* b;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
bottleneck_int8_kernel(const T* __restrict__ x, Site c1, Site c2, Site c3,
                       Site cd, T* __restrict__ out, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = d.w, H = d.h, cin = d.cin, cmid = d.cmid, cout = d.cout;
  const int TR = d.tile_rows;
  const int img = blockIdx.y;
  const int r0 = blockIdx.x * TR;
  const int rows = min(TR, H - r0);  // output rows of this tile
  const int halo_rows = rows + 2;
  const int ldy1 = W + 2;            // halo buffer pixels per row

  int* As = reinterpret_cast<int*>(smem_raw);
  int* Bs = As + kTileP * kLdA;
  int8_t* y1s = reinterpret_cast<int8_t*>(Bs + kChunkW * kTileN);
  int8_t* y2s = y1s + (size_t)(TR + 2) * ldy1 * cmid;  // [TR*W][cmid]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const T* ximg = x + (size_t)img * H * W * cin;
  const float inv1 = c1.q[0], inv2 = c2.q[0], inv3 = c3.q[0];

  // Zero padding of the 3x3 (in the int8 domain, as the reference's zeroed
  // pad scratch): edge columns and off-image rows stay zero.
  int* y1w = reinterpret_cast<int*>(y1s);
  for (int e = tid; e < halo_rows * ldy1 * cmid / 4; e += kThreads) y1w[e] = 0;
  __syncthreads();

  int acc[8][4];

  // Phase A: y1q = quant(relu(T(T(xq w1 * s1) + T(b1))), inv2) on the halo.
  const int halo_px = halo_rows * W;
  for (int pb = 0; pb < halo_px; pb += kTileP) {
    const int P = min(kTileP, halo_px - pb);
    for (int n0 = 0; n0 < cmid; n0 += kTileN) {
      zero(acc);
      block_gemm(
          acc, P, cin / 4,
          [&](int p, int kw) {
            const int hp = pb + p, row = r0 - 1 + hp / W;
            if (row < 0 || row >= H) return 0;
            return quant4(ximg + ((size_t)row * W + hp % W) * cin + 4 * kw,
                          inv1);
          },
          c1.w, cmid, cmid, n0, As, Bs);
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
          const float y = fmaxf(
              dequant_bias<T>(acc[i][j], c1.s[c], round_t<T>(c1.b[c])), 0.f);
          y1s[((size_t)lr * ldy1 + col + 1) * cmid + c] = (int8_t)quant(y, inv2);
        }
      }
    }
  }
  __syncthreads();

  // Phase B: y2q = quant(relu(T(T(conv3x3(y1q) * s2) + T(b2))), inv3).
  const int P = rows * W;
  for (int n0 = 0; n0 < cmid; n0 += kTileN) {
    zero(acc);
    block_gemm(
        acc, P, 9 * cmid / 4,
        [&](int p, int kw) {
          const int k = 4 * kw;
          const int tap = k / cmid, ci = k - tap * cmid;
          const int ky = tap / 3, kx = tap - ky * 3;
          const int lr = p / W, col = p - lr * W;
          return *reinterpret_cast<const int*>(
              &y1s[((size_t)(lr + ky) * ldy1 + col + kx) * cmid + ci]);
        },
        c2.w, cmid, cmid, n0, As, Bs);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty + 16 * i;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + tx * 4 + j;
        if (c >= cmid) continue;
        const float y = fmaxf(
            dequant_bias<T>(acc[i][j], c2.s[c], round_t<T>(c2.b[c])), 0.f);
        y2s[(size_t)p * cmid + c] = (int8_t)quant(y, inv3);
      }
    }
  }
  __syncthreads();

  // Phase C: out = relu(T(y3 + r)), y3 = T(T(y2q w3 * s3) + T(b3)) and r the
  // projection T(T(quant(x) wd * sd) + T(bd)) or x.
  const T* xtile = ximg + (size_t)r0 * W * cin;
  T* otile = out + ((size_t)img * H * W + (size_t)r0 * W) * cout;
  const bool proj = cd.w != nullptr;
  const float invd = proj ? cd.q[0] : 0.f;
  for (int n0 = 0; n0 < cout; n0 += kTileN) {
    int res[8][4];
    zero(res);
    if (proj) {
      block_gemm(
          res, P, cin / 4,
          [&](int p, int kw) {
            return quant4(xtile + (size_t)p * cin + 4 * kw, invd);
          },
          cd.w, cout, cout, n0, As, Bs);
    }
    zero(acc);
    block_gemm(
        acc, P, cmid / 4,
        [&](int p, int kw) {
          return *reinterpret_cast<const int*>(&y2s[(size_t)p * cmid + 4 * kw]);
        },
        c3.w, cout, cout, n0, As, Bs);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty + 16 * i;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + tx * 4 + j;
        if (c >= cout) continue;
        const float y3 =
            dequant_bias<T>(acc[i][j], c3.s[c], round_t<T>(c3.b[c]));
        const float r =
            proj ? dequant_bias<T>(res[i][j], cd.s[c], round_t<T>(cd.b[c]))
                 : to_f(xtile[(size_t)p * cin + c]);
        otile[(size_t)p * cout + c] =
            from_f<T>(fmaxf(round_t<T>(__fadd_rn(y3, r)), 0.f));
      }
    }
  }
}

size_t smem_bytes(const Dims& d) {
  return sizeof(int) * (kTileP * kLdA + kChunkW * kTileN) +
         (size_t)(d.tile_rows + 2) * (d.w + 2) * d.cmid +
         (size_t)d.tile_rows * d.w * d.cmid;
}

template <typename T>
int launch(const void* x, Site c1, Site c2, Site c3, Site cd, void* out,
           Dims d, cudaStream_t s) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_int8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((d.h + d.tile_rows - 1) / d.tile_rows, d.n);
  bottleneck_int8_kernel<T><<<grid, kThreads, smem, s>>>(
      (const T*)x, c1, c2, c3, cd, (T*)out, d);
  return (int)cudaGetLastError();
}

Site site(const void* w, const void* s, const void* q, const void* b) {
  return Site{(const int8_t*)w, (const float*)s, (const float*)q,
              (const float*)b};
}

}  // namespace

extern "C" long long bottleneck_int8_smem_bytes(int w, int cmid,
                                                int tile_rows) {
  Dims d{0, 0, w, 0, cmid, 0, tile_rows};
  return (long long)smem_bytes(d);
}

// The projection's four pointers may be null (identity residual, requires
// cin == cout).
extern "C" int bottleneck_int8_block_launch(
    const void* x, const void* w1, const void* s1, const void* q1,
    const void* b1, const void* w2, const void* s2, const void* q2,
    const void* b2, const void* w3, const void* s3, const void* q3,
    const void* b3, const void* wd, const void* sd, const void* qd,
    const void* bd, void* out, int n, int h, int w, int cin, int cmid,
    int cout, int tile_rows, int bf16, void* stream) {
  if (n == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
  Dims d{n, h, w, cin, cmid, cout, tile_rows};
  cudaStream_t s = (cudaStream_t)stream;
  const Site c1 = site(w1, s1, q1, b1), c2 = site(w2, s2, q2, b2),
             c3 = site(w3, s3, q3, b3), cd = site(wd, sd, qd, bd);
  if (bf16) return launch<__nv_bfloat16>(x, c1, c2, c3, cd, out, d, s);
  return launch<float>(x, c1, c2, c3, cd, out, d, s);
}
