// Batched episode matcher: per-class scores [E, Q, N] of Q query features
// against N classes of M support members each, for E episodes at once.
//
// Replaces the Pallas TPU kernel eov_tpu/ops/pallas_similarity.py
// episode_class_scores (_matcher_kernel). Per episode:
//   cosine:    q.s * rsqrt(max(|q|^2, 1e-24)) * rsqrt(max(|s|^2, 1e-24))
//   euclidean: 2 q.s - |q|^2 - |s|^2
// then + (0 for a valid member, -1e30 for a masked one) and the max over
// each class's members, from -inf. Dot products are full f32 FFMA (never
// TF32 or tensor cores): the reference runs them at Precision.HIGHEST
// because near-tie argmaxes flip under reduced-precision inputs.
//
// Bound on the H100: memory. At the protocol's shapes (E=64, Q=5, N=5, M=1,
// D=2048) the function reads ~5.2 MB of features and does ~0.2 GFLOP, so
// the least time is the bytes over 3.35 TB/s (~1.6 us). Design, one pass
// over every byte:
// - A cluster of kCluster blocks (thread block clusters) takes one tile of
//   up to kQT queries of one episode; its blocks split D, so E = 64 puts
//   256 blocks on the 132 SMs. Each thread reads its float4 columns of the
//   tile's query rows and of up to kST support rows at a time, once, and
//   keeps in registers the partial squared norm of every row and the
//   partial dot of every (query, support row) pair (kQT kST + kQT + kST
//   sums; 35 of them used at the protocol shape).
// - The partials are reduced in a fixed order: warp shuffles (halving, so
//   a warp exchanges about as many values as it holds), the block's warps
//   in order through shared memory, then the cluster's blocks in rank order
//   through distributed shared memory by the rank-0 block. No atomics: the
//   scores are the same bits run to run.
// - Rank 0 forms the scores and folds them into each class's max; a class
//   whose members span two support tiles continues from the value its
//   earlier tile stored (same block, tiles in order).
// Cosine is taken as dot * iq * is, the norms coming from the same pass.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 4;          // blocks of one tile, splitting D
constexpr int kQT = 5, kST = 10;     // queries, support rows a tile
constexpr int kV = kQT * kST + kQT + kST;  // partial sums a tile

// The warp's sums of kVP values by halving: at offset o a lane keeps the
// half of its values that its bit o selects and adds its partner's copy of
// that half, so five exchanges of kVP/2 ... kVP/32 values (not five of
// each value) leave lane l the full sums of values 3l, 3l + 1, 3l + 2.
constexpr int kVP = 96;  // kV padded to 32 x 3

template <int kO, int kN>
__device__ __forceinline__ void halve(float (&v)[kVP]) {
  const bool up = threadIdx.x & kO;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const float send = up ? v[i] : v[i + kN];
    const float keep = up ? v[i + kN] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kO);
  }
}

__device__ __forceinline__ void warp_reduce_scatter(float (&v)[kVP]) {
  halve<16, kVP / 2>(v);
  halve<8, kVP / 4>(v);
  halve<4, kVP / 8>(v);
  halve<2, kVP / 16>(v);
  halve<1, kVP / 32>(v);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The partial sums of one tile over this thread's columns: part[qi kST +
// si] the dots, then the kQT query and kST support squared norms. kVec:
// float4 columns (D % 4 == 0, rows 16-byte aligned), else single floats.
template <bool kVec>
__device__ __forceinline__ void tile_partials(const float* __restrict__ q,
                                              const float* __restrict__ s,
                                              int qt, int st, int D,
                                              int first, int stride,
                                              float (&part)[kV]) {
#pragma unroll
  for (int v = 0; v < kV; ++v) part[v] = 0.f;
  const int cols = kVec ? D >> 2 : D;
  for (int c = first; c < cols; c += stride) {
    float4 qv[kQT], sv[kST];
#pragma unroll
    for (int i = 0; i < kQT; ++i) {
      qv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < qt) {
        if (kVec)
          qv[i] = __ldg(reinterpret_cast<const float4*>(q + (size_t)i * D) + c);
        else
          qv[i].x = __ldg(q + (size_t)i * D + c);
      }
    }
#pragma unroll
    for (int i = 0; i < kST; ++i) {
      sv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < st) {
        if (kVec)
          sv[i] = __ldg(reinterpret_cast<const float4*>(s + (size_t)i * D) + c);
        else
          sv[i].x = __ldg(s + (size_t)i * D + c);
      }
    }
#pragma unroll
    for (int i = 0; i < kQT; ++i) {
#pragma unroll
      for (int j = 0; j < kST; ++j)
        part[i * kST + j] = dot4(qv[i], sv[j], part[i * kST + j]);
      part[kQT * kST + i] = dot4(qv[i], qv[i], part[kQT * kST + i]);
    }
#pragma unroll
    for (int j = 0; j < kST; ++j)
      part[kQT * kST + kQT + j] = dot4(sv[j], sv[j], part[kQT * kST + kQT + j]);
  }
}

template <bool kVec>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
episode_scores_kernel(const float* __restrict__ query,
                      const float* __restrict__ support,
                      const float* __restrict__ mask, float* __restrict__ out,
                      int Q, int N, int M, int D, int cosine) {
  __shared__ float red[kWarps][kV];  // the warps' sums
  __shared__ float part[kV];         // this block's sums (read by rank 0)
  __shared__ float tot[kV];          // the cluster's (rank 0)
  __shared__ float sims[kQT][kST];   // masked scores of the tile (rank 0)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int qtiles = (Q + kQT - 1) / kQT;
  const int tile = blockIdx.x / kCluster;
  const int e = tile / qtiles, q0 = (tile - e * qtiles) * kQT;
  const int qt = min(kQT, Q - q0);
  const int NM = N * M;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* q = query + ((size_t)e * Q + q0) * D;
  const float* sbase = support + (size_t)e * NM * D;
  const float* msk = mask + (size_t)e * NM;
  float* o = out + ((size_t)e * Q + q0) * N;

  for (int s0 = 0; s0 < NM; s0 += kST) {
    const int st = min(kST, NM - s0);
    float part_[kV], acc[kVP];
    tile_partials<kVec>(q, sbase + (size_t)s0 * D, qt, st, D,
                        rank * kThreads + threadIdx.x, kCluster * kThreads,
                        part_);
#pragma unroll
    for (int v = 0; v < kVP; ++v) acc[v] = v < kV ? part_[v] : 0.f;
    warp_reduce_scatter(acc);
#pragma unroll
    for (int j = 0; j < kVP / 32; ++j)
      if (3 * lane + j < kV) red[warp][3 * lane + j] = acc[j];
    __syncthreads();
    if (threadIdx.x < kV) {
      float sum = red[0][threadIdx.x];
#pragma unroll
      for (int i = 1; i < kWarps; ++i) sum += red[i][threadIdx.x];
      part[threadIdx.x] = sum;
    }
    cluster.sync();  // every block's part is written
    if (rank == 0) {
      if (threadIdx.x < kV) {
        float sum = part[threadIdx.x];
#pragma unroll
        for (int r = 1; r < kCluster; ++r)
          sum += cluster.map_shared_rank(part, r)[threadIdx.x];
        tot[threadIdx.x] = sum;
      }
      __syncthreads();
      if (threadIdx.x < kQT * kST) {
        const int qi = threadIdx.x / kST, si = threadIdx.x - qi * kST;
        if (qi < qt && si < st) {
          const float dot = tot[threadIdx.x];
          const float qq = tot[kQT * kST + qi];
          const float ss = tot[kQT * kST + kQT + si];
          float sim = cosine ? dot * rsqrtf(fmaxf(qq, 1e-24f)) *
                                   rsqrtf(fmaxf(ss, 1e-24f))
                             : 2.f * dot - qq - ss;
          sim += msk[s0 + si] > 0.f ? 0.f : -1e30f;
          sims[qi][si] = sim;
        }
      }
      __syncthreads();
      // Fold: classes [s0 / M, (s0 + st - 1) / M], one thread per (query,
      // class); a class begun in an earlier tile continues from out.
      const int c0 = s0 / M, nc = (s0 + st - 1) / M - c0 + 1;
      for (int i = threadIdx.x; i < qt * nc; i += kThreads) {
        const int qi = i / nc, c = c0 + (i - qi * nc);
        const int m0 = max(c * M, s0), m1 = min((c + 1) * M, s0 + st);
        float best = m0 == c * M ? -__int_as_float(0x7f800000)  // -inf
                                 : o[(size_t)qi * N + c];
        for (int m = m0; m < m1; ++m) best = fmaxf(best, sims[qi][m - s0]);
        o[(size_t)qi * N + c] = best;
      }
    }
    cluster.sync();  // rank 0 has read every part: the next tile may write
  }
}

}  // namespace

extern "C" int episode_scores_launch(const void* query, const void* support,
                                     const void* mask, void* out, int E, int Q,
                                     int N, int M, int D, int cosine,
                                     int vec, void* stream) {
  if (E > 0 && Q > 0 && N > 0) {
    // A cluster of kCluster blocks per (episode, tile of kQT queries).
    const long long blocks = (long long)E * ((Q + kQT - 1) / kQT) * kCluster;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (vec)
      episode_scores_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
          (const float*)query, (const float*)support, (const float*)mask,
          (float*)out, Q, N, M, D, cosine);
    else
      episode_scores_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
          (const float*)query, (const float*)support, (const float*)mask,
          (float*)out, Q, N, M, D, cosine);
  }
  return (int)cudaGetLastError();
}
