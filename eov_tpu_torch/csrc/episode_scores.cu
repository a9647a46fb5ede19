// Batched episode matcher: per-class scores [E, Q, N] of Q query features
// against N classes of M support members each, for E episodes at once.
//
// Replaces the Pallas TPU kernel eov_tpu/ops/pallas_similarity.py
// episode_class_scores (_matcher_kernel). Per episode:
//   cosine:    q and s rows scaled by rsqrt(max(sum x^2, 1e-24)), then q.s
//   euclidean: 2 q.s - |q|^2 - |s|^2
// then + (0 for a valid member, -1e30 for a masked one) and the max over
// each class's members. Dot products are full f32 FFMA (never TF32 or bf16
// tensor cores): the reference runs them at Precision.HIGHEST because
// near-tie argmaxes flip under reduced-precision inputs.
//
// Bound on the H100: memory. At the protocol's shapes (E=64, Q=5, N=5, M=1,
// D=2048) the function reads ~5.2 MB of features and does ~0.2 GFLOP, so
// the least time is the bytes over 3.35 TB/s (~1.6 us). Design: one block
// per episode; its 8 warps first reduce every row's squared norm (one warp
// per row, lanes striding D so loads coalesce), then each warp scores
// (query, class) pairs, re-reading the rows from L1/L2. Nothing round-trips
// to device memory except the [E, Q, N] scores.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
episode_scores_kernel(const float* __restrict__ query,
                      const float* __restrict__ support,
                      const float* __restrict__ mask, float* __restrict__ out,
                      int Q, int N, int M, int D, int cosine) {
  extern __shared__ float smem[];
  const int rows = Q + N * M;
  float* sq = smem;          // [rows] sum of squares
  float* inv = smem + rows;  // [rows] rsqrt(max(sum, 1e-24))
  const int e = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* q = query + (size_t)e * Q * D;
  const float* s = support + (size_t)e * N * M * D;
  const float* msk = mask + (size_t)e * N * M;

  for (int r = warp; r < rows; r += kWarps) {
    const float* v = r < Q ? q + (size_t)r * D : s + (size_t)(r - Q) * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc += v[d] * v[d];
    acc = warp_sum(acc);
    if (lane == 0) {
      sq[r] = acc;
      inv[r] = rsqrtf(fmaxf(acc, 1e-24f));
    }
  }
  __syncthreads();

  for (int pair = warp; pair < Q * N; pair += kWarps) {
    const int qi = pair / N, n = pair - qi * N;
    const float* qv = q + (size_t)qi * D;
    const float iq = inv[qi];
    float best = -__int_as_float(0x7f800000);  // -inf
    for (int m = 0; m < M; ++m) {
      const int r = n * M + m;
      const float* sv = s + (size_t)r * D;
      float dot = 0.f;
      if (cosine) {
        const float is = inv[Q + r];
        for (int d = lane; d < D; d += 32) dot += (qv[d] * iq) * (sv[d] * is);
      } else {
        for (int d = lane; d < D; d += 32) dot += qv[d] * sv[d];
      }
      dot = warp_sum(dot);
      float sim = cosine ? dot : 2.f * dot - sq[qi] - sq[Q + r];
      sim += msk[r] > 0.f ? 0.f : -1e30f;
      best = fmaxf(best, sim);
    }
    if (lane == 0) out[((size_t)e * Q + qi) * N + n] = best;
  }
}

}  // namespace

extern "C" int episode_scores_launch(const void* query, const void* support,
                                     const void* mask, void* out, int E, int Q,
                                     int N, int M, int D, int cosine,
                                     void* stream) {
  if (E > 0 && Q > 0 && N > 0) {
    const size_t smem = sizeof(float) * 2 * (size_t)(Q + N * M);
    episode_scores_kernel<<<E, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)query, (const float*)support, (const float*)mask,
        (float*)out, Q, N, M, D, cosine);
  }
  return (int)cudaGetLastError();
}
