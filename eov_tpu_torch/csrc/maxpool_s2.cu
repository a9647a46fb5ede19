// The stem's 3x3 / stride-2 / pad-1 max-pool of a non-negative NHWC map
// (kernel 6): [N, H, W, C] -> [N, H/2, W/2, C], H and W even.
//
// Replaces the Pallas TPU kernel eov_tpu/ops/pallas_pool.py
// maxpool_3x3_s2_nonneg (_pool_kernel / pool_lane_folded). The TPU kernel
// folds x-pairs onto the 128 lanes and shifts rows on the untiled axis so
// that neither stride-2 axis needs a strided access; a GPU thread reads
// strided addresses for free, so here each thread owns one output pixel and
// V consecutive channels (V = 16 bytes of T when C allows it, else 1) and
// reads the nine taps straight from the NHWC map with stride-2 addressing:
// one 16-byte load per tap, neighbouring threads on neighbouring channels.
//
// Padding is 0, as in the TPU kernel: exact against nn.MaxPool2d(3, 2, 1)'s
// -inf pad because the stem map is post-ReLU (input >= 0). The contract is
// the caller's and is not checked (nor is it by the reference). A NaN tap
// is dropped by fmaxf; the plain version would keep it (outside the
// contract). Each channel goes through the same fmaxf sequence as
// pool3x3s2_at, which kernel 5 uses, so the two give the same values.
//
// Bound on the H100: bytes. Max is no arithmetic; every input byte is read
// once and every output byte written once: at 256 images of 112x112x64
// bf16, (112^2 + 56^2) * 64 * 2 B * 256 = 514 MB, 0.153 ms at 3.35 TB/s.
// The three rows of a window overlap the next window's by one, so each input
// byte is fetched ~2.25 times from L1/L2 but once from device memory.

#include "tile_gemm.cuh"

namespace {

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
maxpool_s2_kernel(const T* __restrict__ x, T* __restrict__ out, int n, int h,
                  int w, int c) {
  const int ho = h / 2, wo = w / 2, cv = c / V;
  const size_t total = (size_t)n * ho * wo * cv;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int k = (int)(i % cv) * V;
    size_t pix = i / cv;
    const int oc = (int)(pix % wo);
    pix /= wo;
    const int orow = (int)(pix % ho);
    const size_t img = pix / ho;
    const T* base = x + img * h * w * c;
    auto tap = [&](int y, int xx) {
      return *reinterpret_cast<const Vec<T, V>*>(
          base + ((size_t)y * w + xx) * c + k);
    };
    float m[V];
    const Vec<T, V> center = tap(2 * orow, 2 * oc);
#pragma unroll
    for (int j = 0; j < V; ++j) m[j] = to_f(center.v[j]);
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      const int y = 2 * orow + dy;
      if (y < 0) continue;
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int xx = 2 * oc + dx;
        if (xx < 0 || (dy == 0 && dx == 0)) continue;
        const Vec<T, V> t = tap(y, xx);
#pragma unroll
        for (int j = 0; j < V; ++j) m[j] = fmaxf(m[j], to_f(t.v[j]));
      }
    }
    const bool pad = orow == 0 || oc == 0;
    Vec<T, V> o;
#pragma unroll
    for (int j = 0; j < V; ++j) o.v[j] = from_f<T>(pad ? fmaxf(m[j], 0.f) : m[j]);
    *reinterpret_cast<Vec<T, V>*>(out + i * V) = o;
  }
}

template <typename T, int V>
int launch(const void* x, void* out, int n, int h, int w, int c,
           cudaStream_t s) {
  const size_t total = (size_t)n * (h / 2) * (w / 2) * (c / V);
  const size_t blocks = (total + kThreads - 1) / kThreads;
  const int grid = (int)(blocks < 65535 * 32 ? blocks : 65535 * 32);
  maxpool_s2_kernel<T, V><<<grid, kThreads, 0, s>>>((const T*)x, (T*)out, n,
                                                    h, w, c);
  return (int)cudaGetLastError();
}

}  // namespace

// x [n, h, w, c] contiguous, h and w even; out [n, h/2, w/2, c]. Both
// pointers 16-byte aligned when the vector path is taken (c * sizeof(T) a
// multiple of 16; torch allocations are).
extern "C" int maxpool_s2_launch(const void* x, void* out, int n, int h,
                                 int w, int c, int bf16, void* stream) {
  if (n == 0 || h == 0 || w == 0 || c == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return c % 8 == 0 ? launch<__nv_bfloat16, 8>(x, out, n, h, w, c, s)
                      : launch<__nv_bfloat16, 1>(x, out, n, h, w, c, s);
  return c % 4 == 0 ? launch<float, 4>(x, out, n, h, w, c, s)
                    : launch<float, 1>(x, out, n, h, w, c, s);
}
