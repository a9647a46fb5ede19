// TSM's temporal shift and its adjoint (Lin, Gan, Han 2019,
// arXiv:1811.08383) over channels_last frames, for tsm_nl_resnet50.
//
// Replaces no TPU kernel: the JAX package has no temporal model. The shift
// is a copy with a per-channel frame offset (ops/temporal_shift.py gives the
// equations), so it is bound by bytes: every element of x is read once and
// every element of y written once. At 128 frames of 56x56x256 bf16 (ResNet-50
// stage 1's block input) that is 2 * 205.5 MB, 0.123 ms at 3.35 TB/s.
//
// The data are never looked at as numbers, so one kernel serves every dtype
// and is bit-equal to the plain version. A frame is h*w pixels of c
// channels; the channel ranges [0, fold) and [fold, 2 fold) read the next
// and the previous frame of their clip (swapped by `reverse`, the adjoint),
// the rest the same frame; a source outside the clip reads zero. Each thread
// moves units of V bytes (16 where the row, the fold and both pointers
// allow, as they do for bf16 and f32 at c a multiple of 64), neighbouring
// threads neighbouring units, so loads and stores are whole 16-byte
// transactions. Blocks walk frames along y, so a frame's position in its
// clip is one modulo per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename V>
__global__ void __launch_bounds__(kThreads)
temporal_shift_kernel(const V* __restrict__ x, V* __restrict__ y, int frames,
                      int t_len, int frame_units, int row_units,
                      int fold_units, int reverse) {
  const int ahead = reverse ? -1 : 1;  // the offset of [0, fold)
  for (int f = blockIdx.y; f < frames; f += gridDim.y) {
    const int t = f % t_len;
    const size_t base = (size_t)f * frame_units;
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < frame_units;
         j += gridDim.x * blockDim.x) {
      const int c = j % row_units;
      const int dt = c < fold_units ? ahead
                     : c < 2 * fold_units ? -ahead : 0;
      const int ts = t + dt;
      V v{};
      if (ts >= 0 && ts < t_len)
        v = x[base + (ptrdiff_t)dt * frame_units + j];
      y[base + j] = v;
    }
  }
}

template <typename V>
int launch(const void* x, void* y, int frames, int t_len, int pixels,
           int row_bytes, int fold_bytes, int reverse, cudaStream_t s) {
  const int row_units = row_bytes / (int)sizeof(V);
  const int frame_units = pixels * row_units;
  const int per_frame = (frame_units + kThreads - 1) / kThreads;
  const dim3 grid(per_frame < 1024 ? per_frame : 1024,
                  frames < 65535 ? frames : 65535);
  temporal_shift_kernel<V><<<grid, kThreads, 0, s>>>(
      (const V*)x, (V*)y, frames, t_len, frame_units, row_units,
      fold_bytes / (int)sizeof(V), reverse);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y [frames, pixels, c] contiguous (channels_last), elements of esize
// bytes; frames a multiple of t_len; 2 * fold <= c. y = the shift of x, or
// with reverse its adjoint.
extern "C" int temporal_shift_launch(const void* x, void* y, int frames,
                                     int t_len, int pixels, int c, int fold,
                                     int esize, int reverse, void* stream) {
  if (frames == 0 || pixels == 0 || c == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int row = c * esize, fb = fold * esize;
  const uintptr_t addr = (uintptr_t)x | (uintptr_t)y;
  auto fits = [&](int v) {
    return row % v == 0 && fb % v == 0 && addr % v == 0;
  };
  if (fits(16))
    return launch<uint4>(x, y, frames, t_len, pixels, row, fb, reverse, s);
  if (fits(8))
    return launch<uint2>(x, y, frames, t_len, pixels, row, fb, reverse, s);
  if (fits(4))
    return launch<uint32_t>(x, y, frames, t_len, pixels, row, fb, reverse,
                            s);
  if (fits(2))
    return launch<uint16_t>(x, y, frames, t_len, pixels, row, fb, reverse,
                            s);
  return launch<uint8_t>(x, y, frames, t_len, pixels, row, fb, reverse, s);
}
