// Gather along one axis of a 2-D f32 array: out = take_along_axis(src, idx,
// axis), with out[i, j] = src[i, idx[i, j]] (axis 1) or src[idx[i, j], j]
// (axis 0).
//
// Replaces: scripts/exp_lanegather.py, try_compile and the kernels it
// compiles (the Pallas TPU probe of which gather forms Mosaic accepts inside
// a kernel: take_along_axis along lanes at widths 128 and 512 and from a
// 3328-wide source, with a broadcast index over 128 rows, along sublanes,
// and a stack of 8 dynamically indexed rows). On the TPU the question was
// whether a form compiles at all; on the card every form is a load from an
// address the thread computes, so one kernel covers all six.
//
// Bound on the H100: device-memory bytes, each input read once and the
// output written once (src, idx and out: at most 0.3 MB at the probe's
// shapes, a fraction of a microsecond at 3.35 TB/s); at these sizes the
// launch, not the bound, sets the time. No arithmetic.
//
// Design: one thread per output element, threads on neighbouring output
// elements, so idx reads and out writes are coalesced; the src read is the
// gather. An index outside src along the axis reads 0, so a bad index never
// faults the card (the plain version raises instead). The result is exact:
// it is a copy.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
lanegather_kernel(const float* __restrict__ src, const int* __restrict__ idx,
                  float* __restrict__ out, int s0, int s1, int i1,
                  size_t total, int axis) {
  const size_t e = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= total) return;
  const size_t i = e / i1;
  const size_t j = e % i1;
  const int g = idx[e];
  float v = 0.0f;
  if (axis == 1) {
    if (g >= 0 && g < s1) v = __ldg(src + i * s1 + g);
  } else if (g >= 0 && g < s0) {
    v = __ldg(src + static_cast<size_t>(g) * s1 + j);
  }
  out[e] = v;
}

}  // namespace

extern "C" int spgrid_lanegather(const void* src, const void* idx, void* out,
                                 int s0, int s1, int i0, int i1, int axis,
                                 void* stream) {
  if (axis != 0 && axis != 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t total = static_cast<size_t>(i0) * i1;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const size_t blocks = (total + THREADS - 1) / THREADS;
  lanegather_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const int*>(idx),
      static_cast<float*>(out), s0, s1, i1, total, axis);
  return static_cast<int>(cudaGetLastError());
}
