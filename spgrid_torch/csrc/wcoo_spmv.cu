// Aligned-slot SpMV, y = A @ x with A in DeviceWCOOAligned layout.
//
// Replaces: spgrid/ops/pallas/wcoo_spmv.py, _kernel / _spmv (the Pallas TPU
// kernel behind `wcoo_spmv`: per (8, 128) group one gather of the
// superwindow's 8 x rows, a sublane sum and an add into one row of the
// resident y).
//
// Bound on the H100: device-memory bytes: each group is read once (1024
// int8 columns and 1024 f32 values), x and y once; products are nothing
// beside that.
//
// Design: one CTA of 128 threads per 128-row target block, thread t for row
// t of the block (lane t of every group is row t). The packer sorts groups
// by target block, so block_ptr points at a block's groups; the CTA walks
// them, each thread summing slot (w, t) of each group against
// x[1024 sw + 128 w + col], and writes its element of y once, 0 for a block
// with no group. Columns are int8 holding 0..127 and read as unsigned. Empty
// slots (value 0) skip the gather, and so does a slot whose x index lies at
// or past k: x is not padded to the superwindow.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int LANE = 128;
constexpr int GROUP_ROWS = 8;                    // windows of a superwindow
constexpr int SUPERWINDOW = GROUP_ROWS * LANE;   // columns of x

__global__ void __launch_bounds__(LANE)
wcoo_spmv_kernel(const int* __restrict__ block_ptr,
                 const int* __restrict__ g_sw,
                 const unsigned char* __restrict__ cols,
                 const float* __restrict__ vals, const float* __restrict__ x,
                 float* __restrict__ y, int m, int k) {
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  float acc = 0.0f;
  for (int g = block_ptr[b]; g < block_ptr[b + 1]; ++g) {
    const int xbase = g_sw[g] * SUPERWINDOW;
#pragma unroll
    for (int w = 0; w < GROUP_ROWS; ++w) {
      const size_t e = (static_cast<size_t>(g) * GROUP_ROWS + w) * LANE + t;
      const float v = vals[e];
      const int xi = xbase + w * LANE + cols[e];
      if (v != 0.0f && xi < k) acc = fmaf(v, __ldg(x + xi), acc);
    }
  }
  const long long row = static_cast<long long>(b) * LANE + t;
  if (row < m) y[row] = acc;
}

}  // namespace

extern "C" int spgrid_wcoo_spmv(const void* block_ptr, const void* g_sw,
                                const void* cols, const void* vals,
                                const void* x, void* y, int blocks, int m,
                                int k, void* stream) {
  wcoo_spmv_kernel<<<blocks, LANE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(block_ptr), static_cast<const int*>(g_sw),
      static_cast<const unsigned char*>(cols),
      static_cast<const float*>(vals), static_cast<const float*>(x),
      static_cast<float*>(y), m, k);
  return static_cast<int>(cudaGetLastError());
}
