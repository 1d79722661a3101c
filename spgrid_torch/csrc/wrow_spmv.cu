// Window-row packed SpMV, y = A @ x with A in DeviceWROW layout.
//
// Replaces: spgrid/ops/pallas/wrow_spmv.py, _kernel / _spmv (v1; the Pallas
// TPU kernel behind `wrow_spmv`, the route of every SpMV under 5 % density:
// per group of 8 pieces, 8 window rows of x, one 128-lane gather, a
// sublane sum and a read-modify-write of one row of the resident y).
//
// Bound on the H100: device-memory bytes. The pieces are read once (128
// int8 columns and 128 f32 values each: ~24 MB at the main path's 65535^2,
// 5 nnz a row), x and y are 0.26 MB each; ~7 us at 3.35 TB/s. Two flops a
// live slot are nothing beside that.
//
// Design: one CTA of 128 threads per 128-row target block, thread t for row
// t of the block. The layout stores a block's groups consecutively
// (group_sub is sorted), so block_ptr points at them; the CTA walks them,
// each thread summing its lane over the 8 pieces of each group, and writes
// its element of y once, 0 for a block with no group. Piece reads are
// coalesced (128 neighbouring columns and values); the x reads are the
// gather. Columns are int8 holding 0..127 and read as unsigned. Pad slots
// (value 0) skip the gather, and so does a slot whose x index lies at or
// past k: x is not padded to the window.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int LANE = 128;
constexpr int GROUP_PIECES = 8;

__global__ void __launch_bounds__(LANE)
wrow_spmv_kernel(const int* __restrict__ block_ptr,
                 const int* __restrict__ piece_w,
                 const unsigned char* __restrict__ cols,
                 const float* __restrict__ vals, const float* __restrict__ x,
                 float* __restrict__ y, int m, int k) {
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  float acc = 0.0f;
  for (int g = block_ptr[b]; g < block_ptr[b + 1]; ++g) {
#pragma unroll
    for (int r = 0; r < GROUP_PIECES; ++r) {
      const size_t p = static_cast<size_t>(g) * GROUP_PIECES + r;
      const float v = vals[p * LANE + t];
      const int xi = piece_w[p] * LANE + cols[p * LANE + t];
      if (v != 0.0f && xi < k) acc = fmaf(v, __ldg(x + xi), acc);
    }
  }
  const long long row = static_cast<long long>(b) * LANE + t;
  if (row < m) y[row] = acc;
}

}  // namespace

extern "C" int spgrid_wrow_spmv(const void* block_ptr, const void* piece_w,
                                const void* cols, const void* vals,
                                const void* x, void* y, int blocks, int m,
                                int k, void* stream) {
  wrow_spmv_kernel<<<blocks, LANE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(block_ptr), static_cast<const int*>(piece_w),
      static_cast<const unsigned char*>(cols),
      static_cast<const float*>(vals), static_cast<const float*>(x),
      static_cast<float*>(y), m, k);
  return static_cast<int>(cudaGetLastError());
}
