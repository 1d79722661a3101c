// Multi-row packed SpMV, y = A @ x with A in DeviceWPACK layout.
//
// Replaces: spgrid/ops/pallas/wpack_spmv.py, _make_kernel / _spmv, with
// _lane_prefix (the Pallas TPU kernel behind `wpack_spmv`: per group of 8
// pieces, a lane gather from wsel stacked x rows, a lane prefix sum and two
// take_along_axis calls for the segmented row reduce
// P[end] - (P - p)[start], because a TPU vector register cannot be
// scattered into).
//
// Bound on the H100: device-memory bytes. At the main path's 100000^2
// scattered matrix (2.1M nnz) the product needs each nnz's value and int8
// column once plus x and y (~11.3 MB, ~3.4 us at 3.35 TB/s). The pieces
// hold 10x more slots than nnz there (utilization 0.105), each slot 8
// bytes (value, column, sel, start, end), so reading them dominates.
//
// Design: one CTA of 128 threads per 128-row target block walks the
// block's groups (block_ptr; a block's groups are consecutive). For each
// group, thread t puts lane t's product of each of the 8 pieces into
// shared memory; after a barrier, thread r adds lanes starts[r] .. ends[r]
// of each piece, the lanes of its own row (an absent row has start 1, end
// 0 and adds nothing). Segments are disjoint, so no atomics; summing the
// segment directly avoids the cancellation of the prefix difference. Each
// thread writes its element of y once, 0 for a block with no group. Lanes
// whose value is 0 or whose x index, (piece_w + sel) * 128 + col, lies at
// or past k add nothing: x is not padded to the window.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int LANE = 128;
constexpr int GROUP_PIECES = 8;

__global__ void __launch_bounds__(LANE)
wpack_spmv_kernel(const int* __restrict__ block_ptr,
                  const int* __restrict__ piece_w,
                  const unsigned char* __restrict__ cols,
                  const signed char* __restrict__ sel,
                  const signed char* __restrict__ starts,
                  const signed char* __restrict__ ends,
                  const float* __restrict__ vals, const float* __restrict__ x,
                  float* __restrict__ y, int m, int k) {
  __shared__ float prod[GROUP_PIECES][LANE];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  float acc = 0.0f;
  for (int g = block_ptr[b]; g < block_ptr[b + 1]; ++g) {
#pragma unroll
    for (int r = 0; r < GROUP_PIECES; ++r) {
      const size_t p = static_cast<size_t>(g) * GROUP_PIECES + r;
      const size_t q = p * LANE + t;
      const float v = vals[q];
      const int xi = (piece_w[p] + sel[q]) * LANE + cols[q];
      prod[r][t] = (v != 0.0f && xi < k) ? v * __ldg(x + xi) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < GROUP_PIECES; ++r) {
      const size_t q = (static_cast<size_t>(g) * GROUP_PIECES + r) * LANE + t;
      const int e = ends[q];
      for (int l = starts[q]; l <= e; ++l) acc += prod[r][l];
    }
    __syncthreads();  // prod is rewritten by the next group
  }
  const long long row = static_cast<long long>(b) * LANE + t;
  if (row < m) y[row] = acc;
}

}  // namespace

extern "C" int spgrid_wpack_spmv(const void* block_ptr, const void* piece_w,
                                 const void* cols, const void* sel,
                                 const void* starts, const void* ends,
                                 const void* vals, const void* x, void* y,
                                 int blocks, int m, int k, void* stream) {
  wpack_spmv_kernel<<<blocks, LANE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(block_ptr), static_cast<const int*>(piece_w),
      static_cast<const unsigned char*>(cols),
      static_cast<const signed char*>(sel),
      static_cast<const signed char*>(starts),
      static_cast<const signed char*>(ends), static_cast<const float*>(vals),
      static_cast<const float*>(x), static_cast<float*>(y), m, k);
  return static_cast<int>(cudaGetLastError());
}
