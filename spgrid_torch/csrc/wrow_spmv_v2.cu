// Window-row packed SpMV, variant v2: y = A @ x with A in DeviceWROW layout,
// walking the group stream with a carried accumulator.
//
// Replaces: spgrid/ops/pallas/wrow_spmv.py, _kernel_v2 / _spmv_v2 (the
// Pallas TPU kernel behind `wrow_spmv(..., variant="v2")`: one (8, 128)
// accumulator carried across groups and grid steps, flushed into y at each
// change of target block).
//
// Bound on the H100: device-memory bytes, as v1 (wrow_spmv.cu): each nnz's
// value and int8 column once plus x and y (~11.3 MB, ~3.4 us at 3.35 TB/s
// at the 100000^2 scattered matrix); the pieces hold ~40x more slots than
// nnz there (utilization 0.025), so reading them sets the time.
//
// Design: what v2 does differently from v1 is the work split. v1 gives
// each 128-row target block one CTA, however many groups it has; v2 gives
// each CTA an equal contiguous range of `groups_per_cta` groups. Thread t
// of a CTA walks lane t of its groups with one accumulator in a register
// and flushes it at each change of target block. A block whose groups all
// lie in the range is written to y at its flush. A block that straddles
// range boundaries leaves one partial sum per range in a carry buffer
// (slot 1 of a range it continues past, slot 0 of the range where it
// ends), and a second kernel, one CTA per block, adds those partials in
// range order and writes y, or 0 for a block with no group. No atomics:
// the result does not depend on scheduling. Pad slots (value 0) and slots
// whose x index is at or past k skip the gather: x is not padded.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int LANE = 128;
constexpr int GROUP_PIECES = 8;

__global__ void __launch_bounds__(LANE)
wrow_v2_walk(const int* __restrict__ group_sub,
             const int* __restrict__ block_ptr,
             const int* __restrict__ piece_w,
             const unsigned char* __restrict__ cols,
             const float* __restrict__ vals, const float* __restrict__ x,
             float* __restrict__ y, float* __restrict__ carry, int num_groups,
             int groups_per_cta, int m, int k) {
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int g0 = c * groups_per_cta;
  const int g1 = min(g0 + groups_per_cta, num_groups);
  // run of the open block within this range: flush its sum
  auto flush = [&](int sub, float acc) {
    const int first = block_ptr[sub];
    const int last = block_ptr[sub + 1];
    if (first >= g0 && last <= g1) {
      const long long row = static_cast<long long>(sub) * LANE + t;
      if (row < m) y[row] = acc;
    } else {
      carry[(static_cast<size_t>(c) * 2 + (last > g1 ? 1 : 0)) * LANE + t] =
          acc;
    }
  };
  int open = group_sub[g0];
  float acc = 0.0f;
  for (int g = g0; g < g1; ++g) {
    const int sub = group_sub[g];
    if (sub != open) {
      flush(open, acc);
      open = sub;
      acc = 0.0f;
    }
#pragma unroll
    for (int r = 0; r < GROUP_PIECES; ++r) {
      const size_t p = static_cast<size_t>(g) * GROUP_PIECES + r;
      const float v = vals[p * LANE + t];
      const int xi = piece_w[p] * LANE + cols[p * LANE + t];
      if (v != 0.0f && xi < k) acc = fmaf(v, __ldg(x + xi), acc);
    }
  }
  flush(open, acc);
}

__global__ void __launch_bounds__(LANE)
wrow_v2_combine(const int* __restrict__ block_ptr,
                const float* __restrict__ carry, float* __restrict__ y,
                int groups_per_cta, int m) {
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const long long row = static_cast<long long>(b) * LANE + t;
  const int first = block_ptr[b];
  const int last = block_ptr[b + 1];
  float acc = 0.0f;
  if (first < last) {
    const int c0 = first / groups_per_cta;
    const int c1 = (last - 1) / groups_per_cta;
    if (c0 == c1) return;  // inside one range: the walk wrote it
    for (int c = c0; c < c1; ++c) acc += carry[(static_cast<size_t>(c) * 2 + 1) * LANE + t];
    acc += carry[static_cast<size_t>(c1) * 2 * LANE + t];
  }
  if (row < m) y[row] = acc;
}

}  // namespace

extern "C" int spgrid_wrow_spmv_v2(const void* group_sub,
                                   const void* block_ptr, const void* piece_w,
                                   const void* cols, const void* vals,
                                   const void* x, void* y, void* carry,
                                   int num_groups, int groups_per_cta,
                                   int blocks, int m, int k, void* stream) {
  if (groups_per_cta <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ctas = (num_groups + groups_per_cta - 1) / groups_per_cta;
  if (ctas > 0) {
    wrow_v2_walk<<<ctas, LANE, 0, s>>>(
        static_cast<const int*>(group_sub), static_cast<const int*>(block_ptr),
        static_cast<const int*>(piece_w),
        static_cast<const unsigned char*>(cols),
        static_cast<const float*>(vals), static_cast<const float*>(x),
        static_cast<float*>(y), static_cast<float*>(carry), num_groups,
        groups_per_cta, m, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  wrow_v2_combine<<<blocks, LANE, 0, s>>>(
      static_cast<const int*>(block_ptr), static_cast<const float*>(carry),
      static_cast<float*>(y), groups_per_cta, m);
  return static_cast<int>(cudaGetLastError());
}
