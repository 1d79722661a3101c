// WROW SpMV group-body ablation: five variants of the WROW v1 kernel, each
// with one stage of the group body deleted, for timing where a group's time
// goes. Only "full" computes y = A @ x; the others are wrong by design.
//
// Replaces: scripts/exp_spmv_ablate.py, _kernel / _spmv_variant (the Pallas
// TPU probe that deleted one stage of the WROW group body at a time: the
// x-row loads, the lane gather, the y read-modify-write).
//
// For piece p of group g, its index r in the group, w = piece_w[p],
// c = cols[p, t] (unsigned), v = values[p, t] and b = the group's target
// block, thread t adds
//
//   full      v * x[128 w + c]   to y[128 b + t]   (WROW v1's arithmetic)
//   nogather  v * x[128 w + t]   to y[128 b + t]   (no scatter in a window)
//   noload    v * x[128 r + c]   to y[128 b + t]   (1,024 fixed x entries)
//   normw     v * x[128 w + c]   to y[t]           (rows 0..127 only)
//   empty     v                  to y[t]           (values streamed only)
//
// An x index at or past k reads 0 (x is not padded to whole windows), and
// as in v1 a slot whose value is 0 reads no x.
//
// Bound on the H100: device-memory bytes. At the probe's 100000^2 matrix
// (2,095,859 nnz) the product needs each nnz's value and column (5 bytes)
// and x and y once: 11.28 MB, ~3.4 us at 3.35 TB/s. The layout streams all
// of its 113,944 pieces of 128 slots (72.9 MB, utilization 0.14), so a
// kernel that reads every slot cannot beat ~22 us, and the values alone
// (58.3 MB) take ~17 us: the floor of "empty".
//
// Design: v1's own (csrc/wrow_spmv.cu): one CTA of 128 threads per 128-row
// target block, thread t for lane t, the block's groups walked in order and
// the sum kept in a register; the variant is a template parameter, so each
// variant is v1 with one stage compiled out. On this design what each
// variant removes is: nogather the scattered access within a window, noload
// the x traffic (its 1,024 entries stay in L1), normw only the final write
// (v1 has no per-group read-modify-write: a control), empty everything but
// streaming the values. normw and empty sum across CTAs: the wrapper zeroes
// y and each thread adds its sum to y[t] once with atomicAdd, in an order
// that changes from run to run.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int LANE = 128;
constexpr int GROUP_PIECES = 8;

enum Variant { FULL = 0, NOGATHER = 1, NOLOAD = 2, NORMW = 3, EMPTY = 4 };

template <int V>
__global__ void __launch_bounds__(LANE)
spmv_ablate_kernel(const int* __restrict__ block_ptr,
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
      if (V == EMPTY) {
        acc += v;
        continue;
      }
      int xi;
      if (V == NOGATHER) {
        xi = piece_w[p] * LANE + t;
      } else if (V == NOLOAD) {
        xi = r * LANE + cols[p * LANE + t];
      } else {
        xi = piece_w[p] * LANE + cols[p * LANE + t];
      }
      if (v != 0.0f && xi < k) acc = fmaf(v, __ldg(x + xi), acc);
    }
  }
  if (V == NORMW || V == EMPTY) {
    if (t < m) atomicAdd(y + t, acc);
  } else {
    const long long row = static_cast<long long>(b) * LANE + t;
    if (row < m) y[row] = acc;
  }
}

template <int V>
void launch(const void* block_ptr, const void* piece_w, const void* cols,
            const void* vals, const void* x, void* y, int blocks, int m,
            int k, cudaStream_t stream) {
  spmv_ablate_kernel<V><<<blocks, LANE, 0, stream>>>(
      static_cast<const int*>(block_ptr), static_cast<const int*>(piece_w),
      static_cast<const unsigned char*>(cols),
      static_cast<const float*>(vals), static_cast<const float*>(x),
      static_cast<float*>(y), m, k);
}

}  // namespace

extern "C" int spgrid_spmv_ablate(const void* block_ptr, const void* piece_w,
                                  const void* cols, const void* vals,
                                  const void* x, void* y, int variant,
                                  int blocks, int m, int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case FULL:
      launch<FULL>(block_ptr, piece_w, cols, vals, x, y, blocks, m, k, s);
      break;
    case NOGATHER:
      launch<NOGATHER>(block_ptr, piece_w, cols, vals, x, y, blocks, m, k, s);
      break;
    case NOLOAD:
      launch<NOLOAD>(block_ptr, piece_w, cols, vals, x, y, blocks, m, k, s);
      break;
    case NORMW:
      launch<NORMW>(block_ptr, piece_w, cols, vals, x, y, blocks, m, k, s);
      break;
    case EMPTY:
      launch<EMPTY>(block_ptr, piece_w, cols, vals, x, y, blocks, m, k, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
