// Window-row packed SpMV, y = A @ x with A in DeviceWROW layout.
//
// Replaces: spgrid/ops/pallas/wrow_spmv.py, _kernel / _spmv (v1; the Pallas
// TPU kernel behind `wrow_spmv`, the route of every SpMV under 5 % density:
// per group of 8 pieces, 8 window rows of x, one 128-lane gather, a
// sublane sum and a read-modify-write of one row of the resident y).
//
// Bound on the H100: device-memory bytes. The padded pieces are mostly
// empty (2.5 % full at the 100000^2 scattered matrix: ~423 MB of slots for
// 2.1M nnz), so the kernel reads the layout's row-ordered live-slot stream
// (DeviceWROW.row_*, built on the host): each live slot's f32 value and
// int32 x index, 8 bytes, ~17 MB there, ~3.6 MB at the 65535^2
// hypersparse one; with x, y and the row pointer ~5.5 us at 3.35 TB/s.
// Two flops a slot are nothing beside that; each slot's x read is a
// gather, mostly from L2.
//
// Design: v1's grid, one CTA of 128 threads per 128-row target block,
// thread t for row t of the block, which it writes once (0 for a row with
// no live slot): no atomics, no second launch. The stream holds a row's
// live slots contiguously in piece order, the order in which the padded
// kernel summed the row, and thread t sums them in that order with fmaf
// from 0.0f, so y has the padded kernel's bits. Each warp stages its 32
// rows in rounds of DEPTH slots a row through shared memory: for each of
// its rows in turn the warp reads the row's next DEPTH values and x
// indices, lane j slot j (128 bytes of each, coalesced), gathers x for
// them and stores value and x side by side at the row's place; then each
// lane sums its own row's slots of the round. The rounds of a warp are as
// many as its longest row needs, so a row of thousands of slots runs in
// rounds beside the warp's other rows, all 32 lanes loading, and shared
// memory holds one round whatever the block's size; a row with no slot
// left in a round loads nothing there. Slots whose value is 0 or whose x
// index lies at or past k (x is not padded to the window) are not in the
// stream.
#include <cuda_runtime.h>

namespace {

constexpr int LANE = 128;         // rows of a target block, threads a CTA
constexpr int WARPS = LANE / 32;
constexpr int DEPTH = 32;         // slots of each row a round stages
constexpr int LD = DEPTH + 1;     // a row's stride in shared memory
constexpr int UNROLL = 16;        // rows whose loads are in flight together
static_assert(DEPTH == 32, "a round stages one slot a lane of each row");

__global__ void __launch_bounds__(LANE)
wrow_spmv_kernel(const int* __restrict__ row_slot,
                 const float* __restrict__ vals,
                 const int* __restrict__ cols, const float* __restrict__ x,
                 float* __restrict__ y, int m) {
  __shared__ float staged_v[WARPS][32 * LD];
  __shared__ float staged_x[WARPS][32 * LD];
  const int lane = threadIdx.x % 32;
  float* sv = staged_v[threadIdx.x / 32];
  float* sx = staged_x[threadIdx.x / 32];
  const long long row = static_cast<long long>(blockIdx.x) * LANE +
                        threadIdx.x;
  int begin = 0;
  int len = 0;
  if (row < m) {
    begin = row_slot[row];
    len = row_slot[row + 1] - begin;
  }
  const int rounds =
      (__reduce_max_sync(0xffffffffu, len) + DEPTH - 1) / DEPTH;
  float acc = 0.0f;
  for (int i = 0; i < rounds; ++i) {
    const int at = i * DEPTH + lane;  // this lane's slot of each row
    for (int q0 = 0; q0 < 32; q0 += UNROLL) {
      float v[UNROLL] = {}, xv[UNROLL] = {};
      int c[UNROLL] = {};
      bool live[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int q_begin = __shfl_sync(0xffffffffu, begin, q0 + u);
        live[u] = at < __shfl_sync(0xffffffffu, len, q0 + u);
        if (live[u]) {
          v[u] = __ldg(vals + q_begin + at);
          c[u] = __ldg(cols + q_begin + at);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (live[u]) xv[u] = __ldg(x + c[u]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (live[u]) {
          sv[(q0 + u) * LD + lane] = v[u];
          sx[(q0 + u) * LD + lane] = xv[u];
        }
      }
    }
    __syncwarp();  // the round's slots are in place
    const int here = min(DEPTH, len - i * DEPTH);
    for (int j = 0; j < here; ++j) {
      acc = fmaf(sv[lane * LD + j], sx[lane * LD + j], acc);
    }
    __syncwarp();  // every lane has read the round before the next is staged
  }
  if (row < m) y[row] = acc;
}

}  // namespace

extern "C" int spgrid_wrow_spmv(const void* row_slot, const void* vals,
                                const void* cols, const void* x, void* y,
                                int blocks, int m, void* stream) {
  wrow_spmv_kernel<<<blocks, LANE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_slot), static_cast<const float*>(vals),
      static_cast<const int*>(cols), static_cast<const float*>(x),
      static_cast<float*>(y), m);
  return static_cast<int>(cudaGetLastError());
}
