// The slot-list SpMM tile that the two hypersparse SpMM kernels share.
//
// One CTA of 64 threads owns a 128-row x 64-column tile of Y, held in shared
// memory (32 KB f32), and thread j owns column j of it. The CTA walks the
// slot packets (WCOO chunks, aligned groups) that land on its 128 rows. For
// each packet it first compacts the packet's live slots into a list in
// shared memory, in slot order: a slot is live when its value is not 0 and
// its X row lies inside X (pad slots point at column 0 of their window,
// which may lie past k when X is not padded). Then every thread runs down
// the list: tile[row][j] += val * X[xrow, n0 + j]. No two threads write the
// same element and the order of the sums is fixed, so there are no atomics
// and the result is deterministic. The 64 threads of a list entry read 64
// neighbouring floats of one row of X.
//
// f32 FMA on the CUDA cores, no tensor cores: TF32 would miss the f32
// accuracy gate (1e-4 relative against the f64 oracle).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace spgrid {

constexpr int LANE = 128;      // rows of a tile, slots of a window row
constexpr int SLOT_COLS = 64;  // columns of Y per CTA == threads per CTA
constexpr int SLOT_WARPS = SLOT_COLS / 32;

template <int MAX_SLOTS>
struct SlotList {
  int row[MAX_SLOTS];        // row within the tile
  int xrow[MAX_SLOTS];       // row of X
  float val[MAX_SLOTS];
  int warp_live[SLOT_WARPS];
};

// Every thread of the CTA offers one slot; the live ones are appended to the
// list after the `count` entries it holds, in thread order. Returns the new
// count, the same in every thread. Must be reached by all threads.
template <int MAX_SLOTS>
__device__ __forceinline__ int append_live(SlotList<MAX_SLOTS>& list,
                                           int count, bool live, int row,
                                           int xrow, float val) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (lane == 0) list.warp_live[warp] = __popc(ballot);
  __syncthreads();
  int before = __popc(ballot & ((1u << lane) - 1u));
  int total = 0;
#pragma unroll
  for (int w = 0; w < SLOT_WARPS; ++w) {
    if (w < warp) before += list.warp_live[w];
    total += list.warp_live[w];
  }
  if (live) {
    list.row[count + before] = row;
    list.xrow[count + before] = xrow;
    list.val[count + before] = val;
  }
  __syncthreads();  // warp_live is rewritten by the next call
  return count + total;
}

__device__ __forceinline__ void zero_tile(float (*tile)[SLOT_COLS]) {
  for (int r = 0; r < LANE; ++r) tile[r][threadIdx.x] = 0.0f;
}

// tile[row][j] += val * X[xrow, n0 + j] over the list, four X loads in
// flight a thread.
template <int MAX_SLOTS>
__device__ __forceinline__ void accumulate(float (*tile)[SLOT_COLS],
                                           const SlotList<MAX_SLOTS>& list,
                                           int count,
                                           const float* __restrict__ x,
                                           int n, int n0) {
  const int j = threadIdx.x;
  if (n0 + j >= n) return;
  const float* xj = x + n0 + j;
  int i = 0;
  for (; i + 4 <= count; i += 4) {
    float xv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      xv[u] = __ldg(xj + static_cast<size_t>(list.xrow[i + u]) * n);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float& t = tile[list.row[i + u]][j];
      t = fmaf(list.val[i + u], xv[u], t);
    }
  }
  for (; i < count; ++i) {
    float& t = tile[list.row[i]][j];
    t = fmaf(list.val[i], __ldg(xj + static_cast<size_t>(list.xrow[i]) * n), t);
  }
}

// Y[row0 + r, n0 + j] = tile[r][j] for rows < m and columns < n: every
// element of Y the CTA owns is written, zeros included.
__device__ __forceinline__ void write_tile(float (*tile)[SLOT_COLS],
                                           float* __restrict__ y,
                                           long long row0, int m, int n,
                                           int n0) {
  const int j = threadIdx.x;
  if (n0 + j >= n) return;
  for (int r = 0; r < LANE && row0 + r < m; ++r)
    y[static_cast<size_t>(row0 + r) * n + n0 + j] = tile[r][j];
}

}  // namespace spgrid
