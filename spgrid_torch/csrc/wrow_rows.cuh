// WROW v1's row walk, the body that wrow_spmv.cu runs and that
// spmv_ablate.cu runs with one stage of it compiled out at a time.
//
// The stream (DeviceWROW.row_*, built on the host with the layout): the
// live slots of the padded pieces (value not 0, x index inside x) by output
// row and, within a row, in piece order, the order in which the padded
// kernel summed the row; per slot an f32 value, its int32 x index and, for
// the ablation only, one byte: its piece's place r in its group (0..7).
// row_slot (m + 1) points at each row's slots.
//
// One CTA of 128 threads per 128-row target block, thread t for row t of
// the block, which it writes once (0 for a row with no live slot): no
// atomics in the full walk. Thread t sums its row's slots in stream order
// with fmaf from 0.0f, so y has the padded kernel's bits. Each warp stages
// its 32 rows in rounds of DEPTH slots a row through shared memory: for each
// of its rows in turn the warp reads the row's next DEPTH values and x
// indices, lane j slot j (128 bytes of each, coalesced), gathers x for them
// and stores value and x side by side at the row's place; then each lane
// sums its own row's slots of the round. The rounds of a warp are as many as
// its longest row needs, so a row of thousands of slots runs in rounds
// beside the warp's other rows, all 32 lanes loading, and shared memory
// holds one round whatever the block's size; a row with no slot left in a
// round loads nothing there.
//
// The variants (V), for a slot of row q (t = q mod 128) with x index
// xi = 128 w + c (w its window, c its column in the window):
//
//   FULL      v * x[xi]                 to y[q]  (v1's product)
//   NOGATHER  v * x[(xi & ~127) + t]    to y[q]  (no scatter in a window)
//   NOLOAD    v * x[128 r + c]          to y[q]  (1,024 fixed x entries)
//   NORMW     v * x[xi]                 to y[t]  (atomicAdd: rows 0..127)
//   EMPTY     v                         to y[t]  (atomicAdd; no x index)
//
// An x index at or past k reads 0 (x is not padded to whole windows; only
// NOGATHER and NOLOAD make one). What each removes from this body: NOGATHER
// the scatter of the staged x gather (each warp round reads x rows that the
// rows of its block share), NOLOAD the x traffic (its entries stay in L1),
// NORMW the one y write (replaced by an atomic add: a control), EMPTY
// everything but streaming the values through the staging. NORMW and EMPTY
// sum every block into y[0:128], which the caller zeroes, in an order that
// changes from run to run.
#pragma once

#include <cuda_runtime.h>

namespace spgrid {
namespace wrow_rows {
namespace {  // each kernel source gets its own copy of the kernels

enum Variant { FULL = 0, NOGATHER = 1, NOLOAD = 2, NORMW = 3, EMPTY = 4 };

constexpr int LANE = 128;         // rows of a target block, threads a CTA
constexpr int WARPS = LANE / 32;
constexpr int DEPTH = 32;         // slots of each row a round stages
constexpr int LD = DEPTH + 1;     // a row's stride in shared memory
constexpr int UNROLL = 16;        // rows whose loads are in flight together
static_assert(DEPTH == 32, "a round stages one slot a lane of each row");

template <int V>
__global__ void __launch_bounds__(LANE)
walk(const int* __restrict__ row_slot, const float* __restrict__ vals,
     const int* __restrict__ cols, const unsigned char* __restrict__ pieces,
     const float* __restrict__ x, float* __restrict__ y, int m, int k) {
  __shared__ float staged_v[WARPS][32 * LD];
  __shared__ float staged_x[WARPS][32 * LD];
  const int lane = threadIdx.x % 32;
  const int warp_row = threadIdx.x - lane;  // t of the warp's first row
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
          if (V == NOLOAD) {
            c[u] = 128 * __ldg(pieces + q_begin + at) +
                   (__ldg(cols + q_begin + at) & 127);
          } else if (V == NOGATHER) {
            c[u] = (__ldg(cols + q_begin + at) & ~127) + warp_row + q0 + u;
          } else if (V != EMPTY) {
            c[u] = __ldg(cols + q_begin + at);
          }
        }
      }
      if (V != EMPTY) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          // FULL's and NORMW's indices lie inside x by the stream's making
          const bool inside = V == FULL || V == NORMW || c[u] < k;
          if (live[u] && inside) xv[u] = __ldg(x + c[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (live[u]) {
          sv[(q0 + u) * LD + lane] = v[u];
          if (V != EMPTY) sx[(q0 + u) * LD + lane] = xv[u];
        }
      }
    }
    __syncwarp();  // the round's slots are in place
    const int here = min(DEPTH, len - i * DEPTH);
    for (int j = 0; j < here; ++j) {
      if (V == EMPTY) {
        acc += sv[lane * LD + j];
      } else {
        acc = fmaf(sv[lane * LD + j], sx[lane * LD + j], acc);
      }
    }
    __syncwarp();  // every lane has read the round before the next is staged
  }
  if (row < m) {
    if (V == NORMW || V == EMPTY) {
      atomicAdd(y + threadIdx.x, acc);
    } else {
      y[row] = acc;
    }
  }
}

// The walk of variant V over `blocks` target blocks on `stream`; 0 or the
// CUDA error.
template <int V>
int launch(const void* row_slot, const void* vals, const void* cols,
           const void* pieces, const void* x, void* y, int blocks, int m,
           int k, void* stream) {
  walk<V><<<blocks, LANE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_slot), static_cast<const float*>(vals),
      static_cast<const int*>(cols),
      static_cast<const unsigned char*>(pieces),
      static_cast<const float*>(x), static_cast<float*>(y), m, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace wrow_rows
}  // namespace spgrid
