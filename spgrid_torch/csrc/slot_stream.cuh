// The live-slot stream walk that the two packed SpMV kernels share
// (wrow_spmv_v2.cu, wpack_spmv.cu).
//
// The stream: the live slots of a layout's pieces (value not 0, x index
// inside x), in piece order and, within a piece, in lane order, so in the
// layout's order of target blocks, groups, pieces and windows. Per slot an
// f32 value, its x index (the piece's window * 128 + the column within it,
// int32) and a row byte: the row within the target block, 0x80 set on a
// piece's first slot. `block_slot` (blocks + 1) gives each 128-row target
// block's slots: a block's pieces are consecutive, so are its slots. Pad
// slots and empty pieces take no room; 9 bytes a live slot, read once and
// coalesced. The x index is stored whole, not as the column within the
// piece's window: the layout keeps each piece's slot offset beside
// piece_w, but finding each slot's piece for its window is a chain of
// dependent loads (a search, the offsets, the window) ahead of the gather,
// and on the card that chain, not the stream's bytes, sets the time.
//
// Work split: CTA c of 256 threads takes the slots [c S, (c + 1) S), S =
// `per_cta`, in tiles of 512: warp w takes 64 consecutive slots of a tile,
// lane l the slots l and 32 + l of them. (Four slots a lane took 48
// registers and ran slower on the card: fewer CTAs fit an SM.) A tile's
// slots are loaded before the previous tile's adds, and the first
// tile's while warp 0 finds the range's first block by a 32-way search of
// block_slot.
//
// Accumulation: one 128-float accumulator in shared memory for the target
// block the CTA has open. Slots add value * x to acc[row] with a
// shared-memory atomicAdd: slots of one piece hit distinct rows (WROW) or
// runs of one row (WPACK), but slots of different pieces hit the same rows.
// With SEGMENT (WPACK: a piece's slots are sorted by row), each warp first
// sums each run of one row within a piece among its 32 slots by a
// segmented shuffle scan, an add of the run's own terms and no prefix
// difference, so the run takes one atomic. A slot adds only once its block
// is open: the block of the slots below block_slot[open + 1]. When a tile
// holds slots past that, the CTA flushes the accumulator (two barriers) and
// opens the block of the next slot. A flushed block whose slots all lie in
// the CTA's range is written to y, all 128 rows, zeros included. A block
// that straddles a range boundary leaves its partial sum in the carry
// buffer: slot 1 of a range it continues past, slot 0 of the range it ends
// in. `combine`, one CTA per block, then adds those partials in range order
// and writes y, or 0 for a block with no live slot. No atomics on y.
//
// Not bit-reproducible from run to run: the shared-memory atomics of one
// block's slots land in the order the warps reach them. The carry combine
// is in a fixed order.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace spgrid {
namespace slot_stream {
namespace {  // each kernel source gets its own copy of the kernels

constexpr int LANE = 128;      // rows of a target block
constexpr int THREADS = 256;   // a CTA
constexpr int RUNS = 2;        // 32-slot runs of a warp in a tile
constexpr int WARP_SLOTS = 32 * RUNS;
constexpr int TILE = THREADS * RUNS;
constexpr int PIECE_START = 0x80;  // row byte's flag: a piece's first slot
constexpr unsigned FULL = 0xffffffffu;

// Warp-collective, the same v in every lane: the largest j in [lo, hi)
// with a[j] <= v, for a nondecreasing a with a[lo] <= v and the answer
// below hi. A 32-way search: each step every lane reads one candidate, so
// ceil(log32(hi - lo)) dependent loads where a bisection takes log2.
__device__ __forceinline__ int warp_search(const int* __restrict__ a, int lo,
                                           int hi, int v) {
  const int lane = threadIdx.x % 32;
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int j = lo + lane * step;
    const bool le = j < hi && __ldg(a + j) <= v;
    lo += (31 - __clz(__ballot_sync(FULL, le))) * step;
    hi = min(lo + step, hi);
  }
  return lo;
}

template <bool SEGMENT>
__global__ void __launch_bounds__(THREADS)
walk(const int* __restrict__ block_slot, const float* __restrict__ vals,
     const int* __restrict__ cols, const unsigned char* __restrict__ rows,
     const float* __restrict__ x, float* __restrict__ y,
     float* __restrict__ carry, int num_slots, int per_cta, int blocks,
     int m) {
  __shared__ float acc[LANE];
  __shared__ int first_block;
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int c = blockIdx.x;
  const long long first = static_cast<long long>(c) * per_cta;
  const int s0 = static_cast<int>(first);
  const int s1 = static_cast<int>(
      min(static_cast<long long>(num_slots), first + per_cta));

  // this warp's slots of a tile: values, x indices, rows
  float v[RUNS];
  int xi[RUNS], row[RUNS];
  auto load_tile = [&](int base) {
    const int end = min(base + TILE, s1);
#pragma unroll
    for (int u = 0; u < RUNS; ++u) {
      const int s = base + warp * WARP_SLOTS + 32 * u + lane;
      const bool ok = s < end;
      v[u] = ok ? vals[s] : 0.0f;
      xi[u] = ok ? cols[s] : 0;
      row[u] = ok ? static_cast<int>(rows[s]) : 0;
    }
  };
  load_tile(s0);  // in flight while warp 0 finds the range's first block
  if (t < LANE) acc[t] = 0.0f;
  if (warp == 0) {
    const int b = warp_search(block_slot, 0, blocks, s0);
    if (lane == 0) first_block = b;
  }
  __syncthreads();
  int open = first_block;
  int open_end = __ldg(block_slot + open + 1);

  auto flush = [&](int b) {
    if (t < LANE) {
      const int b0 = __ldg(block_slot + b);
      const int b1 = __ldg(block_slot + b + 1);
      if (b0 >= s0 && b1 <= s1) {
        const long long r = static_cast<long long>(b) * LANE + t;
        if (r < m) y[r] = acc[t];
      } else {
        carry[(static_cast<size_t>(c) * 2 + (b1 > s1 ? 1 : 0)) * LANE + t] =
            acc[t];
      }
      acc[t] = 0.0f;
    }
  };

  for (int base = s0; base < s1; base += TILE) {
    const int end = min(base + TILE, s1);
    const int w0 = base + warp * WARP_SLOTS;
    float prod[RUNS];
    int r[RUNS];
    bool pending[RUNS];
#pragma unroll
    for (int u = 0; u < RUNS; ++u) {
      pending[u] = w0 + 32 * u + lane < end;
      prod[u] = pending[u] ? v[u] * __ldg(x + xi[u]) : 0.0f;
      r[u] = row[u] & (LANE - 1);
    }
    if (SEGMENT && w0 < end) {  // warp-uniform
#pragma unroll
      for (int u = 0; u < RUNS; ++u) {
        const int up_r = __shfl_up_sync(FULL, r[u], 1);
        const bool head = lane == 0 || !pending[u] || (row[u] & PIECE_START) ||
                          up_r != r[u];
        const unsigned heads = __ballot_sync(FULL, head);
        const int run0 = 31 - __clz(heads & (FULL >> (31 - lane)));
        float sum = prod[u];
#pragma unroll
        for (int d = 1; d < 32; d *= 2) {
          const float o = __shfl_up_sync(FULL, sum, d);
          if (lane - d >= run0) sum += o;
        }
        prod[u] = sum;
        pending[u] =
            pending[u] && (lane == 31 || ((heads >> (lane + 1)) & 1u));
      }
    }
    if (base + TILE < s1) load_tile(base + TILE);  // the next tile's slots
    while (true) {
#pragma unroll
      for (int u = 0; u < RUNS; ++u) {
        if (pending[u] && w0 + 32 * u + lane < open_end) {
          atomicAdd(&acc[r[u]], prod[u]);
          pending[u] = false;
        }
      }
      if (open_end >= end) break;  // the tile's other slots are the open block's
      __syncthreads();             // its adds are in
      flush(open);
      __syncthreads();             // acc is zero again
      open = warp_search(block_slot, open + 1, blocks, open_end);
      open_end = __ldg(block_slot + open + 1);
    }
  }
  __syncthreads();
  flush(open);
}

__global__ void __launch_bounds__(LANE)
combine(const int* __restrict__ block_slot, const float* __restrict__ carry,
        float* __restrict__ y, int per_cta, int m) {
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const long long row = static_cast<long long>(b) * LANE + t;
  const int first = block_slot[b];
  const int last = block_slot[b + 1];
  float acc = 0.0f;
  if (first < last) {
    const int c0 = first / per_cta;
    const int c1 = (last - 1) / per_cta;
    if (c0 == c1) return;  // inside one range: the walk wrote it
    for (int c = c0; c < c1; ++c)
      acc += carry[(static_cast<size_t>(c) * 2 + 1) * LANE + t];
    acc += carry[static_cast<size_t>(c1) * 2 * LANE + t];
  }
  if (row < m) y[row] = acc;
}

// The walk (where there are slots) and the combine on `stream`; 0 or the
// CUDA error. carry holds 2 * 128 floats a CTA, ceil(num_slots / per_cta)
// CTAs.
template <bool SEGMENT>
int launch(const void* block_slot, const void* vals, const void* cols,
           const void* rows, const void* x, void* y, void* carry,
           int num_slots, int per_cta, int blocks, int m, void* stream) {
  if (per_cta <= 0 || num_slots < 0 || num_slots > INT_MAX - TILE)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ctas =
      (static_cast<long long>(num_slots) + per_cta - 1) / per_cta;
  if (ctas > 0) {
    walk<SEGMENT><<<static_cast<unsigned>(ctas), THREADS, 0, s>>>(
        static_cast<const int*>(block_slot), static_cast<const float*>(vals),
        static_cast<const int*>(cols), static_cast<const unsigned char*>(rows),
        static_cast<const float*>(x), static_cast<float*>(y),
        static_cast<float*>(carry), num_slots, per_cta, blocks, m);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  combine<<<blocks, LANE, 0, s>>>(static_cast<const int*>(block_slot),
                                  static_cast<const float*>(carry),
                                  static_cast<float*>(y), per_cta, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace slot_stream
}  // namespace spgrid
