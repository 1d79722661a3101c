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
//
// The bf16 form (WROW v2 and WPACK at wsel 2 and 4, at dtype bf16, whose
// Pallas bodies keep products and sums in f32 there; `row_walk` below) must
// give the same bits every call, so its sums take a fixed order; it reads
// the layouts' row-ordered stream instead: the same live slots by (target
// block, row) and, within a row, in piece and lane order (`row_slot` (m +
// 1) points at each row's; bf16 values and int32 x indices, 6 bytes a live
// slot; bit 31 of WROW's x index, v1's group mark, is masked off). A CTA
// takes an equal range of live slots as above, and its warp w the w-th
// stretch of it, in passes of 32 slots (a pass's slots loaded two passes
// ahead, its x gathered one pass ahead). A pass holds a few whole runs of
// one row. Lane l loads where row r + l ends, r the row of the pass's
// first slot; where all the pass's rows are among those 32, their ends
// or-reduced give the pass's row-end mask, and lane l writes row r + l if
// it ends in the pass (a lane bisection finds each slot's row where more
// rows end in the pass than that). Each run is summed by a segmented
// shuffle scan (5 steps, a fixed order); the writer takes its run's sum
// from the run's last lane, row r's after the row's open partial, and
// writes y directly. A row that goes on past the pass carries its partial
// in a register; one that crosses a warp's stretch leaves it in shared
// memory, where thread 0 adds the warps' partials in warp order; one that
// crosses the range leaves it in the carry buffer, and `row_combine` adds
// those in range order. Rows without a slot are written 0 by the warp
// whose stretch they end in. No atomics, no shared accumulator: every row
// of y is written once. The products are exact in f32 and y is rounded
// once.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "bf16_bits.cuh"

namespace spgrid {
namespace slot_stream {
namespace {  // each kernel source gets its own copy of the kernels

using bf16::Elem;
using bf16::narrow;
using bf16::widen;

constexpr int LANE = 128;      // rows of a target block
constexpr int THREADS = 256;   // a CTA
// CTAs an SM that the default range aims at (slot_stream.py): the walks
// keep to 32 registers a thread so that they fit
constexpr int CTAS_PER_SM = 8;
constexpr int RUNS = 2;        // 32-slot runs of a warp in a tile
constexpr int WARP_SLOTS = 32 * RUNS;
constexpr int TILE = THREADS * RUNS;
constexpr int PIECE_START = 0x80;  // row byte's flag: a piece's first slot
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = THREADS / 32;

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
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
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
      const float sum = acc[t];
      acc[t] = 0.0f;
      if (b0 >= s0 && b1 <= s1) {
        const long long r = static_cast<long long>(b) * LANE + t;
        if (r < m) y[r] = sum;
      } else {
        carry[(static_cast<size_t>(c) * 2 + (b1 > s1 ? 1 : 0)) * LANE + t] =
            sum;
      }
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
        const bool add = pending[u] && w0 + 32 * u + lane < open_end;
        if (add) {
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

template <bool BF>
__global__ void __launch_bounds__(LANE)
combine(const int* __restrict__ block_slot, const float* __restrict__ carry,
        Elem<BF>* __restrict__ y, int per_cta, int m) {
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
  if (row < m) y[row] = narrow<BF>(acc);
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
        static_cast<const int*>(cols),
        static_cast<const unsigned char*>(rows),
        static_cast<const float*>(x), static_cast<float*>(y),
        static_cast<float*>(carry), num_slots, per_cta, blocks, m);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  combine<false><<<blocks, LANE, 0, s>>>(static_cast<const int*>(block_slot),
                                         static_cast<const float*>(carry),
                                         static_cast<float*>(y), per_cta, m);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The bf16 form: the row-ordered stream (the header says how it is walked).

using bf16::X_INDEX;

// The largest j in [lo, hi) with a[j] <= v, for a nondecreasing a with
// a[lo] <= v: one lane's bisection.
__device__ __forceinline__ int lane_search(const int* __restrict__ a, int lo,
                                           int hi, int v) {
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (__ldg(a + mid) <= v) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Warp-collective: y = 0 on each row j >= from that holds no slot and ends
// at or before slot `upto` (its rows after the first one of the stretch).
__device__ __forceinline__ void zero_empty_rows(
    const int* __restrict__ row_slot, unsigned short* __restrict__ y,
    int from, int upto, int m) {
  const int lane = threadIdx.x % 32;
  for (int j0 = from; j0 < m; j0 += 32) {
    const int j = j0 + lane;
    const int lo = j < m ? __ldg(row_slot + j) : INT_MAX;
    const int hi = j < m ? __ldg(row_slot + j + 1) : INT_MAX;
    if (hi <= upto && lo == hi) y[j] = 0;
    if (__shfl_sync(FULL, hi, 31) > upto) break;  // rows end in order
  }
}

// What a warp leaves its CTA of the rows its stretch shares: `head`, the
// partial of its first row where that row began before the stretch and
// ends in it; `tail`, the partial of its last row where that row goes on
// past it (`tail_before`: the row began before the stretch too).
struct WarpEdge {
  float head, tail;
  int head_row;
  bool has_head, has_tail, tail_before;
};

__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
row_walk(const int* __restrict__ row_slot,
         const unsigned short* __restrict__ vals,
         const int* __restrict__ cols, const unsigned short* __restrict__ x,
         unsigned short* __restrict__ y, float* __restrict__ carry,
         int* __restrict__ carry_row, int num_slots, int per_cta, int m) {
  __shared__ WarpEdge edge[WARPS];
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int c = blockIdx.x;
  const long long first = static_cast<long long>(c) * per_cta;
  const int s0 = static_cast<int>(first);
  const int s1 = static_cast<int>(
      min(static_cast<long long>(num_slots), first + per_cta));
  // the warp's stretch: whole passes of 32 slots, the last one cut at s1
  const long long stretch =
      ((static_cast<long long>(per_cta) + WARPS - 1) / WARPS + 31) / 32 * 32;
  const int ws0 = static_cast<int>(min(static_cast<long long>(s1),
                                       s0 + warp * stretch));
  const int ws1 = static_cast<int>(min(static_cast<long long>(s1),
                                       ws0 + stretch));
  WarpEdge e{0.0f, 0.0f, 0, false, false, false};
  if (ws0 < ws1) {  // warp-uniform
    // a pass's slots (value, x index) are loaded two passes ahead, its x
    // gathered one pass ahead, all in flight while the warp finds its
    // first row
    float v = 0.0f;
    int xi = 0;
    auto load = [&](int b) {
      const int s = b + lane;
      v = s < ws1 ? widen(vals[s]) : 0.0f;
      xi = s < ws1 ? cols[s] & X_INDEX : 0;
    };
    load(ws0);
    float v_cur = v;  // the pass's values and x
    unsigned short x_cur = v != 0.0f ? __ldg(x + xi) : 0;
    if (ws0 + 32 < ws1) load(ws0 + 32);
    int r = warp_search(row_slot, 0, m, ws0);  // the row of slot b
    if (lane == 0 && warp == 0) carry_row[c] = r;
    zero_empty_rows(row_slot, y, ws0 == 0 ? 0 : r + 1, ws1, m);
    float open = 0.0f;  // row r's partial over the stretch's slots before b
    bool before = __ldg(row_slot + r) < ws0;  // row r began before ws0
    bool goes_on = false;  // the pass's last row goes on past it
    for (int b = ws0; b < ws1; b += 32) {
      const int valid = min(32, ws1 - b);  // lanes with a slot
      const int s = b + lane;
      const float prod = lane < valid ? v_cur * widen(x_cur) : 0.0f;
      // lane l: where row r + l ends
      const int end = r + 1 + lane <= m ? __ldg(row_slot + r + 1 + lane)
                                        : INT_MAX;
      unsigned ends;  // bit j: slot b + j is its row's last
      bool writer;    // the lane writes a row that ends in the pass
      int wrow, src;  // that row, and the lane whose scan sum is its run's
      bool first;     // that row is r, which may have begun before b
      int next = r;   // the row of slot b + 32
      if (__shfl_sync(FULL, end, 31) > b + 32) {  // warp-uniform
        // every row that ends by b + 32 is one of r .. r + 30: lane l
        // writes row r + l where it ends in the pass and holds a slot
        const int d = end - b;
        const int before_end = __shfl_up_sync(FULL, end, 1);
        ends = __reduce_or_sync(FULL, d <= valid ? 1u << (d - 1) : 0u);
        next = r + __popc(__ballot_sync(FULL, end <= b + 32));
        writer = d <= valid && (lane == 0 || before_end != end);
        wrow = r + lane;
        src = min(d, 32) - 1;
        first = lane == 0;
      } else {
        // more rows end in the pass than the window holds: each lane's
        // own bisection, and the lane that ends a row writes it
        const int row = lane < valid ? lane_search(row_slot, r, m, s) : r;
        writer = lane < valid && __ldg(row_slot + row + 1) == s + 1;
        ends = __ballot_sync(FULL, writer);
        if (b + 32 < ws1) next = warp_search(row_slot, r, m, b + 32);
        wrow = row;
        src = lane;
        first = row == r;
      }
      // each run of one row summed by a segmented scan
      const unsigned heads = (ends << 1) | 1u;
      const int run0 = 31 - __clz(heads & (FULL >> (31 - lane)));
      float sum = prod;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const float o = __shfl_up_sync(FULL, sum, d);
        if (lane - d >= run0) sum += o;
      }
      const float got = __shfl_sync(FULL, sum, src);
      const float total = first ? open + got : got;  // row r's partial first
      if (writer && !(first && before)) y[wrow] = narrow<true>(total);
      if (before) {  // warp-uniform: row r began before the stretch
        const unsigned head = __ballot_sync(FULL, writer && first);
        if (head != 0) {  // it ends in this pass: the warp's head partial
          const int h = __ffs(head) - 1;
          e.head = __shfl_sync(FULL, total, h);
          e.head_row = __shfl_sync(FULL, wrow, h);
          e.has_head = true;
        }
      }
      const int tail = valid - 1;
      goes_on = !((ends >> tail) & 1u);  // warp-uniform
      const float tail_sum = __shfl_sync(FULL, sum, tail);
      const bool tail_in_r = (heads & (FULL >> (31 - tail))) == 1u;
      before = goes_on && before && tail_in_r;
      open = goes_on ? (tail_in_r ? open + tail_sum : tail_sum) : 0.0f;
      r = next;
      // the next pass's x gathers, and the slots of the one after it
      v_cur = v;
      x_cur = v != 0.0f ? __ldg(x + xi) : 0;
      if (b + 64 < ws1) load(b + 64);
    }
    // the last pass's row goes on past ws1 unless it ended there
    e.has_tail = goes_on;
    e.tail = open;
    e.tail_before = before;
  }
  if (lane == 0) edge[warp] = e;
  __syncthreads();
  if (t == 0) {
    // the rows that cross the warps' stretches, their partials added in
    // warp order: one that began before s0 goes to carry slot 0 once it
    // ends, the one that goes on past s1 to slot 1 (also where it began
    // before s0), any other to y
    float run = 0.0f;
    bool run_before = true;  // the open chain began before s0
    bool chain = false;      // a row goes on past the last warp's stretch
    for (int w = 0; w < WARPS && s0 + w * stretch < s1; ++w) {
      const WarpEdge& ew = edge[w];
      if (ew.has_head) {
        const float total = run + ew.head;
        if (run_before) {
          carry[static_cast<size_t>(c) * 2] = total;
        } else {
          y[ew.head_row] = narrow<true>(total);
        }
      }
      if (ew.has_tail) {
        if (ew.tail_before) {
          run = run + ew.tail;
        } else {
          run = ew.tail;
          run_before = false;
        }
      }
      chain = ew.has_tail;
    }
    if (chain) carry[static_cast<size_t>(c) * 2 + 1] = run;
  }
}

// One thread a range boundary c (slot c * per_cta): the row that crosses
// it, if this is the first boundary it crosses, gets its ranges' partials
// in range order (carry slot 1 of each range it goes on past, slot 0 of the
// one it ends in).
__global__ void __launch_bounds__(LANE)
row_combine(const int* __restrict__ row_slot, const float* __restrict__ carry,
            const int* __restrict__ carry_row, unsigned short* __restrict__ y,
            int ctas, int per_cta) {
  const int c = blockIdx.x * LANE + threadIdx.x + 1;
  if (c >= ctas) return;
  const int r = carry_row[c];
  const long long bound = static_cast<long long>(c) * per_cta;
  const int start = __ldg(row_slot + r);
  if (start >= bound || start < bound - per_cta) return;
  const int c1 = (__ldg(row_slot + r + 1) - 1) / per_cta;
  float acc = 0.0f;
#pragma unroll 4
  for (int k = c - 1; k < c1; ++k) acc += carry[static_cast<size_t>(k) * 2 + 1];
  acc += carry[static_cast<size_t>(c1) * 2];
  y[r] = narrow<true>(acc);
}

// The bf16 walk (y = 0 where there are no slots) and its combine on
// `stream`; 0 or the CUDA error. carry holds 2 floats and carry_row an int
// a CTA, ceil(num_slots / per_cta) CTAs.
int launch_rows(const void* row_slot, const void* vals, const void* cols,
                const void* x, void* y, void* carry, void* carry_row,
                int num_slots, int per_cta, int m, void* stream) {
  if (per_cta <= 0 || num_slots < 0 || m <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_slots == 0) {
    return static_cast<int>(cudaMemsetAsync(
        y, 0, static_cast<size_t>(m) * sizeof(unsigned short), s));
  }
  const long long ctas =
      (static_cast<long long>(num_slots) + per_cta - 1) / per_cta;
  row_walk<<<static_cast<unsigned>(ctas), THREADS, 0, s>>>(
      static_cast<const int*>(row_slot),
      static_cast<const unsigned short*>(vals), static_cast<const int*>(cols),
      static_cast<const unsigned short*>(x), static_cast<unsigned short*>(y),
      static_cast<float*>(carry), static_cast<int*>(carry_row), num_slots,
      per_cta, m);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ctas == 1) return static_cast<int>(err);
  row_combine<<<static_cast<unsigned>((ctas - 1 + LANE - 1) / LANE), LANE, 0,
                s>>>(static_cast<const int*>(row_slot),
                     static_cast<const float*>(carry),
                     static_cast<const int*>(carry_row),
                     static_cast<unsigned short*>(y), static_cast<int>(ctas),
                     per_cta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace slot_stream
}  // namespace spgrid
