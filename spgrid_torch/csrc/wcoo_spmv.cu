// Aligned-slot SpMV, y = A @ x with A in DeviceWCOOAligned layout, read as
// its row-ordered live-slot stream in row tiles of equal work.
//
// Replaces: spgrid/ops/pallas/wcoo_spmv.py, _kernel / _spmv (the Pallas TPU
// kernel behind `wcoo_spmv`: per (8, 128) group one gather of the
// superwindow's 8 x rows, a sublane sum and an add into one row of the
// resident y).
//
// Bound on the H100: device-memory bytes: each live slot's value and x
// index once, x and y once; products are nothing beside that. The padded
// groups hold ~18 slots for each live one on a hypersparse matrix (5.67 %
// utilisation on the 65535^2 CLI slice), so the kernel reads none of them:
// the host keeps only the live slots (value not 0, x index inside x), sorted
// stably by output row from the groups' (group, window, lane) order, each as
// its f32 value and whole int32 x index, with row_slot (m + 1) pointing at
// each row's slots (ops/kernels/slot_rows.py, built in from_arrays).
//
// Design (the CSR-stream scheme of Greathouse and Daga, SC'14): the host
// cuts the rows into tiles of whole rows, each of at most TILE live slots
// and at most THREADS rows (tile_row, ops/kernels/wcoo_spmv.py:row_tiles),
// a row of more slots a tile of its own. One CTA a tile. The CTA reads its
// tile's slots in one coalesced pass (the slots are consecutive in the
// stream), issues every slot's x gather at once (x is small and stays in
// L2), stores each (value, x) pair side by side in shared memory and crosses
// one barrier; then thread r sums row r's pairs in stream order with fmaf
// from 0 and writes y once (0 for a row with no slot). A tile of one row
// longer than TILE walks the row in rounds of TILE slots, each thread
// keeping a strided partial; the partials are added in a fixed order (a warp
// shuffle tree, then the warps in order through shared memory). No atomics:
// the same bits every call.
//
// Bits: a row of at most TILE slots is summed in the order in which the
// padded walk summed it (groups ascending, then windows 0..7), each product
// fused into the sum from 0.0f, so it keeps the padded kernel's bits; a row
// longer than TILE does not (its partials are summed in a tree).
//
// The bf16 form (wcoo_spmv at dtype bf16): bf16 values, x and y, 6 bytes a
// live slot, each x index marked (bit 31) where the slot opens one of its
// row's groups (ops/kernels/slot_rows.py:mark_groups; a row can hold several
// groups of one superwindow). The Pallas body sums a group's products for a
// row (its windows) in f32, XLA keeping the bf16 product in f32 there, and
// rounds that sum to bf16 before adding it into the f32 row; so does the
// form. The tile stages each slot's product and mark; thread r adds the
// products to a group partial and, at each mark and at the row's end, the
// partial rounded to bf16 to its row, which it rounds once. A long row: the
// thread that holds a group's first slot sums the group (at most 8 slots,
// one a window) and adds it rounded to its partial; the partials are added
// in the same fixed tree.
#include <cuda_runtime.h>

#include "bf16_bits.cuh"

namespace {

using spgrid::bf16::Elem;
using spgrid::bf16::X_INDEX;
using spgrid::bf16::narrow;
using spgrid::bf16::rounded;
using spgrid::bf16::widen;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// One row longer than TILE: every thread sums a strided share of its slots,
// PER slots in flight a round (BF: of the row's groups, each by the thread
// that holds its first slot); then the fixed-order reduction.
template <int PER, bool BF>
__device__ void long_row(const Elem<BF>* __restrict__ vals,
                         const int* __restrict__ xidx,
                         const Elem<BF>* __restrict__ x, int s0, int count,
                         Elem<BF>* __restrict__ y_row, float* warp_sums) {
  constexpr int TILE = PER * THREADS;
  const int t = threadIdx.x;
  float acc = 0.0f;
  if constexpr (BF) {
    for (int j = t; j < count; j += THREADS) {
      if (__ldg(xidx + s0 + j) >= 0) continue;  // not a group's first slot
      float part = 0.0f;
      for (int i = j; i < count; ++i) {
        const int marked = __ldg(xidx + s0 + i);
        if (i > j && marked < 0) break;  // the next group
        part += widen(__ldg(vals + s0 + i)) *
                widen(__ldg(x + (marked & X_INDEX)));
      }
      acc += rounded(part);
    }
  } else {
    for (int base = 0; base < count; base += TILE) {
      float v[PER], xv[PER];
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int j = base + t + q * THREADS;
        v[q] = 0.0f;
        xv[q] = 0.0f;
        if (j < count) {
          v[q] = widen(__ldg(vals + s0 + j));
          xv[q] = widen(__ldg(x + __ldg(xidx + s0 + j)));
        }
      }
#pragma unroll
      for (int q = 0; q < PER; ++q) acc = fmaf(v[q], xv[q], acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if (t % 32 == 0) warp_sums[t / 32] = acc;
  __syncthreads();
  if (t == 0) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += warp_sums[w];
    *y_row = narrow<BF>(sum);
  }
}

// TILE = PER * THREADS live slots a tile, PER a thread; BF: the bf16 form.
template <int PER, bool BF>
__global__ void __launch_bounds__(THREADS)
wcoo_spmv_kernel(const int* __restrict__ tile_row,
                 const int* __restrict__ row_slot,
                 const Elem<BF>* __restrict__ vals,
                 const int* __restrict__ xidx, const Elem<BF>* __restrict__ x,
                 Elem<BF>* __restrict__ y) {
  constexpr int TILE = PER * THREADS;
  __shared__ float2 pairs[TILE];
  __shared__ float warp_sums[WARPS];
  const int t = threadIdx.x;
  const int r0 = tile_row[blockIdx.x];
  const int r1 = tile_row[blockIdx.x + 1];
  const int s0 = row_slot[r0];
  const int count = row_slot[r1] - s0;
  if (count > TILE) {  // the host gives such a tile one row: r1 == r0 + 1
    long_row<PER, BF>(vals, xidx, x, s0, count, y + r0, warp_sums);
    return;
  }
  // this thread's row, its bounds read before the barrier
  const int row = r0 + t;
  int begin = 0, end = 0;
  if (row < r1) {
    begin = row_slot[row] - s0;
    end = row_slot[row + 1] - s0;
  }
  float v[PER];
  int xi[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int j = t + q * THREADS;
    v[q] = 0.0f;
    xi[q] = 0;
    if (j < count) {
      v[q] = widen(__ldg(vals + s0 + j));
      xi[q] = __ldg(xidx + s0 + j);
    }
  }
  float xv[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int c = BF ? xi[q] & X_INDEX : xi[q];
    xv[q] = t + q * THREADS < count ? widen(__ldg(x + c)) : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int j = t + q * THREADS;
    if (j < count) {
      // BF: the product, exact in f32, and the slot's mark
      pairs[j] = BF ? make_float2(v[q] * xv[q], xi[q] < 0 ? 1.0f : 0.0f)
                    : make_float2(v[q], xv[q]);
    }
  }
  __syncthreads();
  if (row < r1) {
    float acc = 0.0f;
    float part = 0.0f;  // BF: the row's open group's partial sum
    for (int j = begin; j < end; ++j) {
      const float2 p = pairs[j];
      if (BF) {
        if (p.y != 0.0f) {  // a group of the row opens
          acc += rounded(part);
          part = 0.0f;
        }
        part += p.x;
      } else {
        acc = fmaf(p.x, p.y, acc);
      }
    }
    if (BF) acc += rounded(part);
    y[row] = narrow<BF>(acc);
  }
}

template <bool BF>
int launch(const void* tile_row, const void* row_slot, const void* vals,
           const void* xidx, const void* x, void* y, int tiles,
           int tile_slots, void* stream) {
  if (tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles == 0) return static_cast<int>(cudaSuccess);
  using T = Elem<BF>;
  using Kernel = void (*)(const int*, const int*, const T*, const int*,
                          const T*, T*);
  Kernel kernel;
  switch (tile_slots) {
    case 512: kernel = wcoo_spmv_kernel<2, BF>; break;
    case 1024: kernel = wcoo_spmv_kernel<4, BF>; break;
    case 2048: kernel = wcoo_spmv_kernel<8, BF>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_row), static_cast<const int*>(row_slot),
      static_cast<const T*>(vals), static_cast<const int*>(xidx),
      static_cast<const T*>(x), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tile_slots: 512, 1024 or 2048, the TILE that tile_row was cut at
// (ops/kernels/wcoo_spmv.py:row_tiles).
extern "C" int spgrid_wcoo_spmv(const void* tile_row, const void* row_slot,
                                const void* vals, const void* xidx,
                                const void* x, void* y, int tiles,
                                int tile_slots, void* stream) {
  return launch<false>(tile_row, row_slot, vals, xidx, x, y, tiles,
                       tile_slots, stream);
}

// The bf16 form: vals, x and y as bf16 bit patterns, xidx marked with the
// groups' starts (bit 31); the same arguments.
extern "C" int spgrid_wcoo_spmv_bf16(const void* tile_row,
                                     const void* row_slot, const void* vals,
                                     const void* xidx, const void* x, void* y,
                                     int tiles, int tile_slots, void* stream) {
  return launch<true>(tile_row, row_slot, vals, xidx, x, y, tiles,
                      tile_slots, stream);
}
