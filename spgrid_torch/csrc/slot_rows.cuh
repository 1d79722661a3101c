// The row-ordered live-slot walk that the two slot SpMM kernels share
// (wcoo_spmm.cu, wcoo_bands.cu), each in f32 and bf16.
//
// The stream (ops/kernels/slot_rows.py, built on the host with the layout):
// the live slots of the layout's padded chunks or groups (value not 0, X row
// inside X), sorted by output row and, within a row, in the layout's slot
// order. Per slot an f32 value and its whole X row (int32); row_slot (m + 1)
// points at each row's slots. Pad slots, coverage chunks, pad groups and the
// sacrificial row block take no room: 8 bytes a live slot, read once by the
// one warp that owns the row.
//
// Work split: CTA (bx, by) of WARPS warps takes the rows [bx WARPS,
// (bx + 1) WARPS) and the column slab [128 C by, 128 C (by + 1)), with C the
// float4 a lane (1, 2 or 4, chosen from n by launch); warp w takes the row
// bx WARPS + w. Consecutive rows of a band read neighbouring X rows, which
// the CTAs in flight share in L2.
//
// A warp owns one row at a time and holds its part of the row in registers:
// lane l owns the columns 128 c + 4 l .. 128 c + 4 l + 3 for c < C (the
// float4 form, when n % 4 == 0 and X and Y are 16-byte aligned) or 32 j + l
// for j < 4 C (the scalar form). It loads the row's slots 32 at a time, one
// (value, X row) a lane by a coalesced load, and hands them out with
// __shfl_sync, U = 4 / C slots at a time: U C 16-byte X loads in flight a
// lane, none of them waiting on a load of its own address. Each slot's X
// slab is one coalesced read of 512 C bytes. 256 threads of at most 64
// registers (__launch_bounds__(256, 4)) put 32 warps on an SM; on the H100
// more loads a lane spilled under that cap or, uncapped, cost occupancy,
// and both ran slower. f32 FMA on the CUDA cores, in slot order, so the
// order of each sum is fixed and the result is deterministic (TF32 would
// miss the 1e-4 gate). The row is written once, with streaming stores (Y
// is not read again and should not push X's rows out of L2); an empty row
// is written as zeros. The walk uses no shared memory, no barrier and no
// atomics: its occupancy is set by registers alone.
//
// The bf16 form (BF; wcoo_bands and wcoo_pallas at dtype bf16, as the
// Pallas kernels multiply there): bf16 values and X, each product rounded
// to bf16 (to nearest, ties to even) before it is added into the f32 sum,
// and each element of Y rounded once to bf16. Lane l's part of an X row is the same
// columns, 8 bytes a float4's place (n % 4 == 0, X and Y on 8 B), else
// 2-byte loads; the stream's values are bf16 too (6 bytes a live slot).
//
// Long rows: a warp walks its row's slots in turn, U at a time, so one row
// of many slots sets the pace of the whole launch (on the H100 the edge
// matrix's one 250-slot row set its whole time). The walk leaves rows of
// more than long_row slots alone; a second kernel, long_walk, gives each
// of them (the layout's long_rows, listed on the host) a CTA of LONG_WARPS
// warps, each summing an equal run of the row's slots, and adds the runs'
// sums in warp order through shared memory: no atomics, a fixed order.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "bf16_bits.cuh"

namespace spgrid {
namespace slot_rows {
namespace {  // each kernel source gets its own copy of the kernels

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int SLAB = 128;   // columns of a warp's slab for each C
constexpr int LOADS = 4;    // U C: X loads in flight a lane
constexpr int LONG_WARPS = 16;  // warps that share one long row
constexpr int LONG_THREADS = 32 * LONG_WARPS;
constexpr unsigned FULL = 0xffffffffu;

using bf16::Elem;
using bf16::round_bf16;
using bf16::widen;

// Lane `lane`'s part of one X row's slab, xr pointing at the slab's first
// column, `left` columns of the slab inside X: 4 C values, 0 past them.
template <int C, bool VEC, bool BF>
__device__ __forceinline__ void load_slab(const Elem<BF>* __restrict__ xr,
                                          int lane, int left,
                                          float (&v)[4 * C]) {
  if constexpr (VEC) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = SLAB * c + 4 * lane;
      if constexpr (BF) {
        const uint2 t = col < left
                            ? __ldg(reinterpret_cast<const uint2*>(xr + col))
                            : make_uint2(0u, 0u);
        v[4 * c] = __uint_as_float(t.x << 16);
        v[4 * c + 1] = __uint_as_float(t.x & 0xFFFF0000u);
        v[4 * c + 2] = __uint_as_float(t.y << 16);
        v[4 * c + 3] = __uint_as_float(t.y & 0xFFFF0000u);
      } else {
        const float4 t = col < left
                             ? __ldg(reinterpret_cast<const float4*>(xr + col))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        v[4 * c] = t.x;
        v[4 * c + 1] = t.y;
        v[4 * c + 2] = t.z;
        v[4 * c + 3] = t.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4 * C; ++j) {
      const int col = 32 * j + lane;
      v[j] = col < left ? widen(__ldg(xr + col)) : 0.0f;
    }
  }
}

// Lane `lane`'s part of one Y row's slab, the columns inside Y only (bf16:
// each rounded once).
template <int C, bool VEC, bool BF>
__device__ __forceinline__ void store_slab(Elem<BF>* __restrict__ yr,
                                           int lane, int left,
                                           const float (&v)[4 * C]) {
  if constexpr (VEC) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = SLAB * c + 4 * lane;
      if (col >= left) continue;
      if constexpr (BF) {
        *reinterpret_cast<uint2*>(yr + col) = make_uint2(
            static_cast<uint32_t>(round_bf16(v[4 * c])) |
                static_cast<uint32_t>(round_bf16(v[4 * c + 1])) << 16,
            static_cast<uint32_t>(round_bf16(v[4 * c + 2])) |
                static_cast<uint32_t>(round_bf16(v[4 * c + 3])) << 16);
      } else {
        __stcs(reinterpret_cast<float4*>(yr + col),
               make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2],
                           v[4 * c + 3]));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4 * C; ++j) {
      const int col = 32 * j + lane;
      if (col >= left) continue;
      if constexpr (BF) {
        yr[col] = round_bf16(v[j]);
      } else {
        __stcs(yr + col, v[j]);
      }
    }
  }
}

// acc += value * X[X row] over the slots [beg, end) of one row, in slot
// order, by one warp: the slots' (value, X row) 32 at a time, one a lane,
// handed out by shuffles U at a time. Warp-collective: beg and end are the
// same in every lane. bf16: each product rounded to bf16 before the add.
template <int C, bool VEC, bool BF>
__device__ __forceinline__ void add_slots(float (&acc)[4 * C], int beg,
                                          int end,
                                          const Elem<BF>* __restrict__ vals,
                                          const int* __restrict__ xrows,
                                          const Elem<BF>* __restrict__ x,
                                          int n, int n0, int lane) {
  constexpr int U = LOADS / C;
  const int left = n - n0;
  for (int base = beg; base < end; base += 32) {
    const int count = min(32, end - base);
    float v = 0.0f;
    int xrow = 0;
    if (lane < count) {
      v = widen(__ldg(vals + base + lane));
      xrow = __ldg(xrows + base + lane);
    }
    for (int j = 0; j < count; j += U) {
      float xv[U][4 * C];
      float vv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        vv[u] = __shfl_sync(FULL, v, (j + u) & 31);
        const int r = __shfl_sync(FULL, xrow, (j + u) & 31);
        if (j + u < count)
          load_slab<C, VEC, BF>(x + static_cast<size_t>(r) * n + n0, lane,
                                left, xv[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j + u < count) {
#pragma unroll
          for (int e = 0; e < 4 * C; ++e) {
            if constexpr (BF) {
              acc[e] += widen(round_bf16(vv[u] * xv[u][e]));
            } else {
              acc[e] = fmaf(vv[u], xv[u][e], acc[e]);
            }
          }
        }
      }
    }
  }
}

// The row walk: a warp a row, every row but the long ones (more than
// long_row slots), which long_walk writes.
template <int C, bool VEC, bool BF>
__global__ void __launch_bounds__(THREADS, 4)
walk(const int* __restrict__ row_slot, const Elem<BF>* __restrict__ vals,
     const int* __restrict__ xrows, const Elem<BF>* __restrict__ x,
     Elem<BF>* __restrict__ y, int m, int n, int long_row) {
  const int lane = threadIdx.x % 32;
  const int n0 = blockIdx.y * SLAB * C;
  const long long row =
      static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (row >= m) return;
  const int beg = __ldg(row_slot + row);
  const int end = __ldg(row_slot + row + 1);
  if (end - beg > long_row) return;
  float acc[4 * C];
#pragma unroll
  for (int e = 0; e < 4 * C; ++e) acc[e] = 0.0f;
  add_slots<C, VEC, BF>(acc, beg, end, vals, xrows, x, n, n0, lane);
  store_slab<C, VEC, BF>(y + static_cast<size_t>(row) * n + n0, lane, n - n0,
                         acc);
}

// A long row a CTA (blockIdx.x indexes long_rows): warp w sums the w-th of
// LONG_WARPS equal runs of the row's slots, then warp 0 adds the runs'
// sums in warp order and writes the row. No atomics; a fixed order.
template <int C, bool VEC, bool BF>
__global__ void __launch_bounds__(LONG_THREADS)
long_walk(const int* __restrict__ long_rows, const int* __restrict__ row_slot,
          const Elem<BF>* __restrict__ vals, const int* __restrict__ xrows,
          const Elem<BF>* __restrict__ x, Elem<BF>* __restrict__ y, int n) {
  __shared__ float part[LONG_WARPS][4 * C][32];
  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32;
  const int n0 = blockIdx.y * SLAB * C;
  const int row = __ldg(long_rows + blockIdx.x);
  const int beg = __ldg(row_slot + row);
  const int end = __ldg(row_slot + row + 1);
  const int run = (end - beg + LONG_WARPS - 1) / LONG_WARPS;
  const int lo = min(end, beg + w * run);
  float acc[4 * C];
#pragma unroll
  for (int e = 0; e < 4 * C; ++e) acc[e] = 0.0f;
  add_slots<C, VEC, BF>(acc, lo, min(end, lo + run), vals, xrows, x, n, n0,
                        lane);
#pragma unroll
  for (int e = 0; e < 4 * C; ++e) part[w][e][lane] = acc[e];
  __syncthreads();
  if (w != 0) return;
#pragma unroll
  for (int e = 0; e < 4 * C; ++e) {
    float sum = part[0][e][lane];
    for (int v = 1; v < LONG_WARPS; ++v) sum += part[v][e][lane];
    acc[e] = sum;
  }
  store_slab<C, VEC, BF>(y + static_cast<size_t>(row) * n + n0, lane, n - n0,
                         acc);
}

template <int C, bool VEC, bool BF>
int launch_form(cudaStream_t s, const void* row_slot, const void* vals,
                const void* xrows, const void* long_rows, const void* x,
                void* y, int m, int n, int long_row, int num_long) {
  using T = Elem<BF>;
  const dim3 grid(m / WARPS + (m % WARPS != 0),
                  n / (SLAB * C) + (n % (SLAB * C) != 0));
  walk<C, VEC, BF><<<grid, THREADS, 0, s>>>(
      static_cast<const int*>(row_slot), static_cast<const T*>(vals),
      static_cast<const int*>(xrows), static_cast<const T*>(x),
      static_cast<T*>(y), m, n, long_row);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_long == 0) return static_cast<int>(err);
  long_walk<C, VEC, BF><<<dim3(num_long, grid.y), LONG_THREADS, 0, s>>>(
      static_cast<const int*>(long_rows), static_cast<const int*>(row_slot),
      static_cast<const T*>(vals), static_cast<const int*>(xrows),
      static_cast<const T*>(x), static_cast<T*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

template <int C, bool BF>
int launch_cols(bool vec, cudaStream_t s, const void* row_slot,
                const void* vals, const void* xrows, const void* long_rows,
                const void* x, void* y, int m, int n, int long_row,
                int num_long) {
  return vec ? launch_form<C, true, BF>(s, row_slot, vals, xrows, long_rows,
                                        x, y, m, n, long_row, num_long)
             : launch_form<C, false, BF>(s, row_slot, vals, xrows, long_rows,
                                         x, y, m, n, long_row, num_long);
}

// The walk and, where there are long rows, the long-row walk on `stream`;
// 0 or the CUDA error. C is 1, 2 or 4 by n (a warp covers 128, 256 or 512
// columns); the vector form when n % 4 == 0 and X and Y are aligned to four
// elements (16 B in f32, 8 B in bf16), else the scalar form. long_rows
// holds the num_long rows with more than long_row slots. BF: the bf16 form.
template <bool BF = false>
int launch(const void* row_slot, const void* vals, const void* xrows,
           const void* long_rows, const void* x, void* y, int m, int n,
           int long_row, int num_long, void* stream) {
  if (m < 0 || n < 0 || long_row < 0 || num_long < 0 || num_long > m)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  const std::uintptr_t addr = reinterpret_cast<std::uintptr_t>(x) |
                              reinterpret_cast<std::uintptr_t>(y);
  const bool vec = n % 4 == 0 && addr % (4 * sizeof(Elem<BF>)) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= SLAB)
    return launch_cols<1, BF>(vec, s, row_slot, vals, xrows, long_rows, x, y,
                              m, n, long_row, num_long);
  if (n <= 2 * SLAB)
    return launch_cols<2, BF>(vec, s, row_slot, vals, xrows, long_rows, x, y,
                              m, n, long_row, num_long);
  return launch_cols<4, BF>(vec, s, row_slot, vals, xrows, long_rows, x, y, m,
                            n, long_row, num_long);
}

}  // namespace
}  // namespace slot_rows
}  // namespace spgrid
