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
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// One row longer than TILE: every thread sums a strided share of its slots,
// PER slots in flight a round; then the fixed-order reduction.
template <int PER>
__device__ void long_row(const float* __restrict__ vals,
                         const int* __restrict__ xidx,
                         const float* __restrict__ x, int s0, int count,
                         float* __restrict__ y_row, float* warp_sums) {
  constexpr int TILE = PER * THREADS;
  const int t = threadIdx.x;
  float acc = 0.0f;
  for (int base = 0; base < count; base += TILE) {
    float v[PER], xv[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int j = base + t + q * THREADS;
      v[q] = 0.0f;
      xv[q] = 0.0f;
      if (j < count) {
        v[q] = __ldg(vals + s0 + j);
        xv[q] = __ldg(x + __ldg(xidx + s0 + j));
      }
    }
#pragma unroll
    for (int q = 0; q < PER; ++q) acc = fmaf(v[q], xv[q], acc);
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
    *y_row = sum;
  }
}

// TILE = PER * THREADS live slots a tile, PER a thread.
template <int PER>
__global__ void __launch_bounds__(THREADS)
wcoo_spmv_kernel(const int* __restrict__ tile_row,
                 const int* __restrict__ row_slot,
                 const float* __restrict__ vals,
                 const int* __restrict__ xidx, const float* __restrict__ x,
                 float* __restrict__ y) {
  constexpr int TILE = PER * THREADS;
  __shared__ float2 pairs[TILE];
  __shared__ float warp_sums[WARPS];
  const int t = threadIdx.x;
  const int r0 = tile_row[blockIdx.x];
  const int r1 = tile_row[blockIdx.x + 1];
  const int s0 = row_slot[r0];
  const int count = row_slot[r1] - s0;
  if (count > TILE) {  // the host gives such a tile one row: r1 == r0 + 1
    long_row<PER>(vals, xidx, x, s0, count, y + r0, warp_sums);
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
      v[q] = __ldg(vals + s0 + j);
      xi[q] = __ldg(xidx + s0 + j);
    }
  }
  float xv[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    xv[q] = t + q * THREADS < count ? __ldg(x + xi[q]) : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int j = t + q * THREADS;
    if (j < count) pairs[j] = make_float2(v[q], xv[q]);
  }
  __syncthreads();
  if (row < r1) {
    float acc = 0.0f;
    for (int j = begin; j < end; ++j) {
      const float2 p = pairs[j];
      acc = fmaf(p.x, p.y, acc);
    }
    y[row] = acc;
  }
}

}  // namespace

// tile_slots: 512, 1024 or 2048, the TILE that tile_row was cut at
// (ops/kernels/wcoo_spmv.py:row_tiles).
extern "C" int spgrid_wcoo_spmv(const void* tile_row, const void* row_slot,
                                const void* vals, const void* xidx,
                                const void* x, void* y, int tiles,
                                int tile_slots, void* stream) {
  if (tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles == 0) return static_cast<int>(cudaSuccess);
  using Kernel = void (*)(const int*, const int*, const float*, const int*,
                          const float*, float*);
  Kernel kernel;
  switch (tile_slots) {
    case 512: kernel = wcoo_spmv_kernel<2>; break;
    case 1024: kernel = wcoo_spmv_kernel<4>; break;
    case 2048: kernel = wcoo_spmv_kernel<8>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_row), static_cast<const int*>(row_slot),
      static_cast<const float*>(vals), static_cast<const int*>(xidx),
      static_cast<const float*>(x), static_cast<float*>(y));
  return static_cast<int>(cudaGetLastError());
}
