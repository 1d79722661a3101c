// Aligned-slot banded SpMM, Y = A @ X with A in DeviceWCOOBands layout.
//
// Replaces: spgrid/ops/pallas/wcoo_spmm_aligned.py, _make_kernel / _spmm
// (the Pallas TPU kernel behind `wcoo_bands`: groups of 8 windows x 128
// lanes, lane = target row, sorted by 1024-column superwindow inside a row
// band whose output slab stays resident, with a sacrificial row block for
// pad groups).
//
// Bound on the H100: device-memory bytes, as for wcoo_spmm: at the main
// path's shape X and Y are 134 MB each against 0.4 GFLOP of products.
//
// Design: one CTA per (128-row block of Y, 64 columns); block b is row block
// lb of band b / mbb, i.e. rows 128 b .. 128 b + 127. It walks the groups
// that land on its block through block_ptr / block_groups, built once with
// the layout (inside a band the groups are sorted by superwindow first, so
// one block's groups are not consecutive), and accumulates with the
// slot-list tile of slot_tile.cuh: slot (w, lane) of group g adds
// vals * X[1024 sw + 128 w + col] to row `lane` of the tile, sw being the
// superwindow of g's step of 16 groups. Pad groups (row block mbb) are in
// no block's list and are never read. The Pallas kernel zeroed its slab at
// a band's first step; here each CTA writes its whole tile, zeros included.
// Empty slots (value 0) are not live, and a slot whose X row lies at or
// past k is never read: X is not padded to the superwindow.
#include "slot_tile.cuh"

namespace {

constexpr int GROUP_ROWS = 8;  // windows of a superwindow == rows of a group
constexpr int G_STEP = 16;     // groups of a step, which share g_sw
constexpr int GROUP_SLOTS = GROUP_ROWS * spgrid::LANE;
constexpr int SUPERWINDOW = GROUP_ROWS * spgrid::LANE;  // columns of X

__global__ void __launch_bounds__(spgrid::SLOT_COLS)
wcoo_bands_kernel(const int* __restrict__ block_ptr,
                  const int* __restrict__ block_groups,
                  const int* __restrict__ g_sw,
                  const unsigned char* __restrict__ cols,
                  const float* __restrict__ vals,
                  const float* __restrict__ x, float* __restrict__ y, int m,
                  int k, int n) {
  using spgrid::LANE;
  __shared__ float tile[LANE][spgrid::SLOT_COLS];
  __shared__ spgrid::SlotList<GROUP_SLOTS> list;
  const int b = blockIdx.x;
  const int n0 = blockIdx.y * spgrid::SLOT_COLS;
  spgrid::zero_tile(tile);
  for (int p = block_ptr[b]; p < block_ptr[b + 1]; ++p) {
    const int g = block_groups[p];
    const int xbase = g_sw[g / G_STEP] * SUPERWINDOW;
    int count = 0;
    for (int s = threadIdx.x; s < GROUP_SLOTS; s += spgrid::SLOT_COLS) {
      const size_t e = static_cast<size_t>(g) * GROUP_SLOTS + s;
      const int lane = s % LANE;
      const float v = vals[e];
      const int xrow = xbase + (s / LANE) * LANE + cols[e];
      count = spgrid::append_live(list, count, v != 0.0f && xrow < k, lane,
                                  xrow, v);
    }
    spgrid::accumulate(tile, list, count, x, n, n0);
  }
  spgrid::write_tile(tile, y, static_cast<long long>(b) * LANE, m, n, n0);
}

}  // namespace

extern "C" int spgrid_wcoo_bands(const void* block_ptr,
                                 const void* block_groups, const void* g_sw,
                                 const void* cols, const void* vals,
                                 const void* x, void* y, int blocks, int m,
                                 int k, int n, void* stream) {
  const dim3 grid(blocks, (n + spgrid::SLOT_COLS - 1) / spgrid::SLOT_COLS);
  wcoo_bands_kernel<<<grid, spgrid::SLOT_COLS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(block_ptr),
      static_cast<const int*>(block_groups), static_cast<const int*>(g_sw),
      static_cast<const unsigned char*>(cols),
      static_cast<const float*>(vals), static_cast<const float*>(x),
      static_cast<float*>(y), m, k, n);
  return static_cast<int>(cudaGetLastError());
}
