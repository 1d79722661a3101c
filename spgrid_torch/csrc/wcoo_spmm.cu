// Windowed slot-chunk COO SpMM, Y = A @ X with A in DeviceWCOO layout.
//
// Replaces: spgrid/ops/pallas/wcoo_spmm.py, _kernel / _wcoo_spmm (the Pallas
// TPU kernel behind `wcoo_pallas`: per chunk a 128-lane gather of the X
// window, a product with the slot values and a one-hot matmul that reduces
// the slots onto the subblock's rows of a transposed output tile).
//
// Bound on the H100: device-memory bytes. At the main path's shape (65535^2,
// 5 nnz a row, n = 512) X and Y are 134 MB each and the slot arrays 32 MB,
// while the product is 0.4 GFLOP; the least time is ~90 us at 3.35 TB/s.
// Each nnz costs one 256-byte row read of X per 64 columns, from L2 when
// the window's rows were read by a neighbouring CTA.
//
// Design: one CTA per (128-row tile, 64 columns of Y); tile t is the
// (row block, subblock) pair rb * (R / 128) + sub, i.e. rows 128 t .. 128 t
// + 127. It walks the chunks that land on its tile through tile_ptr /
// tile_chunks (built once with the layout: a row block's chunks are
// consecutive, but their subblocks interleave) and accumulates with the
// slot-list tile of slot_tile.cuh. The Pallas kernel zeroed its resident
// tile on a row block's first chunk, and the layout's empty coverage chunks
// exist for that; here each CTA writes its whole tile, zeros included, so a
// tile with no chunk, or only coverage chunks, comes out zero. Pad slots
// (value 0) are not live; a slot whose X row lies at or past k is never
// read, since X is not padded to the window.
#include "slot_tile.cuh"

namespace {

__global__ void __launch_bounds__(spgrid::SLOT_COLS)
wcoo_spmm_kernel(const int* __restrict__ tile_ptr,
                 const int* __restrict__ tile_chunks,
                 const int* __restrict__ chunk_win,
                 const int* __restrict__ cols, const int* __restrict__ rows,
                 const float* __restrict__ vals, const float* __restrict__ x,
                 float* __restrict__ y, int m, int k, int n) {
  using spgrid::LANE;
  __shared__ float tile[LANE][spgrid::SLOT_COLS];
  __shared__ spgrid::SlotList<LANE> list;
  const int t = blockIdx.x;
  const int n0 = blockIdx.y * spgrid::SLOT_COLS;
  spgrid::zero_tile(tile);
  for (int p = tile_ptr[t]; p < tile_ptr[t + 1]; ++p) {
    const int c = tile_chunks[p];
    const int xbase = chunk_win[c] * LANE;
    int count = 0;
    for (int s = threadIdx.x; s < LANE; s += spgrid::SLOT_COLS) {
      const size_t e = static_cast<size_t>(c) * LANE + s;
      const float v = vals[e];
      const int xrow = xbase + cols[e];
      count = spgrid::append_live(list, count, v != 0.0f && xrow < k,
                                  rows[e], xrow, v);
    }
    spgrid::accumulate(tile, list, count, x, n, n0);
  }
  spgrid::write_tile(tile, y, static_cast<long long>(t) * LANE, m, n, n0);
}

}  // namespace

extern "C" int spgrid_wcoo_spmm(const void* tile_ptr, const void* tile_chunks,
                                const void* chunk_win, const void* cols,
                                const void* rows, const void* vals,
                                const void* x, void* y, int tiles, int m,
                                int k, int n, void* stream) {
  const dim3 grid(tiles, (n + spgrid::SLOT_COLS - 1) / spgrid::SLOT_COLS);
  wcoo_spmm_kernel<<<grid, spgrid::SLOT_COLS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_ptr), static_cast<const int*>(tile_chunks),
      static_cast<const int*>(chunk_win), static_cast<const int*>(cols),
      static_cast<const int*>(rows), static_cast<const float*>(vals),
      static_cast<const float*>(x), static_cast<float*>(y), m, k, n);
  return static_cast<int>(cudaGetLastError());
}
