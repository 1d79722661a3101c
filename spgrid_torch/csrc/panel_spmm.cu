// Vertical-panel SpMM, Y = A @ X with A in DevicePanels layout.
//
// Replaces: spgrid/ops/pallas/panel_spmm.py, _kernel / _panel_spmm (the
// Pallas TPU kernel behind `panel_pallas`).
//
// Bound on the H100: the same work as the BSR kernel with taller blocks: a
// panel is all R rows of a row band for one block column (R x bk), and the
// kernel does the panels' full work, 2 R bk n flops each. At the headline
// (512 x 512, n = 512) R = 512: one band of four panels, 0.27 GFLOP, three
// times over in 3xTF32, 1.6 us at 495 TFLOP/s; A, X and Y (3 MB) sit in
// L2. The grid is what is short: 4 row slices x 8 column tiles of 64 is 32
// tiles for 132 SMs, each a contraction of 16 steps.
//
// Design (the tile of block_mma.cuh, as bsr_spmm.cu runs it): a band is a
// row of blocks whose blocks are its panel slots, so each tile (band, slice
// of 128 of its R rows, 64 columns of X) runs `row_tile_spmm` over slots
// band * max_p .. band * max_p + counts[band] - 1, 3xTF32 on the tensor
// cores through a cp.async ring, its steps split across a cluster of C
// CTAs (`cluster_for`, from the grid and the SM count: C = 4 at the
// headline, 128 CTAs of 4 steps). Bands taller than 128 rows run as slices
// of 128 (16 at the default R = 2048; the last slice of R = 1000 has 104
// rows); below 64 rows one warpgroup multiplies. Pad slots (zero panels
// that repeat the band's last column) lie past the band's count and are
// never visited. Every element of Y is written once, zeros included (a
// band with no panel writes zeros), with no atomics; rows >= m are never
// written and X rows >= k read as zero.
#include "block_mma.cuh"

namespace {

__global__ void __launch_bounds__(THREADS, 2)
panel_spmm_kernel(const int* __restrict__ counts, const int* __restrict__ cols,
                  const float* __restrict__ panels,
                  const float* __restrict__ x, float* __restrict__ y,
                  int max_p, int band_rows, int bk, int m, int k, int n,
                  int slices, int col_tiles, bool a16, bool x16, bool y16) {
  const RowTile t = row_tile(slices, col_tiles);
  const int begin = t.r * max_p;
  row_tile_spmm(t, begin, begin + counts[t.r], cols, panels, x, y,
                band_rows, bk, m, k, n, a16, x16, y16);
}

}  // namespace

// out (int[6]) = {tiles, cluster, ROWS, NT, TK, STAGES} of the launch
// spgrid_panel_spmm makes for these sizes at cluster 0 on the current card.
extern "C" int spgrid_panel_spmm_shape(int bands, int band_rows, int n,
                                       void* out) {
  if (bands <= 0 || band_rows <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return report_shape(row_tiles(bands, band_rows, n), out);
}

// cluster: 0 for the launch rule (cluster_for), else 1, 2, 4 or 8.
extern "C" int spgrid_panel_spmm(const void* counts, const void* cols,
                                 const void* panels, const void* x, void* y,
                                 int bands, int max_p, int band_rows, int bk,
                                 int m, int k, int n, int cluster,
                                 void* stream) {
  if (bands <= 0 || max_p <= 0 || band_rows <= 0 || bk <= 0 || m <= 0 ||
      n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_clusters(
      panel_spmm_kernel, row_tiles(bands, band_rows, n), cluster, stream,
      static_cast<const int*>(counts), static_cast<const int*>(cols),
      static_cast<const float*>(panels), static_cast<const float*>(x),
      static_cast<float*>(y), max_p, band_rows, bk, m, k, n,
      (band_rows + ROWS - 1) / ROWS, (n + NT - 1) / NT,
      bk % 4 == 0 && aligned16(panels), n % 4 == 0 && aligned16(x),
      n % 4 == 0 && aligned16(y));
}
