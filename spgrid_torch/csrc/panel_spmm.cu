// Vertical-panel SpMM, Y = A @ X with A in DevicePanels layout, in three
// forms: f32 panels (3xTF32, below), and bf16 panels with f32 X and Y or
// with bf16 X and Y (further below).
//
// Replaces: spgrid/ops/pallas/panel_spmm.py, _kernel / _panel_spmm (the
// Pallas TPU kernel behind `panel_pallas` at f32 and at bf16 (bf16 panels
// and X, f32 sums, Y rounded to bf16), and behind `cv_panel` with its bf16
// panels at precision "default": bf16 panels times X rounded to bf16, f32
// sums).
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
#include "bf16_mma.cuh"

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

// The bf16 forms. Bound on the H100: the bytes of the function (each
// nnz's bf16 value and index, X and Y once: in f32 for cv_panel, in bf16
// for the bf16 panels' form) over 3.35 TB/s, 0.0108 ms for cv_panel on
// LINE_B (8192^2, 413,698 nnz, n = 512); the panels' dense work over 989
// TFLOP/s bf16 lies below it where the panels are sparse. At the headline
// (one band of R = 512 rows, four panels, n = 512) A (256 KB in bf16), X
// and Y sit in L2 and the grid is short, as in the f32 form.
//
// Design: the f32 form's launch (a tile is a band's 128-row slice by 64
// columns of X, its steps split across a cluster where the tiles alone
// leave the card idle, the ranks' partial tiles summed in rank order
// through distributed shared memory), on the bf16 tile of bf16_mma.cuh
// (`bf16_row_tile`), with one change: a tile walks only its live slots,
// those of its band's real panels that hold an entry of the CSR in its
// 128-row slice, in column order, from the host-built index slice_ptr /
// slice_slots (on LINE_B 316 of the 1,216 (panel, slice) pairs). A tile
// with none writes zeros. cv_panel's form reads f32 X, rounded to bf16 as
// its fragments are loaded, and writes f32 Y; the bf16 panels' form (the
// Pallas kernel at dtype bf16: bf16 panels and X, f32 sums, Y rounded once
// to bf16) copies bf16 X straight into the ring (half the bytes) and
// writes bf16 Y. The bf16 panels' form runs the pipelined tile of
// bf16_mma.cuh (`bf16_pipe_tile`: TMA into a 6-stage ring fed by a
// producer warp, both operands from shared memory, 128 columns of X a
// tile, overlapped steps) where TMA takes its operands (bk and n multiples
// of 8, panels and X on 16 bytes), else the cp.async tile. cv_panel's form
// stays on the cp.async tile: its X is f32, rounded as it is loaded, which
// TMA cannot do.
template <bool XH>
__global__ void __launch_bounds__(THREADS, 2)
panel_spmm_bf16_kernel(const int* __restrict__ slice_ptr,
                       const int* __restrict__ slice_slots,
                       const int* __restrict__ cols,
                       const unsigned short* __restrict__ panels,
                       const void* x, void* y, int band_rows, int bk, int m,
                       int k, int n, int slices, int col_tiles, bool a16,
                       bool x16, bool y16) {
  const RowTile t = row_tile(slices, col_tiles);
  const int slice = t.r * slices + t.i0 / ROWS;
  const int first = slice_ptr[slice];
  bf16_row_tile<XH>(t, first, slice_ptr[slice + 1] - first, slice_slots,
                    cols, panels, x, y, band_rows, bk, m, k, n, a16, x16,
                    y16);
}

// The bf16 panels' form on the pipelined tile.
__global__ void __launch_bounds__(PT_THREADS, 1)
panel_spmm_bf16_pipe_kernel(const __grid_constant__ CUtensorMap a_map,
                            const __grid_constant__ CUtensorMap x_map,
                            const int* __restrict__ slice_ptr,
                            const int* __restrict__ slice_slots,
                            const int* __restrict__ cols, unsigned short* y,
                            int band_rows, int bk, int m, int n, int slices,
                            int col_tiles, bool y16) {
  const RowTile t = listed_tile<PT_NT>(nullptr, slices, col_tiles);
  const int slice = t.r * slices + t.i0 / ROWS;
  const int first = slice_ptr[slice];
  bf16_pipe_tile(t, first, slice_ptr[slice + 1] - first, slice_slots, cols,
                 &a_map, &x_map, y, band_rows, bk, m, n, y16);
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

// out (int[6]) = {tiles, cluster, ROWS, cols, BF_TK, stages} of the launch
// spgrid_panel_spmm_bf16 makes for these sizes at cluster 0: the bf16
// panels' form (xy_bf16 1) on the pipelined tile where bk % 8 == n % 8 ==
// 0 (128 columns, PT_STAGES), else the cp.async tile (64, BF_STAGES).
extern "C" int spgrid_panel_spmm_bf16_shape(int bands, int band_rows, int bk,
                                            int n, int xy_bf16, void* out) {
  if (bands <= 0 || band_rows <= 0 || bk <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long slices =
      static_cast<long long>(bands) * ((band_rows + ROWS - 1) / ROWS);
  if (xy_bf16 && bk % 8 == 0 && n % 8 == 0) {
    return report_shape(pipe_tiles(slices, n), out, BF_TK, PT_STAGES, PT_NT,
                        PT_SHARE);
  }
  return report_shape(row_tiles(bands, band_rows, n), out, BF_TK, BF_STAGES);
}

// The bf16 forms: panels as bf16 bit patterns, walked by the live-slice
// index (slice_ptr: bands x ceil(band_rows / 128) + 1 offsets into
// slice_slots); X and Y f32 (xy_bf16 0: cv_panel) or bf16 (xy_bf16 1).
// max_p: panel slots a band (the panels hold bands x max_p of band_rows x
// bk). cluster: 0 for the launch rule, else 1, 2, 4 or 8.
extern "C" int spgrid_panel_spmm_bf16(const void* slice_ptr,
                                      const void* slice_slots,
                                      const void* cols, const void* panels,
                                      const void* x, void* y, int bands,
                                      int max_p, int band_rows, int bk, int m,
                                      int k, int n, int xy_bf16, int cluster,
                                      void* stream) {
  if (bands <= 0 || max_p <= 0 || band_rows <= 0 || bk <= 0 || m <= 0 ||
      k <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = row_tiles(bands, band_rows, n);
  const int slices = (band_rows + ROWS - 1) / ROWS;
  const int col_tiles = (n + NT - 1) / NT;
  const bool a16 = bk % 8 == 0 && aligned16(panels);
  CUtensorMap a_map, x_map;
  if (xy_bf16 && bk % 8 == 0 && n % 8 == 0 &&
      pipe_maps(&a_map, &x_map, panels,
                static_cast<long long>(bands) * max_p * band_rows, bk, x, k,
                n)) {
    return launch_cta_tiles(
        panel_spmm_bf16_pipe_kernel,
        pipe_tiles(static_cast<long long>(bands) * slices, n), cluster,
        PT_SMEM, PT_THREADS, PT_SHARE, stream, a_map, x_map,
        static_cast<const int*>(slice_ptr),
        static_cast<const int*>(slice_slots), static_cast<const int*>(cols),
        static_cast<unsigned short*>(y), band_rows, bk, m, n, slices,
        (n + PT_NT - 1) / PT_NT, n % 4 == 0 && aligned8(y));
  }
  if (xy_bf16) {
    return launch_tiles(
        panel_spmm_bf16_kernel<true>, tiles, cluster, RowStage<true>::SMEM,
        stream, static_cast<const int*>(slice_ptr),
        static_cast<const int*>(slice_slots), static_cast<const int*>(cols),
        static_cast<const unsigned short*>(panels), x, y, band_rows, bk, m,
        k, n, slices, col_tiles, a16, n % 8 == 0 && aligned16(x),
        n % 4 == 0 && aligned8(y));
  }
  return launch_tiles(
      panel_spmm_bf16_kernel<false>, tiles, cluster, RowStage<false>::SMEM,
      stream, static_cast<const int*>(slice_ptr),
      static_cast<const int*>(slice_slots), static_cast<const int*>(cols),
      static_cast<const unsigned short*>(panels), x, y, band_rows, bk, m, k,
      n, slices, col_tiles, a16, n % 4 == 0 && aligned16(x),
      n % 4 == 0 && aligned16(y));
}
