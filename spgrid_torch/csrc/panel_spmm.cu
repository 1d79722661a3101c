// Vertical-panel SpMM, Y = A @ X with A in DevicePanels layout.
//
// Replaces: spgrid/ops/pallas/panel_spmm.py, _kernel / _panel_spmm (the
// Pallas TPU kernel behind `panel_pallas`).
//
// Bound on the H100: the same work as the BSR kernel with taller blocks: a
// panel is all R rows of a row band for one block column (R x bk). At the
// headline shape (512 x 512, n = 512) R = 512, one band and four panels on
// 64 CTAs: latency bound like bsr_spmm.cu, with everything in L2 (57 us on
// an H100 SXM at 700 W).
//
// Design: one CTA per (band, 64 columns of X, 64 rows of the band). A band
// is a row of blocks whose blocks are its panel slots, so the CTA runs the
// same tiled product as bsr_spmm.cu over slots band * max_p ... band *
// max_p + counts[band]. Pad slots (zero panels that repeat the band's last
// column) lie past the band's count and are skipped. Every output element
// of the tile is written, zeros included; rows >= m and X rows >= k are
// masked.
#include "block_tile.cuh"

namespace {

__global__ void __launch_bounds__(spgrid::THREADS)
panel_spmm_kernel(const int* __restrict__ counts, const int* __restrict__ cols,
                  const float* __restrict__ panels, const float* __restrict__ x,
                  float* __restrict__ y, int max_p, int band_rows, int bk,
                  int m, int k, int n) {
  __shared__ spgrid::Stage s;
  const int band = blockIdx.x;
  const int begin = band * max_p;
  spgrid::block_row_spmm(s, begin, begin + counts[band], cols, panels,
                         band_rows, bk,
                         static_cast<long long>(band) * band_rows, x, y, m, k,
                         n);
}

}  // namespace

extern "C" int spgrid_panel_spmm(const void* counts, const void* cols,
                                 const void* panels, const void* x, void* y,
                                 int bands, int max_p, int band_rows, int bk,
                                 int m, int k, int n, void* stream) {
  const dim3 grid(bands, spgrid::cdiv(n, spgrid::TILE),
                  spgrid::cdiv(band_rows, spgrid::TILE));
  panel_spmm_kernel<<<grid, spgrid::THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(counts), static_cast<const int*>(cols),
      static_cast<const float*>(panels), static_cast<const float*>(x),
      static_cast<float*>(y), max_p, band_rows, bk, m, k, n);
  return static_cast<int>(cudaGetLastError());
}
