// Windowed slot-chunk COO SpMM, Y = A @ X with A in DeviceWCOO layout.
//
// Replaces: spgrid/ops/pallas/wcoo_spmm.py, _kernel / _wcoo_spmm (the Pallas
// TPU kernel behind `wcoo_pallas`: per chunk a 128-lane gather of the X
// window, a product with the slot values and a one-hot matmul that reduces
// the slots onto the subblock's rows of a transposed output tile).
//
// Bound on the H100: device-memory bytes. At the main path's shape (65535^2,
// 5 nnz a row, n = 512) X and Y are 134 MB each and the product 0.4 GFLOP;
// the least time is ~81 us at 3.35 TB/s. Each nnz gathers a 2 KB row of X,
// 803 MB in all, mostly from L2: a run of rows reads a band of X rows that
// stays there.
//
// Design: the TPU kernel's chunks exist for its 128-lane gather and its
// resident output tile. Their slots are mostly padding (14.8 % live at the
// main path), so this kernel does not read them: it walks the layout's
// row-ordered live-slot stream (DeviceWCOO.row_slot / slot_vals /
// slot_xrows, built on the host from the chunks) with the shared walk of
// slot_rows.cuh: a warp a row, its slab of Y in registers, the slots'
// (value, X row) pairs loaded 32 at a time and handed out by shuffles,
// float4 X-row gathers, every element of Y written once, zeros included.
// Pad slots (value 0) and slots whose X row lies at or past k were dropped
// when the stream was built: X is not padded to the window.
#include "slot_rows.cuh"

// row_slot, vals, xrows, long_rows, x, y, m, n, long_row, num_long, stream
extern "C" int spgrid_wcoo_spmm(const void* row_slot, const void* vals,
                                const void* xrows, const void* long_rows,
                                const void* x, void* y, int m, int n,
                                int long_row, int num_long, void* stream) {
  return spgrid::slot_rows::launch(row_slot, vals, xrows, long_rows, x, y, m,
                                   n, long_row, num_long, stream);
}
