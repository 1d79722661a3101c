// Aligned-slot banded SpMM, Y = A @ X with A in DeviceWCOOBands layout.
//
// Replaces: spgrid/ops/pallas/wcoo_spmm_aligned.py, _make_kernel / _spmm
// (the Pallas TPU kernel behind `wcoo_bands`: groups of 8 windows x 128
// lanes, lane = target row, sorted by 1024-column superwindow inside a row
// band whose output slab stays resident, with a sacrificial row block for
// pad groups).
//
// Bound on the H100: device-memory bytes, as for wcoo_spmm: at the main
// path's shape X and Y are 134 MB each against 0.4 GFLOP of products, and
// the 803 MB of gathered X rows come mostly from L2.
//
// Design: the groups, their superwindows and the pad groups exist for the
// TPU's 128-lane gather and its resident slab. Their slots are mostly empty
// (5.7 % live at the main path), so this kernel does not read them: it walks
// the layout's row-ordered live-slot stream (DeviceWCOOBands.row_slot /
// slot_vals / slot_xrows, built on the host from the real groups, the
// columns read as unsigned bytes; pad groups and the sacrificial row block
// are never read) with the shared walk of slot_rows.cuh, as wcoo_spmm.cu
// does: a warp a row, its slab of Y in registers, float4 X-row gathers,
// every element of Y written once, zeros included. Empty slots and slots
// whose X row lies at or past k were dropped when the stream was built: X is
// not padded to the superwindow.
//
// The bf16 form (wcoo_bands at dtype bf16): the same walk on bf16 values,
// X and Y, each product rounded to bf16 before it is added into the f32
// sum, as the Pallas kernel's bf16 multiply rounds it, and Y rounded once.
#include "slot_rows.cuh"

// row_slot, vals, xrows, long_rows, x, y, m, n, long_row, num_long, stream
extern "C" int spgrid_wcoo_bands(const void* row_slot, const void* vals,
                                 const void* xrows, const void* long_rows,
                                 const void* x, void* y, int m, int n,
                                 int long_row, int num_long, void* stream) {
  return spgrid::slot_rows::launch(row_slot, vals, xrows, long_rows, x, y, m,
                                   n, long_row, num_long, stream);
}

// The bf16 form: vals, x and y as bf16 bit patterns; the same arguments.
extern "C" int spgrid_wcoo_bands_bf16(const void* row_slot, const void* vals,
                                      const void* xrows, const void* long_rows,
                                      const void* x, void* y, int m, int n,
                                      int long_row, int num_long,
                                      void* stream) {
  return spgrid::slot_rows::launch<true>(row_slot, vals, xrows, long_rows, x,
                                         y, m, n, long_row, num_long, stream);
}
