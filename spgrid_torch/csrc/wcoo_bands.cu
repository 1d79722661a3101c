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
// The bf16 form (wcoo_bands at dtype bf16): bf16 values, X and Y, each
// product rounded to bf16 before it is added into the f32 sum, as the
// Pallas kernel's bf16 multiply rounds it (wcoo_spmm_aligned.py:194), and
// Y rounded once (:270). Bound on the H100: X read once and Y written once
// (402 MB on wideband_196k, n = 512: 0.121 ms at 3.35 TB/s); each live slot
// also gathers its X row's slab (1.41 GB there), mostly from L2.
// What held its first form (the walk above, 8 bytes a lane, the product
// rounded by round_bf16 on the CUDA cores; 0.345944 ms on wideband_196k
// and 0.088678 on MAIN_LINE, NVIDIA H100 80GB HBM3, 700 W): a warp a row
// and, at n = 512, one slot's loads in flight a lane (U = LOADS / C = 1).
// The design now (slot_rows.cuh's walk16, where n % 8 == 0 and X and Y lie
// on 16 bytes; the 8-byte and scalar forms otherwise, in the same slabs):
// 16 bytes a lane, the raw loads of U slots in flight, the products by
// mul.rn.bf16x2 (exact bf16 products rounded once, so the bits of
// round_bf16 of the f32 product wherever that lies in f32's normal range;
// below it, |v x| < 2^-126, the f32 product is itself rounded to the
// subnormal grid first, and the two roundings may differ from the one by
// an ulp of the subnormal result), a warp walking two sets of rows with
// the next set's slots loaded ahead.
// The slab rule (bands_slab): the widest slab, 512 columns (one slab of n
// where n <= 512). Slabs that keep the X rows a band reaches in L2 were
// slower, measured on the H100 (NVIDIA H100 80GB HBM3, 700 W; device ms,
// graph replay, n = 512, 16-byte form at slabs 64, 128, 256, 512):
// wideband_196k 0.343405, 0.321546, 0.310715, 0.320798; MAIN_LINE
// 0.094898, 0.093131, 0.088152, 0.071164; the 8-byte form slower at every
// slab (see PERF.md, row 6b). At 256 columns wideband_196k ran 3 % faster
// than at 512, MAIN_LINE 24 % slower. With every gather made to hit one X
// row, wideband_196k still took 0.166594 at 512 and 0.229647 at 256: a
// narrower slab halves the gathers' misses but adds more to the walk.
// Whole form: wideband_196k 0.320834, MAIN_LINE 0.071241 (from 0.356543
// and 0.088437 for the first form on the same card).
#include <cstdint>

#include "slot_rows.cuh"

namespace {

using namespace spgrid::slot_rows;

// The bands' bf16 forms: 2 the 16-byte walk (n % 8 == 0, X and Y on 16
// bytes), 1 the 8-byte one (n % 4 == 0, on 8), 0 an element a lane.
int bands_vec(int n, const void* x, const void* y) {
  const std::uintptr_t at = reinterpret_cast<std::uintptr_t>(x) |
                            reinterpret_cast<std::uintptr_t>(y);
  if (n % 8 == 0 && at % 16 == 0) return 2;
  if (n % 4 == 0 && at % 8 == 0) return 1;
  return 0;
}

// The slab the bands' bf16 walk takes for n columns when asked for `slab`:
// 0 asks for the rule, the widest, V16_MAX_SLAB (one slab of n where n is
// no wider: on the H100 the widest slab was the fastest on both of 11a's
// cases, see the top of this file); a power of two from V16_MIN_SLAB to
// V16_MAX_SLAB is taken as it is, one slab of n where that covers n. -1 for
// a request it refuses.
int bands_slab(int n, int slab) {
  if (slab == 0) {
    slab = V16_MAX_SLAB;
  } else if (slab < V16_MIN_SLAB || slab > V16_MAX_SLAB ||
             (slab & (slab - 1)) != 0) {
    return -1;
  }
  return slab >= n ? n : slab;
}

// L lanes a row and E vectors a lane for a slab of `slab` columns in
// vectors of w elements: the slab's vectors rounded up to a power of two
// P, L = min(P, 32), E = P / L.
void bands_lanes(int slab, int w, int* lanes, int* per_lane) {
  const int vectors = (slab + w - 1) / w;
  int p = 1;
  while (p < vectors) p *= 2;
  *lanes = p < 32 ? p : 32;
  *per_lane = p / *lanes;
}

// wcoo_bands' bf16 form (RP) at the slab `bands_slab` gives: the 16-byte
// walk, or the present walk (8-byte or scalar) in slabs of that width;
// then the long-row walk in the same slabs. 0 or the CUDA error.
int launch_bands(const void* row_slot, const void* vals, const void* xrows,
                 const void* long_rows, const void* x, void* y, int m, int n,
                 int long_row, int num_long, int slab, void* stream) {
  if (m < 0 || n < 0 || long_row < 0 || num_long < 0 || num_long > m)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  const int width = bands_slab(n, slab);
  if (width < 1 || (n + width - 1) / width > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = bands_vec(n, x, y);
  int err = 0;
  if (vec == 2) {
    int lanes = 0;
    int per_lane = 0;
    bands_lanes(width, 8, &lanes, &per_lane);
    if (per_lane == 2) {
      err = launch16<32, 2>(s, row_slot, vals, xrows, x, y, m, n, width,
                            long_row);
    } else {
      switch (lanes) {
        case 1: err = launch16<1, 1>(s, row_slot, vals, xrows, x, y, m, n,
                                     width, long_row); break;
        case 2: err = launch16<2, 1>(s, row_slot, vals, xrows, x, y, m, n,
                                     width, long_row); break;
        case 4: err = launch16<4, 1>(s, row_slot, vals, xrows, x, y, m, n,
                                     width, long_row); break;
        case 8: err = launch16<8, 1>(s, row_slot, vals, xrows, x, y, m, n,
                                     width, long_row); break;
        case 16: err = launch16<16, 1>(s, row_slot, vals, xrows, x, y, m, n,
                                       width, long_row); break;
        default: err = launch16<32, 1>(s, row_slot, vals, xrows, x, y, m, n,
                                       width, long_row); break;
      }
    }
    if (err != 0) return err;
  }
  // the present walk's C (a warp covers 128 C columns) for the slab
  const int c = width <= SLAB ? 1 : width <= 2 * SLAB ? 2 : 4;
  if (vec == 2) {
    if (c == 1)
      return launch_long<1, true, true, true>(s, row_slot, vals, xrows,
                                              long_rows, x, y, n, width,
                                              num_long);
    if (c == 2)
      return launch_long<2, true, true, true>(s, row_slot, vals, xrows,
                                              long_rows, x, y, n, width,
                                              num_long);
    return launch_long<4, true, true, true>(s, row_slot, vals, xrows,
                                            long_rows, x, y, n, width,
                                            num_long);
  }
  if (c == 1)
    return launch_cols<1, true, true>(vec == 1, s, row_slot, vals, xrows,
                                      long_rows, x, y, m, n, width, long_row,
                                      num_long, nullptr);
  if (c == 2)
    return launch_cols<2, true, true>(vec == 1, s, row_slot, vals, xrows,
                                      long_rows, x, y, m, n, width, long_row,
                                      num_long, nullptr);
  return launch_cols<4, true, true>(vec == 1, s, row_slot, vals, xrows,
                                    long_rows, x, y, m, n, width, long_row,
                                    num_long, nullptr);
}

// out (int[5]) = {slab, slabs, rows a CTA, lanes a row, slots in flight a
// lane} of launch_bands for n columns at `slab` in form `vec` (2, 1 or 0,
// as bands_vec).
int bands_shape(int n, int slab, int vec, void* out) {
  const int width = n > 0 ? bands_slab(n, slab) : -1;
  if (width < 1 || vec < 0 || vec > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int* shape = static_cast<int*>(out);
  shape[0] = width;
  shape[1] = (n + width - 1) / width;
  if (vec == 2) {
    int lanes = 0;
    int per_lane = 0;
    bands_lanes(width, 8, &lanes, &per_lane);
    shape[2] = WARPS * V16_SETS * 32 / lanes;
    shape[3] = lanes;
    shape[4] = v16_gathers(lanes, per_lane);
  } else {
    const int c = width <= SLAB ? 1 : width <= 2 * SLAB ? 2 : 4;
    shape[2] = WARPS;
    shape[3] = 32;
    shape[4] = LOADS / c;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// row_slot, vals, xrows, long_rows, x, y, m, n, long_row, num_long, stream
extern "C" int spgrid_wcoo_bands(const void* row_slot, const void* vals,
                                 const void* xrows, const void* long_rows,
                                 const void* x, void* y, int m, int n,
                                 int long_row, int num_long, void* stream) {
  return spgrid::slot_rows::launch(row_slot, vals, xrows, long_rows, x, y, m,
                                   n, long_row, num_long, stream);
}

// The bf16 form: vals, x and y as bf16 bit patterns; slab 0 for the slab
// rule (bands_slab) or a power of two from 64 to 512, for sweeps and tests;
// the other arguments as above.
extern "C" int spgrid_wcoo_bands_bf16(const void* row_slot, const void* vals,
                                      const void* xrows, const void* long_rows,
                                      const void* x, void* y, int m, int n,
                                      int long_row, int num_long, int slab,
                                      void* stream) {
  return launch_bands(row_slot, vals, xrows, long_rows, x, y, m, n, long_row,
                      num_long, slab, stream);
}

// out (int[5]) = {slab, slabs, rows a CTA, lanes a row, slots in flight a
// lane} of spgrid_wcoo_bands_bf16's launch for n columns at slab in the
// form vec (2: the 16-byte walk, 1: the 8-byte one, 0: an element a lane).
extern "C" int spgrid_wcoo_bands_bf16_shape(int n, int slab, int vec,
                                            void* out) {
  return bands_shape(n, slab, vec, out);
}
