// Multi-row packed SpMV, y = A @ x with A in DeviceWPACK layout.
//
// Replaces: spgrid/ops/pallas/wpack_spmv.py, _make_kernel / _spmv, with
// _lane_prefix (the Pallas TPU kernel behind `wpack_spmv`: per group of 8
// pieces, a lane gather from wsel stacked x rows, a lane prefix sum and two
// take_along_axis calls for the segmented row reduce
// P[end] - (P - p)[start], because a TPU vector register cannot be
// scattered into).
//
// Bound on the H100: device-memory bytes. At the main path's 100000^2
// scattered matrix (2.1M nnz) the product needs each nnz's value and int8
// column once plus x and y (~11.3 MB, ~3.4 us at 3.35 TB/s). The padded
// pieces hold 10x more slots than nnz there (utilization 0.105), each slot
// 8 bytes (value, column, sel, start, end: 160 MB, >= 48 us to stream), so
// the default kernel does not read them: it reads the layout's live-slot
// stream (DeviceWPACK.slot_*: value, x index and row, 9 bytes a live slot,
// ~18.9 MB there). A piece's live slots are its lanes 0 .. c-1 (lane =
// packing order), sorted by target row.
//
// Design: the shared spgrid::slot_stream walk (slot_stream.cuh) with
// SEGMENT: equal ranges of `slots_per_cta` live slots a CTA of 256
// threads, a 128-float shared-memory accumulator for the open target
// block, blocks that straddle ranges summed by a second kernel in range
// order, every row of y written. Within a warp's 32 consecutive slots each
// run of one (piece, row) is summed by a segmented shuffle scan and added
// to the accumulator by one shared-memory atomicAdd. The segment is summed
// directly, from its own terms: the TPU's prefix difference P[end] - (P -
// p)[start] rounds with the size of the piece's whole prefix, not of the
// row's sum, and cancels (the ablation forms below keep it). The x index,
// (piece_w + sel) * 128 + col, is stored whole; slots whose value is 0 or
// whose x index lies at or past k were dropped when the stream was built:
// x is not padded. The result is not bit-reproducible from run to run (the
// order of the shared-memory atomics).
#include <cuda_runtime.h>

#include <cstddef>

#include "slot_stream.cuh"

namespace {

constexpr int LANE = 128;
constexpr int GROUP_PIECES = 8;

// ---------------------------------------------------------------------------
// The ablation variants: the TPU group body's own segmented reduce.
//
// Replaces: spgrid/ops/pallas/wpack_spmv.py, _make_kernel with ablate /
// prefix and _lane_prefix (the timing variants of the WPACK group body that
// scripts/exp_wpack_ablate.py runs). With p[r][l] = value * x at lane l of
// piece r, P the inclusive lane prefix of p and P - p the exclusive one,
// thread j adds, for each group of its block, the sum over the 8 pieces of
//
//   NOSEG     p[r][j]                                (wrong by design)
//   NOGATHER  P[r][j]                                (wrong by design)
//   FULL      P[r][ends[r][j]] - (P - p)[r][starts[r][j]]   (y = A @ x)
//
// An absent row (start 1, end 0) adds p[0] - (P[1] - p[1]), zero up to
// rounding, as on the TPU. Only FULL computes the product; it differs from
// the direct segment sum of the default kernel above by the rounding of the prefix difference, whose
// error grows with the piece's whole prefix and not with the row's sum.
//
// The prefix, in two forms with the same additions in the same order (so
// they agree bit for bit; products are __fmul_rn so no form contracts one
// into an FMA): a Hillis-Steele scan with shifts 1, 2, 4, 8 and 16 inside
// each 32-lane warp, then the 4 warps' totals exchanged through shared
// memory and their own Hillis-Steele (shifts of 32 and 64 lanes) added as
// each warp's carry. The TPU's 7 shift-adds run over all 128 lanes; a warp
// shuffle cannot reach across warps, so both forms split at the warp.
//
//   PAD   each in-warp shift through shared memory, two barriers a shift
//         (the counterpart of jnp.pad, which materialises each shift)
//   ROLL  each in-warp shift by __shfl_up_sync, no barrier (the
//         counterpart of pltpu.roll)
//
// Design: these read the padded pieces, as the TPU body does: one CTA of
// 128 threads per 128-row target block, thread j for row and lane j, and
// each thread keeps its lane of all 8 pieces of a group in registers, so
// one barrier (or one shuffle instruction a piece) serves the 8 pieces of
// a shift; scanning the pieces one after another would take 8 times the
// barriers. FULL then stores P and P - p of the group in shared memory for
// the two boundary reads. Each thread writes its row of y once: no atomics.
// Bound: as the default kernel, bytes; every variant streams the same
// padded slots (FULL and NOGATHER also the starts and ends).

enum AblateBody { NOSEG = 0, NOGATHER = 1, FULL = 2 };
constexpr int WARP = 32;
constexpr int WARPS = LANE / WARP;

template <int BODY, bool ROLL>
__global__ void __launch_bounds__(LANE)
wpack_ablate_kernel(const int* __restrict__ block_ptr,
                    const int* __restrict__ piece_w,
                    const unsigned char* __restrict__ cols,
                    const signed char* __restrict__ sel,
                    const signed char* __restrict__ starts,
                    const signed char* __restrict__ ends,
                    const float* __restrict__ vals,
                    const float* __restrict__ x, float* __restrict__ y, int m,
                    int k) {
  __shared__ float scan[GROUP_PIECES][LANE];  // PAD's shifts; FULL's P
  __shared__ float pex[GROUP_PIECES][LANE];   // FULL's P - p
  __shared__ float total[GROUP_PIECES][WARPS];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t % WARP;
  const int warp = t / WARP;
  float acc = 0.0f;
  for (int g = block_ptr[b]; g < block_ptr[b + 1]; ++g) {
    const size_t q0 = static_cast<size_t>(g) * GROUP_PIECES * LANE + t;
    float p[GROUP_PIECES];
#pragma unroll
    for (int r = 0; r < GROUP_PIECES; ++r) {
      const size_t q = q0 + static_cast<size_t>(r) * LANE;
      const float v = vals[q];
      const int xi = (piece_w[static_cast<size_t>(g) * GROUP_PIECES + r] +
                      sel[q]) * LANE + cols[q];
      p[r] = (v != 0.0f && xi < k) ? __fmul_rn(v, __ldg(x + xi)) : 0.0f;
    }
    float c = 0.0f;
    if (BODY == NOSEG) {
#pragma unroll
      for (int r = 0; r < GROUP_PIECES; ++r) c += p[r];
    } else {
      float P[GROUP_PIECES];
#pragma unroll
      for (int r = 0; r < GROUP_PIECES; ++r) P[r] = p[r];
#pragma unroll
      for (int sh = 1; sh < WARP; sh *= 2) {
        if (ROLL) {
#pragma unroll
          for (int r = 0; r < GROUP_PIECES; ++r) {
            const float u = __shfl_up_sync(0xffffffffu, P[r], sh);
            if (lane >= sh) P[r] += u;
          }
        } else {
#pragma unroll
          for (int r = 0; r < GROUP_PIECES; ++r) scan[r][t] = P[r];
          __syncthreads();
#pragma unroll
          for (int r = 0; r < GROUP_PIECES; ++r)
            if (lane >= sh) P[r] += scan[r][t - sh];
          __syncthreads();
        }
      }
      if (lane == WARP - 1) {
#pragma unroll
        for (int r = 0; r < GROUP_PIECES; ++r) total[r][warp] = P[r];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < GROUP_PIECES; ++r) {
        // Hillis-Steele over the warps' totals: shifts of 1 and 2 warps
        float s1[WARPS], s2[WARPS];
#pragma unroll
        for (int w = 0; w < WARPS; ++w)
          s1[w] = w >= 1 ? total[r][w] + total[r][w - 1] : total[r][w];
#pragma unroll
        for (int w = 0; w < WARPS; ++w)
          s2[w] = w >= 2 ? s1[w] + s1[w - 2] : s1[w];
        if (warp >= 1) P[r] += s2[warp - 1];
      }
      if (BODY == NOGATHER) {
#pragma unroll
        for (int r = 0; r < GROUP_PIECES; ++r) c += P[r];
      } else {
#pragma unroll
        for (int r = 0; r < GROUP_PIECES; ++r) {
          scan[r][t] = P[r];
          pex[r][t] = P[r] - p[r];
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < GROUP_PIECES; ++r) {
          const size_t q = q0 + static_cast<size_t>(r) * LANE;
          c += scan[r][ends[q]] - pex[r][starts[q]];
        }
      }
      __syncthreads();  // scan, pex and total are rewritten by the next group
    }
    acc += c;
  }
  const long long row = static_cast<long long>(b) * LANE + t;
  if (row < m) y[row] = acc;
}

template <int BODY, bool ROLL>
void launch_ablate(const void* block_ptr, const void* piece_w,
                   const void* cols, const void* sel, const void* starts,
                   const void* ends, const void* vals, const void* x, void* y,
                   int blocks, int m, int k, cudaStream_t stream) {
  wpack_ablate_kernel<BODY, ROLL><<<blocks, LANE, 0, stream>>>(
      static_cast<const int*>(block_ptr), static_cast<const int*>(piece_w),
      static_cast<const unsigned char*>(cols),
      static_cast<const signed char*>(sel),
      static_cast<const signed char*>(starts),
      static_cast<const signed char*>(ends), static_cast<const float*>(vals),
      static_cast<const float*>(x), static_cast<float*>(y), m, k);
}

}  // namespace

// block_slot, vals, cols (int32 x index), rows (uint8), x, y, carry,
// num_slots, slots_per_cta, blocks, m, stream
extern "C" int spgrid_wpack_spmv(const void* block_slot, const void* vals,
                                 const void* cols, const void* rows,
                                 const void* x, void* y, void* carry,
                                 int num_slots, int slots_per_cta,
                                 int blocks, int m, void* stream) {
  return spgrid::slot_stream::launch<true>(block_slot, vals, cols, rows, x, y,
                                           carry, num_slots, slots_per_cta,
                                           blocks, m, stream);
}

// variant: 0 noseg, 1 nogather/pad, 2 nogather/roll, 3 full/pad,
// 4 full/roll.
extern "C" int spgrid_wpack_ablate(const void* block_ptr, const void* piece_w,
                                   const void* cols, const void* sel,
                                   const void* starts, const void* ends,
                                   const void* vals, const void* x, void* y,
                                   int variant, int blocks, int m, int k,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      launch_ablate<NOSEG, false>(block_ptr, piece_w, cols, sel, starts, ends,
                                  vals, x, y, blocks, m, k, s);
      break;
    case 1:
      launch_ablate<NOGATHER, false>(block_ptr, piece_w, cols, sel, starts,
                                     ends, vals, x, y, blocks, m, k, s);
      break;
    case 2:
      launch_ablate<NOGATHER, true>(block_ptr, piece_w, cols, sel, starts,
                                    ends, vals, x, y, blocks, m, k, s);
      break;
    case 3:
      launch_ablate<FULL, false>(block_ptr, piece_w, cols, sel, starts, ends,
                                 vals, x, y, blocks, m, k, s);
      break;
    case 4:
      launch_ablate<FULL, true>(block_ptr, piece_w, cols, sel, starts, ends,
                                vals, x, y, blocks, m, k, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
