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
//
// The bf16 forms (wpack_spmv at dtype bf16) compute what the Pallas body
// computes at the layout's wsel, as XLA computes it on the CPU (it rounds a
// bf16 operation's result unless that result feeds only an f32 sum). At
// wsel 2 and 4 the body's products start from f32 zeros, so products and
// sums are f32 and y is rounded once: the stream walk above on bf16 values,
// x and y, in its fixed order of sums (slot_stream.cuh's BF form). At wsel 1
// the body's product is a bf16 multiply and the prefix runs in bf16: the
// FULL/ROLL ablation kernel below in its bf16 form.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "bf16_bits.cuh"
#include "slot_stream.cuh"

namespace {

using spgrid::bf16::Elem;
using spgrid::bf16::narrow;
using spgrid::bf16::rounded;
using spgrid::bf16::widen;

constexpr int LANE = 128;
constexpr int GROUP_PIECES = 8;

// ---------------------------------------------------------------------------
// The ablation variants: the TPU group body's own segmented reduce.
//
// Replaces: spgrid/ops/pallas/wpack_spmv.py, _make_kernel with ablate /
// prefix and _lane_prefix (the timing variants of the WPACK group body that
// scripts/exp_wpack_ablate.py runs). With p[r][l] = value * x at lane l of
// piece r, P the inclusive lane prefix of p and P - p the exclusive one,
// row j of a target block gets, from each piece r of the block,
//
//   NOSEG     p[r][j]                                (wrong by design)
//   NOGATHER  P[r][j]                                (wrong by design)
//   FULL      P[r][ends[r][j]] - (P - p)[r][starts[r][j]]   (y = A @ x)
//
// An absent row (start 1, end 0) adds p[0] - (P[1] - p[1]), zero up to
// rounding, as on the TPU. Only FULL computes the product; it differs from
// the direct segment sum of the default kernel above by the rounding of the
// prefix difference, whose error grows with the piece's whole prefix and
// not with the row's sum.
//
// Bound: as the default kernel, bytes. What sets the pace is each warp's
// walk of its pieces (loads, x gathers, then the scan's and the boundary
// reads' instructions), so the walk is spread over as many warps as keep
// the card in one wave.
//
// Design: a warp a piece. One CTA of W warps per 128-row target block; warp
// w takes the block's pieces w, w + W, ... in order. W (4, 8 or 16) comes
// from the grid (warps_for). Thread t holds lanes t + 32q (q = 0..3) of
// its piece in registers. piece_lanes (each piece's
// last live lane + 1, built on the host from the live rule: value not 0, x
// index below k) bounds what is read: a piece of 0 is not read at all (all
// its terms are 0, absent rows included), a 32-lane quarter wholly past it
// is not loaded (its p is 0), and starts/ends are read only for pieces that
// are. A warp reads the piece_lanes and piece_w of 32 of its pieces at
// once, a lane each, and hands them out by shuffles; a piece's loads start
// one piece ahead (AHEAD), into registers that are read in place.
//
// The prefix is _lane_prefix's own: P += shift(P, sh) for sh = 1, 2, 4, 8,
// 16, 32, 64 over the piece's 128 lanes, the same additions in the same
// order, so P is the TPU's bit for bit and the two forms agree bit for bit
// (products are __fmul_rn so no form contracts one into an FMA):
//
//   ROLL  sh <= 16: one __shfl_sync(P[q], (t - sh) & 31) a register; lane
//         t >= sh takes its register q's value, lane t < sh register q - 1's
//         (lane t - sh + 32 of the row before), register 0 takes 0 (the
//         counterpart of pltpu.roll and its mask)
//   PAD   sh <= 16: through the warp's 128-float shared buffer between two
//         __syncwarp() (the counterpart of jnp.pad, which materialises each
//         shift)
//
// and shifts of 32 and 64 lanes are whole registers, added in the thread.
// FULL then stores P and P - p in the warp's shared memory, and thread t
// adds P[ends] - (P - p)[starts] for its rows 4t .. 4t + 3 (a word of
// starts and of ends): no CTA barrier inside the piece loop. Thread t sums
// its rows (t + 32q, or FULL's 4t + q) in registers over its pieces; at
// the end the W warps' sums go through shared memory and are added in warp
// order, each row of y written once (zeros for a block with no group, rows
// past m dropped): no atomics, the same bits every call.
//
// The bf16 form at wsel 1 (BF; FULL and ROLL only). Replaces: the same
// _make_kernel / _spmv at wsel 1 and dtype bf16 (ablate "", the default
// prefix "roll"). There the product p = value * x is a bf16 multiply, and
// each bf16 operation whose result feeds another is rounded to bf16: p; the
// 7 shift-adds of _lane_prefix, P; P - p. The difference P[end] - (P -
// p)[start] feeds only the f32 sum of the group's 8 pieces for its row, so
// it stays f32; that sum is rounded to bf16 and added into the f32 row, and
// y is rounded once. An absent row (start 1, end 0) adds p[0] - (P[1] -
// p[1]), which is not 0 where P[1] rounds. (At bf16 this body can miss the
// 3e-2 row gate that wrow_spmv and wcoo_spmv pass on the same matrix; the
// form computes it as it is.) So the form rounds after each of those
// operations (step) and a warp takes whole groups, w, w + W, ..., each
// group's 8 pieces in order, its rows' sums rounded at the group's last
// piece. It reads bf16 values (2 bytes a lane up to each piece's last live
// lane, with the column, start and end) and no sel (0 at wsel 1).

enum AblateBody { NOSEG = 0, NOGATHER = 1, FULL = 2 };
constexpr int WARP = 32;
constexpr int QUARTERS = LANE / WARP;
constexpr unsigned ALL_LANES = 0xffffffffu;
// The rule's warps an SM (warps_for). At 16 on 132 SMs, the 782 blocks of
// scripts/exp_wpack_ablate.py's matrix take 4 warps a CTA, MAIN_LINE's 512
// take 8 and the 24 of chip_smoke.py's edge matrix 16: the fastest of 4, 8
// and 16 on each (PERF.md §6, row 10a).
constexpr int WARPS_PER_SM = 16;
// Pieces whose loads are in flight while a warp sums one; a deeper ring
// costs registers (one ahead keeps every form at 64 or fewer).
constexpr int AHEAD = 1;

template <bool BF>
struct AblateArgs {
  const int* __restrict__ block_ptr;
  const int* __restrict__ piece_w;
  const unsigned char* __restrict__ piece_lanes;
  const unsigned char* __restrict__ cols;
  const signed char* __restrict__ sel;  // not read by the bf16 form
  const signed char* __restrict__ starts;
  const signed char* __restrict__ ends;
  const Elem<BF>* __restrict__ vals;
  const Elem<BF>* __restrict__ x;
  Elem<BF>* __restrict__ y;
  int m, k;
};

// What thread t holds of a piece before its x gathers: lanes t + 32q.
struct Quarters {
  int lanes;                // the piece's piece_lanes
  float v[QUARTERS];        // values; 0 in a quarter that is not loaded
  int xi[QUARTERS];         // x indices
  unsigned s, e;            // FULL: starts and ends of rows 4t .. 4t + 3
};

template <int BODY, bool BF>
__device__ __forceinline__ Quarters fetch(const AblateArgs<BF>& a,
                                          long long piece, int lanes,
                                          int window, int t) {
  Quarters f;
  f.lanes = lanes;
  const size_t base = static_cast<size_t>(piece) * LANE;
#pragma unroll
  for (int q = 0; q < QUARTERS; ++q) {
    const size_t i = base + t + WARP * q;
    f.v[q] = 0.0f;
    f.xi[q] = 0;
    if (WARP * q < lanes) {
      f.v[q] = widen(a.vals[i]);
      // the bf16 form runs at wsel 1 only, where sel is 0
      f.xi[q] = (window + (BF ? 0 : a.sel[i])) * LANE + a.cols[i];
    }
  }
  f.s = 0;
  f.e = 0;
  if (BODY == FULL && lanes > 0) {
    f.s = reinterpret_cast<const unsigned*>(a.starts + base)[t];
    f.e = reinterpret_cast<const unsigned*>(a.ends + base)[t];
  }
  return f;
}

// An operation's result: itself at f32; rounded to bf16 in the bf16 form,
// where each bf16 operation of the body rounds.
template <bool BF>
__device__ __forceinline__ float step(float v) {
  if constexpr (BF) {
    return rounded(v);
  } else {
    return v;
  }
}

// The warp's pieces' piece_lanes and piece_w, 32 at a time: lane i holds
// those of its piece 32 c + i (0 past its last).
struct Meta {
  int lanes, window;
};

template <int BODY, bool ROLL, int W, bool BF>
__global__ void __launch_bounds__(WARP * W)
wpack_ablate_kernel(const AblateArgs<BF> a) {
  __shared__ float part[W][LANE];     // each warp's sums of the block's rows
  __shared__ float scan[W][2][LANE];  // a warp's PAD shifts; FULL's P, P - p
  const int b = blockIdx.x;
  const int t = threadIdx.x % WARP;
  const int w = threadIdx.x / WARP;
  float* const buf = scan[w][0];
  float* const pex = scan[w][1];
  const long long start =
      static_cast<long long>(a.block_ptr[b]) * GROUP_PIECES;
  // the block's pieces (the bf16 form: groups) that the warp takes
  const long long units =
      (static_cast<long long>(a.block_ptr[b + 1]) * GROUP_PIECES - start) /
      (BF ? GROUP_PIECES : 1);
  const int n = units > w ? static_cast<int>((units - w + W - 1) / W) *
                                (BF ? GROUP_PIECES : 1)
                          : 0;
  // the warp's piece f: the block's pieces w, w + W, ...; in the bf16 form
  // the 8 pieces, in order, of its groups w, w + W, ...
  auto piece_of = [&](int f) {
    if (BF) {
      return start +
             (static_cast<long long>(f / GROUP_PIECES) * W + w) *
                 GROUP_PIECES +
             f % GROUP_PIECES;
    }
    return start + w + static_cast<long long>(f) * W;
  };
  auto meta_chunk = [&](int c) {
    const int f = 32 * c + t;
    if (f >= n) return Meta{0, 0};
    const long long p = piece_of(f);
    return Meta{static_cast<int>(a.piece_lanes[p]), a.piece_w[p]};
  };
  Meta chunk = meta_chunk(0);
  // the loads of the warp's piece f
  auto load_piece = [&](int f) {
    if (f > 0 && (f & 31) == 0) chunk = meta_chunk(f / 32);
    const int lanes = __shfl_sync(ALL_LANES, chunk.lanes, f & 31);
    const int window = __shfl_sync(ALL_LANES, chunk.window, f & 31);
    return fetch<BODY>(a, piece_of(f), lanes, window, t);
  };
  // rows t + 32q (FULL: rows 4t + q) over the warp's pieces; the bf16
  // form's rows of the open group
  float acc[QUARTERS] = {0.0f, 0.0f, 0.0f, 0.0f};
  float sum[QUARTERS] = {0.0f, 0.0f, 0.0f, 0.0f};
  auto add_piece = [&](const Quarters& cur) {
    if (cur.lanes == 0) return;  // the same for the whole warp
    float p[QUARTERS];
#pragma unroll
    for (int q = 0; q < QUARTERS; ++q) {
      p[q] = (cur.v[q] != 0.0f && cur.xi[q] < a.k)
                 ? step<BF>(__fmul_rn(cur.v[q], widen(__ldg(a.x + cur.xi[q]))))
                 : 0.0f;
    }
    if (BODY == NOSEG) {
#pragma unroll
      for (int q = 0; q < QUARTERS; ++q) acc[q] += p[q];
      return;
    }
    float P[QUARTERS];
#pragma unroll
    for (int q = 0; q < QUARTERS; ++q) P[q] = p[q];
#pragma unroll
    for (int sh = 1; sh < WARP; sh *= 2) {
      float u[QUARTERS];
      if (ROLL) {
        float s[QUARTERS];
#pragma unroll
        for (int q = 0; q < QUARTERS; ++q) {
          s[q] = __shfl_sync(ALL_LANES, P[q], (t - sh) & (WARP - 1));
        }
#pragma unroll
        for (int q = 0; q < QUARTERS; ++q) {
          const float below = s[(q + QUARTERS - 1) % QUARTERS];
          u[q] = t >= sh ? s[q] : (q > 0 ? below : 0.0f);
        }
      } else {
#pragma unroll
        for (int q = 0; q < QUARTERS; ++q) buf[t + WARP * q] = P[q];
        __syncwarp();
#pragma unroll
        for (int q = 0; q < QUARTERS; ++q) {
          const int j = t + WARP * q;
          u[q] = j >= sh ? buf[j - sh] : 0.0f;
        }
        __syncwarp();
      }
#pragma unroll
      for (int q = 0; q < QUARTERS; ++q) P[q] = step<BF>(P[q] + u[q]);
    }
    // shifts of 32 and 64 lanes: registers q - 1 and q - 2, added from the
    // last register down so each adds the value before the shift
#pragma unroll
    for (int sh = 1; sh < QUARTERS; sh *= 2) {
#pragma unroll
      for (int q = QUARTERS - 1; q >= 0; --q) {
        P[q] = step<BF>(
            P[q] + (q >= sh ? P[(q + QUARTERS - sh) % QUARTERS] : 0.0f));
      }
    }
    if (BODY == NOGATHER) {
#pragma unroll
      for (int q = 0; q < QUARTERS; ++q) acc[q] += P[q];
      return;
    }
#pragma unroll
    for (int q = 0; q < QUARTERS; ++q) {
      buf[t + WARP * q] = P[q];
      pex[t + WARP * q] = step<BF>(P[q] - p[q]);
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < QUARTERS; ++q) {
      const int first_lane = (cur.s >> (8 * q)) & 0x7f;
      const int last_lane = (cur.e >> (8 * q)) & 0x7f;
      const float term = buf[last_lane] - pex[first_lane];
      if (BF) {
        sum[q] += term;
      } else {
        acc[q] += term;
      }
    }
    __syncwarp();  // the next piece rewrites buf and pex
  };
  // the bf16 form, at a group's last piece: its rows' f32 sums rounded to
  // bf16 and added into the f32 rows
  auto close_group = [&](int f) {
    if (!BF || f % GROUP_PIECES != GROUP_PIECES - 1) return;
#pragma unroll
    for (int q = 0; q < QUARTERS; ++q) {
      acc[q] += rounded(sum[q]);
      sum[q] = 0.0f;
    }
  };
  // AHEAD + 1 buffers, the loop unrolled by AHEAD + 1 so that a buffer is
  // loaded and read in place (a copy of a buffer would wait for its loads):
  // piece i + AHEAD's loads go into the buffer piece i - 1 left, and piece
  // i's, started AHEAD pieces earlier, are read.
  constexpr int D = AHEAD;
  Quarters ring[D + 1];
#pragma unroll
  for (int d = 0; d < D; ++d) ring[d] = load_piece(d);
  for (int i0 = 0; i0 < n; i0 += D + 1) {
#pragma unroll
    for (int d = 0; d <= D; ++d) {
      if (i0 + d >= n) break;
      ring[(d + D) % (D + 1)] = load_piece(i0 + d + D);
      add_piece(ring[d]);
      close_group(i0 + d);
    }
  }
#pragma unroll
  for (int q = 0; q < QUARTERS; ++q) {
    part[w][BODY == FULL ? QUARTERS * t + q : t + WARP * q] = acc[q];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < LANE; j += WARP * W) {
    float total = part[0][j];
#pragma unroll
    for (int u = 1; u < W; ++u) total += part[u][j];
    const long long row = static_cast<long long>(b) * LANE + j;
    if (row < a.m) a.y[row] = narrow<BF>(total);
  }
}

template <int BODY, bool ROLL, bool BF>
cudaError_t launch_ablate(const AblateArgs<BF>& a, int warps, int blocks,
                          cudaStream_t stream) {
  switch (warps) {
    case 4:
      wpack_ablate_kernel<BODY, ROLL, 4, BF>
          <<<blocks, WARP * 4, 0, stream>>>(a);
      break;
    case 8:
      wpack_ablate_kernel<BODY, ROLL, 8, BF>
          <<<blocks, WARP * 8, 0, stream>>>(a);
      break;
    case 16:
      wpack_ablate_kernel<BODY, ROLL, 16, BF>
          <<<blocks, WARP * 16, 0, stream>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// W, the warps a CTA, for `warps` (0: the rule's) on a grid of `blocks`
// CTAs on the current card; 0 where the kernel has no such form. The rule:
// the fewest warps (4, 8, 16) that give every SM WARPS_PER_SM of them, so
// a grid of many blocks runs in one wave of short CTAs and a grid of few
// blocks spreads each block's pieces over more warps.
int warps_for(int warps, int blocks) {
  if (warps != 0) return warps == 4 || warps == 8 || warps == 16 ? warps : 0;
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch checks clean
    return 0;
  }
  int W = 4;
  while (W < 16 && static_cast<long long>(blocks) * W <
                       static_cast<long long>(WARPS_PER_SM) * sms) {
    W *= 2;
  }
  return W;
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
// 4 full/roll; warps: W, the warps a CTA (4, 8 or 16; 0: the rule's);
// starts and ends 4-byte aligned.
extern "C" int spgrid_wpack_ablate(const void* block_ptr, const void* piece_w,
                                   const void* piece_lanes, const void* cols,
                                   const void* sel, const void* starts,
                                   const void* ends, const void* vals,
                                   const void* x, void* y, int variant,
                                   int warps, int blocks, int m, int k,
                                   void* stream) {
  const AblateArgs<false> a{static_cast<const int*>(block_ptr),
                     static_cast<const int*>(piece_w),
                     static_cast<const unsigned char*>(piece_lanes),
                     static_cast<const unsigned char*>(cols),
                     static_cast<const signed char*>(sel),
                     static_cast<const signed char*>(starts),
                     static_cast<const signed char*>(ends),
                     static_cast<const float*>(vals),
                     static_cast<const float*>(x),
                     static_cast<float*>(y),
                     m,
                     k};
  const int W = warps_for(warps, blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the full forms read starts and ends 4 rows a word
  const bool aligned = (reinterpret_cast<uintptr_t>(starts) |
                        reinterpret_cast<uintptr_t>(ends)) % 4 == 0;
  switch (W == 0 || !aligned ? -1 : variant) {
    case 0:
      return static_cast<int>(launch_ablate<NOSEG, false>(a, W, blocks, s));
    case 1:
      return static_cast<int>(launch_ablate<NOGATHER, false>(a, W, blocks, s));
    case 2:
      return static_cast<int>(launch_ablate<NOGATHER, true>(a, W, blocks, s));
    case 3:
      return static_cast<int>(launch_ablate<FULL, false>(a, W, blocks, s));
    case 4:
      return static_cast<int>(launch_ablate<FULL, true>(a, W, blocks, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out (int[1]) = W: the warps a CTA that spgrid_wpack_ablate launches at
// `warps` (0: the rule's) on a grid of `blocks` CTAs on the current card.
extern "C" int spgrid_wpack_ablate_warps(int warps, int blocks, void* out) {
  const int W = warps_for(warps, blocks);
  if (W == 0) return static_cast<int>(cudaErrorInvalidValue);
  *static_cast<int*>(out) = W;
  return static_cast<int>(cudaSuccess);
}

// The bf16 form at wsel 2 and 4: vals, x and y as bf16 bit patterns; the
// same arguments as spgrid_wpack_spmv.
extern "C" int spgrid_wpack_spmv_bf16(const void* block_slot,
                                      const void* vals, const void* cols,
                                      const void* rows, const void* x,
                                      void* y, void* carry, int num_slots,
                                      int slots_per_cta, int blocks, int m,
                                      void* stream) {
  return spgrid::slot_stream::launch<false, true>(
      block_slot, vals, cols, rows, x, y, carry, num_slots, slots_per_cta,
      blocks, m, stream);
}

// The bf16 form at wsel 1: vals, x and y as bf16 bit patterns; warps: W (4,
// 8 or 16; 0: the rule's); starts and ends 4-byte aligned.
extern "C" int spgrid_wpack_spmv_bf16_prefix(
    const void* block_ptr, const void* piece_w, const void* piece_lanes,
    const void* cols, const void* starts, const void* ends, const void* vals,
    const void* x, void* y, int warps, int blocks, int m, int k,
    void* stream) {
  const AblateArgs<true> a{static_cast<const int*>(block_ptr),
                           static_cast<const int*>(piece_w),
                           static_cast<const unsigned char*>(piece_lanes),
                           static_cast<const unsigned char*>(cols),
                           nullptr,
                           static_cast<const signed char*>(starts),
                           static_cast<const signed char*>(ends),
                           static_cast<const unsigned short*>(vals),
                           static_cast<const unsigned short*>(x),
                           static_cast<unsigned short*>(y),
                           m,
                           k};
  const int W = warps_for(warps, blocks);
  const bool aligned = (reinterpret_cast<uintptr_t>(starts) |
                        reinterpret_cast<uintptr_t>(ends)) % 4 == 0;
  if (W == 0 || !aligned) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_ablate<FULL, true>(
      a, W, blocks, static_cast<cudaStream_t>(stream)));
}
