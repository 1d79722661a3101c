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
// sums are f32 and y is rounded once: slot_stream.cuh's bf16 row walk over
// the layout's row-ordered stream (DeviceWPACK.row_*), in its fixed order of
// sums. At wsel 1 the body's product is a bf16 multiply and the prefix runs
// in bf16: the prefix kernel at the end of this file.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "bf16_bits.cuh"
#include "slot_stream.cuh"

namespace {

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
// The bf16 form at wsel 1 has a kernel of its own (below), which shares
// `fetch`'s layout of a piece and `lane_prefix`.

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

struct AblateArgs {
  const int* __restrict__ block_ptr;
  const int* __restrict__ piece_w;
  const unsigned char* __restrict__ piece_lanes;
  const unsigned char* __restrict__ cols;
  const signed char* __restrict__ sel;
  const signed char* __restrict__ starts;
  const signed char* __restrict__ ends;
  const float* __restrict__ vals;
  const float* __restrict__ x;
  float* __restrict__ y;
  int m, k;
};

// What thread t holds of a piece before its x gathers: lanes t + 32q.
struct Quarters {
  int lanes;                // the piece's piece_lanes
  float v[QUARTERS];        // values; 0 in a quarter that is not loaded
  int xi[QUARTERS];         // x indices
  unsigned s, e;            // FULL: starts and ends of rows 4t .. 4t + 3
};

template <int BODY>
__device__ __forceinline__ Quarters fetch(const AblateArgs& a,
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
      f.v[q] = a.vals[i];
      f.xi[q] = (window + a.sel[i]) * LANE + a.cols[i];
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

// _lane_prefix on a piece held as lanes t + 32q in register q of thread t:
// P += shift(P, sh) for sh = 1, 2, 4, ..., 64, each addition a step (ROLL
// or PAD, the header says how; `buf` the warp's 128 floats for PAD).
template <bool ROLL, bool BF>
__device__ __forceinline__ void lane_prefix(float (&P)[QUARTERS], int t,
                                            float* buf) {
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
}

// The warp's pieces' piece_lanes and piece_w, 32 at a time: lane i holds
// those of its piece 32 c + i (0 past its last).
struct Meta {
  int lanes, window;
};

template <int BODY, bool ROLL, int W>
__global__ void __launch_bounds__(WARP * W)
wpack_ablate_kernel(const AblateArgs a) {
  __shared__ float part[W][LANE];     // each warp's sums of the block's rows
  __shared__ float scan[W][2][LANE];  // a warp's PAD shifts; FULL's P, P - p
  const int b = blockIdx.x;
  const int t = threadIdx.x % WARP;
  const int w = threadIdx.x / WARP;
  float* const buf = scan[w][0];
  float* const pex = scan[w][1];
  const long long start =
      static_cast<long long>(a.block_ptr[b]) * GROUP_PIECES;
  const long long pieces =
      static_cast<long long>(a.block_ptr[b + 1]) * GROUP_PIECES - start;
  // the warp's pieces: the block's pieces w, w + W, ...
  const int n =
      pieces > w ? static_cast<int>((pieces - w + W - 1) / W) : 0;
  auto piece_of = [&](int f) {
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
  // rows t + 32q (FULL: rows 4t + q) over the warp's pieces
  float acc[QUARTERS] = {0.0f, 0.0f, 0.0f, 0.0f};
  auto add_piece = [&](const Quarters& cur) {
    if (cur.lanes == 0) return;  // the same for the whole warp
    float p[QUARTERS];
#pragma unroll
    for (int q = 0; q < QUARTERS; ++q) {
      p[q] = (cur.v[q] != 0.0f && cur.xi[q] < a.k)
                 ? __fmul_rn(cur.v[q], __ldg(a.x + cur.xi[q]))
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
    lane_prefix<ROLL, false>(P, t, buf);
    if (BODY == NOGATHER) {
#pragma unroll
      for (int q = 0; q < QUARTERS; ++q) acc[q] += P[q];
      return;
    }
#pragma unroll
    for (int q = 0; q < QUARTERS; ++q) {
      buf[t + WARP * q] = P[q];
      pex[t + WARP * q] = P[q] - p[q];
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < QUARTERS; ++q) {
      const int first_lane = (cur.s >> (8 * q)) & 0x7f;
      const int last_lane = (cur.e >> (8 * q)) & 0x7f;
      acc[q] += buf[last_lane] - pex[first_lane];
    }
    __syncwarp();  // the next piece rewrites buf and pex
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
    if (row < a.m) a.y[row] = total;
  }
}

template <int BODY, bool ROLL>
cudaError_t launch_ablate(const AblateArgs& a, int warps, int blocks,
                          cudaStream_t stream) {
  switch (warps) {
    case 4:
      wpack_ablate_kernel<BODY, ROLL, 4><<<blocks, WARP * 4, 0, stream>>>(a);
      break;
    case 8:
      wpack_ablate_kernel<BODY, ROLL, 8><<<blocks, WARP * 8, 0, stream>>>(a);
      break;
    case 16:
      wpack_ablate_kernel<BODY, ROLL, 16><<<blocks, WARP * 16, 0, stream>>>(
          a);
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

// ---------------------------------------------------------------------------
// The bf16 form at wsel 1.
//
// Replaces: the same _make_kernel / _spmv at wsel 1 and dtype bf16 (ablate
// "", the default prefix "roll"). There the product p = value * x is a bf16
// multiply, and each bf16 operation whose result feeds another is rounded
// to bf16: p; the 7 shift-adds of _lane_prefix, P; P - p. The difference
// P[end] - (P - p)[start] feeds only the f32 sum of the group's 8 pieces
// for its row, so it stays f32; that sum is rounded to bf16 and added into
// the f32 row, and y is rounded once. An absent row (start 1, end 0) adds
// p[0] - (P[1] - p[1]), which is not 0 where P[1] rounds. (At bf16 this
// body can miss the 3e-2 row gate that wrow_spmv and wcoo_spmv pass on the
// same matrix; the form computes it as it is.)
//
// Bound: bytes, as the f32 forms; but a group is a chain (loads, x
// gathers, 7 rounded shift-adds, P and P - p through shared memory) and a
// wsel-1 matrix has few groups (the 512^2 twin: 104 in 4 target blocks),
// so the time is one chain's latency where the grid spreads the groups
// over the card, and a chain per group a warp takes in turn where it does
// not.
//
// Design: a warp a piece. A CTA of 8 warps takes `per_cta` consecutive
// groups (`groups_per_cta`, 1 to 16; the rule in ops/kernels/
// wpack_spmv.py gives one wave of the card), one group at a time, warp w
// its piece w: thread t loads lanes t + 32q of it (bf16 values, columns,
// and the starts and ends of rows 4t .. 4t + 3) with the piece's window,
// gathers x, rounds each product (__fmul_rn: no FMA), runs lane_prefix in
// its bf16 form (ROLL), stores P and P - p (rounded) in the warp's shared
// buffers and leaves the 4 f32 differences of its rows in the group's
// shared tile. After one barrier thread j < 128 sums row j's 8 terms in
// piece order (the Pallas body's order, so the rounded group sum is its
// bits), rounds the sum to bf16 and adds it into its f32 row of the open
// target block. The group tiles alternate, so a group takes one barrier;
// the next group's piece loads are in flight while a group is summed. A
// target block whose groups all lie in the CTA's range is written to y at
// its last group; one that crosses a range boundary leaves its partial rows
// in the carry buffer (slot 1 of a range it goes on past, slot 0 of the
// range it ends in), and slot_stream.cuh's `combine`, a CTA a block, adds
// them in range order, or writes 0 for a block with no group. No atomics:
// the same bits every call; only the order of the f32 sums of a block's
// rounded group sums differs from the Pallas body's (group order), within
// 1 bf16 ulp.

constexpr int PREFIX_THREADS = WARP * GROUP_PIECES;  // a warp a piece
constexpr int MAX_GROUPS_PER_CTA = 16;

struct PrefixArgs {
  const int* __restrict__ block_ptr;  // (blocks + 1,) groups of each block
  const int* __restrict__ group_sub;  // (G,) target block of each group
  const int* __restrict__ piece_w;
  const unsigned char* __restrict__ cols;
  const signed char* __restrict__ starts;
  const signed char* __restrict__ ends;
  const unsigned short* __restrict__ vals;
  const unsigned short* __restrict__ x;
  unsigned short* __restrict__ y;
  float* __restrict__ carry;
  int groups, per_cta, m, k;
};

// What thread t loads of its warp's piece: lanes t + 32q, the piece's
// window, and the starts and ends of rows 4t .. 4t + 3.
struct PieceLoads {
  unsigned short v[QUARTERS];
  unsigned char col[QUARTERS];
  int window;
  unsigned s, e;
};

__device__ __forceinline__ PieceLoads load_piece_bf16(const PrefixArgs& a,
                                                      long long piece,
                                                      int t) {
  PieceLoads f;
  const size_t base = static_cast<size_t>(piece) * LANE;
  f.window = __ldg(a.piece_w + piece);
#pragma unroll
  for (int q = 0; q < QUARTERS; ++q) {
    f.v[q] = __ldg(a.vals + base + t + WARP * q);
    f.col[q] = __ldg(a.cols + base + t + WARP * q);
  }
  f.s = __ldg(reinterpret_cast<const unsigned*>(a.starts + base) + t);
  f.e = __ldg(reinterpret_cast<const unsigned*>(a.ends + base) + t);
  return f;
}

__global__ void __launch_bounds__(PREFIX_THREADS)
wpack_prefix_bf16_kernel(const PrefixArgs a) {
  __shared__ float scan[GROUP_PIECES][2][LANE];  // each warp's P, P - p
  __shared__ __align__(16) float term[2][GROUP_PIECES][LANE];  // a group's
  const int c = blockIdx.x;
  const int j = threadIdx.x;  // row j of the open block (j < 128)
  const int t = threadIdx.x % WARP;
  const int w = threadIdx.x / WARP;
  float* const buf = scan[w][0];
  float* const pex = scan[w][1];
  const int g0 = c * a.per_cta;
  const int g1 = min(a.groups, g0 + a.per_cta);
  float acc = 0.0f;  // row j's f32 sum of the open block's rounded groups
  int open = __ldg(a.group_sub + g0);

  auto flush = [&](int b) {
    const int b0 = __ldg(a.block_ptr + b);
    const int b1 = __ldg(a.block_ptr + b + 1);
    if (b0 >= g0 && b1 <= g1) {
      const long long row = static_cast<long long>(b) * LANE + j;
      if (row < a.m) a.y[row] = narrow<true>(acc);
    } else {
      a.carry[(static_cast<size_t>(c) * 2 + (b1 > g1 ? 1 : 0)) * LANE + j] =
          acc;
    }
  };

  PieceLoads cur = load_piece_bf16(
      a, static_cast<long long>(g0) * GROUP_PIECES + w, t);
  for (int g = g0; g < g1; ++g) {
    PieceLoads nxt = cur;
    if (g + 1 < g1) {
      nxt = load_piece_bf16(
          a, static_cast<long long>(g + 1) * GROUP_PIECES + w, t);
    }
    float p[QUARTERS];
#pragma unroll
    for (int q = 0; q < QUARTERS; ++q) {
      const float v = widen(cur.v[q]);
      const int xi = cur.window * LANE + cur.col[q];
      p[q] = (v != 0.0f && xi < a.k)
                 ? rounded(__fmul_rn(v, widen(__ldg(a.x + xi))))
                 : 0.0f;
    }
    float P[QUARTERS];
#pragma unroll
    for (int q = 0; q < QUARTERS; ++q) P[q] = p[q];
    lane_prefix<true, true>(P, t, buf);
#pragma unroll
    for (int q = 0; q < QUARTERS; ++q) {
      buf[t + WARP * q] = P[q];
      pex[t + WARP * q] = rounded(P[q] - p[q]);
    }
    __syncwarp();
    float d[QUARTERS];
#pragma unroll
    for (int q = 0; q < QUARTERS; ++q) {
      const int first_lane = (cur.s >> (8 * q)) & 0x7f;
      const int last_lane = (cur.e >> (8 * q)) & 0x7f;
      d[q] = buf[last_lane] - pex[first_lane];
    }
    __syncwarp();  // the next group's piece rewrites buf and pex
    float* const tile = term[g & 1][w];
    *reinterpret_cast<float4*>(tile + QUARTERS * t) =
        make_float4(d[0], d[1], d[2], d[3]);
    __syncthreads();  // the group's 8 pieces are in its tile
    if (j < LANE) {
      float sum = term[g & 1][0][j];
#pragma unroll
      for (int r = 1; r < GROUP_PIECES; ++r) sum += term[g & 1][r][j];
      const int b = __ldg(a.group_sub + g);
      if (b != open) {
        flush(open);
        acc = 0.0f;
        open = b;
      }
      acc += rounded(sum);
    }
    cur = nxt;
  }
  if (j < LANE) flush(open);
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
  const AblateArgs a{static_cast<const int*>(block_ptr),
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

// The bf16 form at wsel 2 and 4: the row walk over the layout's row-ordered
// stream. row_slot, vals, cols (int32 x index), x, y (vals, x and y as bf16
// bit patterns), carry (2 floats a CTA), carry_row (an int a CTA),
// num_slots, slots_per_cta, m, stream
extern "C" int spgrid_wpack_spmv_bf16(const void* row_slot, const void* vals,
                                      const void* cols, const void* x,
                                      void* y, void* carry, void* carry_row,
                                      int num_slots, int slots_per_cta,
                                      int m, void* stream) {
  return spgrid::slot_stream::launch_rows(row_slot, vals, cols, x, y, carry,
                                          carry_row, num_slots,
                                          slots_per_cta, m, stream);
}

// The bf16 form at wsel 1: vals, x and y as bf16 bit patterns; carry holds
// 2 * 128 floats a CTA, ceil(groups / groups_per_cta) CTAs; groups_per_cta
// 1 to 16; starts and ends 4-byte aligned.
extern "C" int spgrid_wpack_spmv_bf16_prefix(
    const void* block_ptr, const void* group_sub, const void* piece_w,
    const void* cols, const void* starts, const void* ends, const void* vals,
    const void* x, void* y, void* carry, int groups_per_cta, int groups,
    int blocks, int m, int k, void* stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(starts) |
                        reinterpret_cast<uintptr_t>(ends)) % 4 == 0;
  if (groups_per_cta < 1 || groups_per_cta > MAX_GROUPS_PER_CTA ||
      groups < 1 || blocks < 1 || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  const PrefixArgs a{static_cast<const int*>(block_ptr),
                     static_cast<const int*>(group_sub),
                     static_cast<const int*>(piece_w),
                     static_cast<const unsigned char*>(cols),
                     static_cast<const signed char*>(starts),
                     static_cast<const signed char*>(ends),
                     static_cast<const unsigned short*>(vals),
                     static_cast<const unsigned short*>(x),
                     static_cast<unsigned short*>(y),
                     static_cast<float*>(carry),
                     groups,
                     groups_per_cta,
                     m,
                     k};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ctas = (groups + groups_per_cta - 1) / groups_per_cta;
  wpack_prefix_bf16_kernel<<<ctas, PREFIX_THREADS, 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  spgrid::slot_stream::combine<true><<<blocks, LANE, 0, s>>>(
      static_cast<const int*>(block_ptr), static_cast<const float*>(carry),
      static_cast<unsigned short*>(y), groups_per_cta, m);
  return static_cast<int>(cudaGetLastError());
}
