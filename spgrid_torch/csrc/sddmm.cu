// Block-sparse SDDMM: S_b = mask_b * (Q[rows[b] * bm : +bm] @ K[cols[b] * bk : +bk]^T)
// for every stored block b of a DeviceBSR mask.
//
// Replaces: spgrid/ops/pallas/sddmm.py, _kernel / _bsr_sddmm (the Pallas TPU
// kernel behind the attention pipeline's SDDMM stage).
//
// Bound on the H100: the blocks' full work, 2 nb bm bk d flops, three
// times over in 3xTF32 on the tensor cores. At the pipeline's shapes (512^2
// mask, 13 blocks of 128^2, d = 512) that is 0.22 GFLOP, 1.3 us at 495
// TFLOP/s in 3xTF32, and Q and K (2 MB) sit in L2. The grid is what is short: 13 blocks x 2 column
// tiles of 64 is 26 tiles for 132 SMs, each a contraction of 16 steps.
//
// Design (the tile of block_mma.cuh):
// - One tile a (mask block, slice of 128 of its bm rows, 64 of its bk
//   columns); below 64 rows one warpgroup multiplies. Both operands are
//   row-major with d contiguous, so Q's rows are A (K-major) and K's rows
//   are B, K-major as stored: K^T is never formed, and a step's (64 x 32) K
//   slice is split into TF32 hi and lo core matrices without a transpose.
//   A step is TK = 32 of d.
// - The tile's d steps are split across a cluster of C CTAs, C the largest
//   power of two up to 8 for which tiles x C CTAs still fit on the card's
//   SMs (`cluster_for` in block_mma.cuh, from the grid and the SM count):
//   at the pipeline C = 4, 104 CTAs of 4 steps. The partial tiles are summed in
//   rank order through distributed shared memory, multiplied by the mask
//   block once, and each element of the (nb, bm, bk) output is written
//   once, with no atomics.
// - Q rows >= mq and K rows >= mk read as zeros, so pad blocks (block_row =
//   mb) give zero blocks, as the Pallas kernel's sacrificial zero panel of Q
//   did; depths past d read as zeros. Q and K are staged by 16-byte
//   cp.async where d % 4 == 0 and the operand starts on 16 bytes, else by
//   4-byte copies.
//
// Device time at the pipeline (NVIDIA H100 80GB HBM3, 700 W power limit):
// 0.0114 ms at cluster 4 (0.0309 at cluster 1), against 0.0451 for
// torch.sparse.sampled_addmm; the f32 CUDA-core tile this design replaced,
// 52 CTAs of 32 unpipelined steps, took 0.0844 ms on the same card.
//
// The bf16 form (the Pallas kernel at dtype bf16: bf16 mask, Q and K, the
// f32 sum times the mask value in f32, rounded once to bf16): the same
// tiles and cluster split on the bf16 step of bf16_mma.cuh, BF_TK = 64 of
// d a step through a cp.async ring of BF_STAGES. Q's (128 x 64) slice is
// staged row-major (depth contiguous, rows padded to 144 bytes) and read
// into registers as wgmma's A; K's (64 x 64) slice goes straight into the
// K-major layout with the 128-byte swizzle as wgmma's B, K^T never formed.
// Bound on the H100: the bytes of the mask's blocks (bf16 in and out) and
// of Q and K once, or the blocks' dense work at 989 TFLOP/s, whichever is
// larger.
//
// The 3-pass bf16 form (the Pallas kernel's jnp.dot, sddmm.py:41, at
// matmul precision 'high', which the TPU computes as three bf16 passes):
// f32 mask, Q, K and out; v = v_hi + v_lo with v_hi = bf16(v) and v_lo =
// bf16(v - v_hi) (v - v_hi is exact in f32), both rounded to nearest, ties
// to even; out = (Q_hi K_lo + Q_lo K_hi) + Q_hi K_hi, times the mask (the
// dropped Q_lo K_lo term is ~2^-16 of a product). Bound on the H100: the
// bytes of the f32 mask's blocks in and out and of Q and K once, or three
// times the blocks' dense work at 989 TFLOP/s, whichever is larger; the
// blocks' work sets it (4096^2 band_and_decay mask at 0.95, d = 512: ~28
// GFLOP of three passes, 0.028 ms).
// What held its first form (0.257578 ms on that case, NVIDIA H100 80GB
// HBM3, 700 W): each CTA re-read and re-split its f32 Q and K slices at
// every step, once for every tile that touched them, with plain loads into
// one buffer and no ring, so no step's loads overlapped the previous
// step's products.
// The design now:
// - Split once. A pass of its own (`split_planes_kernel`, a thread 8
//   columns of a row) writes Q and K as bf16 hi and lo planes into scratch
//   that the wrapper allocates: rows of plane_cols(d) (d rounded up to whole
//   64-deep steps, zeros past d), so every row lies on 16 bytes and every
//   step is a whole TMA box; rows past mq and mk are read as zeros by TMA.
// - A TMA-fed tile of 128 x 128 outputs (a mask block's 128-row slice by
//   128 of its columns: each Q slice feeds twice the columns of the first
//   form's 64), on bf16_mma.cuh's pipelined machinery: a ring of X3_STAGES
//   stages of 64 KB (Q_hi, Q_lo, K_hi, K_lo, each a 128 x 64 box in the
//   128-byte swizzle, K-major as they lie, so K^T is never formed), one
//   producer thread keeping the loads in flight, two consumer warpgroups
//   at PT_CONSUMER_REGS registers (setmaxnreg): the hi and cross sums (64
//   f32 each a thread) and one fresh accumulator of 64 (ptxas: 168
//   registers at launch, the share of 384 threads, and no spill).
// - A step: Q_hi K_hi (four wgmma m64n128k16, both operands in shared
//   memory) into the fresh accumulator, added to the hi sum in f32 (the
//   tensor cores truncate their accumulate: a chain over all of d on the
//   hi sum would drift by ~d / 16 ulps); Q_hi K_lo and Q_lo K_hi straight
//   into the cross sum, whose terms are ~2^-8 of the hi terms, and so is
//   its truncation, ~2^-8 of an ulp of the output a product. The cross
//   products run on the tensor cores while the hi product is added (one
//   wait a step). After the last step the cross sum is added to the hi
//   sum, the cluster's partial tiles are summed in rank order through
//   distributed shared memory, and the mask multiplies the sum once: each
//   output written once, no atomics.
// - The epilogue's mask block is brought into L2 by the producer
//   warpgroup's idle warps as the tile starts, and each consumer loads its
//   elements' mask values before the barriers, so that the load's latency
//   passes under them (without, a development probe ran slower).
// - The d steps split across a cluster where the tiles leave the card
//   short (`cluster_for` at PT_SHARE, as bf16_mma.cuh's pipelined tile).
// Device time (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 11a, the
// case above, by graph replay): 0.095674 ms, the split pass 0.008017 of it
// (timed alone), against 0.257578 for the first form and 0.715976 for
// torch.sparse.sampled_addmm. The tile runs the three passes at ~320
// TFLOP/s: 559 tiles on one CTA an SM are 4.2 waves, and each tile's
// first loads and epilogue overlap no other tile's steps.
#include "bf16_mma.cuh"

namespace {

__global__ void __launch_bounds__(THREADS, 2)
bsr_sddmm_kernel(const int* __restrict__ block_rows,
                 const int* __restrict__ block_cols,
                 const float* __restrict__ mask, const float* __restrict__ q,
                 const float* __restrict__ kmat, float* __restrict__ out,
                 int bm, int bk, int mq, int mk, int d, int slices,
                 int col_tiles, bool q16, bool k16, bool o16) {
  extern __shared__ float4 smem4[];
  float* sb = reinterpret_cast<float*>(smem4);  // split K slice
  float* ring = sb + 2 * SB_FLOATS;
  const Frag f = frag();
  const int ranks = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int tile = blockIdx.x / ranks;
  const int j0 = tile % col_tiles * NT;
  const int i0 = tile / col_tiles % slices * ROWS;
  const int b = tile / col_tiles / slices;
  const int rows = min(ROWS, bm - i0);
  const int ncols = min(NT, bk - j0);
  const long long q0 = static_cast<long long>(block_rows[b]) * bm + i0;
  const long long k0 = static_cast<long long>(block_cols[b]) * bk + j0;
  const int qrows = static_cast<int>(
      max(0LL, min(static_cast<long long>(rows), mq - q0)));
  const int krows = static_cast<int>(
      max(0LL, min(static_cast<long long>(ncols), mk - k0)));
  const int nq = qrows > 0 && krows > 0 ? (d + TK - 1) / TK : 0;
  const int s0 = nq * rank / ranks;
  const int steps = nq * (rank + 1) / ranks - s0;

  auto issue = [&](int it, float* as) {
    const int d0 = (s0 + it) * TK;
    const int depth = min(TK, d - d0);
    stage_kmajor(as, q + static_cast<size_t>(q0) * d + d0, d, qrows, depth,
                 rows > 64 ? ROWS : 64, q16);
    stage_kmajor(as + A_FLOATS, kmat + static_cast<size_t>(k0) * d + d0, d,
                 krows, depth, NT, k16);
  };
  float acc[NT / 2] = {};
  mainloop(acc, ring, sb, steps, rows, f, issue,
           [](const float* ks, float* to) { split_kmajor(ks, to); });

  const size_t base =
      (static_cast<size_t>(b) * bm + i0) * bk + static_cast<size_t>(j0);
  reduce_store(acc, ring, rows, ncols, f, [&](int i, int j, const float4& v) {
    const size_t at = base + static_cast<size_t>(i) * bk + j;
    if (o16) {  // ncols % 4 == 0
      const float4 w = *reinterpret_cast<const float4*>(mask + at);
      *reinterpret_cast<float4*>(out + at) =
          make_float4(v.x * w.x, v.y * w.y, v.z * w.z, v.w * w.w);
      return;
    }
    const float s[4] = {v.x, v.y, v.z, v.w};
    for (int c = 0; c < 4 && j + c < ncols; ++c) {
      out[at + c] = s[c] * mask[at + c];
    }
  });
}

// The bf16 form's stage: Q's (128 x 64) slice, row-major with rows of
// QS_LD bf16, then K's (64 x 64) slice, swizzled.
constexpr int QS_LD = BF_TK + 8;
constexpr int Q_BYTES = ROWS * QS_LD * 2;
constexpr int SD_STAGE_BYTES = Q_BYTES + NT * BF_TK * 2;
constexpr size_t SD_SMEM_BYTES = BF_STAGES * SD_STAGE_BYTES + SWIZZLE_BYTES;
static_assert(Q_BYTES % SWIZZLE_BYTES == 0 &&
                  SD_STAGE_BYTES % SWIZZLE_BYTES == 0,
              "every stage's K slice starts on a swizzle atom");
static_assert(ROWS * RED_LD * sizeof(float) <= BF_STAGES * SD_STAGE_BYTES,
              "the partial tile fits in the ring");

// dst[i][c] (row stride QS_LD) = src[i * ld + c] (bf16) for i < rows and c
// < depth, 0 elsewhere, for i < fill rows: 16-byte cp.async where `vec`
// (depth % 8 == 0, src rows on 16 B), else 2-byte loads.
__device__ __forceinline__ void stage_rows_bf16(
    unsigned short* dst, const unsigned short* __restrict__ src, size_t ld,
    int rows, int depth, int fill, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < fill * (BF_TK / 8); e += THREADS) {
      const int i = e / (BF_TK / 8);
      const int c = e % (BF_TK / 8) * 8;
      unsigned short* d = dst + i * QS_LD + c;
      if (i < rows && c < depth) {
        cp_async16(d, src + i * ld + c);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    for (int e = threadIdx.x; e < fill * BF_TK; e += THREADS) {
      const int i = e / BF_TK;
      const int c = e % BF_TK;
      dst[i * QS_LD + c] = i < rows && c < depth
                               ? src[i * ld + c]
                               : static_cast<unsigned short>(0);
    }
  }
}

// The fragments of the warpgroup's 64 rows of a staged Q slice: row 16 w +
// g (+ 8), depths 2 q, 2 q + 1 (+ 8) of each 16, one 4-byte load each.
__device__ __forceinline__ void q_frags(StepFrags& a,
                                        const unsigned short* __restrict__ qs,
                                        const Frag& f) {
  const unsigned short* p = qs + (64 * f.wg + 16 * f.w + f.g) * QS_LD +
                            2 * f.q;
#pragma unroll
  for (int s = 0; s < BF_TK / 16; ++s) {
    const unsigned short* ps = p + 16 * s;
    a[s][0] = *reinterpret_cast<const uint32_t*>(ps);
    a[s][1] = *reinterpret_cast<const uint32_t*>(ps + 8 * QS_LD);
    a[s][2] = *reinterpret_cast<const uint32_t*>(ps + 8);
    a[s][3] = *reinterpret_cast<const uint32_t*>(ps + 8 * QS_LD + 8);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
bsr_sddmm_bf16_kernel(const int* __restrict__ block_rows,
                      const int* __restrict__ block_cols,
                      const unsigned short* __restrict__ mask,
                      const unsigned short* __restrict__ q,
                      const unsigned short* __restrict__ kmat,
                      unsigned short* __restrict__ out, int bm, int bk,
                      int mq, int mk, int d, int slices, int col_tiles,
                      bool q16, bool k16, bool o8) {
  unsigned char* ring = aligned_ring();
  const Frag f = frag();
  const int ranks = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int tile = blockIdx.x / ranks;
  const int j0 = tile % col_tiles * NT;
  const int i0 = tile / col_tiles % slices * ROWS;
  const int b = tile / col_tiles / slices;
  const int rows = min(ROWS, bm - i0);
  const int ncols = min(NT, bk - j0);
  const long long q0 = static_cast<long long>(block_rows[b]) * bm + i0;
  const long long k0 = static_cast<long long>(block_cols[b]) * bk + j0;
  const int qrows = static_cast<int>(
      max(0LL, min(static_cast<long long>(rows), mq - q0)));
  const int krows = static_cast<int>(
      max(0LL, min(static_cast<long long>(ncols), mk - k0)));
  const int nq = qrows > 0 && krows > 0 ? (d + BF_TK - 1) / BF_TK : 0;
  const int s0 = nq * rank / ranks;
  const int steps = nq * (rank + 1) / ranks - s0;

  auto issue = [&](int it, unsigned char* stage) {
    const int d0 = (s0 + it) * BF_TK;
    const int depth = min(BF_TK, d - d0);
    stage_rows_bf16(reinterpret_cast<unsigned short*>(stage),
                    q + static_cast<size_t>(q0) * d + d0, d, qrows, depth,
                    rows > 64 ? ROWS : 64, q16);
    stage_panel(stage + Q_BYTES, kmat + static_cast<size_t>(k0) * d + d0, d,
                krows, depth, NT, k16);
  };

  float acc[NT / 2] = {};
#pragma unroll
  for (int s = 0; s < BF_STAGES - 1; ++s) {
    if (s < steps) issue(s, ring + s * SD_STAGE_BYTES);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<BF_STAGES - 2>();
    fence_proxy_async();  // the copies land before the tensor cores read
    __syncthreads();      // step it has landed; step it - 1 is consumed
    const int next = it + BF_STAGES - 1;
    if (next < steps) issue(next, ring + next % BF_STAGES * SD_STAGE_BYTES);
    cp_async_commit();
    const unsigned char* stage = ring + it % BF_STAGES * SD_STAGE_BYTES;
    if (64 * f.wg < rows) {
      StepFrags a;
      q_frags(a, reinterpret_cast<const unsigned short*>(stage), f);
      mma_step(acc, a, descriptor_sw128(stage + Q_BYTES));
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the partial tile

  const size_t base =
      (static_cast<size_t>(b) * bm + i0) * bk + static_cast<size_t>(j0);
  reduce_store(acc, reinterpret_cast<float*>(ring), rows, ncols, f,
               [&](int i, int j, const float4& v) {
                 const size_t at = base + static_cast<size_t>(i) * bk + j;
                 float w[4] = {0.f, 0.f, 0.f, 0.f};
                 if (o8) {  // ncols % 4 == 0
                   const uint2 u = *reinterpret_cast<const uint2*>(mask + at);
                   w[0] = __uint_as_float(u.x << 16);
                   w[1] = __uint_as_float(u.x & 0xFFFF0000u);
                   w[2] = __uint_as_float(u.y << 16);
                   w[3] = __uint_as_float(u.y & 0xFFFF0000u);
                 } else {
                   for (int c = 0; c < 4 && j + c < ncols; ++c) {
                     w[c] = widen(mask[at + c]);
                   }
                 }
                 store_bf16x4(out + at,
                              make_float4(v.x * w[0], v.y * w[1], v.z * w[2],
                                          v.w * w[3]),
                              ncols - j, o8);
               });
}

// ---- The 3-pass form (see the top of this file).

constexpr int X3_STAGES = 3;                      // steps in the ring
constexpr int X3_BOX_BYTES = ROWS * BF_TK * 2;    // a 128 x 64 bf16 box
// a step's Q_hi, Q_lo, K_hi and K_lo boxes (K's PT_NT rows as Q's ROWS)
constexpr int X3_STAGE_BYTES = 4 * X3_BOX_BYTES;
constexpr int X3_RING_BYTES = X3_STAGES * X3_STAGE_BYTES;
constexpr size_t X3_SMEM =
    X3_RING_BYTES + SWIZZLE_BYTES + 2 * X3_STAGES * sizeof(uint64_t);
constexpr int SPLIT_THREADS = 256;
static_assert(PT_NT == ROWS, "a K box has as many rows as a Q box");
static_assert(X3_BOX_BYTES % SWIZZLE_BYTES == 0,
              "every box starts on a swizzle atom");
static_assert(ROWS * PT_RED_LD * sizeof(float) <= X3_RING_BYTES,
              "the partial tile fits in the ring");

// A split plane: plane_rows(m) rows of plane_cols(d) bf16, d rounded up to
// whole steps (at least one), so that every row lies on 16 bytes and every
// step is a whole TMA box. The scratch holds Q_hi, Q_lo, K_hi, K_lo in that
// order.
int plane_rows(int m) { return m > 1 ? m : 1; }

long long plane_cols(int d) {
  return d > BF_TK ? (d + BF_TK - 1LL) / BF_TK * BF_TK : BF_TK;
}

long long x3_scratch_bytes(int mq, int mk, int d) {
  return 2LL * 2 * (plane_rows(mq) + plane_rows(mk)) * plane_cols(d);
}

// The bf16 parts of v: hi = v rounded, lo = (v - hi) rounded.
__device__ __forceinline__ void split_bf16(float v, unsigned short& hi,
                                           unsigned short& lo) {
  hi = round_bf16(v);
  lo = round_bf16(v - widen(hi));
}

// The split pass: a thread the 8 columns c .. c + 7 of one plane row, the
// Q rows first, then the K rows. Row r < m of an operand (row stride d):
// hi and lo of each value, zeros past d; rows >= m zeros. float4 loads
// where `vec` (d % 4 == 0, the operand on 16 B), else 4-byte ones; one
// 16-byte store a plane.
__global__ void __launch_bounds__(SPLIT_THREADS)
split_planes_kernel(const float* __restrict__ q,
                    const float* __restrict__ kmat,
                    unsigned short* __restrict__ planes, int mq, int mk,
                    int d, int rq, int rk, int dp, bool q16, bool k16) {
  const int chunks = dp / 8;
  const long long e =
      static_cast<long long>(blockIdx.x) * SPLIT_THREADS + threadIdx.x;
  if (e >= (static_cast<long long>(rq) + rk) * chunks) return;
  long long r = e / chunks;
  const int c = static_cast<int>(e % chunks) * 8;
  const float* src = q;
  int m = mq;
  bool vec = q16;
  size_t plane = static_cast<size_t>(rq) * dp;
  unsigned short* hi = planes;
  if (r >= rq) {
    r -= rq;
    src = kmat;
    m = mk;
    vec = k16;
    hi = planes + 2 * plane;
    plane = static_cast<size_t>(rk) * dp;
  }
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (r < m) {
    const float* p = src + static_cast<size_t>(r) * d;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cc = c + 4 * h;
      if (vec && cc + 4 <= d) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p + cc));
        v[4 * h] = t.x;
        v[4 * h + 1] = t.y;
        v[4 * h + 2] = t.z;
        v[4 * h + 3] = t.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (cc + i < d) v[4 * h + i] = __ldg(p + cc + i);
        }
      }
    }
  }
  unsigned short h[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) split_bf16(v[i], h[i], l[i]);
  const size_t at = static_cast<size_t>(r) * dp + c;
  *reinterpret_cast<uint4*>(hi + at) =
      make_uint4(pack_bf16(h[0], h[1]), pack_bf16(h[2], h[3]),
                 pack_bf16(h[4], h[5]), pack_bf16(h[6], h[7]));
  *reinterpret_cast<uint4*>(hi + plane + at) =
      make_uint4(pack_bf16(l[0], l[1]), pack_bf16(l[2], l[3]),
                 pack_bf16(l[4], l[5]), pack_bf16(l[6], l[7]));
}

// Tile (block b, its rows i0 .. i0 + 127, its columns j0 .. j0 + 127): rank
// r of the cluster takes the steps [S r / C, S (r + 1) / C) of the tile's
// S = ceil(d / 64). The maps are the four planes in boxes of 128 rows x 64
// columns with the 128-byte swizzle; TMA fills the rows past mq or mk with
// zeros.
__global__ void __launch_bounds__(PT_THREADS, 1)
bsr_sddmm_bf16x3_kernel(const __grid_constant__ CUtensorMap qh_map,
                        const __grid_constant__ CUtensorMap ql_map,
                        const __grid_constant__ CUtensorMap kh_map,
                        const __grid_constant__ CUtensorMap kl_map,
                        const int* __restrict__ block_rows,
                        const int* __restrict__ block_cols,
                        const float* __restrict__ mask,
                        float* __restrict__ out, int bm, int bk, int mq,
                        int mk, int d, int slices, int col_tiles, bool o16) {
  unsigned char* ring = aligned_ring();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + X3_RING_BYTES);
  uint64_t* empty = full + X3_STAGES;
  const int ranks = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int tile = blockIdx.x / ranks;
  const int j0 = tile % col_tiles * PT_NT;
  const int i0 = tile / col_tiles % slices * ROWS;
  const int b = tile / col_tiles / slices;
  const int rows = min(ROWS, bm - i0);
  const int ncols = min(PT_NT, bk - j0);
  const long long q0 = static_cast<long long>(block_rows[b]) * bm + i0;
  const long long k0 = static_cast<long long>(block_cols[b]) * bk + j0;
  // a tile with no Q row or no K row inside its operand has no step
  const int nq = q0 < mq && k0 < mk ? (d + BF_TK - 1) / BF_TK : 0;
  const int s0 = nq * rank / ranks;
  const int steps = nq * (rank + 1) / ranks - s0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < X3_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  } else if (threadIdx.x == THREADS) {
    // the four descriptors' fetch, under the barriers' set-up
    asm volatile("prefetch.tensormap [%0];" ::"l"(&qh_map) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(&ql_map) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(&kh_map) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(&kl_map) : "memory");
  }
  __syncthreads();

  if (threadIdx.x >= THREADS) {
    // the producer warpgroup gives up registers; one thread keeps the ring
    // full, then the group takes part in sum_store's cluster barriers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PT_PRODUCER_REGS));
    if (threadIdx.x >= THREADS + 32) {
      // the group's other warps bring the tile's mask block into L2 for
      // the epilogue: 128-byte lines of its rows' ncols columns
      const float* m = mask + (static_cast<size_t>(b) * bm + i0) * bk + j0;
      const int lines = (ncols + 31) / 32;
      for (int e = threadIdx.x - THREADS - 32; e < rows * lines; e += 96) {
        asm volatile("prefetch.global.L2 [%0];" ::"l"(
            m + static_cast<size_t>(e / lines) * bk + e % lines * 32));
      }
    } else if (threadIdx.x == THREADS) {
      for (int it = 0; it < steps; ++it) {
        const int s = it % X3_STAGES;
        if (it >= X3_STAGES) mbar_wait(empty + s, (it / X3_STAGES - 1) & 1);
        const int c0 = (s0 + it) * BF_TK;
        unsigned char* stage = ring + s * X3_STAGE_BYTES;
        mbar_arrive_expect_tx(full + s, X3_STAGE_BYTES);
        tma_load(stage, &qh_map, c0, static_cast<int>(q0), full + s);
        tma_load(stage + X3_BOX_BYTES, &ql_map, c0, static_cast<int>(q0),
                 full + s);
        tma_load(stage + 2 * X3_BOX_BYTES, &kh_map, c0, static_cast<int>(k0),
                 full + s);
        tma_load(stage + 3 * X3_BOX_BYTES, &kl_map, c0, static_cast<int>(k0),
                 full + s);
      }
    }
    cg::this_cluster().sync();
    cg::this_cluster().sync();
    return;
  }
  // the consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(PT_CONSUMER_REGS));
  const Frag f = frag();
  float hi[PT_NT / 2], cross[PT_NT / 2];
#pragma unroll
  for (int e = 0; e < PT_NT / 2; ++e) {
    hi[e] = 0.0f;
    cross[e] = 0.0f;
  }
  {
    // step it: Q_hi K_hi into the fresh accumulator dd (one commit group),
    // then Q_hi K_lo and Q_lo K_hi straight into the cross sum (a second
    // group); wgmma_wait<1> retires the first, and dd is added to the hi
    // sum while the cross products run. Groups retire in order, so that
    // wait also retires step it - 1's cross products: its stage is free.
    const bool multiplies = 64 * f.wg < rows;
    float dd[PT_NT / 2];
    for (int it = 0; it < steps; ++it) {
      const int s = it % X3_STAGES;
      mbar_wait(full + s, (it / X3_STAGES) & 1);
      if (multiplies) {
        const unsigned char* stage = ring + s * X3_STAGE_BYTES;
        const uint64_t qh = descriptor_sw128(stage + f.wg * 64 * 128);
        const uint64_t ql =
            descriptor_sw128(stage + X3_BOX_BYTES + f.wg * 64 * 128);
        const uint64_t kh = descriptor_sw128(stage + 2 * X3_BOX_BYTES);
        const uint64_t kl = descriptor_sw128(stage + 3 * X3_BOX_BYTES);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BF_TK / 16; ++ks) {
          wgmma_bf16_ss<0>(dd, qh + 32 / 16 * ks, kh + 32 / 16 * ks, ks > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int ks = 0; ks < BF_TK / 16; ++ks) {
          wgmma_bf16_ss<0>(cross, qh + 32 / 16 * ks, kl + 32 / 16 * ks, 1);
          wgmma_bf16_ss<0>(cross, ql + 32 / 16 * ks, kh + 32 / 16 * ks, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
#pragma unroll
        for (int e = 0; e < PT_NT / 2; ++e) {
          fence_operand(dd[e]);
          hi[e] += dd[e];
        }
      }
      if (it > 0) mbar_arrive(empty + (it - 1) % X3_STAGES);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < PT_NT / 2; ++e) fence_operand(cross[e]);
    if (steps > 0) mbar_arrive(empty + (steps - 1) % X3_STAGES);
  }
  // the cross sum plus the hi sum, as bsr_sddmm_bf16x3_plain adds them
#pragma unroll
  for (int e = 0; e < PT_NT / 2; ++e) cross[e] += hi[e];

  // The epilogue: this thread's elements of the tile (four columns each,
  // every ranks * THREADS-th of the tile's rows x PT_NT / 4, as sum_store
  // deals them), their mask values loaded before the barriers so that the
  // loads' latency passes under them.
  const size_t base =
      (static_cast<size_t>(b) * bm + i0) * bk + static_cast<size_t>(j0);
  constexpr int PER = ROWS * (PT_NT / 4) / THREADS;  // elements at one rank
  float4 w[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = (k * ranks + rank) * THREADS + threadIdx.x;
    const int i = e / (PT_NT / 4);
    const int j = e % (PT_NT / 4) * 4;
    w[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i >= rows || j >= ncols) continue;
    const float* m = mask + base + static_cast<size_t>(i) * bk + j;
    if (o16) {  // ncols % 4 == 0
      w[k] = __ldg(reinterpret_cast<const float4*>(m));
    } else {
      w[k].x = __ldg(m);
      if (j + 1 < ncols) w[k].y = __ldg(m + 1);
      if (j + 2 < ncols) w[k].z = __ldg(m + 2);
      if (j + 3 < ncols) w[k].w = __ldg(m + 3);
    }
  }
  // every step consumed by both warpgroups: the ring is free
  asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");

  // accumulator 4 j + 2 h + c: row 64 wg + 16 w + 8 h + g, column 8 j +
  // 2 q + c of the tile
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * f.wg + 16 * f.w + 8 * h + f.g;
#pragma unroll
    for (int j = 0; j < PT_NT / 8; ++j) {
      *reinterpret_cast<float2*>(part + r * PT_RED_LD + 8 * j + 2 * f.q) =
          make_float2(cross[4 * j + 2 * h], cross[4 * j + 2 * h + 1]);
    }
  }
  // the ranks' partial tiles summed in rank order, times the mask, each
  // element stored once (sum_store's walk, with the mask loaded ahead)
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = (k * ranks + rank) * THREADS + threadIdx.x;
    const int i = e / (PT_NT / 4);
    const int j = e % (PT_NT / 4) * 4;
    if (i >= rows || j >= ncols) continue;
    const int at = i * PT_RED_LD + j;
    float4 v = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(part, 0) + at);
    for (int q = 1; q < ranks; ++q) {
      const float4 u = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, q) + at);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    float* o = out + base + static_cast<size_t>(i) * bk + j;
    const float4 r = make_float4(v.x * w[k].x, v.y * w[k].y, v.z * w[k].z,
                                 v.w * w[k].w);
    if (o16) {
      *reinterpret_cast<float4*>(o) = r;
    } else {
      o[0] = r.x;
      if (j + 1 < ncols) o[1] = r.y;
      if (j + 2 < ncols) o[2] = r.z;
      if (j + 3 < ncols) o[3] = r.w;
    }
  }
  cluster.sync();  // no rank leaves while another reads its tile
}

// The split pass into `scratch` (x3_scratch_bytes(mq, mk, d) bytes).
int split_planes(const void* q, const void* kmat, void* scratch, int mq,
                 int mk, int d, void* stream) {
  const int rq = plane_rows(mq);
  const int rk = plane_rows(mk);
  const long long dp = plane_cols(d);
  const long long threads = (static_cast<long long>(rq) + rk) * (dp / 8);
  const long long grid = (threads + SPLIT_THREADS - 1) / SPLIT_THREADS;
  if (dp > INT_MAX || grid > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  split_planes_kernel<<<static_cast<unsigned>(grid), SPLIT_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(kmat),
      static_cast<unsigned short*>(scratch), mq, mk, d, rq, rk,
      static_cast<int>(dp), d % 4 == 0 && aligned16(q),
      d % 4 == 0 && aligned16(kmat));
  return static_cast<int>(cudaGetLastError());
}

// The 3-pass form's tiles: mask blocks x 128-row slices x 128-column tiles.
long long x3_tiles(int nb, int bm, int bk) {
  return static_cast<long long>(nb) * ((bm + ROWS - 1) / ROWS) *
         ((bk + PT_NT - 1) / PT_NT);
}

// The tiles of a launch: mask blocks x 128-row slices x 64-column tiles.
long long sddmm_tiles(int nb, int bm, int bk) {
  return static_cast<long long>(nb) * ((bm + ROWS - 1) / ROWS) *
         ((bk + NT - 1) / NT);
}

}  // namespace

// out (int[6]) = {tiles, cluster, ROWS, NT, TK, STAGES} of the launch
// spgrid_bsr_sddmm makes for these sizes at cluster 0 on the current card.
extern "C" int spgrid_bsr_sddmm_shape(int nb, int bm, int bk, void* out) {
  if (nb <= 0 || bm <= 0 || bk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return report_shape(sddmm_tiles(nb, bm, bk), out);
}

// cluster: 0 for the launch rule (cluster_for), else 1, 2, 4 or 8.
// out (int[6]) = {tiles, cluster, ROWS, NT, BF_TK, BF_STAGES} of the
// launch spgrid_bsr_sddmm_bf16 makes for these sizes at cluster 0.
extern "C" int spgrid_bsr_sddmm_bf16_shape(int nb, int bm, int bk,
                                           void* out) {
  if (nb <= 0 || bm <= 0 || bk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return report_shape(sddmm_tiles(nb, bm, bk), out, BF_TK, BF_STAGES);
}

// out (int[6]) = {tiles, cluster, ROWS, PT_NT, BF_TK, X3_STAGES} of the
// tile launch spgrid_bsr_sddmm_bf16x3 makes for these sizes at cluster 0;
// scratch (long long[1]) = the bytes of the split planes it needs.
extern "C" int spgrid_bsr_sddmm_bf16x3_shape(int nb, int bm, int bk, int mq,
                                             int mk, int d, void* out,
                                             void* scratch) {
  if (nb <= 0 || bm <= 0 || bk <= 0 || mq < 0 || mk < 0 || d < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *static_cast<long long*>(scratch) = x3_scratch_bytes(mq, mk, d);
  return report_shape(x3_tiles(nb, bm, bk), out, BF_TK, X3_STAGES, PT_NT,
                      PT_SHARE);
}

// The 3-pass form's split pass alone: q (mq x d) and k (mk x d) in f32
// into the bf16 planes at scratch (for tests and timing; the form runs it
// itself).
extern "C" int spgrid_bsr_sddmm_bf16x3_split(const void* q, const void* kmat,
                                             void* scratch, int mq, int mk,
                                             int d, void* stream) {
  if (mq < 0 || mk < 0 || d < 0 || !aligned16(scratch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return split_planes(q, kmat, scratch, mq, mk, d, stream);
}

// The 3-pass bf16 form: mask, q, k and out in f32; scratch (on 16 B) the
// split planes' bytes that spgrid_bsr_sddmm_bf16x3_shape reports. Two
// launches: the split pass, then the tiles. cluster: 0 for the launch rule
// (cluster_for at PT_SHARE), else 1, 2, 4 or 8.
extern "C" int spgrid_bsr_sddmm_bf16x3(const void* rows, const void* cols,
                                       const void* mask, const void* q,
                                       const void* kmat, void* out,
                                       void* scratch, int nb, int bm, int bk,
                                       int mq, int mk, int d, int cluster,
                                       void* stream) {
  if (nb <= 0 || bm <= 0 || bk <= 0 || mq < 0 || mk < 0 || d < 0 ||
      !aligned16(scratch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int split = split_planes(q, kmat, scratch, mq, mk, d, stream);
  if (split != 0) return split;
  const long long rq = plane_rows(mq);
  const long long rk = plane_rows(mk);
  const long long dp = plane_cols(d);
  const unsigned short* planes = static_cast<const unsigned short*>(scratch);
  const unsigned short* k_planes = planes + 2 * rq * dp;
  CUtensorMap qh_map, ql_map, kh_map, kl_map;
  if (!bf16_tensor_map(&qh_map, planes, dp, rq, ROWS) ||
      !bf16_tensor_map(&ql_map, planes + rq * dp, dp, rq, ROWS) ||
      !bf16_tensor_map(&kh_map, k_planes, dp, rk, PT_NT) ||
      !bf16_tensor_map(&kl_map, k_planes + rk * dp, dp, rk, PT_NT)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  return launch_cta_tiles(
      bsr_sddmm_bf16x3_kernel, x3_tiles(nb, bm, bk), cluster, X3_SMEM,
      PT_THREADS, PT_SHARE, stream, qh_map, ql_map, kh_map, kl_map,
      static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<const float*>(mask), static_cast<float*>(out), bm, bk, mq,
      mk, d, (bm + ROWS - 1) / ROWS, (bk + PT_NT - 1) / PT_NT,
      bk % 4 == 0 && aligned16(mask) && aligned16(out));
}

// The bf16 form: mask, q, k and out as bf16 bit patterns. cluster: 0 for
// the launch rule (cluster_for), else 1, 2, 4 or 8.
extern "C" int spgrid_bsr_sddmm_bf16(const void* rows, const void* cols,
                                     const void* mask, const void* q,
                                     const void* kmat, void* out, int nb,
                                     int bm, int bk, int mq, int mk, int d,
                                     int cluster, void* stream) {
  if (nb <= 0 || bm <= 0 || bk <= 0 || d < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_tiles(
      bsr_sddmm_bf16_kernel, sddmm_tiles(nb, bm, bk), cluster, SD_SMEM_BYTES,
      stream, static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<const unsigned short*>(mask),
      static_cast<const unsigned short*>(q),
      static_cast<const unsigned short*>(kmat),
      static_cast<unsigned short*>(out), bm, bk, mq, mk, d,
      (bm + ROWS - 1) / ROWS, (bk + NT - 1) / NT,
      d % 8 == 0 && aligned16(q), d % 8 == 0 && aligned16(kmat),
      bk % 4 == 0 && aligned8(mask) && aligned8(out));
}

extern "C" int spgrid_bsr_sddmm(const void* rows, const void* cols,
                                const void* mask, const void* q,
                                const void* kmat, void* out, int nb, int bm,
                                int bk, int mq, int mk, int d, int cluster,
                                void* stream) {
  if (nb <= 0 || bm <= 0 || bk <= 0 || d < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_clusters(
      bsr_sddmm_kernel, sddmm_tiles(nb, bm, bk), cluster, stream,
      static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<const float*>(mask), static_cast<const float*>(q),
      static_cast<const float*>(kmat), static_cast<float*>(out), bm, bk, mq,
      mk, d, (bm + ROWS - 1) / ROWS, (bk + NT - 1) / NT,
      d % 4 == 0 && aligned16(q), d % 4 == 0 && aligned16(kmat),
      bk % 4 == 0 && aligned16(mask) && aligned16(out));
}
