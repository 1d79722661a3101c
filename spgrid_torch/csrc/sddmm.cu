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
// The bf16 form, 3b (the Pallas kernel at dtype bf16: bf16 mask, Q and K,
// the f32 sum times the mask value in f32, rounded once to bf16). Bound on
// the H100: the bytes of the mask's blocks (bf16 in and out) and of Q and K
// once, or the blocks' dense work at 989 TFLOP/s, whichever is larger (on
// the 4096^2 band_and_random mask at 0.95, d = 512, 559 blocks of 128^2:
// 45 MB, 0.0134 ms, against 9.4 GFLOP, 0.0095 ms).
// What held its first form (0.083276 ms there, NVIDIA H100 80GB HBM3, 700
// W): tiles of 128 x 64 with two CTAs an SM, Q staged by cp.async
// row-major and read into registers as wgmma's A, each Q slice staged once
// for each of a block's two 64-column tiles, 4.2 waves of tiles, and each
// tile's epilogue through the ring, overlapping none of its own CTA's
// steps.
// The design now:
// - A tile of 128 x 128 outputs fed by TMA: a ring of SD_STAGES (4) stages
//   of 32 KB, a step's Q and K boxes (128 rows x 64 of d each, both K-major
//   as they lie, in the 128-byte swizzle, so K^T is never formed); one
//   producer thread keeps the ring full, two consumer warpgroups at
//   PT_CONSUMER_REGS (setmaxnreg) run a step as four wgmma m64n128k16, both
//   operands in shared memory, into a fresh accumulator (d0, d1 in turn)
//   added to the running f32 sum while the next step runs (the tensor
//   cores truncate their accumulate). TMA reads Q and K as they lie where
//   d % 8 == 0 and both lie on 16 bytes; rows past mq or mk and depths past
//   d come back as its zero fill. Otherwise a copy pass (copy_planes_kernel)
//   writes them, zero-padded to plane_cols(d), into scratch that the
//   wrapper allocates (sd_scratch_bytes; 0 where TMA reads them).
// - Persistent tiles: where cluster_for (at PT_SHARE) gives 1, one CTA an
//   SM walks its share of the tiles in order (consecutive tiles share a
//   block row, so a Q slice), the ring's stages and phases carrying on
//   across tiles: the producer loads the next tile's steps while the
//   consumers finish this tile's epilogue. The epilogue uses no stage of
//   the ring: as each tile starts, a helper thread of the producer
//   warpgroup loads its bf16 mask block (32 KB) by TMA into one of two
//   tile buffers; the consumers overwrite it in place with round(sum x
//   mask), and the helper stores it out by TMA (rows past bm and columns
//   past bk neither read nor written), then refills that buffer two tiles
//   on. Where TMA cannot take the mask or the output (bk % 8 != 0, off 16
//   bytes), the producer warpgroup's warps 1 .. 3 fill and drain the
//   buffers with plain loads and stores instead.
// - Where the grid is short (the pipeline's 512^2 mask), a cluster of C
//   CTAs takes one tile, its ranks splitting its steps; rank 0 adds the
//   other ranks' partial tiles to its own in rank order through
//   distributed shared memory before the same epilogue. Every output
//   element is written once, no atomics: the same bits on every call.
// - Budget: 384 threads, one CTA an SM: the ring (128 KB), two tile
//   buffers (64 KB), the alignment and 12 mbarriers, 197,728 bytes; ptxas
//   168 registers at launch (the share of 384 threads), no spill.
// Device time (NVIDIA H100 80GB HBM3, 700 W; the case above, by graph
// replay; see PERF.md, row 3b): 0.036614 ms, from 0.082996 for the first
// form on the same card, 132 CTAs walking 4.23 tiles each; forcing a
// cluster a tile there took 0.080 ms (2), 0.206 (4), 0.608 (8). Each step
// still streams its 32 KB of Q and K from L2 (143 MB in all, ~4 TB/s at
// this time): the feed, not the tensor cores, sets the pace.
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
// - Split once. A pass of its own (`split_pair` of bf16x3.cuh, which the
//   SpMMs' 3-pass forms share; a thread 8 columns of a row) writes Q and K
//   as bf16 hi and lo planes into scratch that the wrapper allocates: rows
//   of plane_cols(d) (d rounded up to whole 64-deep steps, zeros past d),
//   so every row lies on 16 bytes and every step is a whole TMA box; rows
//   past mq and mk are read as zeros by TMA.
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
#include <algorithm>

#include "bf16x3.cuh"

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

// ---- The 3-pass form (see the top of this file). Its ring, its constants
// and the split pass are bf16x3.cuh's, which the SpMMs' 3-pass forms share.

// The split planes' bytes: Q's plane_rows(mq), then K's plane_rows(mk),
// each hi and lo, of plane_cols(d).
long long x3_scratch_bytes(int mq, int mk, int d) {
  return plane_pair_bytes(plane_rows(mq), d) +
         plane_pair_bytes(plane_rows(mk), d);
}

// Tile (block b, its rows i0 .. i0 + 127, its columns j0 .. j0 + 127): rank
// r of the cluster takes the steps [S r / C, S (r + 1) / C) of the tile's
// S = ceil(d / 64). The maps are the four planes (Q_hi, Q_lo, K_hi, K_lo)
// in boxes of 128 rows x 64 columns with the 128-byte swizzle; TMA fills
// the rows past mq or mk with zeros. The ring and the 3-pass step are
// bf16x3.cuh's (`x3_consume<0>`: K's boxes K-major).
__global__ void __launch_bounds__(PT_THREADS, 1)
bsr_sddmm_bf16x3_kernel(const __grid_constant__ X3Maps maps,
                        const int* __restrict__ block_rows,
                        const int* __restrict__ block_cols,
                        const float* __restrict__ mask,
                        float* __restrict__ out, int bm, int bk, int mq,
                        int mk, int d, int slices, int col_tiles, bool o16) {
  const X3Ring ring = x3_ring(maps.m);
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
      x3_produce(ring, steps, [&](unsigned char* stage, uint64_t* bar,
                                  int it) {
        const int c0 = (s0 + it) * BF_TK;
        for (int i = 0; i < 4; ++i) {
          tma_load(stage + i * X3_BOX_BYTES, maps.m + i, c0,
                   static_cast<int>(i < 2 ? q0 : k0), bar);
        }
      });
    }
    cg::this_cluster().sync();
    cg::this_cluster().sync();
    return;
  }
  // the consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63; cross
  // + hi, as bsr_sddmm_bf16x3_plain adds them
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(PT_CONSUMER_REGS));
  const Frag f = frag();
  float cross[PT_NT / 2];
  x3_consume<0>(ring, steps, 64 * f.wg < rows, f, cross);

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
  float* part = reinterpret_cast<float*>(ring.stages);
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

// ---- The bf16 form, 3b (see the top of this file).

constexpr int SD_STAGES = 4;                        // steps in the ring
constexpr int SD_BOX_BYTES = ROWS * BF_TK * 2;      // a 128 x 64 bf16 box
constexpr int SD_STAGE_BYTES = 2 * SD_BOX_BYTES;    // a step's Q and K boxes
constexpr int SD_RING_BYTES = SD_STAGES * SD_STAGE_BYTES;
// a tile's bf16 mask block, then its output, in place: two 128 x 64 boxes
constexpr int SD_TILE_BYTES = ROWS * PT_NT * 2;
constexpr int SD_TILE_BUFS = 2;                     // tiles n and n + 1
constexpr int SD_HELPERS = 96;  // the producer warpgroup's warps 1 .. 3
constexpr size_t SD_SMEM = SD_RING_BYTES + SD_TILE_BUFS * SD_TILE_BYTES +
                           SWIZZLE_BYTES +
                           2 * (SD_STAGES + SD_TILE_BUFS) * sizeof(uint64_t);
static_assert(PT_NT == ROWS, "a K box has as many rows as a Q box");
static_assert(SD_BOX_BYTES % SWIZZLE_BYTES == 0 &&
                  SD_TILE_BYTES % (2 * SWIZZLE_BYTES) == 0,
              "every box starts on a swizzle atom");
static_assert(ROWS * PT_RED_LD * sizeof(float) <= SD_RING_BYTES,
              "a rank's partial tile fits in the ring");
static_assert(SD_SMEM <= 232448, "one CTA an SM");

// A tile of the bf16 form: mask block b, its rows i0 .. i0 + 127 and its
// columns j0 .. j0 + 127 (rows and ncols of them inside the block); Q rows
// from q0, K rows from k0; this rank's steps s0 .. s0 + steps - 1 of the
// tile's ceil(d / 64) (none where no Q row or no K row lies inside its
// operand).
struct SdTile {
  int b, i0, j0, rows, ncols, q0, k0, s0, steps;
};

__device__ __forceinline__ SdTile sd_tile(int t, const int* __restrict__ rows_,
                                          const int* __restrict__ cols_,
                                          int bm, int bk, int mq, int mk,
                                          int d, int slices, int col_tiles,
                                          int ranks, int rank) {
  SdTile x;
  x.j0 = t % col_tiles * PT_NT;
  x.i0 = t / col_tiles % slices * ROWS;
  x.b = t / col_tiles / slices;
  x.rows = min(ROWS, bm - x.i0);
  x.ncols = min(PT_NT, bk - x.j0);
  const long long q0 = static_cast<long long>(__ldg(rows_ + x.b)) * bm + x.i0;
  const long long k0 = static_cast<long long>(__ldg(cols_ + x.b)) * bk + x.j0;
  const int nq = q0 < mq && k0 < mk ? (d + BF_TK - 1) / BF_TK : 0;
  x.q0 = static_cast<int>(min(q0, static_cast<long long>(INT_MAX)));
  x.k0 = static_cast<int>(min(k0, static_cast<long long>(INT_MAX)));
  x.s0 = nq * rank / ranks;
  x.steps = nq * (rank + 1) / ranks - x.s0;
  return x;
}

// The 3-d box of `map` at (c0, c1, c2) into dst, completing on bar.
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map,
                                          int c0, int c1, int c2,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// src into the 3-d box of `map` at (c0, c1, c2); elements outside the
// tensor are not written.
__device__ __forceinline__ void tma_store3(const CUtensorMap* map,
                                           const void* src, int c0, int c1,
                                           int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// The committed bulk stores have read their shared memory (`read`) or are
// done.
template <bool READ>
__device__ __forceinline__ void bulk_wait_all() {
  if (READ) {
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

// Byte of the tile buffer at row i, columns 8 c .. 8 c + 7 (c < 16): two
// boxes of 64 columns, each with the 128-byte swizzle, as TMA lays them.
__device__ __forceinline__ int tile_byte(int i, int c) {
  return c / 8 * (SD_TILE_BYTES / 2) + swizzled(i, c % 8);
}

// The mask block of tile x into buf by the SD_HELPERS threads (h their
// index) with 2-byte loads, zeros outside the block; for a mask or an
// output TMA cannot take (bk % 8 != 0, off 16 bytes).
__device__ __forceinline__ void fill_plain(unsigned char* buf,
                                           const unsigned short* mask,
                                           const SdTile& x, int bm, int bk,
                                           int h) {
  const unsigned short* m =
      mask + (static_cast<size_t>(x.b) * bm + x.i0) * bk + x.j0;
  for (int e = h; e < ROWS * (PT_NT / 8); e += SD_HELPERS) {
    const int i = e / (PT_NT / 8);
    const int c = e % (PT_NT / 8);
    unsigned short v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = 8 * c + u;
      v[u] = i < x.rows && j < x.ncols ? m[static_cast<size_t>(i) * bk + j]
                                       : static_cast<unsigned short>(0);
    }
    *reinterpret_cast<uint4*>(buf + tile_byte(i, c)) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

// The output tile in buf to out, the block's elements only.
__device__ __forceinline__ void drain_plain(const unsigned char* buf,
                                            unsigned short* out,
                                            const SdTile& x, int bm, int bk,
                                            int h) {
  unsigned short* o = out + (static_cast<size_t>(x.b) * bm + x.i0) * bk + x.j0;
  for (int e = h; e < x.rows * (PT_NT / 8); e += SD_HELPERS) {
    const int i = e / (PT_NT / 8);
    const int c = e % (PT_NT / 8);
    if (8 * c >= x.ncols) continue;
    const unsigned short* v =
        reinterpret_cast<const unsigned short*>(buf + tile_byte(i, c));
    for (int u = 0; u < 8 && 8 * c + u < x.ncols; ++u) {
      o[static_cast<size_t>(i) * bk + 8 * c + u] = v[u];
    }
  }
}

// The bf16 form: a cluster of `ranks` CTAs walks the tiles [T c / G, T (c
// + 1) / G) of the launch's T, c its index of G (consecutive tiles share
// their block's Q slice). A cluster of one CTA walks several tiles (the
// persistent walk); a larger cluster takes one tile, its ranks splitting
// its steps, and rank 0 sums the ranks' partial tiles in rank order. The
// ring's stages and phases carry on across a CTA's tiles. q_map and k_map
// are Q and K (or their copies, `copy_planes`) in boxes of 128 rows x 64 of
// d; m_map and o_map the mask and the output as (nb, bm, bk) in boxes of
// 128 rows x 64 columns of one block, where `tile_tma`.
__global__ void __launch_bounds__(PT_THREADS, 1)
bsr_sddmm_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap m_map,
                      const __grid_constant__ CUtensorMap o_map,
                      const int* __restrict__ block_rows,
                      const int* __restrict__ block_cols,
                      const unsigned short* __restrict__ mask,
                      unsigned short* __restrict__ out, int bm, int bk,
                      int mq, int mk, int d, int slices, int col_tiles,
                      int tiles, bool tile_tma) {
  unsigned char* ring = aligned_ring();
  unsigned char* tbuf = ring + SD_RING_BYTES;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(tbuf + SD_TILE_BUFS * SD_TILE_BYTES);
  uint64_t* empty = full + SD_STAGES;
  uint64_t* mask_full = empty + SD_STAGES;     // a tile buffer's mask is in
  uint64_t* out_ready = mask_full + SD_TILE_BUFS;  // ... its output is
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const bool split = ranks > 1;
  const long long walkers = gridDim.x / ranks;
  const long long c = blockIdx.x / ranks;
  const int t_begin = static_cast<int>(tiles * c / walkers);
  const int t_end = static_cast<int>(tiles * (c + 1) / walkers);
  auto tile_at = [&](int t) {
    return sd_tile(t, block_rows, block_cols, bm, bk, mq, mk, d, slices,
                   col_tiles, ranks, rank);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < SD_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, THREADS);
    }
    for (int u = 0; u < SD_TILE_BUFS; ++u) {
      mbar_init(mask_full + u, tile_tma ? 1 : SD_HELPERS);
      mbar_init(out_ready + u, THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  } else if (threadIdx.x == THREADS) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(&q_map) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(&k_map) : "memory");
    if (tile_tma) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(&m_map) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(&o_map) : "memory");
    }
  }
  __syncthreads();

  if (threadIdx.x >= THREADS) {
    // the producer warpgroup gives up registers: thread THREADS keeps the
    // ring full across the CTA's tiles; warps 1 .. 3 (one thread of them
    // under TMA) bring each tile's mask block into a tile buffer as the
    // tile starts, and take its output out once the consumers have written
    // it there (rank 0 of a cluster only)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PT_PRODUCER_REGS));
    const int h = threadIdx.x - THREADS - 32;
    if (threadIdx.x == THREADS) {
      int g = 0;
      for (int t = t_begin; t < t_end; ++t) {
        const SdTile x = tile_at(t);
        for (int it = 0; it < x.steps; ++it, ++g) {
          const int s = g % SD_STAGES;
          if (g >= SD_STAGES) mbar_wait(empty + s, (g / SD_STAGES - 1) & 1);
          const int c0 = (x.s0 + it) * BF_TK;
          unsigned char* stage = ring + s * SD_STAGE_BYTES;
          mbar_arrive_expect_tx(full + s, SD_STAGE_BYTES);
          tma_load(stage, &q_map, c0, x.q0, full + s);
          tma_load(stage + SD_BOX_BYTES, &k_map, c0, x.k0, full + s);
        }
      }
    }
    // the helpers: tile n's mask block into buffer n % 2 as the walk
    // reaches it, once tile n - 2's output has left that buffer
    const bool helper = h >= 0 && rank == 0 && (!tile_tma || h == 0);
    int pend[SD_TILE_BUFS] = {0, 0};
    int n = 0;
    auto fill = [&](int t, int u) {
      const SdTile x = tile_at(t);
      unsigned char* buf = tbuf + u * SD_TILE_BYTES;
      if (tile_tma) {
        const bool two = x.j0 + 64 < bk;  // the second box holds columns
        mbar_arrive_expect_tx(mask_full + u,
                              two ? SD_TILE_BYTES : SD_TILE_BYTES / 2);
        tma_load3(buf, &m_map, x.j0, x.i0, x.b, mask_full + u);
        if (two) {
          tma_load3(buf + SD_TILE_BYTES / 2, &m_map, x.j0 + 64, x.i0, x.b,
                    mask_full + u);
        }
      } else {
        fill_plain(buf, mask, x, bm, bk, h);
        mbar_arrive(mask_full + u);
      }
    };
    auto drain = [&](int e) {  // the e-th tile of the walk
      const int u = e % SD_TILE_BUFS;
      const SdTile x = tile_at(pend[u]);
      const unsigned char* buf = tbuf + u * SD_TILE_BYTES;
      mbar_wait(out_ready + u, (e / SD_TILE_BUFS) & 1);
      if (tile_tma) {
        tma_store3(&o_map, buf, x.j0, x.i0, x.b);
        if (x.j0 + 64 < bk) {
          tma_store3(&o_map, buf + SD_TILE_BYTES / 2, x.j0 + 64, x.i0, x.b);
        }
        bulk_commit();
        bulk_wait_all<true>();  // the buffer is free for tile e + 2
      } else {
        drain_plain(buf, out, x, bm, bk, h);
        asm volatile("bar.sync 2, %0;" ::"n"(SD_HELPERS) : "memory");
      }
    };
    if (helper) {
      for (int t = t_begin; t < t_end; ++t, ++n) {
        if (n >= SD_TILE_BUFS) drain(n - SD_TILE_BUFS);
        fill(t, n % SD_TILE_BUFS);
        pend[n % SD_TILE_BUFS] = t;
      }
    }
    if (split) {  // every thread of the group, at one place
      cluster.sync();
      cluster.sync();
    }
    if (helper) {
      for (int e = max(n - SD_TILE_BUFS, 0); e < n; ++e) drain(e);
      if (tile_tma) bulk_wait_all<false>();
    }
    return;
  }

  // the consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(PT_CONSUMER_REGS));
  const Frag f = frag();
  int g = 0;
  int n = 0;
  for (int t = t_begin; t < t_end; ++t, ++n) {
    const SdTile x = tile_at(t);
    float acc[PT_NT / 2];
#pragma unroll
    for (int e = 0; e < PT_NT / 2; ++e) acc[e] = 0.0f;
    {
      // a step's four wgmma into a fresh accumulator (d0, d1 in turn),
      // added to the running sums while the next step runs
      const bool multiplies = 64 * f.wg < x.rows;
      float d0[PT_NT / 2], d1[PT_NT / 2];
      auto issue = [&](float (&dd)[PT_NT / 2], int gi) {
        const int s = gi % SD_STAGES;
        mbar_wait(full + s, (gi / SD_STAGES) & 1);
        if (!multiplies) return;
        const unsigned char* stage = ring + s * SD_STAGE_BYTES;
        const uint64_t qa = descriptor_sw128(stage + f.wg * 64 * 128);
        const uint64_t kb = descriptor_sw128(stage + SD_BOX_BYTES);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BF_TK / 16; ++ks) {
          wgmma_bf16_ss<0>(dd, qa + 32 / 16 * ks, kb + 32 / 16 * ks, ks > 0);
        }
        wgmma_commit();
      };
      auto retire = [&](float (&dd)[PT_NT / 2], int gi) {
        if (multiplies) {
#pragma unroll
          for (int e = 0; e < PT_NT / 2; ++e) {
            fence_operand(dd[e]);
            acc[e] += dd[e];
          }
        }
        mbar_arrive(empty + gi % SD_STAGES);
      };
      const int steps = x.steps;
      int it = 1;
      if (steps > 0) issue(d0, g);
      for (; it + 1 < steps; it += 2) {
        issue(d1, g + it);
        wgmma_wait<1>();
        retire(d0, g + it - 1);
        issue(d0, g + it + 1);
        wgmma_wait<1>();
        retire(d1, g + it);
      }
      if (it < steps) {
        issue(d1, g + it);
        wgmma_wait<1>();
        retire(d0, g + it - 1);
        wgmma_wait<0>();
        retire(d1, g + it);
      } else if (steps > 0) {
        wgmma_wait<0>();
        retire(d0, g + it - 1);
      }
      g += steps;
    }
    if (split) {
      // the one tile of the cluster: every step consumed by both
      // warpgroups, so the ring is free for the ranks' partial tiles;
      // rank 0 adds ranks 1 .. C - 1's to its own, in rank order
      asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
      float* part = reinterpret_cast<float*>(ring);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 64 * f.wg + 16 * f.w + 8 * hh + f.g;
#pragma unroll
        for (int j = 0; j < PT_NT / 8; ++j) {
          *reinterpret_cast<float2*>(part + r * PT_RED_LD + 8 * j + 2 * f.q) =
              make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
        }
      }
      cluster.sync();
      if (rank == 0) {
        for (int q = 1; q < ranks; ++q) {
          const float* peer = cluster.map_shared_rank(part, q);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = 64 * f.wg + 16 * f.w + 8 * hh + f.g;
#pragma unroll
            for (int j = 0; j < PT_NT / 8; ++j) {
              const float2 v = *reinterpret_cast<const float2*>(
                  peer + r * PT_RED_LD + 8 * j + 2 * f.q);
              acc[4 * j + 2 * hh] += v.x;
              acc[4 * j + 2 * hh + 1] += v.y;
            }
          }
        }
      }
      cluster.sync();  // no rank leaves while rank 0 reads its tile
      if (rank != 0) continue;
    }
    // the epilogue, over the tile buffer: each element of this thread's
    // (row 64 wg + 16 w + 8 h + g, columns 8 j + 2 q, + 1) becomes
    // round(sum x mask) in place, in f32 then rounded once; then the
    // helper takes the tile out while this CTA goes on to the next tile
    const int u = n % SD_TILE_BUFS;
    unsigned char* buf = tbuf + u * SD_TILE_BYTES;
    mbar_wait(mask_full + u, (n / SD_TILE_BUFS) & 1);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 64 * f.wg + 16 * f.w + 8 * hh + f.g;
#pragma unroll
      for (int j = 0; j < PT_NT / 8; ++j) {
        uint32_t* p =
            reinterpret_cast<uint32_t*>(buf + tile_byte(r, j) + 4 * f.q);
        const uint32_t w = *p;
        *p = pack_bf16(
            round_bf16(acc[4 * j + 2 * hh] * __uint_as_float(w << 16)),
            round_bf16(acc[4 * j + 2 * hh + 1] *
                       __uint_as_float(w & 0xFFFF0000u)));
      }
    }
    fence_proxy_async();  // the writes land before TMA reads the buffer
    mbar_arrive(out_ready + u);
  }
}

// The copy pass of the bf16 form where TMA cannot read Q or K as they lie
// (d % 8 != 0, an operand off 16 bytes, no row or no depth): a thread the
// 8 columns c .. c + 7 of a plane row, Q's rows first, then K's; zeros
// past d and past the operand's rows; one 16-byte store.
__global__ void __launch_bounds__(SPLIT_THREADS)
copy_planes_kernel(const unsigned short* __restrict__ q,
                   const unsigned short* __restrict__ kmat,
                   unsigned short* __restrict__ planes, int mq, int mk,
                   int d, int rq, int rk, int dp) {
  const int chunks = dp / 8;
  const long long e =
      static_cast<long long>(blockIdx.x) * SPLIT_THREADS + threadIdx.x;
  if (e >= (static_cast<long long>(rq) + rk) * chunks) return;
  long long r = e / chunks;
  const int c = static_cast<int>(e % chunks) * 8;
  const unsigned short* src = q;
  int m = mq;
  unsigned short* dst = planes;
  if (r >= rq) {
    r -= rq;
    src = kmat;
    m = mk;
    dst = planes + static_cast<size_t>(rq) * dp;
  }
  unsigned short v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = r < m && c + i < d ? __ldg(src + static_cast<size_t>(r) * d + c + i)
                              : static_cast<unsigned short>(0);
  }
  *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * dp + c) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
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

// Whether TMA reads the bf16 form's Q and K as they lie: d a whole
// number of 16-byte chunks, both on 16 bytes, each with a row and a depth;
// else the copy pass writes them padded into scratch.
bool sd_direct(const void* q, const void* kmat, int mq, int mk, int d) {
  return d > 0 && d % 8 == 0 && mq > 0 && mk > 0 && aligned16(q) &&
         aligned16(kmat);
}

long long sd_scratch_bytes(const void* q, const void* kmat, int mq, int mk,
                           int d) {
  return sd_direct(q, kmat, mq, mk, d)
             ? 0
             : 2LL * (plane_rows(mq) + plane_rows(mk)) * plane_cols(d);
}

// The bf16 form's copy pass into `scratch` (sd_scratch_bytes of its
// planes: Q's plane_rows(mq), then K's plane_rows(mk), of plane_cols(d)).
int copy_planes(const void* q, const void* kmat, void* scratch, int mq,
                int mk, int d, void* stream) {
  const long long rq = plane_rows(mq);
  const long long rk = plane_rows(mk);
  const long long dp = plane_cols(d);
  const long long grid =
      ((rq + rk) * (dp / 8) + SPLIT_THREADS - 1) / SPLIT_THREADS;
  if (dp > INT_MAX || grid > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  copy_planes_kernel<<<static_cast<unsigned>(grid), SPLIT_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(q),
      static_cast<const unsigned short*>(kmat),
      static_cast<unsigned short*>(scratch), mq, mk, d, static_cast<int>(rq),
      static_cast<int>(rk), static_cast<int>(dp));
  return static_cast<int>(cudaGetLastError());
}

// The bf16 form's launch of `tiles` tiles at `cluster` (0: cluster_for at
// PT_SHARE): its cluster and its CTAs, one an SM walking tiles where the
// cluster is 1, else a cluster a tile.
void sd_grid(long long tiles, int& cluster, long long& ctas) {
  if (cluster == 0) cluster = cluster_for(tiles, PT_SHARE);
  int device = 0;
  int sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long sm_count = std::max(sms, 1);
  ctas = cluster == 1 ? std::min(tiles, sm_count) : tiles * cluster;
}

// map = (nb, bm, bk) bf16 blocks at base as a 3-d tensor, boxes of ROWS
// rows x 64 columns of one block with the 128-byte swizzle (rows past bm
// and columns past bk: zeros in, not written out); false where TMA cannot
// take it.
bool bf16_block_map(CUtensorMap* map, const void* base, int nb, int bm,
                    int bk) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr || bk % 8 != 0 || !aligned16(base)) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(bk),
                              static_cast<cuuint64_t>(bm),
                              static_cast<cuuint64_t>(nb)};
  const cuuint64_t strides[2] = {2ULL * bk, 2ULL * bk * bm};
  const cuuint32_t box[3] = {64, ROWS, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// out (int[7]) = {tiles, cluster, ROWS, PT_NT, BF_TK, SD_STAGES, CTAs} of
// the launch spgrid_bsr_sddmm_bf16 makes for these sizes at cluster 0 on
// the current card; scratch (long long[1]) = the bytes of the copy pass's
// planes it needs for Q at q and K at kmat (0 where TMA reads them).
extern "C" int spgrid_bsr_sddmm_bf16_shape(int nb, int bm, int bk, int mq,
                                           int mk, int d, const void* q,
                                           const void* kmat, void* out,
                                           void* scratch) {
  if (nb <= 0 || bm <= 0 || bk <= 0 || mq < 0 || mk < 0 || d < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *static_cast<long long*>(scratch) = sd_scratch_bytes(q, kmat, mq, mk, d);
  const long long tiles = x3_tiles(nb, bm, bk);
  int cluster = 0;
  long long ctas = 0;
  sd_grid(tiles, cluster, ctas);
  const int code = report_shape(tiles, out, BF_TK, SD_STAGES, PT_NT, PT_SHARE);
  static_cast<int*>(out)[6] = static_cast<int>(ctas);
  return code;
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
  const int split = split_pair(q, mq, d, kmat, mk, d, scratch, stream);
  if (split != 0) return split;
  const long long rq = plane_rows(mq);
  const long long rk = plane_rows(mk);
  const long long dp = plane_cols(d);
  const unsigned short* planes = static_cast<const unsigned short*>(scratch);
  const unsigned short* k_planes = planes + 2 * rq * dp;
  X3Maps maps;
  if (!bf16_tensor_map(&maps.m[0], planes, dp, rq, ROWS) ||
      !bf16_tensor_map(&maps.m[1], planes + rq * dp, dp, rq, ROWS) ||
      !bf16_tensor_map(&maps.m[2], k_planes, dp, rk, PT_NT) ||
      !bf16_tensor_map(&maps.m[3], k_planes + rk * dp, dp, rk, PT_NT)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  return launch_cta_tiles(
      bsr_sddmm_bf16x3_kernel, x3_tiles(nb, bm, bk), cluster, X3_SMEM,
      PT_THREADS, PT_SHARE, stream, maps,
      static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<const float*>(mask), static_cast<float*>(out), bm, bk, mq,
      mk, d, (bm + ROWS - 1) / ROWS, (bk + PT_NT - 1) / PT_NT,
      bk % 4 == 0 && aligned16(mask) && aligned16(out));
}

// The bf16 form's copy pass alone: q (mq x d) and k (mk x d) in bf16 into
// the padded planes at scratch (for timing; the form runs it itself where
// TMA cannot read Q and K as they lie).
extern "C" int spgrid_bsr_sddmm_bf16_copy(const void* q, const void* kmat,
                                          void* scratch, int mq, int mk,
                                          int d, void* stream) {
  if (mq < 0 || mk < 0 || d < 0 || !aligned16(scratch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return copy_planes(q, kmat, scratch, mq, mk, d, stream);
}

// The bf16 form: mask, q, k and out as bf16 bit patterns; scratch (on 16
// B) the bytes spgrid_bsr_sddmm_bf16_shape reports (null where they are
// 0). cluster: 0 for the launch rule (cluster_for at PT_SHARE: where it
// gives 1, one CTA an SM walks tiles), else 1, 2, 4 or 8.
extern "C" int spgrid_bsr_sddmm_bf16(const void* rows, const void* cols,
                                     const void* mask, const void* q,
                                     const void* kmat, void* out,
                                     void* scratch, int nb, int bm, int bk,
                                     int mq, int mk, int d, int cluster,
                                     void* stream) {
  if (nb <= 0 || bm <= 0 || bk <= 0 || mq < 0 || mk < 0 || d < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* qs = q;
  const void* ks = kmat;
  long long inner = d, rq = mq, rk = mk;
  if (!sd_direct(q, kmat, mq, mk, d)) {
    if (scratch == nullptr || !aligned16(scratch)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    rq = plane_rows(mq);
    rk = plane_rows(mk);
    inner = plane_cols(d);
    const int err = copy_planes(q, kmat, scratch, mq, mk, d, stream);
    if (err != 0) return err;
    qs = scratch;
    ks = static_cast<const unsigned short*>(scratch) + rq * inner;
  }
  CUtensorMap q_map, k_map, m_map = {}, o_map = {};
  if (!bf16_tensor_map(&q_map, qs, inner, rq, ROWS) ||
      !bf16_tensor_map(&k_map, ks, inner, rk, PT_NT)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  const bool tile_tma = bf16_block_map(&m_map, mask, nb, bm, bk) &&
                        bf16_block_map(&o_map, out, nb, bm, bk);
  const long long tiles = x3_tiles(nb, bm, bk);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (cluster != 0 && cluster != 1 && cluster != 2 && cluster != 4 &&
      cluster != 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long ctas = 0;
  sd_grid(tiles, cluster, ctas);
  return launch_cta_tiles(
      bsr_sddmm_bf16_kernel, cluster == 1 ? ctas : tiles, cluster, SD_SMEM,
      PT_THREADS, PT_SHARE, stream, q_map, k_map, m_map, o_map,
      static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<const unsigned short*>(mask),
      static_cast<unsigned short*>(out), bm, bk, mq, mk, d,
      (bm + ROWS - 1) / ROWS, (bk + PT_NT - 1) / PT_NT,
      static_cast<int>(tiles), tile_tma);
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
