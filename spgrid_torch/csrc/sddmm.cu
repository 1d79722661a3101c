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
#include "block_mma.cuh"

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
