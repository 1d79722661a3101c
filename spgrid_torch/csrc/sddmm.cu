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
// f32 mask, Q, K and out; Q and K stay f32 in device memory and are split
// as they are staged, v = v_hi + v_lo with v_hi = bf16(v) and v_lo =
// bf16(v - v_hi) (v - v_hi is exact in f32), both rounded to nearest, ties
// to even. A step (BF_TK = 64 of d) runs three products on the bf16 step of
// bf16_mma.cuh, each into its own fresh f32 accumulator: Q_hi K_hi into the
// hi sum, then Q_hi K_lo and Q_lo K_hi into the cross sum (the dropped
// Q_lo K_lo term is ~2^-16 of a product). The cross sum is added to the hi
// sum once, after the last step (cross first, then hi, as
// bsr_sddmm_bf16x3_plain adds its passes), before the ranks' partial tiles
// are summed; the mask multiplies the sum once, in f32. The same tiles and
// cluster split as the other forms. Staging converts, so it is plain loads
// and stores into one buffer (Q_hi, Q_lo row-major as the bf16 form's Q;
// K_hi, K_lo swizzled), not a cp.async ring: two or more CTAs an SM hide
// one CTA's staging behind another's products. Bound on the H100: the
// bytes of the f32 mask's blocks in and out and of Q and K once, or three
// times the blocks' dense work at 989 TFLOP/s, whichever is larger.
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

// The 3-pass form's buffer: Q_hi, Q_lo (each ROWS rows of QS_LD bf16), then
// K_hi, K_lo (each NT rows of BF_TK bf16, swizzled).
constexpr int X3_K_BYTES = NT * BF_TK * 2;
constexpr size_t X3_SMEM_BYTES =
    2 * Q_BYTES + 2 * X3_K_BYTES + SWIZZLE_BYTES;
static_assert(2 * Q_BYTES % SWIZZLE_BYTES == 0 &&
                  X3_K_BYTES % SWIZZLE_BYTES == 0,
              "K_hi and K_lo start on swizzle atoms");
static_assert(ROWS * RED_LD * sizeof(float) <= 2 * Q_BYTES + 2 * X3_K_BYTES,
              "the partial tile fits in the buffer");

// The bf16 parts of v: hi = v rounded, lo = (v - hi) rounded.
__device__ __forceinline__ void split_bf16(float v, unsigned short& hi,
                                           unsigned short& lo) {
  hi = round_bf16(v);
  lo = round_bf16(v - widen(hi));
}

// Four f32 values' parts at hi and lo (8 bytes each, on 8 B).
__device__ __forceinline__ void store_parts4(unsigned short* hi,
                                             unsigned short* lo,
                                             const float4& v) {
  unsigned short h[4], l[4];
  split_bf16(v.x, h[0], l[0]);
  split_bf16(v.y, h[1], l[1]);
  split_bf16(v.z, h[2], l[2]);
  split_bf16(v.w, h[3], l[3]);
  *reinterpret_cast<uint2*>(hi) =
      make_uint2(pack_bf16(h[0], h[1]), pack_bf16(h[2], h[3]));
  *reinterpret_cast<uint2*>(lo) =
      make_uint2(pack_bf16(l[0], l[1]), pack_bf16(l[2], l[3]));
}

// The (rows x depth) f32 slice at src (row stride ld), split, zeros
// elsewhere, for `fill` rows: element (i, c) of the slice goes to byte
// at(i, c) of each part (hi at dst, lo `part` bytes on). float4 loads where
// `vec` (depth % 4 == 0, src rows on 16 B), else 4-byte ones. `at` keeps
// four neighbouring columns c .. c + 3 (c % 4 == 0) on 8 contiguous bytes.
template <class At>
__device__ __forceinline__ void stage_split(unsigned char* dst, int part,
                                            const float* __restrict__ src,
                                            size_t ld, int rows, int depth,
                                            int fill, bool vec, At at) {
  for (int e = threadIdx.x; e < fill * (BF_TK / 4); e += THREADS) {
    const int i = e / (BF_TK / 4);
    const int c = e % (BF_TK / 4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < rows && c < depth) {
      const float* p = src + i * ld + c;
      if (vec) {
        v = __ldg(reinterpret_cast<const float4*>(p));
      } else {
        v.x = __ldg(p);
        v.y = c + 1 < depth ? __ldg(p + 1) : 0.f;
        v.z = c + 2 < depth ? __ldg(p + 2) : 0.f;
        v.w = c + 3 < depth ? __ldg(p + 3) : 0.f;
      }
    }
    unsigned char* d = dst + at(i, c);
    store_parts4(reinterpret_cast<unsigned short*>(d),
                 reinterpret_cast<unsigned short*>(d + part), v);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
bsr_sddmm_bf16x3_kernel(const int* __restrict__ block_rows,
                        const int* __restrict__ block_cols,
                        const float* __restrict__ mask,
                        const float* __restrict__ q,
                        const float* __restrict__ kmat,
                        float* __restrict__ out, int bm, int bk, int mq,
                        int mk, int d, int slices, int col_tiles, bool q16,
                        bool k16, bool o16) {
  unsigned char* buf = aligned_ring();
  unsigned char* ks = buf + 2 * Q_BYTES;
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

  float hi[NT / 2] = {};
  float cross[NT / 2] = {};
  for (int it = 0; it < steps; ++it) {
    if (it > 0) __syncthreads();  // step it - 1's operands are consumed
    const int d0 = (s0 + it) * BF_TK;
    const int depth = min(BF_TK, d - d0);
    stage_split(buf, Q_BYTES, q + static_cast<size_t>(q0) * d + d0, d, qrows,
                depth, rows > 64 ? ROWS : 64, q16,
                [](int i, int c) { return (i * QS_LD + c) * 2; });
    stage_split(ks, X3_K_BYTES, kmat + static_cast<size_t>(k0) * d + d0, d,
                krows, depth, NT, k16,
                [](int i, int c) { return swizzled(i, c / 8) + c % 8 * 2; });
    fence_proxy_async();  // the stores land before the tensor cores read
    __syncthreads();
    if (64 * f.wg < rows) {
      StepFrags a;
      q_frags(a, reinterpret_cast<const unsigned short*>(buf), f);
      mma_step(hi, a, descriptor_sw128(ks));
      mma_step(cross, a, descriptor_sw128(ks + X3_K_BYTES));
      q_frags(a, reinterpret_cast<const unsigned short*>(buf + Q_BYTES), f);
      mma_step(cross, a, descriptor_sw128(ks));
    }
  }
#pragma unroll
  for (int e = 0; e < NT / 2; ++e) cross[e] += hi[e];
  __syncthreads();  // the buffer is free for the partial tile

  const size_t base =
      (static_cast<size_t>(b) * bm + i0) * bk + static_cast<size_t>(j0);
  reduce_store(cross, reinterpret_cast<float*>(buf), rows, ncols, f,
               [&](int i, int j, const float4& v) {
                 const size_t at = base + static_cast<size_t>(i) * bk + j;
                 if (o16) {  // ncols % 4 == 0
                   const float4 w = *reinterpret_cast<const float4*>(mask + at);
                   *reinterpret_cast<float4*>(out + at) = make_float4(
                       v.x * w.x, v.y * w.y, v.z * w.z, v.w * w.w);
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
// out (int[6]) = {tiles, cluster, ROWS, NT, BF_TK, BF_STAGES} of the
// launch spgrid_bsr_sddmm_bf16 makes for these sizes at cluster 0.
extern "C" int spgrid_bsr_sddmm_bf16_shape(int nb, int bm, int bk,
                                           void* out) {
  if (nb <= 0 || bm <= 0 || bk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return report_shape(sddmm_tiles(nb, bm, bk), out, BF_TK, BF_STAGES);
}

// out (int[6]) = {tiles, cluster, ROWS, NT, BF_TK, 1} of the launch
// spgrid_bsr_sddmm_bf16x3 makes for these sizes at cluster 0.
extern "C" int spgrid_bsr_sddmm_bf16x3_shape(int nb, int bm, int bk,
                                             void* out) {
  if (nb <= 0 || bm <= 0 || bk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return report_shape(sddmm_tiles(nb, bm, bk), out, BF_TK, 1);
}

// The 3-pass bf16 form: mask, q, k and out in f32. cluster: 0 for the
// launch rule (cluster_for), else 1, 2, 4 or 8.
extern "C" int spgrid_bsr_sddmm_bf16x3(const void* rows, const void* cols,
                                       const void* mask, const void* q,
                                       const void* kmat, void* out, int nb,
                                       int bm, int bk, int mq, int mk, int d,
                                       int cluster, void* stream) {
  if (nb <= 0 || bm <= 0 || bk <= 0 || d < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_tiles(
      bsr_sddmm_bf16x3_kernel, sddmm_tiles(nb, bm, bk), cluster,
      X3_SMEM_BYTES, stream, static_cast<const int*>(rows),
      static_cast<const int*>(cols), static_cast<const float*>(mask),
      static_cast<const float*>(q), static_cast<const float*>(kmat),
      static_cast<float*>(out), bm, bk, mq, mk, d, (bm + ROWS - 1) / ROWS,
      (bk + NT - 1) / NT, d % 4 == 0 && aligned16(q),
      d % 4 == 0 && aligned16(kmat),
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
