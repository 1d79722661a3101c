// The bf16 tensor-core tiles that the bf16 forms of the block kernels
// share: panel_spmm.cu (cv_panel's form, f32 X and Y, and the bf16 panels'
// form, bf16 X and Y), bsr_spmm.cu (the bf16 BSR form) and sddmm.cu (the
// bf16 SDDMM, 3b, and the 3-pass one, 3c, which run the pipelined tile's
// ring, barriers, TMA loads and wgmma with both operands K-major).
//
// The step (`mma_step`, which 4b's bsr_spmm_cstat.cu runs, and
// `bf16_row_tile` below): BF_TK = 64 of the
// contraction, one 128-byte line of bf16: four wgmma m64n64k16 with bf16
// operands, A (64 x 16) in registers and B (16 x 64) in shared memory,
// K-major with the 128-byte swizzle (a row a 128-byte line, its 16-byte
// chunks permuted by the row), into fresh f32 accumulators that are then
// added to the running f32 sums (the tensor cores truncate their
// accumulate). A bf16 x bf16 product is exact in f32.
//
// Two row-tiled SpMMs run on it. Both: a tile is a row of blocks' (a BSR
// block row's, a panel band's) 128-row slice by a slab of X's columns, its
// steps (the walk's blocks times BF_TK of each block's bk columns) split
// across a cluster, the ranks' partial tiles summed in f32 in rank order
// through distributed shared memory (`sum_store`), and each element of Y
// rounded once and written once, with no atomics.
//
// `bf16_row_tile`, the cp.async tile (2a's, and 1b's and 2b's where TMA
// cannot take the operands: n or bk not a multiple of 8, an operand off
// 16 bytes): 64 columns of X, the product transposed, Y^T tile = X^T A^T,
// so that the bf16 block, K-major as it lies, is the shared-memory operand
// and X^T's fragments are built in registers from a staged N-major slice
// (`xt_frags`); all 256 threads copy (a cp.async ring of BF_STAGES) and
// multiply, a __syncthreads a step.
//
// `bf16_pipe_tile`, the pipelined tile (1b and 2b on TMA-ready operands),
// redesigned for Hopper:
// - 128 columns of X (PT_NT): each staged block slice feeds a 64 x 128
//   product per warpgroup (wgmma m64n128k16), twice the columns of the
//   cp.async tile, so each block is streamed from L2 half as often.
// - Both operands from shared memory, by TMA with the 128-byte swizzle:
//   the block's (128 x 64) slice K-major as it lies (wgmma's A), X's
//   (64 x 128) slice as two (64 x 64) boxes, N-major as X lies (wgmma's B,
//   read through its transpose bit: MN-major, 64-column atoms PT_XBOX_BYTES
//   apart, 8-row groups 1,024 bytes apart). No fragment is built in
//   registers. TMA fills X rows >= k and block columns >= bk with zeros.
// - A producer warpgroup keeps a ring of PT_STAGES (6) stages of 32 KB in
//   flight: one thread waits on the stage's `empty` mbarrier, arms its
//   `full` mbarrier with the stage's bytes and issues the three TMA loads;
//   the two consumer warpgroups wait on `full` and, once a step's products
//   are done, arrive on `empty` (all 256 threads).
// - Overlapped steps: a step's four wgmma go into a fresh f32 accumulator,
//   double-buffered (d0, d1); the consumers commit step s, then
//   wgmma_wait<1> retires step s - 1, whose accumulator is added to the
//   running sums while step s runs on the tensor cores.
// - Budget: 384 threads (the producer warpgroup and two consumer
//   warpgroups), one CTA an SM (__launch_bounds__(384, 1): 168 registers a
//   thread at launch). setmaxnreg moves them: the producer drops to
//   PT_PRODUCER_REGS (40), the consumers rise to PT_CONSUMER_REGS (232),
//   40 x 128 + 232 x 256 = 64,512 of the SM's 65,536, for 64 running sums
//   and two fresh accumulators of 64 (192 f32) and addresses (at 168, with
//   a producer warp and no setmaxnreg, the consumers spilled and the tile
//   ran slower than the cp.async tile). Shared memory: the ring, 6 x 32
//   KB, + 1 KB of alignment + 12 mbarriers = 197,728 bytes; the f32
//   partial tile (128 x 136 floats, 69,632 bytes) reuses the ring after the
//   last step.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>

#include "bf16_bits.cuh"
#include "block_mma.cuh"

namespace {

using spgrid::bf16::round_bf16;
using spgrid::bf16::widen;

constexpr int BF_TK = 64;         // contraction depth a step, in bf16
constexpr int BF_STAGES = 3;      // steps in the ring: two CTAs an SM
constexpr int XS_LD = NT + 4;     // row stride of an f32 X slice: fragment
                                  // loads hit 32 banks
constexpr int XH_LD = NT + 8;     // row stride of a bf16 X slice: 144-byte
                                  // rows, each on 16 B
constexpr int PANEL_BYTES = ROWS * BF_TK * 2;
constexpr int SWIZZLE_BYTES = 1024;  // the 128-byte swizzle's atom: 8 rows
static_assert(BF_TK * 2 == 128, "a step's block row is one swizzled line");

// The stage of the row-tiled product: the block's (128 x 64) bf16 slice,
// swizzled, then X's (64 x 64) slice, N-major, in bf16 (XH) or f32.
template <bool XH>
struct RowStage {
  static constexpr int X_BYTES = XH ? BF_TK * XH_LD * 2 : BF_TK * XS_LD * 4;
  static constexpr int BYTES = PANEL_BYTES + X_BYTES;
  // the ring, and a swizzle atom's worth of room to align it
  static constexpr size_t SMEM = BF_STAGES * BYTES + SWIZZLE_BYTES;
  static_assert(BYTES % SWIZZLE_BYTES == 0,
                "every stage's block slice starts on a swizzle atom");
  static_assert(ROWS * RED_LD * sizeof(float) <= BF_STAGES * BYTES,
                "the partial tile fits in the ring");
};

// The dynamic shared memory, aligned up to a swizzle atom.
__device__ __forceinline__ unsigned char* aligned_ring() {
  extern __shared__ float4 smem4[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem4);
  return ring + (SWIZZLE_BYTES - smem_u32(ring) % SWIZZLE_BYTES) %
                    SWIZZLE_BYTES;
}

// Two bf16 bit patterns in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(unsigned short lo,
                                              unsigned short hi) {
  return static_cast<uint32_t>(lo) | static_cast<uint32_t>(hi) << 16;
}

// lo, hi rounded to bf16 (to nearest, ties to even), lo in the low half.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte of row i, columns 8 c8 .. 8 c8 + 7, of a staged block slice: rows
// of 128 bytes whose 16-byte chunks are permuted by the row (chunk c8 at
// c8 ^ (i % 8)), wgmma's K-major layout with the 128-byte swizzle.
__device__ __forceinline__ int swizzled(int i, int c8) {
  return i * 128 + ((c8 ^ (i % 8)) * 16);
}

// dst (on a swizzle atom) = src's (rows x depth) bf16 slice (row stride
// ld), zeros elsewhere, for fill rows, swizzled. Eight neighbouring threads
// copy one 128-byte line of a row: 16-byte cp.async where `vec` (depth % 8
// == 0, src rows on 16 B), else 2-byte loads.
__device__ __forceinline__ void stage_panel(
    unsigned char* dst, const unsigned short* __restrict__ src, int ld,
    int rows, int depth, int fill, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < fill * (BF_TK / 8); e += THREADS) {
      const int i = e / (BF_TK / 8);
      const int c8 = e % (BF_TK / 8);
      unsigned char* d = dst + swizzled(i, c8);
      if (i < rows && 8 * c8 < depth) {
        cp_async16(d, src + static_cast<size_t>(i) * ld + 8 * c8);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    for (int e = threadIdx.x; e < fill * BF_TK; e += THREADS) {
      const int i = e / BF_TK;
      const int c = e % BF_TK;
      unsigned short* d =
          reinterpret_cast<unsigned short*>(dst + swizzled(i, c / 8)) + c % 8;
      *d = i < rows && c < depth ? src[static_cast<size_t>(i) * ld + c]
                                 : static_cast<unsigned short>(0);
    }
  }
}

// dst[kk][j] (row stride XH_LD) = src[kk * ld + j] (bf16) for kk < depth
// and j < ncols, 0 elsewhere, for kk < BF_TK: 16-byte cp.async where `vec`
// (ncols % 8 == 0, src rows on 16 B), else 2-byte loads.
__device__ __forceinline__ void stage_nmajor_bf16(
    unsigned short* dst, const unsigned short* __restrict__ src, size_t ld,
    int depth, int ncols, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < BF_TK * (NT / 8); e += THREADS) {
      const int kk = e / (NT / 8);
      const int j = e % (NT / 8) * 8;
      unsigned short* d = dst + kk * XH_LD + j;
      if (kk < depth && j < ncols) {
        cp_async16(d, src + kk * ld + j);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    for (int e = threadIdx.x; e < BF_TK * NT; e += THREADS) {
      const int kk = e / NT;
      const int j = e % NT;
      dst[kk * XH_LD + j] = kk < depth && j < ncols
                                ? src[kk * ld + j]
                                : static_cast<unsigned short>(0);
    }
  }
}

// Shared-memory descriptor of a K-major operand with the 128-byte swizzle
// starting at p: 8-row groups SWIZZLE_BYTES apart (the leading offset is
// unused); p + 32 bytes is the next 16 of K within the atom.
__device__ __forceinline__ uint64_t descriptor_sw128(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(SWIZZLE_BYTES >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// d (64 x 64, f32) = a (64 x 16, bf16 fragments in registers) * b (16 x 64,
// bf16 K-major in shared memory) + (accumulate ? d : 0); warpgroup-
// collective and asynchronous until wgmma_wait.
__device__ __forceinline__ void wgmma_bf16(float (&d)[32],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}

// A step's A fragments: a[s] those of depths 16 s .. 16 s + 15, each
// register two neighbouring depths of one row (rows + g and + g + 8,
// depths 2 q, 2 q + 1 and + 8, as mma.sync m16n8k16's A).
using StepFrags = uint32_t[BF_TK / 16][4];

// The fragments of X^T from the step's f32 X slice xs (N-major, stride
// XS_LD), rounded to bf16 as they are loaded: row 16 w + g of the
// warpgroup's A is X's column 16 w + g.
__device__ __forceinline__ void xt_frags(StepFrags& a,
                                         const float* __restrict__ xs,
                                         const Frag& f) {
  const float* p = xs + 2 * f.q * XS_LD + 16 * f.w + f.g;
#pragma unroll
  for (int s = 0; s < BF_TK / 16; ++s) {
    const float* ps16 = p + 16 * s * XS_LD;
    a[s][0] = bf16x2(ps16[0], ps16[XS_LD]);
    a[s][1] = bf16x2(ps16[8], ps16[XS_LD + 8]);
    a[s][2] = bf16x2(ps16[8 * XS_LD], ps16[9 * XS_LD]);
    a[s][3] = bf16x2(ps16[8 * XS_LD + 8], ps16[9 * XS_LD + 8]);
  }
}

// The same from a bf16 X slice xh (N-major, stride XH_LD), as it is.
__device__ __forceinline__ void xt_frags(StepFrags& a,
                                         const unsigned short* __restrict__ xh,
                                         const Frag& f) {
  const unsigned short* p = xh + 2 * f.q * XH_LD + 16 * f.w + f.g;
#pragma unroll
  for (int s = 0; s < BF_TK / 16; ++s) {
    const unsigned short* ps16 = p + 16 * s * XH_LD;
    a[s][0] = pack_bf16(ps16[0], ps16[XH_LD]);
    a[s][1] = pack_bf16(ps16[8], ps16[XH_LD + 8]);
    a[s][2] = pack_bf16(ps16[8 * XH_LD], ps16[9 * XH_LD]);
    a[s][3] = pack_bf16(ps16[8 * XH_LD + 8], ps16[9 * XH_LD + 8]);
  }
}

// acc += A B over the step: A's fragments a, B the K-major swizzled slice
// whose descriptor is b (16 of K each 32 bytes on). Fresh accumulators a
// step, added to the running f32 sums.
__device__ __forceinline__ void mma_step(float (&acc)[NT / 2], StepFrags& a,
                                         uint64_t b) {
  float d[NT / 2];
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < BF_TK / 16; ++s) {
    wgmma_bf16(d, a[s], b + 32 / 16 * s, s > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int s = 0; s < BF_TK / 16; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_operand(a[s][e]);
#pragma unroll
  for (int e = 0; e < NT / 2; ++e) {
    fence_operand(d[e]);
    acc[e] += d[e];
  }
}

// Four sums v, rounded to bf16 once each, at p (c < count of them): one
// 8-byte store where `vec` (count == 4, p on 8 B), else 2-byte ones.
__device__ __forceinline__ void store_bf16x4(unsigned short* p,
                                             const float4& v, int count,
                                             bool vec) {
  const unsigned short h[4] = {round_bf16(v.x), round_bf16(v.y),
                               round_bf16(v.z), round_bf16(v.w)};
  if (vec) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16(h[0], h[1]), pack_bf16(h[2], h[3]));
    return;
  }
  for (int c = 0; c < 4 && c < count; ++c) p[c] = h[c];
}

// This CTA's share of row tile t of Y = A @ X in bf16 on the tensor cores:
// A's row t.r made of count (band_rows, bk) bf16 blocks, the walk's i-th
// block `slots[first + i]` (or first + i where slots is null), at block
// column cols[b]:
//   Y[t.r band_rows + t.i0 + i, t.n0 + j] =
//       sum_b blocks[b][t.i0 + i, :] . X[cols[b] bk + :, t.n0 + j],
// X and Y in bf16 (XH) or f32. The tile's steps are split across the
// cluster, rank r taking [S r / C, S (r + 1) / C); the sums are f32, and
// each element of the tile inside the band's rows and inside Y (row < m,
// column < n) is written once, rounded once (bf16 Y), zeros included (a
// tile whose walk is empty writes zeros); X rows >= k read as zero. Blocks
// come in by 16-byte cp.async where `a16` (bk % 8 == 0, blocks on 16 B),
// else 2-byte loads; X by 16-byte cp.async where `x16` (n % 4 == 0 (f32)
// or n % 8 == 0 (bf16), X on 16 B), else smaller copies; `y16` stores 4
// columns at once (n % 4 == 0, Y on 16 B (f32) or 8 B (bf16)).
template <bool XH>
__device__ __forceinline__ void bf16_row_tile(
    const RowTile& t, int first, int count, const int* __restrict__ slots,
    const int* __restrict__ cols, const unsigned short* __restrict__ blocks,
    const void* x_, void* y_, int band_rows, int bk, int m, int k, int n,
    bool a16, bool x16, bool y16) {
  using Stage = RowStage<XH>;
  unsigned char* ring = aligned_ring();
  const Frag f = frag();
  const int ranks = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int rows = min(ROWS, band_rows - t.i0);
  const int ncols = min(NT, n - t.n0);
  const int nq = (bk + BF_TK - 1) / BF_TK;  // steps a block
  const long long total = static_cast<long long>(count) * nq;
  const long long s0 = total * rank / ranks;
  const int steps = static_cast<int>(total * (rank + 1) / ranks - s0);

  auto issue = [&](int it, unsigned char* stage) {
    const long long s = s0 + it;
    const int i = first + static_cast<int>(s / nq);
    const int b = slots != nullptr ? slots[i] : i;
    const int k0 = static_cast<int>(s % nq) * BF_TK;
    const int depth = min(BF_TK, bk - k0);
    const long long xr0 = static_cast<long long>(cols[b]) * bk + k0;
    const long long x_left = static_cast<long long>(k) - xr0;
    const int x_depth = x_left < depth ? static_cast<int>(max(x_left, 0LL))
                                       : depth;
    stage_panel(stage,
                blocks + (static_cast<size_t>(b) * band_rows + t.i0) * bk + k0,
                bk, rows, depth, rows > 64 ? ROWS : 64, a16);
    const size_t at = static_cast<size_t>(xr0) * n + t.n0;
    if constexpr (XH) {
      stage_nmajor_bf16(
          reinterpret_cast<unsigned short*>(stage + PANEL_BYTES),
          static_cast<const unsigned short*>(x_) + at, n, x_depth, ncols,
          x16);
    } else {
      stage_nmajor<BF_TK, XS_LD>(reinterpret_cast<float*>(stage + PANEL_BYTES),
                                 static_cast<const float*>(x_) + at, n,
                                 x_depth, ncols, x16);
    }
  };

  float acc[NT / 2] = {};
#pragma unroll
  for (int s = 0; s < BF_STAGES - 1; ++s) {
    if (s < steps) issue(s, ring + s * Stage::BYTES);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<BF_STAGES - 2>();
    fence_proxy_async();  // the copies land before the tensor cores read
    __syncthreads();      // step it has landed; step it - 1 is consumed
    const int next = it + BF_STAGES - 1;
    if (next < steps) issue(next, ring + next % BF_STAGES * Stage::BYTES);
    cp_async_commit();
    const unsigned char* stage = ring + it % BF_STAGES * Stage::BYTES;
    if (64 * f.wg < rows) {
      StepFrags a;
      if constexpr (XH) {
        xt_frags(a, reinterpret_cast<const unsigned short*>(stage + PANEL_BYTES),
                 f);
      } else {
        xt_frags(a, reinterpret_cast<const float*>(stage + PANEL_BYTES), f);
      }
      mma_step(acc, a, descriptor_sw128(stage + f.wg * 64 * 128));
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the partial tile

  // accumulator 4 j + 2 h + c: column 16 w + 8 h + g of the tile (wgmma's
  // row), row 64 wg + 8 j + 2 q + c (wgmma's column)
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        part[(64 * f.wg + 8 * j + 2 * f.q + c) * RED_LD + 16 * f.w + 8 * h +
             f.g] = acc[4 * j + 2 * h + c];
      }
  const long long row0 = static_cast<long long>(t.r) * band_rows + t.i0;
  const int out_rows = static_cast<int>(
      min(static_cast<long long>(rows), static_cast<long long>(m) - row0));
  sum_store(part, out_rows, ncols, [&](int i, int j, const float4& v) {
    const size_t at = static_cast<size_t>(row0 + i) * n + t.n0 + j;
    if constexpr (XH) {
      store_bf16x4(static_cast<unsigned short*>(y_) + at, v, ncols - j, y16);
    } else {
      float* p = static_cast<float*>(y_) + at;
      if (y16) {  // ncols % 4 == 0
        *reinterpret_cast<float4*>(p) = v;
        return;
      }
      const float w[4] = {v.x, v.y, v.z, v.w};
      for (int c = 0; c < 4 && j + c < ncols; ++c) p[c] = w[c];
    }
  });
}

bool aligned8(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 8 == 0;
}

// ---- The pipelined tile (see the top of this file).

constexpr int PT_NT = 128;                      // columns of X a tile
constexpr int PT_STAGES = 6;                    // steps in the ring
constexpr int PT_THREADS = THREADS + 128;       // + the producer warpgroup
constexpr int PT_PRODUCER_REGS = 40;            // setmaxnreg of each role
constexpr int PT_CONSUMER_REGS = 232;
static_assert(PT_PRODUCER_REGS * 128 + PT_CONSUMER_REGS * THREADS <= 65536,
              "the two roles' registers fit the SM's file");
constexpr int PT_A_BYTES = ROWS * BF_TK * 2;    // a block slice, 128 x 64
constexpr int PT_XBOX_BYTES = BF_TK * 64 * 2;   // X, 64 deep x 64 columns
constexpr int PT_STAGE_BYTES = PT_A_BYTES + 2 * PT_XBOX_BYTES;
constexpr int PT_RED_LD = PT_NT + 8;            // partial tile's row stride
constexpr int PT_SLICE_BYTES = PT_STAGES * PT_STAGE_BYTES;
// The launch rule's share of the SMs (cluster_for): a cluster splits a
// tile only while the grid fills at most half of them. A CTA an SM with a
// step or two a rank loses to its fixed costs (the barriers, the first
// TMA loads, the rank sum of a 128 x 128 tile): chip_smoke.py's 11a times
// the twin (16 tiles of 8 steps) at each cluster size.
constexpr int PT_SHARE = 2;
constexpr size_t PT_SMEM =
    PT_SLICE_BYTES + SWIZZLE_BYTES + 2 * PT_STAGES * sizeof(uint64_t);
static_assert(PT_STAGE_BYTES % SWIZZLE_BYTES == 0,
              "every box starts on a swizzle atom");
static_assert(ROWS * PT_RED_LD * sizeof(float) <= PT_SLICE_BYTES,
              "the partial tile fits in the ring");

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// dst = the box of `map` at (c0 inner, c1 outer), completing its bytes on
// bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// Shared-memory descriptor of an MN-major operand with the 128-byte
// swizzle starting at p: 64-element atoms along MN PT_XBOX_BYTES apart
// (the leading offset), 8-row groups along K SWIZZLE_BYTES apart;
// p + 16 rows (2,048 bytes) is the next 16 of K.
__device__ __forceinline__ uint64_t descriptor_mn128(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(PT_XBOX_BYTES >> 4) << 16 |
         static_cast<uint64_t>(SWIZZLE_BYTES >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// d (64 x 128, f32) = a (64 x 16, bf16 K-major, descriptor a) * b (16 x
// 128, bf16, descriptor b: MN-major, read through wgmma's transpose bit,
// where TRANS_B is 1; K-major where it is 0) + (accumulate ? d : 0);
// warpgroup-collective and asynchronous until wgmma_wait.
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[PT_NT / 2],
                                              uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B)
      : "memory");
}

// This CTA's share of row tile t (PT_NT columns) of Y = A @ X in bf16 on
// the tensor cores, the function of bf16_row_tile<true>: the walk's i-th
// block `slots[first + i]` (or first + i where slots is null) of `count`,
// at block column cols[b]; `a_map` the blocks as rows of bk (block b's row
// i at row b band_rows + i), `x_map` X (k rows of n), both in boxes of 64
// columns with the 128-byte swizzle. Each element of the tile inside the
// band's rows and inside Y is written once, rounded once, zeros included;
// `y16` stores 4 columns at once (n % 4 == 0, Y on 8 B).
__device__ __forceinline__ void bf16_pipe_tile(
    const RowTile& t, int first, int count, const int* __restrict__ slots,
    const int* __restrict__ cols, const CUtensorMap* a_map,
    const CUtensorMap* x_map, unsigned short* y, int band_rows, int bk,
    int m, int n, bool y16) {
  unsigned char* ring = aligned_ring();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + PT_SLICE_BYTES);
  uint64_t* empty = full + PT_STAGES;
  const int ranks = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int rows = min(ROWS, band_rows - t.i0);
  const int ncols = min(PT_NT, n - t.n0);
  const int nq = (bk + BF_TK - 1) / BF_TK;  // steps a block
  const long long total = static_cast<long long>(count) * nq;
  const long long s0 = total * rank / ranks;
  const int steps = static_cast<int>(total * (rank + 1) / ranks - s0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < PT_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  } else if (threadIdx.x == THREADS) {
    // the two descriptors' fetch, under the barriers' set-up
    asm volatile("prefetch.tensormap [%0];" ::"l"(a_map) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(x_map) : "memory");
  }
  __syncthreads();

  if (threadIdx.x >= THREADS) {
    // the producer warpgroup gives up registers; one thread keeps the ring
    // full, then the group takes part in sum_store's cluster barriers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PT_PRODUCER_REGS));
    if (threadIdx.x == THREADS) {
      for (int it = 0; it < steps; ++it) {
        const int s = it % PT_STAGES;
        if (it >= PT_STAGES) mbar_wait(empty + s, (it / PT_STAGES - 1) & 1);
        const long long q = s0 + it;
        const int i = first + static_cast<int>(q / nq);
        const int b = slots != nullptr ? __ldg(slots + i) : i;
        const int k0 = static_cast<int>(q % nq) * BF_TK;
        const int xr0 = __ldg(cols + b) * bk + k0;
        unsigned char* stage = ring + s * PT_STAGE_BYTES;
        mbar_arrive_expect_tx(full + s, PT_STAGE_BYTES);
        tma_load(stage, a_map, k0, b * band_rows + t.i0, full + s);
        tma_load(stage + PT_A_BYTES, x_map, t.n0, xr0, full + s);
        tma_load(stage + PT_A_BYTES + PT_XBOX_BYTES, x_map, t.n0 + 64, xr0,
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
  float acc[PT_NT / 2];
#pragma unroll
  for (int e = 0; e < PT_NT / 2; ++e) acc[e] = 0.0f;
  {
    const bool multiplies = 64 * f.wg < rows;
    float d0[PT_NT / 2], d1[PT_NT / 2];
    auto issue = [&](float (&d)[PT_NT / 2], int it) {
      const int s = it % PT_STAGES;
      mbar_wait(full + s, (it / PT_STAGES) & 1);
      if (!multiplies) return;
      const unsigned char* stage = ring + s * PT_STAGE_BYTES;
      const uint64_t da = descriptor_sw128(stage + f.wg * 64 * 128);
      const uint64_t db = descriptor_mn128(stage + PT_A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BF_TK / 16; ++ks) {
        wgmma_bf16_ss(d, da + 32 / 16 * ks, db + 2048 / 16 * ks, ks > 0);
      }
      wgmma_commit();
    };
    auto retire = [&](float (&d)[PT_NT / 2], int it) {
      if (multiplies) {
#pragma unroll
        for (int e = 0; e < PT_NT / 2; ++e) {
          fence_operand(d[e]);
          acc[e] += d[e];
        }
      }
      mbar_arrive(empty + it % PT_STAGES);
    };
    // steps in pairs, so that d0 and d1 stay apart in registers
    int it = 1;
    if (steps > 0) issue(d0, 0);
    for (; it + 1 < steps; it += 2) {
      issue(d1, it);
      wgmma_wait<1>();
      retire(d0, it - 1);
      issue(d0, it + 1);
      wgmma_wait<1>();
      retire(d1, it);
    }
    if (it < steps) {
      issue(d1, it);
      wgmma_wait<1>();
      retire(d0, it - 1);
      wgmma_wait<0>();
      retire(d1, it);
    } else if (steps > 0) {
      wgmma_wait<0>();
      retire(d0, it - 1);
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
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  const long long row0 = static_cast<long long>(t.r) * band_rows + t.i0;
  const int out_rows = static_cast<int>(
      min(static_cast<long long>(rows), static_cast<long long>(m) - row0));
  sum_store<PT_NT, PT_RED_LD, THREADS>(
      part, out_rows, ncols, [&](int i, int j, const float4& v) {
        store_bf16x4(y + static_cast<size_t>(row0 + i) * n + t.n0 + j, v,
                     ncols - j, y16);
      });
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (the library does not link libcuda); null where it is missing.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// map = a bf16 matrix at base, `outer` rows of `inner` elements (row
// stride inner), in boxes of (box_outer x 64) with the 128-byte swizzle,
// zeros outside it; false where TMA cannot take it.
bool bf16_tensor_map(CUtensorMap* map, const void* base,
                     unsigned long long inner, unsigned long long outer,
                     unsigned box_outer) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr || inner % 8 != 0 || !aligned16(base) ||
      inner >= (1ULL << 32) || outer >= (1ULL << 31)) {
    return false;
  }
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 2};
  const cuuint32_t box[2] = {64, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor maps of the pipelined tile: the blocks (`rows` rows of bk)
// and X (k x n); false where TMA cannot take them (then the cp.async tile
// runs).
bool pipe_maps(CUtensorMap* a_map, CUtensorMap* x_map, const void* blocks,
               long long rows, int bk, const void* x, int k, int n) {
  return bf16_tensor_map(a_map, blocks, bk, rows, ROWS) &&
         bf16_tensor_map(x_map, x, n, k, BF_TK);
}

// Tiles of PT_NT columns of a launch of `slices` row slices.
long long pipe_tiles(long long slices, int n) {
  return slices * ((n + PT_NT - 1) / PT_NT);
}

}  // namespace
