// The 3-pass bf16 forms' shared code: the split of f32 operands into bf16
// hi and lo planes, and the pipelined 3-pass row tile of the SpMMs.
//
// Matmul precision 'high' on the TPU computes an f32 dot as three bf16
// passes: v = v_hi + v_lo with v_hi = bf16(v) and v_lo = bf16(v - v_hi)
// (v - v_hi is exact in f32), both rounded to nearest, ties to even, and
// a b = a_hi b_hi + a_hi b_lo + a_lo b_hi summed in f32 (the dropped a_lo
// b_lo term is ~2^-16 of a product). Four forms run it: the SDDMM's 3c
// (sddmm.cu), and the SpMMs' 1c (bsr_spmm.cu), 2c (panel_spmm.cu) and 4c
// (bsr_spmm_cstat.cu).
//
// The split (`split_pair`): a pass of its own writes one or two f32
// operands (rows of d, row stride d) as bf16 hi and lo planes into scratch
// that the wrapper allocates: plane_rows(m) rows of plane_cols(d) (d
// rounded up to whole 64-deep steps, zeros past d), so every row lies on 16
// bytes and every step is a whole TMA box or cp.async line. A thread
// splits 8 columns of a row: float4 loads where d % 4 == 0 and the operand
// lies on 16 bytes, else 4-byte ones; one 16-byte store a plane. The
// scratch holds A_hi, A_lo, then B_hi, B_lo.
//
// The SpMMs' tile (`x3_pipe_tile`, 1c's and 2c's): bf16_pipe_tile's
// launch and walk (a tile is a row of blocks' 128-row slice by PT_NT = 128
// columns of X, its steps the walk's blocks times 64 of each block's bk
// columns, split across a cluster where the tiles leave the card short),
// fed from the planes by TMA into a ring of X3_STAGES stages of 64 KB (the
// block's hi and lo (128 x 64) slices, K-major as they lie, and X's hi
// and lo (64 x 128) slices, each two (64 x 64) boxes, N-major as X lies,
// read through wgmma's transpose bit), one producer thread keeping the
// loads in flight, two consumer warpgroups at PT_CONSUMER_REGS (setmaxnreg).
// The ring (`x3_ring`), its producer loop (`x3_produce`) and the 3-pass
// step (`x3_consume`) are 3c's too: a step runs A_hi X_hi (four wgmma
// m64n128k16) into a fresh accumulator, added to the hi sum in f32 (the
// tensor cores truncate their accumulate), and A_hi X_lo and A_lo X_hi
// straight into the cross sum, whose terms are ~2^-8 of the hi terms, and
// so is its truncation, ~2^-8 of an ulp of the output a product. After
// the last step the cross sum is added to the hi sum, the cluster's
// partial tiles are summed in rank order through distributed shared
// memory, and each element of Y (f32) is written once, zeros included (a
// tile whose walk is empty, an empty block row's, writes zeros), no
// atomics.
// Budget: 384 threads, one CTA an SM: the ring (192 KB), the alignment and
// 6 mbarriers; registers as 3c's tile: the hi and cross sums and one fresh
// accumulator, 64 f32 each a thread.
#pragma once

#include "bf16_mma.cuh"

namespace {

constexpr int X3_STAGES = 3;                      // steps in the ring
constexpr int X3_BOX_BYTES = ROWS * BF_TK * 2;    // a 128 x 64 bf16 box
// a step's four boxes: 3c's Q_hi, Q_lo, K_hi, K_lo; the SpMMs' A_hi, A_lo,
// X_hi, X_lo (X's two 64 x 64 boxes each)
constexpr int X3_STAGE_BYTES = 4 * X3_BOX_BYTES;
constexpr int X3_RING_BYTES = X3_STAGES * X3_STAGE_BYTES;
constexpr size_t X3_SMEM =
    X3_RING_BYTES + SWIZZLE_BYTES + 2 * X3_STAGES * sizeof(uint64_t);
constexpr int SPLIT_THREADS = 256;
static_assert(PT_NT == ROWS, "a K box has as many rows as a Q box");
static_assert(2 * PT_XBOX_BYTES == X3_BOX_BYTES,
              "X's two 64-column boxes fill a box");
static_assert(X3_BOX_BYTES % SWIZZLE_BYTES == 0,
              "every box starts on a swizzle atom");
static_assert(ROWS * PT_RED_LD * sizeof(float) <= X3_RING_BYTES,
              "the partial tile fits in the ring");
static_assert(X3_SMEM <= 232448, "one CTA an SM");

// A split plane: plane_rows(m) rows of plane_cols(d) bf16.
int plane_rows(int m) { return m > 1 ? m : 1; }

long long plane_cols(int d) {
  return d > BF_TK ? (d + BF_TK - 1LL) / BF_TK * BF_TK : BF_TK;
}

// The bytes of an operand's hi and lo planes.
long long plane_pair_bytes(long long rows, int d) {
  return 2LL * 2 * rows * plane_cols(d);
}

// The bf16 parts of v: hi = v rounded, lo = (v - hi) rounded.
__device__ __forceinline__ void split_bf16(float v, unsigned short& hi,
                                           unsigned short& lo) {
  hi = round_bf16(v);
  lo = round_bf16(v - widen(hi));
}

// Columns c .. c + 7 of row p (of d; zeros past d, and for a null p) split
// into hi[at ..] and lo[at ..], one 16-byte store each. float4 loads where
// `vec` (d % 4 == 0, the row on 16 B), else 4-byte ones.
__device__ __forceinline__ void split_chunk(const float* p, int d, int c,
                                            bool vec, unsigned short* hi,
                                            unsigned short* lo) {
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (p != nullptr) {
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
  *reinterpret_cast<uint4*>(hi) =
      make_uint4(pack_bf16(h[0], h[1]), pack_bf16(h[2], h[3]),
                 pack_bf16(h[4], h[5]), pack_bf16(h[6], h[7]));
  *reinterpret_cast<uint4*>(lo) =
      make_uint4(pack_bf16(l[0], l[1]), pack_bf16(l[2], l[3]),
                 pack_bf16(l[4], l[5]), pack_bf16(l[6], l[7]));
}

// The split pass: a thread the 8 columns c .. c + 7 of one plane row, A's
// rows first, then B's. Row r < m of an operand: hi and lo of each value,
// zeros past d; rows >= m zeros.
__global__ void __launch_bounds__(SPLIT_THREADS)
split_planes_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    unsigned short* __restrict__ planes, int ma, int mb,
                    int da, int db, int ra, int rb, int dpa, int dpb,
                    bool a16, bool b16) {
  const long long ca = dpa / 8;
  const long long e =
      static_cast<long long>(blockIdx.x) * SPLIT_THREADS + threadIdx.x;
  const long long in_a = ra * ca;
  if (e >= in_a + static_cast<long long>(rb) * (dpb / 8)) return;
  if (e < in_a) {
    const long long r = e / ca;
    const int c = static_cast<int>(e % ca) * 8;
    const size_t at = static_cast<size_t>(r) * dpa + c;
    split_chunk(r < ma ? a + static_cast<size_t>(r) * da : nullptr, da, c,
                a16, planes + at,
                planes + static_cast<size_t>(ra) * dpa + at);
    return;
  }
  const long long r = (e - in_a) / (dpb / 8);
  const int c = static_cast<int>((e - in_a) % (dpb / 8)) * 8;
  unsigned short* hi = planes + 2 * static_cast<size_t>(ra) * dpa;
  const size_t at = static_cast<size_t>(r) * dpb + c;
  split_chunk(r < mb ? b + static_cast<size_t>(r) * db : nullptr, db, c, b16,
              hi + at, hi + static_cast<size_t>(rb) * dpb + at);
}

// The split of A (ma rows of da) and B (mb of db; no B where mb < 0) into
// `scratch`: A_hi, A_lo (plane_rows(ma) x plane_cols(da) each), then B_hi,
// B_lo; plane_pair_bytes(plane_rows(ma), da) + (B's) bytes.
int split_pair(const void* a, int ma, int da, const void* b, int mb, int db,
               void* scratch, void* stream) {
  const long long ra = plane_rows(ma);
  const long long rb = mb >= 0 ? plane_rows(mb) : 0;
  const long long dpa = plane_cols(da);
  const long long dpb = plane_cols(db);
  const long long threads = ra * (dpa / 8) + rb * (dpb / 8);
  const long long grid = (threads + SPLIT_THREADS - 1) / SPLIT_THREADS;
  if (ma < 0 || da < 0 || db < 0 || !aligned16(scratch) || dpa > INT_MAX ||
      dpb > INT_MAX || grid > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  split_planes_kernel<<<static_cast<unsigned>(grid), SPLIT_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<unsigned short*>(scratch), ma, mb, da, db,
      static_cast<int>(ra), static_cast<int>(rb), static_cast<int>(dpa),
      static_cast<int>(dpb), da % 4 == 0 && aligned16(a),
      db % 4 == 0 && aligned16(b));
  return static_cast<int>(cudaGetLastError());
}

// The SpMMs' 3-pass tile's tensor maps: the blocks' hi and lo planes,
// then X's. A kernel takes them as one __grid_constant__ parameter.
struct X3Maps {
  CUtensorMap m[4];
};

// The maps from the planes at `planes`: the blocks' hi and lo planes
// (`rows` rows of plane_cols(bk)) in boxes of ROWS rows, then X's
// (plane_rows(k) rows of plane_cols(n), at x_planes) in boxes of 64 rows;
// false where TMA cannot take them.
bool x3_maps(X3Maps& maps, const void* planes, long long rows, int bk,
             const void* x_planes, int k, int n) {
  const unsigned short* a = static_cast<const unsigned short*>(planes);
  const unsigned short* x = static_cast<const unsigned short*>(x_planes);
  const long long dpa = plane_cols(bk);
  const long long rx = plane_rows(k);
  const long long dpx = plane_cols(n);
  return bf16_tensor_map(&maps.m[0], a, dpa, rows, ROWS) &&
         bf16_tensor_map(&maps.m[1], a + rows * dpa, dpa, rows, ROWS) &&
         bf16_tensor_map(&maps.m[2], x, dpx, rx, BF_TK) &&
         bf16_tensor_map(&maps.m[3], x + rx * dpx, dpx, rx, BF_TK);
}

// The 3-pass tile's ring, shared by 3c's tile (sddmm.cu) and the SpMMs'
// (x3_pipe_tile): X3_STAGES stages of four 128 x 64 bf16 boxes (A_hi, A_lo,
// B_hi, B_lo), a `full` barrier each (the producer's arrival and the
// stage's bytes) and an `empty` one (every consumer thread).
struct X3Ring {
  unsigned char* stages;
  uint64_t* full;
  uint64_t* empty;
};

// The ring in this CTA's shared memory, its barriers set up and the four
// maps' descriptors fetched (under the set-up), before the roles split.
__device__ __forceinline__ X3Ring x3_ring(const CUtensorMap* maps) {
  X3Ring r;
  r.stages = aligned_ring();
  r.full = reinterpret_cast<uint64_t*>(r.stages + X3_RING_BYTES);
  r.empty = r.full + X3_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < X3_STAGES; ++s) {
      mbar_init(r.full + s, 1);
      mbar_init(r.empty + s, THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  } else if (threadIdx.x == THREADS) {
    for (int i = 0; i < 4; ++i) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(maps + i) : "memory");
    }
  }
  __syncthreads();
  return r;
}

// The producer thread: each of `steps` steps into its stage once the
// consumers have freed it; load(stage, bar, it) issues step it's four
// boxes (X3_STAGE_BYTES) on `bar`.
template <class Load>
__device__ __forceinline__ void x3_produce(const X3Ring& r, int steps,
                                           Load load) {
  for (int it = 0; it < steps; ++it) {
    const int s = it % X3_STAGES;
    if (it >= X3_STAGES) mbar_wait(r.empty + s, (it / X3_STAGES - 1) & 1);
    mbar_arrive_expect_tx(r.full + s, X3_STAGE_BYTES);
    load(r.stages + s * X3_STAGE_BYTES, r.full + s, it);
  }
}

// The consumers (both warpgroups; warpgroup wg multiplies rows 64 wg ..
// 64 wg + 63 of the A boxes where `multiplies`): `steps` steps of
// A (128 x 64, K-major) times B (64 deep x 128), cross + hi into `acc`.
// TRANS_B 0: B's box is K-major (3c's K rows); 1: N-major, two 64 x 64
// boxes (the SpMMs' X), read through wgmma's transpose bit. A step: A_hi
// B_hi (four wgmma m64n128k16) into the fresh accumulator dd (one commit
// group), then A_hi B_lo and A_lo B_hi straight into the cross sum (a
// second group); wgmma_wait<1> retires the first, and dd is added to the
// hi sum in f32 while the cross products run (the tensor cores truncate
// their accumulate). Groups retire in order, so that wait also retires
// step it - 1's cross products: its stage is free. The cross terms are
// ~2^-8 of the hi terms, and so is their truncation, ~2^-8 of an ulp of
// the output a product.
template <int TRANS_B>
__device__ __forceinline__ void x3_consume(const X3Ring& r, int steps,
                                           bool multiplies, const Frag& f,
                                           float (&acc)[PT_NT / 2]) {
  constexpr uint64_t B_STEP = TRANS_B ? 2048 / 16 : 32 / 16;  // a k16 slice
  float hi[PT_NT / 2];
#pragma unroll
  for (int e = 0; e < PT_NT / 2; ++e) {
    hi[e] = 0.0f;
    acc[e] = 0.0f;
  }
  float dd[PT_NT / 2];
  for (int it = 0; it < steps; ++it) {
    const int s = it % X3_STAGES;
    mbar_wait(r.full + s, (it / X3_STAGES) & 1);
    if (multiplies) {
      const unsigned char* stage = r.stages + s * X3_STAGE_BYTES;
      const uint64_t ah = descriptor_sw128(stage + f.wg * 64 * 128);
      const uint64_t al =
          descriptor_sw128(stage + X3_BOX_BYTES + f.wg * 64 * 128);
      const unsigned char* b = stage + 2 * X3_BOX_BYTES;
      const uint64_t bh =
          TRANS_B ? descriptor_mn128(b) : descriptor_sw128(b);
      const uint64_t bl = TRANS_B ? descriptor_mn128(b + X3_BOX_BYTES)
                                  : descriptor_sw128(b + X3_BOX_BYTES);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BF_TK / 16; ++ks) {
        wgmma_bf16_ss<TRANS_B>(dd, ah + 32 / 16 * ks, bh + B_STEP * ks,
                               ks > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < BF_TK / 16; ++ks) {
        wgmma_bf16_ss<TRANS_B>(acc, ah + 32 / 16 * ks, bl + B_STEP * ks, 1);
        wgmma_bf16_ss<TRANS_B>(acc, al + 32 / 16 * ks, bh + B_STEP * ks, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int e = 0; e < PT_NT / 2; ++e) {
        fence_operand(dd[e]);
        hi[e] += dd[e];
      }
    }
    if (it > 0) mbar_arrive(r.empty + (it - 1) % X3_STAGES);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < PT_NT / 2; ++e) fence_operand(acc[e]);
  if (steps > 0) mbar_arrive(r.empty + (steps - 1) % X3_STAGES);
  // the cross sum plus the hi sum, as the plain versions add them
#pragma unroll
  for (int e = 0; e < PT_NT / 2; ++e) acc[e] += hi[e];
}

// This CTA's share of row tile t (PT_NT columns) of Y = A @ X in f32 at
// matmul precision 'high', the function of bf16_pipe_tile on split
// operands: the walk's i-th block `slots[first + i]` (or first + i where
// slots is null) of `count`, at block column cols[b]; maps[0..1] the
// blocks' hi and lo planes, the walk's block at index j = first + i of
// them at plane row j a_stride + a_off, maps[2..3] X's (its row r at row
// r), each in boxes of 64 columns with the 128-byte swizzle. Each element
// of the tile inside the band's rows and inside Y is written once, zeros
// included; `y16` stores 4 columns at once (n % 4 == 0, Y on 16 B).
__device__ __forceinline__ void x3_pipe_tile(
    const RowTile& t, int first, int count, const int* __restrict__ slots,
    const int* __restrict__ cols, const CUtensorMap* maps, float* y,
    int band_rows, int bk, int m, int n, int a_stride, int a_off, bool y16) {
  const X3Ring ring = x3_ring(maps);
  const int ranks = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int rows = min(ROWS, band_rows - t.i0);
  const int ncols = min(PT_NT, n - t.n0);
  const int nq = (bk + BF_TK - 1) / BF_TK;  // steps a block
  const long long total = static_cast<long long>(count) * nq;
  const long long s0 = total * rank / ranks;
  const int steps = static_cast<int>(total * (rank + 1) / ranks - s0);

  if (threadIdx.x >= THREADS) {
    // the producer warpgroup gives up registers; one thread keeps the ring
    // full, then the group takes part in sum_store's cluster barriers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PT_PRODUCER_REGS));
    if (threadIdx.x == THREADS) {
      x3_produce(ring, steps, [&](unsigned char* stage, uint64_t* bar,
                                  int it) {
        const long long q = s0 + it;
        const int j = first + static_cast<int>(q / nq);
        const int b = slots != nullptr ? __ldg(slots + j) : j;
        const int k0 = static_cast<int>(q % nq) * BF_TK;
        const int xr0 = __ldg(cols + b) * bk + k0;
        const int ar0 = j * a_stride + a_off;
        tma_load(stage, maps, k0, ar0, bar);
        tma_load(stage + X3_BOX_BYTES, maps + 1, k0, ar0, bar);
        for (int h = 0; h < 2; ++h) {
          unsigned char* xs = stage + (2 + h) * X3_BOX_BYTES;
          tma_load(xs, maps + 2 + h, t.n0, xr0, bar);
          tma_load(xs + PT_XBOX_BYTES, maps + 2 + h, t.n0 + 64, xr0, bar);
        }
      });
    }
    cg::this_cluster().sync();
    cg::this_cluster().sync();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(PT_CONSUMER_REGS));
  const Frag f = frag();
  float acc[PT_NT / 2];
  x3_consume<1>(ring, steps, 64 * f.wg < rows, f, acc);
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
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  const long long row0 = static_cast<long long>(t.r) * band_rows + t.i0;
  const int out_rows = static_cast<int>(
      min(static_cast<long long>(rows), static_cast<long long>(m) - row0));
  sum_store<PT_NT, PT_RED_LD, THREADS>(
      part, out_rows, ncols, [&](int i, int j, const float4& v) {
        float* p = y + static_cast<size_t>(row0 + i) * n + t.n0 + j;
        if (y16) {  // ncols % 4 == 0
          *reinterpret_cast<float4*>(p) = v;
          return;
        }
        const float w[4] = {v.x, v.y, v.z, v.w};
        for (int c = 0; c < 4 && j + c < ncols; ++c) p[c] = w[c];
      });
}

}  // namespace
