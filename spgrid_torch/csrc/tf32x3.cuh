// The 3xTF32 tensor-core helpers that the block kernels share
// (bsr_spmm_cstat.cu, and bsr_spmm.cu, panel_spmm.cu and sddmm.cu through
// block_mma.cuh): cp.async staging, the TF32 split v = hi + lo (both
// rounded by cvt.rna.tf32.f32), wgmma m64nNk8 with tf32 operands, A in
// registers and B K-major in shared memory in 8 x 16-byte core matrices
// without swizzle, and the step of a tile NT columns wide (NT = 64 or 128)
// that both tiles run: B's N-major split and the warpgroups' multiply.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TK = 32;  // contraction depth a step
constexpr int THREADS = 256;  // two warpgroups, 64 rows each
constexpr int A_LD = TK + 4;  // row stride of a step's A slice
constexpr unsigned LBO_BYTES = 128;           // core matrices along K
constexpr unsigned SBO_BYTES = TK / 4 * 128;  // along N, 8 columns on

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// All but the newest `pending` commit groups of this thread have landed.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(pending) : "memory");
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

// Orders this thread's generic stores to shared memory before the
// tensor cores' (asynchronous-proxy) reads of it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// All but the newest `pending` committed wgmma groups have completed.
template <int pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(pending) : "memory");
}

// Keeps the compiler from moving or reusing a register across the
// asynchronous wgmma that reads or writes it.
__device__ __forceinline__ void fence_operand(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}

__device__ __forceinline__ void fence_operand(uint32_t& v) {
  asm volatile("" : "+r"(v)::"memory");
}

// Shared-memory descriptor of a K-major operand without swizzle, starting
// at p (16-byte aligned): core matrices at p, p + LBO (next 4 along K) and
// p + SBO (next 8 along N).
__device__ __forceinline__ uint64_t descriptor(const float* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(LBO_BYTES >> 4) << 16 |
         static_cast<uint64_t>(SBO_BYTES >> 4) << 32;
}

// d (64 x N, f32) = a (64 x 8, tf32 fragments in registers) * b (8 x N,
// tf32 in shared memory) + (accumulate ? d : 0), N = 64 or 128;
// warpgroup-collective and asynchronous until wgmma_wait.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
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

__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}

// Row stride of a B slice staged N-major, NT columns wide.
template <int NT>
constexpr int n_major_ld = NT + 8;

// Coordinates of a thread: warpgroup wg owns rows 64 wg .. + 63 of the
// tile, its warp w rows 16 w .. + 15 of those (g = lane / 4, q = lane % 4).
// Accumulator 4 j + 2 h + c holds row 64 wg + 16 w + 8 h + g, column 8 j +
// 2 q + c, as wgmma's m64nNk8 f32 fragment lays them out; the A fragment
// holds rows + g, + g + 8 and columns q, q + 4 of each 8.
struct Frag {
  int wg, w, g, q;
};

__device__ __forceinline__ Frag frag() {
  const int t = threadIdx.x;
  return Frag{t / 128, t / 32 % 4, t % 32 / 4, t % 4};
}

// A step's split B, B_hi then B_lo (NT * TK floats each), K-major in 8 x
// 16-byte core matrices: [NT / 8 column groups][TK / 4][8][4 depths]. One
// core-matrix row, 4 depths of one column, goes to `off`.
template <int NT>
__device__ __forceinline__ void store_split(float* sb, int off,
                                            const float (&v)[4]) {
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) split(v[u], hi[u], lo[u]);
  *reinterpret_cast<uint4*>(sb + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(sb + NT * TK + off) =
      make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// A B slice staged N-major (TK rows of NT columns, stride n_major_ld<NT>),
// split and transposed into core matrices. Eight neighbouring threads read
// 8 neighbouring columns and write one 128-byte core matrix.
template <int NT>
__device__ __forceinline__ void split_nmajor(const float* __restrict__ bs,
                                             float* __restrict__ sb) {
  constexpr int LD = n_major_ld<NT>;
  for (int e = threadIdx.x; e < NT * (TK / 4); e += THREADS) {
    const int r = e % 8;
    const int grp = e / 8 % (NT / 8);
    const int k4 = e / NT;
    const float* p = bs + 4 * k4 * LD + 8 * grp + r;
    const float w[4] = {p[0], p[LD], p[2 * LD], p[3 * LD]};
    store_split<NT>(sb, ((grp * (TK / 4) + k4) * 8 + r) * 4, w);
  }
}

// acc += the warpgroup's 64 rows of the step's A slice (row stride A_LD)
// times its split B: for each 8 depths, A_lo B_hi, A_hi B_lo, then A_hi
// B_hi, one wgmma group. The A fragments of two groups are live at a time:
// a group's are rewritten only after the group two before has completed.
// The tensor cores' f32 accumulate truncates, so a long chain of products
// on one accumulator drifts low: the step's 12 products go to fresh
// accumulators, whose sum is added to acc on the CUDA cores, rounding to
// nearest.
template <int NT>
__device__ __forceinline__ void multiply(float (&acc)[NT / 2],
                                         const float* __restrict__ as,
                                         const float* __restrict__ sb,
                                         const Frag& f) {
  const float* p = as + (64 * f.wg + 16 * f.w + f.g) * A_LD + f.q;
  const uint64_t b_hi = descriptor(sb);
  const uint64_t b_lo = descriptor(sb + NT * TK);
  uint32_t ah[2][4], al[2][4];
  float d[NT / 2];
#pragma unroll
  for (int s = 0; s < TK / 8; ++s) {
    const int b = s % 2;
    if (s >= 2) {
      wgmma_wait<1>();  // group s - 2 has read ah[b], al[b]
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        fence_operand(ah[b][e]);
        fence_operand(al[b][e]);
      }
    }
    split(p[8 * s], ah[b][0], al[b][0]);
    split(p[8 * A_LD + 8 * s], ah[b][1], al[b][1]);
    split(p[8 * s + 4], ah[b][2], al[b][2]);
    split(p[8 * A_LD + 8 * s + 4], ah[b][3], al[b][3]);
    wgmma_fence();
    const uint64_t next = 2 * 128 / 16 * s;  // two core matrices on, >> 4
    wgmma_tf32(d, al[b], b_hi + next, s > 0);
    wgmma_tf32(d, ah[b], b_lo + next, 1);
    wgmma_tf32(d, ah[b], b_hi + next, 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      fence_operand(ah[b][e]);
      fence_operand(al[b][e]);
    }
#pragma unroll
  for (int e = 0; e < NT / 2; ++e) {
    fence_operand(d[e]);
    acc[e] += d[e];
  }
}

}  // namespace
