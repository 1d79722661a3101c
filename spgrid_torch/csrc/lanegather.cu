// Gather along one axis of a 2-D f32 array: out = take_along_axis(src, idx,
// axis), with out[i, j] = src[i, idx[i, j]] (axis 1) or src[idx[i, j], j]
// (axis 0).
//
// Replaces: scripts/exp_lanegather.py, try_compile and the kernels it
// compiles (the Pallas TPU probe of which gather forms Mosaic accepts inside
// a kernel: take_along_axis along lanes at widths 128 and 512 and from a
// 3328-wide source, with a broadcast index over 128 rows, along sublanes,
// and a stack of 8 dynamically indexed rows). The TPU kernel puts the whole
// operand in VMEM (BlockSpec(memory_space=VMEM)) and gathers there.
//
// Bound on the H100: device-memory bytes, each input read once and the
// output written once (src, idx and out: at most 0.3 MB at the probe's
// shapes, a fraction of a microsecond at 3.35 TB/s). At these sizes the
// launch sets the time: spgrid_launch_floor launches an empty kernel (one
// CTA of 32 threads that writes nothing) so that a run can time that floor
// beside the gathers. No arithmetic.
//
// Design: two paths.
// - Staged, VMEM's counterpart: a CTA reads its index words (4 outputs a
//   load) and copies its tile of src into shared memory with 16-byte loads,
//   the two in one round trip to memory, then gathers from shared memory
//   and writes 4 outputs a store. A tile is whole rows (axis 1) or a slab of
//   up to 32 columns of every row (axis 0), at most STAGE_BYTES and
//   STAGE_OUT outputs, so a thread holds one index word and a few words of
//   the tile; the CTAs read the whole source between them.
// - Direct: a thread an output element, the index read coalesced, then the
//   element gathered from device memory (__ldg): two dependent round trips,
//   a 32-byte sector read a gathered element.
// Rule (plan, host side): direct, on every call; the staged path runs only
// where a caller asks for it by name, as chip_smoke.py's A/B of the two
// paths does. Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, phase
// 1): on all six probe forms, the only gathers the port makes, the staged
// path's barrier and shared-memory pass cost 0.19-0.76 us more than the
// direct path's second round trip, even on the (8,128) form whose direct
// sectors come to 8x its 4 KB source. The float4 forms need n % 4 == 0
// along the rows read and 16-byte aligned pointers; elsewhere each path
// runs a 4-byte form with the same walk.
//
// An index outside src along the axis reads 0 on both paths, so a bad
// index never faults the card (the plain version raises instead). The
// result is exact: a gather is a copy.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;             // direct path: a thread an element
constexpr int STAGE_THREADS = 256;       // staged path, a CTA
constexpr int STAGE_BYTES = 16 << 10;    // a staged CTA's tile, at most
constexpr int STAGE_OUT = 4 * STAGE_THREADS;  // its outputs, at most
constexpr int SLAB_COLS = 32;            // axis 0: a tile's columns, at most

enum Path { RULE = 0, DIRECT = 1, STAGED = 2 };

struct Plan {
  int path;   // DIRECT or STAGED
  int tile;   // staged: rows (axis 1) or columns (axis 0) a CTA; direct: 0
  int ctas;
};

// The staged tile, sized so that a thread reads a few 16-byte words of it
// and one index word (4 outputs) at most: axis 1, whole rows of s1, as
// many as STAGE_BYTES and STAGE_OUT outputs hold; axis 0, columns of every
// row, SLAB_COLS at most and a multiple of 4. 0 where not one row (axis 1)
// or 4 columns (axis 0) fit.
int stage_tile(int s0, int s1, int i0, int i1, int axis) {
  if (axis == 1) {
    const long long row = 4LL * s1;
    if (row > STAGE_BYTES || i1 > STAGE_OUT) return 0;
    long long rows = STAGE_BYTES / row;
    const long long by_out = STAGE_OUT / (i1 > 0 ? i1 : 1);
    if (rows > by_out) rows = by_out;
    return static_cast<int>(rows < s0 ? rows : s0);
  }
  long long cols = STAGE_BYTES / (4LL * s0);
  const long long by_out = STAGE_OUT / (i0 > 0 ? i0 : 1);
  if (cols > by_out) cols = by_out;
  if (cols > SLAB_COLS) cols = SLAB_COLS;
  cols &= ~3LL;
  if (cols < 4) return 0;
  return static_cast<int>(cols < s1 ? cols : s1);
}

cudaError_t plan(int s0, int s1, int i0, int i1, int axis, int path,
                 Plan* out) {
  if ((axis != 0 && axis != 1) || s0 < 1 || s1 < 1 || i0 < 0 || i1 < 0 ||
      path < RULE || path > STAGED) {
    return cudaErrorInvalidValue;
  }
  const long long total = static_cast<long long>(i0) * i1;
  if (path == RULE) path = DIRECT;   // the rule: see the design comment
  if (path == STAGED) {
    const int tile = stage_tile(s0, s1, i0, i1, axis);
    if (tile == 0) return cudaErrorInvalidValue;
    const int along = axis == 1 ? s0 : s1;
    *out = {STAGED, tile, (along + tile - 1) / tile};
  } else {
    *out = {DIRECT, 0,
            static_cast<int>((total + THREADS - 1) / THREADS)};
  }
  return cudaSuccess;
}

__global__ void __launch_bounds__(THREADS)
lanegather_direct(const float* __restrict__ src, const int* __restrict__ idx,
                  float* __restrict__ out, int s0, int s1, int i1,
                  size_t total, int axis) {
  const size_t e = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= total) return;
  const size_t i = e / i1;
  const size_t j = e % i1;
  const int g = idx[e];
  float v = 0.0f;
  if (axis == 1) {
    if (g >= 0 && g < s1) v = __ldg(src + i * s1 + g);
  } else if (g >= 0 && g < s0) {
    v = __ldg(src + static_cast<size_t>(g) * s1 + j);
  }
  out[e] = v;
}

// The element of the staged tile (rows x cols, row-major in shared memory)
// that index g picks for output (i, j) of the tile, or 0 outside src.
template <int AXIS>
__device__ __forceinline__ float pick(const float* tile, int g, int i, int j,
                                      int s0, int s1, int cols) {
  if (AXIS == 1) return (g >= 0 && g < s1) ? tile[i * cols + g] : 0.0f;
  return (g >= 0 && g < s0) ? tile[g * cols + j] : 0.0f;
}

// A CTA a tile: axis 1, src rows r0 .. r0 + rows (all s1 columns) and the
// same rows of out (i1 outputs each); axis 0, src columns c0 .. c0 + cols
// of every row and the same columns of every out row (i0 rows).
template <int AXIS, bool VEC>
__global__ void __launch_bounds__(STAGE_THREADS)
lanegather_staged(const float* __restrict__ src, const int* __restrict__ idx,
                  float* __restrict__ out, int s0, int s1, int i0, int i1,
                  int tile) {
  __shared__ float4 stage4[STAGE_BYTES / sizeof(float4)];
  float* stage = reinterpret_cast<float*>(stage4);
  const int r0 = AXIS == 1 ? blockIdx.x * tile : 0;
  const int c0 = AXIS == 1 ? 0 : blockIdx.x * tile;
  const int rows = AXIS == 1 ? min(tile, s0 - r0) : s0;
  const int cols = AXIS == 1 ? s1 : min(tile, s1 - c0);
  const int orows = AXIS == 1 ? rows : i0;
  const int ocols = AXIS == 1 ? i1 : cols;
  const int q_out = VEC ? ocols / 4 : ocols;   // index words an out row
  // output word e of the tile: its place in out (and idx)
  auto place = [&](int e) {
    const int i = e / q_out;
    const int j = (e - i * q_out) * (VEC ? 4 : 1);
    return AXIS == 1 ? static_cast<size_t>(r0 + i) * i1 + j
                     : static_cast<size_t>(i) * i1 + c0 + j;
  };
  // this thread's first index word, read before the tile lands so that the
  // two loads share one round trip (the tile's size keeps it to one word a
  // thread in the float4 form)
  const int words = orows * q_out;
  int4 g4 = make_int4(0, 0, 0, 0);
  int g1 = 0;
  if (threadIdx.x < words) {
    if (VEC) {
      g4 = __ldg(reinterpret_cast<const int4*>(idx + place(threadIdx.x)));
    } else {
      g1 = __ldg(idx + place(threadIdx.x));
    }
  }
  if (VEC) {
    const int q = cols / 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < rows * q; e += STAGE_THREADS) {
      const int r = e / q;
      stage4[e] = __ldg(reinterpret_cast<const float4*>(
          src + static_cast<size_t>(r0 + r) * s1 + c0) + (e - r * q));
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += STAGE_THREADS) {
      const int r = e / cols;
      stage[e] = __ldg(src + static_cast<size_t>(r0 + r) * s1 + c0 +
                       (e - r * cols));
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < words; e += STAGE_THREADS) {
    const int i = e / q_out;
    const int j = (e - i * q_out) * (VEC ? 4 : 1);
    const size_t o = place(e);
    if (VEC) {
      const int4 g = e == static_cast<int>(threadIdx.x)
          ? g4 : __ldg(reinterpret_cast<const int4*>(idx + o));
      float4 v;
      v.x = pick<AXIS>(stage, g.x, i, j, s0, s1, cols);
      v.y = pick<AXIS>(stage, g.y, i, j + 1, s0, s1, cols);
      v.z = pick<AXIS>(stage, g.z, i, j + 2, s0, s1, cols);
      v.w = pick<AXIS>(stage, g.w, i, j + 3, s0, s1, cols);
      *reinterpret_cast<float4*>(out + o) = v;
    } else {
      const int g = e == static_cast<int>(threadIdx.x) ? g1 : __ldg(idx + o);
      out[o] = pick<AXIS>(stage, g, i, j, s0, s1, cols);
    }
  }
}

template <int AXIS, bool VEC>
cudaError_t launch_staged(const float* src, const int* idx, float* out,
                          int s0, int s1, int i0, int i1, const Plan& p,
                          cudaStream_t stream) {
  lanegather_staged<AXIS, VEC><<<p.ctas, STAGE_THREADS, 0, stream>>>(
      src, idx, out, s0, s1, i0, i1, p.tile);
  return cudaGetLastError();
}

__global__ void launch_floor_kernel() {}

}  // namespace

// The launch plan of spgrid_lanegather at ``path`` (0: the rule's, 1:
// direct, 2: staged), into out[3]: path, tile, CTAs.
extern "C" int spgrid_lanegather_shape(int s0, int s1, int i0, int i1,
                                       int axis, int path, void* out) {
  Plan p;
  const cudaError_t err = plan(s0, s1, i0, i1, axis, path, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* o = static_cast<int*>(out);
  o[0] = p.path;
  o[1] = p.tile;
  o[2] = p.ctas;
  return static_cast<int>(cudaSuccess);
}

extern "C" int spgrid_lanegather(const void* src, const void* idx, void* out,
                                 int s0, int s1, int i0, int i1, int axis,
                                 int path, void* stream) {
  Plan p;
  const cudaError_t err = plan(s0, s1, i0, i1, axis, path, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(i0) * i1;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const float* s = static_cast<const float*>(src);
  const int* ix = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.path == DIRECT) {
    lanegather_direct<<<p.ctas, THREADS, 0, st>>>(s, ix, o, s0, s1, i1,
                                                  total, axis);
    return static_cast<int>(cudaGetLastError());
  }
  const bool aligned = ((reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(idx) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const bool vec = aligned && s1 % 4 == 0 && i1 % 4 == 0 &&
                   (axis == 1 || p.tile % 4 == 0);
  cudaError_t e;
  if (axis == 1) {
    e = vec ? launch_staged<1, true>(s, ix, o, s0, s1, i0, i1, p, st)
            : launch_staged<1, false>(s, ix, o, s0, s1, i0, i1, p, st);
  } else {
    e = vec ? launch_staged<0, true>(s, ix, o, s0, s1, i0, i1, p, st)
            : launch_staged<0, false>(s, ix, o, s0, s1, i0, i1, p, st);
  }
  return static_cast<int>(e);
}

// An empty kernel, one CTA of 32 threads: the card's launch floor.
extern "C" int spgrid_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
