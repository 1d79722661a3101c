"""Build the CUDA kernels with nvcc and bind them through ctypes.

The ``spgrid_torch/csrc/*.cu`` files are built, at the first launch of any
kernel, into one shared library with a plain C interface: one nvcc per
source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o libspgrid_kernels.so *.o

The library goes to ``build/spgrid_torch/<hash of sources and flags>/`` under
the repository root (git ignores ``build/``), with nvcc's output, including
ptxas's register and shared-memory report, beside it in ``nvcc.log``. A
source change gives a new hash and a new build. Every C entry point returns
``cudaGetLastError()`` after its launch; ``check`` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "spgrid_torch"
LIB_NAME = "libspgrid_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# C signatures: device pointers and the stream as void*, sizes as int.
SIGNATURES = {
    # row_ptr, cols, blocks, x, y, mb, bm, bk, m, k, n, cluster (0: the
    # launch rule), stream
    "spgrid_bsr_spmm": [_PTR] * 5 + [_INT] * 7 + [_PTR],
    # row_ptr, cols, blocks, tile_slices, x, y (bf16 blocks, x and y),
    # num_slices, nb, bm, bk, m, k, n, cluster (0: the launch rule), stream:
    # the bf16 form's tile route
    "spgrid_bsr_spmm_bf16": [_PTR] * 6 + [_INT] * 8 + [_PTR],
    # row_slot, vals, xrows, rows, long_rows, x, y, num_rows, n, long_row,
    # num_long, stream: the bf16 form's entry route
    "spgrid_bsr_spmm_bf16_entries": [_PTR] * 7 + [_INT] * 4 + [_PTR],
    # counts, cols, panels, x, y, bands, max_p, band_rows, bk, m, k, n,
    # cluster (0: the launch rule), stream
    "spgrid_panel_spmm": [_PTR] * 5 + [_INT] * 8 + [_PTR],
    # slice_ptr, slice_slots, cols, panels (bf16 bit patterns), x, y, bands,
    # max_p, band_rows, bk, m, k, n, xy_bf16 (x and y: 0 f32, 1 bf16),
    # cluster (0: the launch rule), stream
    "spgrid_panel_spmm_bf16": [_PTR] * 6 + [_INT] * 9 + [_PTR],
    # rows, cols, mask, q, k, out, nb, bm, bk, mq, mk, d, cluster, stream
    "spgrid_bsr_sddmm": [_PTR] * 6 + [_INT] * 7 + [_PTR],
    # the same, mask, q, k and out in bf16, and scratch (the copy pass's
    # planes, null where TMA reads Q and K) after out
    "spgrid_bsr_sddmm_bf16": [_PTR] * 7 + [_INT] * 7 + [_PTR],
    # rows, cols, mask, q, k, out, scratch (the split planes), nb, bm, bk,
    # mq, mk, d, cluster, stream: f32, three bf16 passes (matmul precision
    # 'high')
    "spgrid_bsr_sddmm_bf16x3": [_PTR] * 7 + [_INT] * 7 + [_PTR],
    # q, k, scratch, mq, mk, d, stream: its split pass alone
    "spgrid_bsr_sddmm_bf16x3_split": [_PTR] * 3 + [_INT] * 3 + [_PTR],
    # the same: the bf16 form's copy pass alone
    "spgrid_bsr_sddmm_bf16_copy": [_PTR] * 3 + [_INT] * 3 + [_PTR],
    # the launch shapes: mb, bm, n (SpMM); slices, bk, n (bf16 SpMM);
    # bands, band_rows, n (panels); bands, band_rows, bk, n, xy_bf16 (bf16
    # panels); nb, bm, bk (SDDMM); then out (int[6]: tiles, cluster, tile
    # rows, tile columns, step, ring stages)
    "spgrid_bsr_spmm_shape": [_INT] * 3 + [_PTR],
    "spgrid_bsr_spmm_bf16_shape": [_INT] * 3 + [_PTR],
    "spgrid_panel_spmm_shape": [_INT] * 3 + [_PTR],
    "spgrid_panel_spmm_bf16_shape": [_INT] * 5 + [_PTR],
    "spgrid_bsr_sddmm_shape": [_INT] * 3 + [_PTR],
    # nb, bm, bk, mq, mk, d, q, k, out (int[7]: the six, then CTAs),
    # scratch (long long[1]: the copy pass's bytes): the bf16 SDDMM's
    "spgrid_bsr_sddmm_bf16_shape": [_INT] * 6 + [_PTR] * 4,
    # nb, bm, bk, mq, mk, d, out (int[6]), scratch (long long[1]: the
    # split planes' bytes): the 3-pass SDDMM's
    "spgrid_bsr_sddmm_bf16x3_shape": [_INT] * 6 + [_PTR] * 2,
    # n, slab, vec, out (int[5]: slab, slabs, rows a CTA, lanes a row,
    # slots in flight a lane): the bf16 bands walk's
    "spgrid_wcoo_bands_bf16_shape": [_INT] * 3 + [_PTR],
    # row_slot, vals, xrows, long_rows, x, y, m, n, long_row, num_long, stream
    "spgrid_wcoo_spmm": [_PTR] * 6 + [_INT] * 4 + [_PTR],
    "spgrid_wcoo_spmm_bf16": [_PTR] * 6 + [_INT] * 4 + [_PTR],
    "spgrid_wcoo_bands": [_PTR] * 6 + [_INT] * 4 + [_PTR],
    # the same, then slab (0: the rule), stream
    "spgrid_wcoo_bands_bf16": [_PTR] * 6 + [_INT] * 5 + [_PTR],
    # row_slot, vals, cols, x, y, blocks, m, stream
    "spgrid_wrow_spmv": [_PTR] * 5 + [_INT] * 2 + [_PTR],
    # the same, vals, x and y in bf16, cols marked with the groups' starts
    "spgrid_wrow_spmv_bf16": [_PTR] * 5 + [_INT] * 2 + [_PTR],
    # tile_row, row_slot, vals, xidx, x, y, tiles, tile_slots, stream
    "spgrid_wcoo_spmv": [_PTR] * 6 + [_INT] * 2 + [_PTR],
    # the same, vals, x and y in bf16, xidx marked with the groups' starts
    "spgrid_wcoo_spmv_bf16": [_PTR] * 6 + [_INT] * 2 + [_PTR],
    # counts, lrows, cols, blocks, x, y, bands, max_nb, band_rows, bm, bk,
    # m, k, n, stream
    "spgrid_bsr_spmm_cstat": [_PTR] * 6 + [_INT] * 8 + [_PTR],
    # the same, blocks, x and y in bf16
    "spgrid_bsr_spmm_cstat_bf16": [_PTR] * 6 + [_INT] * 8 + [_PTR],
    # bands, band_rows, bm, n, out (int[3]: CTAs, column tile, slice rows)
    "spgrid_bsr_spmm_cstat_shape": [_INT] * 4 + [_PTR],
    "spgrid_bsr_spmm_cstat_bf16_shape": [_INT] * 4 + [_PTR],
    # cols, vals, tail_ptr, tail_cols, tail_vals, x, y, m, k, slots, n,
    # slab (0: the slab rule), stream
    "spgrid_dgell": [_PTR] * 7 + [_INT] * 5 + [_PTR],
    # the same, x and y in bf16
    "spgrid_dgell_bf16": [_PTR] * 7 + [_INT] * 5 + [_PTR],
    # k, n, slab, vec, out (int[4]: slab, slabs, rows a CTA, lanes a row)
    "spgrid_dgell_shape": [_INT] * 4 + [_PTR],
    "spgrid_dgell_bf16_shape": [_INT] * 4 + [_PTR],
    # block_slot, vals, cols, rows, x, y, carry, num_slots, slots_per_cta,
    # blocks, m, stream
    "spgrid_wpack_spmv": [_PTR] * 7 + [_INT] * 4 + [_PTR],
    # row_slot, vals, cols, x, y (bf16 values, x and y), carry, carry_row,
    # num_slots, slots_per_cta, m, stream: the row walk (wsel 2 and 4)
    "spgrid_wpack_spmv_bf16": [_PTR] * 7 + [_INT] * 3 + [_PTR],
    # block_ptr, group_sub, piece_w, cols, starts, ends, vals, x, y (bf16
    # values, x and y), carry, groups_per_cta, groups, blocks, m, k, stream
    "spgrid_wpack_spmv_bf16_prefix": [_PTR] * 10 + [_INT] * 5 + [_PTR],
    # block_ptr, piece_w, piece_lanes, cols, sel, starts, ends, vals, x, y,
    # variant, warps (0: the rule's), blocks, m, k, stream
    "spgrid_wpack_ablate": [_PTR] * 10 + [_INT] * 5 + [_PTR],
    # warps (0: the rule's), blocks, out (int[1]: W)
    "spgrid_wpack_ablate_warps": [_INT, _INT, _PTR],
    # block_slot, vals, cols, rows, x, y, carry, num_slots, slots_per_cta,
    # blocks, m, stream
    "spgrid_wrow_spmv_v2": [_PTR] * 7 + [_INT] * 4 + [_PTR],
    # row_slot, vals, cols, x, y (bf16 values, x and y), carry, carry_row,
    # num_slots, slots_per_cta, m, stream: the row walk
    "spgrid_wrow_spmv_v2_bf16": [_PTR] * 7 + [_INT] * 3 + [_PTR],
    # src, idx, out, s0, s1, i0, i1, axis, path (0: the rule's, 1: direct,
    # 2: staged), stream
    "spgrid_lanegather": [_PTR] * 3 + [_INT] * 6 + [_PTR],
    # s0, s1, i0, i1, axis, path, out (int[3]: path, tile, CTAs)
    "spgrid_lanegather_shape": [_INT] * 6 + [_PTR],
    # stream: an empty kernel, the launch floor
    "spgrid_launch_floor": [_PTR],
    # x, idx, out, k, n, steps, G, stages, chunk_rows (0: the rule's), grid
    # (int* or NULL: the CTAs launched), stream
    "spgrid_dma_gather": [_PTR] * 3 + [_INT] * 6 + [_PTR] * 2,
    # n, steps, G, stages, chunk_rows, out (int[3]: S, R, CTAs)
    "spgrid_dma_gather_shape": [_INT] * 5 + [_PTR],
    # src, idx, out, rows, reps, stream
    "spgrid_shuffle_bench": [_PTR] * 3 + [_INT] * 2 + [_PTR],
    # row_slot, vals, cols, pieces, x, y, variant, blocks, m, k, stream
    "spgrid_spmv_ablate": [_PTR] * 6 + [_INT] * 4 + [_PTR],
}


class BuildError(RuntimeError):
    """The CUDA kernels could not be built."""


def find_nvcc() -> str:
    """nvcc from PATH, else from $CUDA_HOME/bin (default /usr/local/cuda)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise BuildError(
        "nvcc not found on PATH or in $CUDA_HOME/bin: the spgrid_torch CUDA "
        "kernels are built with the CUDA toolkit for sm_90a (Hopper) at their "
        "first launch")


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless this exact build exists; returns the
    library's path."""
    out = build_dir()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / f"{LIB_NAME}.{os.getpid()}.tmp"
    objs, log, procs = [], [], []
    try:
        for src in (p for p in sources() if p.suffix == ".cu"):
            obj = out / f"{src.stem}.{os.getpid()}.o"
            objs.append(obj)
            procs.append((src.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, proc in procs:
            text = proc.communicate()[0]
            log.append(f"== {name}\n{text}")
            if proc.returncode != 0:
                failed.append(f"{name} (exit code {proc.returncode}):\n{text}")
        if not failed:
            proc = subprocess.run(
                [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                 *map(str, objs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                check=False)
            log.append(f"== link\n{proc.stdout}")
            if proc.returncode != 0:
                failed.append(f"link (exit code {proc.returncode}):\n"
                              f"{proc.stdout}")
        (out / "nvcc.log").write_text("".join(log))
        if failed:
            raise BuildError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp, lib)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernels, with argument types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.spgrid_error_string.argtypes = [ctypes.c_int]
    lib.spgrid_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = library().spgrid_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed: {msg} ({code})")
