"""C-stationary block-sparse SpMM: Y = A @ X with A in DeviceBSRCol layout.

Counterpart of ``spgrid/ops/pallas/bsr_spmm_cstat.py`` (format
``bsrc_pallas``); the CUDA kernel is ``spgrid_torch/csrc/bsr_spmm_cstat.cu``.
``bsr_spmm_cstat(..., precision=)`` launches the form of X's dtype and
the precision for CUDA tensors and takes its plain version
(``bsr_spmm_cstat_plain``, ``bsr_spmm_cstat_bf16x3_plain``) only for CPU
tensors; an f64 X, or a precision without a form, raises.

Rows are split into bands of R rows; a band's (bm, bk) blocks are sorted by
(block column, block row), so consecutive blocks share their X tile, and
each block adds into a window of the band's output slab. The kernel splits
each band's slab across CTAs: one CTA a (band, row slice of 128 // bm block
rows, 64 or 128 output columns), multiplying on the tensor cores in 3xTF32
(``launch_grid`` gives its grid). Its bf16 form (``bsr_spmm_cstat_bf16``:
bf16 blocks and X, each block's product summed in f32 and added into the
f32 slab in block order, Y rounded once, as the Pallas kernel runs at dtype
bf16) multiplies in bf16 on the tensor cores, 64 output columns a CTA.
Its 3-pass form of f32 operands (``bsr_spmm_cstat_bf16x3``: the Pallas
kernel's dot at matmul precision 'high', blocks and X split into bf16 hi
and lo parts, A_hi X_hi + A_hi X_lo + A_lo X_hi summed in f32, each
block's product added into the f32 slab in block order) splits the blocks
and X once into bf16 planes (in scratch the wrapper allocates:
``x3_shape``), then runs the bf16 form's CTAs and slab on them, three
products a step.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from spgrid_torch.formats.bsr import csr_to_bsr
from spgrid_torch.formats.csr import value_dtype
from spgrid_torch.ops.kernels import (
    OTHER_PRECISIONS, _build, check_form, check_operands, runs_plain)
from spgrid_torch.ops.kernels.bf16x3 import bmm_bf16x3
from spgrid_torch.ops.layouts import round_up, to_device, torch_dtype
from spgrid_torch.ops.xla import acc_dtype

BM_MAX = 128  # rows of a block and of a row slice (csrc/bsr_spmm_cstat.cu)


def bsrc_arrays(csr, bm: int = 128, bk: int = 128, band_rows: int = 2048):
    """Host arrays of the C-stationary layout, as ``spgrid.ops.pallas.
    bsr_spmm_cstat.DeviceBSRCol.from_csr`` builds them: (local_rows,
    block_cols, blocks, num_blocks, R, bands, max_nb). Each band is padded
    to ``max_nb`` slots; pad slots sit at local block row R/bm, hold zero
    blocks and repeat the band's last column."""
    bsr = csr_to_bsr(csr, bm=bm, bk=bk)
    R = min(band_rows, round_up(max(csr.shape[0], bm), bm))
    if R % bm:
        raise ValueError(f"band_rows {R} must be a multiple of bm {bm}")
    rows_per_band = R // bm
    brows = np.repeat(np.arange(bsr.mb, dtype=np.int64),
                      np.diff(bsr.block_row_ptr))
    bcols = bsr.block_col_idx.astype(np.int64)
    band_of = brows // rows_per_band
    bands = max(int(band_of.max(initial=0)) + 1, -(-bsr.mb // rows_per_band),
                1)
    # (band, col, row): column-major within each band
    order = np.lexsort((brows, bcols, band_of))
    counts = np.bincount(band_of, minlength=bands)
    max_nb = max(int(counts.max(initial=1)), 1)
    starts = np.concatenate([[0], np.cumsum(counts)])
    band_s = band_of[order]
    slot = band_s * max_nb + np.arange(len(order)) - starts[band_s]

    lrows = np.full(bands * max_nb, rows_per_band, dtype=np.int32)
    cols = np.zeros(bands * max_nb, dtype=np.int32)
    blocks = np.zeros((bands * max_nb, bm, bk), dtype=csr.values.dtype)
    lrows[slot] = brows[order] % rows_per_band
    cols[slot] = bcols[order]
    blocks[slot] = bsr.blocks[order]
    # pad slots of a band with blocks repeat its last real column
    band = np.arange(bands * max_nb) // max_nb
    pad = (np.arange(bands * max_nb) % max_nb >= counts[band]) & (
        counts[band] > 0)
    cols[pad] = cols[band[pad] * max_nb + counts[band[pad]] - 1]
    return lrows, cols, blocks, bsr.num_blocks, R, bands, max_nb


@dataclasses.dataclass
class DeviceBSRCol:
    """``bsrc_arrays`` on a torch device, plus ``counts``: each band's number
    of real slots, which come first in the band, so the kernel never reads
    a pad slot."""

    local_rows: torch.Tensor   # (bands*max_nb,) int32, block row in the band
    block_cols: torch.Tensor   # (bands*max_nb,) int32
    blocks: torch.Tensor       # (bands*max_nb, bm, bk) f32 or bf16
    counts: torch.Tensor       # (bands,) int32
    shape: Tuple[int, int]
    nnz: int
    num_blocks: int            # true block count
    band_rows: int             # R, a multiple of bm
    bands: int
    max_nb: int                # slots per band

    @property
    def bm(self) -> int:
        return self.blocks.shape[1]

    @property
    def bk(self) -> int:
        return self.blocks.shape[2]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.local_rows, self.block_cols, self.blocks, self.counts))

    @classmethod
    def from_arrays(cls, local_rows, block_cols, blocks, shape, nnz: int,
                    num_blocks: int, band_rows: int, bands: int, max_nb: int,
                    *, device,
                    dtype: torch.dtype = torch.float32) -> "DeviceBSRCol":
        """Host arrays → device layout, the blocks in ``dtype`` (f32, or
        bf16 for a matrix whose values are bf16); ``counts`` is recovered
        from the slots (pad slots sit at local block row R/bm)."""
        lrows = np.asarray(local_rows, np.int32)
        rows_per_band = int(band_rows) // np.asarray(blocks).shape[1]
        counts = (lrows.reshape(bands, max_nb) < rows_per_band).sum(axis=1)
        return cls(local_rows=to_device(lrows, device),
                   block_cols=to_device(block_cols, device, np.int32),
                   blocks=to_device(blocks, device).to(dtype),
                   counts=to_device(counts, device, np.int32),
                   shape=tuple(shape), nnz=int(nnz),
                   num_blocks=int(num_blocks), band_rows=int(band_rows),
                   bands=int(bands), max_nb=int(max_nb))

    @classmethod
    def from_csr(cls, csr, bm: int = 128, bk: int = 128,
                 band_rows: int = 2048, *, device) -> "DeviceBSRCol":
        lrows, cols, blocks, nb, R, bands, max_nb = bsrc_arrays(
            csr, bm, bk, band_rows)
        return cls.from_arrays(lrows, cols, blocks, csr.shape, csr.nnz, nb, R,
                               bands, max_nb, device=device,
                               dtype=torch_dtype(value_dtype(csr)))


def _check(kernel: str, a: DeviceBSRCol, x: torch.Tensor,
           dtype: torch.dtype) -> None:
    if x.dim() != 2 or x.shape[0] != a.shape[1]:
        raise ValueError(f"x must be ({a.shape[1]}, n), got {tuple(x.shape)}")
    check_operands(kernel, x.device, x=(x, dtype), blocks=(a.blocks, dtype),
                   block_cols=(a.block_cols, torch.int32),
                   local_rows=(a.local_rows, torch.int32),
                   counts=(a.counts, torch.int32))


def launch_grid(a: DeviceBSRCol, n: int) -> Tuple[int, int, int]:
    """(CTAs, output columns a CTA, rows a CTA's slice) of the launch of
    the form ``a``'s blocks take at n columns on the current card, as
    ``spgrid_bsr_spmm_cstat`` (the column tile depends on the card's SM
    count) or ``spgrid_bsr_spmm_cstat_bf16`` (64 columns) sets it."""
    shape = (ctypes.c_int * 3)()
    entry = ("spgrid_bsr_spmm_cstat_bf16_shape"
             if a.blocks.dtype == torch.bfloat16
             else "spgrid_bsr_spmm_cstat_shape")
    _build.check(getattr(_build.library(), entry)(
        a.bands, a.band_rows, a.bm, n, ctypes.addressof(shape)),
        "bsr_spmm_cstat")
    return tuple(shape)


def x3_shape(a: DeviceBSRCol, n: int):
    """((CTAs, output columns a CTA, rows a CTA's slice) of the 3-pass
    form's launch, the bytes of its split planes) for ``a`` at n columns of
    X, as ``spgrid_bsr_spmm_cstat_bf16x3_shape`` reports them."""
    shape = (ctypes.c_int * 3)()
    scratch = ctypes.c_longlong()
    with torch.cuda.device(a.blocks.device):
        _build.check(_build.library().spgrid_bsr_spmm_cstat_bf16x3_shape(
            a.bands, a.max_nb, a.band_rows, a.bm, a.bk, a.shape[1], n,
            ctypes.addressof(shape), ctypes.addressof(scratch)),
            "bsr_spmm_cstat_bf16x3")
    return tuple(shape), scratch.value


def _run(wrapper, a: DeviceBSRCol, x: torch.Tensor, dtype: torch.dtype,
         plain=None) -> torch.Tensor:
    kernel = wrapper.__name__
    _check(kernel, a, x, dtype)
    if runs_plain(kernel, x.device):
        return (plain or bsr_spmm_cstat_plain)(a, x)
    if a.bm > BM_MAX:
        raise ValueError(f"{kernel}: the kernel takes bm <= {BM_MAX}, got "
                         f"{a.bm}")
    m, k = a.shape
    n = x.shape[1]
    y = torch.empty((m, n), dtype=dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    lib = _build.library()
    scratch = ()
    if wrapper is bsr_spmm_cstat_bf16x3:
        planes = torch.empty(x3_shape(a, n)[1], dtype=torch.uint8,
                             device=x.device)
        scratch = (planes.data_ptr(),)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, "spgrid_" + kernel)(
            a.counts.data_ptr(), a.local_rows.data_ptr(),
            a.block_cols.data_ptr(), a.blocks.data_ptr(), x.data_ptr(),
            y.data_ptr(), *scratch, a.bands, a.max_nb, a.band_rows, a.bm,
            a.bk, m, k, n, stream)
    _build.check(code, kernel)
    wrapper.launches += 1
    return y


def bsr_spmm_cstat(a: DeviceBSRCol, x: torch.Tensor,
                   precision=None) -> torch.Tensor:
    """Y (m, n) = A @ X in X's dtype at matmul ``precision`` (None: the
    dtype's own): f32 X (k, n) ('high': ``bsr_spmm_cstat_bf16x3``), or bf16
    X for bf16 blocks (``bsr_spmm_cstat_bf16``)."""
    check_form("bsr_spmm_cstat", x.dtype, precision=precision,
               other_precisions=OTHER_PRECISIONS)
    if x.dtype == torch.bfloat16:
        return bsr_spmm_cstat_bf16(a, x)
    if precision == "high":
        return bsr_spmm_cstat_bf16x3(a, x)
    return _run(bsr_spmm_cstat, a, x, torch.float32)


bsr_spmm_cstat.launches = 0


def bsr_spmm_cstat_bf16(a: DeviceBSRCol, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) bf16 = A @ X for bf16 blocks and bf16 X (k, n): each block's
    product summed in f32 and added into the f32 slab in block order, each
    element of Y rounded once."""
    return _run(bsr_spmm_cstat_bf16, a, x, torch.bfloat16)


bsr_spmm_cstat_bf16.launches = 0


def bsr_spmm_cstat_bf16x3(a: DeviceBSRCol, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) f32 = A @ X for f32 blocks and X (k, n) at matmul precision
    'high': three bf16 passes summed in f32 (``bsr_spmm_cstat_bf16x3_plain``
    says in what order)."""
    return _run(bsr_spmm_cstat_bf16x3, a, x, torch.float32,
                bsr_spmm_cstat_bf16x3_plain)


bsr_spmm_cstat_bf16x3.launches = 0


def _slot_tiles(a: DeviceBSRCol, x: torch.Tensor, dtype: torch.dtype):
    """The X tile of every slot, (S, bk, n) in ``dtype``: X padded with
    zero rows to whole block columns."""
    k, n = x.shape
    kb = -(-k // a.bk)
    xp = torch.zeros((kb * a.bk, n), dtype=dtype, device=x.device)
    xp[:k] = x
    return xp.view(kb, a.bk, n)[a.block_cols.long()]


def _slabs_sum(a: DeviceBSRCol, prod: torch.Tensor) -> torch.Tensor:
    """The slots' products (S, bm, n) added into their bands' slabs in slot
    order (``index_add_``; pad slots land in the window past the band's
    rows, which is dropped), as Y (m, n)."""
    n = prod.shape[2]
    bm, R = a.bm, a.band_rows
    windows = R // bm + 1
    band = torch.arange(a.bands, device=prod.device).repeat_interleave(
        a.max_nb)
    out = torch.zeros((a.bands * windows, bm, n), dtype=prod.dtype,
                      device=prod.device)
    out.index_add_(0, band * windows + a.local_rows.long(), prod)
    out = out.view(a.bands, windows * bm, n)[:, :R]
    return out.reshape(a.bands * R, n)[:a.shape[0]]


def bsr_spmm_cstat_bf16x3_plain(a: DeviceBSRCol,
                                x: torch.Tensor) -> torch.Tensor:
    """The 3-pass form's product in plain torch, f32: each slot's block
    times its X tile by ``bmm_bf16x3`` (each pass's sum in f64 rounded once
    to f32, the cross passes added, then the hi pass), added into its
    band's slab in slot order, as the Pallas kernel's ``out_ref[win] +=``
    does."""
    return _slabs_sum(a, bmm_bf16x3(a.blocks, _slot_tiles(
        a, x, torch.float32)))


def bsr_spmm_cstat_plain(a: DeviceBSRCol, x: torch.Tensor) -> torch.Tensor:
    """The same product in plain torch, in x's dtype: gather the X tile of
    every slot, one batched matmul over the slots, ``index_add_`` into the
    bands' slabs in slot order (pad slots land in the window past the
    band's rows, which is dropped). bf16: the products and the slabs in
    f32, Y rounded once."""
    acc = acc_dtype(x)
    prod = torch.bmm(a.blocks.to(acc), _slot_tiles(a, x, acc))  # (S, bm, n)
    return _slabs_sum(a, prod).to(x.dtype)
