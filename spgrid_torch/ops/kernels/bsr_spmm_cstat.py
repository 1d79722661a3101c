"""C-stationary block-sparse SpMM: Y = A @ X with A in DeviceBSRCol layout.

Counterpart of ``spgrid/ops/pallas/bsr_spmm_cstat.py`` (format
``bsrc_pallas``); the CUDA kernel is ``spgrid_torch/csrc/bsr_spmm_cstat.cu``.
``bsr_spmm_cstat`` launches it for CUDA tensors and takes
``bsr_spmm_cstat_plain`` only for CPU tensors.

Rows are split into bands of R rows; a band's (bm, bk) blocks are sorted by
(block column, block row), so consecutive blocks share their X tile, and
each block adds into a window of the band's output slab. The kernel splits
each band's slab across CTAs: one CTA a (band, row slice of 128 // bm block
rows, 64 or 128 output columns), multiplying on the tensor cores in 3xTF32
(``launch_grid`` gives its grid).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from spgrid_torch.formats.bsr import csr_to_bsr
from spgrid_torch.ops.kernels import _build, check_operands
from spgrid_torch.ops.layouts import round_up, to_device

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
    blocks: torch.Tensor       # (bands*max_nb, bm, bk)
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
                    *, device) -> "DeviceBSRCol":
        """Host arrays → device layout; ``counts`` is recovered from the
        slots (pad slots sit at local block row R/bm)."""
        lrows = np.asarray(local_rows, np.int32)
        rows_per_band = int(band_rows) // np.asarray(blocks).shape[1]
        counts = (lrows.reshape(bands, max_nb) < rows_per_band).sum(axis=1)
        return cls(local_rows=to_device(lrows, device),
                   block_cols=to_device(block_cols, device, np.int32),
                   blocks=to_device(blocks, device),
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
                               bands, max_nb, device=device)


def _check(a: DeviceBSRCol, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] != a.shape[1]:
        raise ValueError(f"x must be ({a.shape[1]}, n), got {tuple(x.shape)}")
    check_operands("bsr_spmm_cstat", x.device, x=(x, torch.float32),
                   blocks=(a.blocks, torch.float32),
                   block_cols=(a.block_cols, torch.int32),
                   local_rows=(a.local_rows, torch.int32),
                   counts=(a.counts, torch.int32))


def launch_grid(a: DeviceBSRCol, n: int) -> Tuple[int, int, int]:
    """(CTAs, output columns a CTA, rows a CTA's slice) of the kernel's
    launch for ``a`` at n columns on the current card, as
    ``spgrid_bsr_spmm_cstat`` sets it (the column tile depends on the card's
    SM count)."""
    shape = (ctypes.c_int * 3)()
    _build.check(_build.library().spgrid_bsr_spmm_cstat_shape(
        a.bands, a.band_rows, a.bm, n, ctypes.addressof(shape)),
        "bsr_spmm_cstat")
    return tuple(shape)


def bsr_spmm_cstat(a: DeviceBSRCol, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) f32 = A @ X for f32 X (k, n)."""
    _check(a, x)
    if x.device.type == "cpu":
        return bsr_spmm_cstat_plain(a, x)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_spmm_cstat: no kernel for device {x.device}")
    if a.bm > BM_MAX:
        raise ValueError(f"bsr_spmm_cstat: the kernel takes bm <= {BM_MAX}, "
                         f"got {a.bm}")
    m, k = a.shape
    n = x.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.spgrid_bsr_spmm_cstat(
            a.counts.data_ptr(), a.local_rows.data_ptr(),
            a.block_cols.data_ptr(), a.blocks.data_ptr(), x.data_ptr(),
            y.data_ptr(), a.bands, a.max_nb, a.band_rows, a.bm, a.bk, m, k,
            n, stream)
    _build.check(code, "bsr_spmm_cstat")
    bsr_spmm_cstat.launches += 1
    return y


bsr_spmm_cstat.launches = 0


def bsr_spmm_cstat_plain(a: DeviceBSRCol, x: torch.Tensor) -> torch.Tensor:
    """The same product in plain torch, in x's dtype: gather the X tile of
    every slot, one batched matmul over the slots, ``index_add_`` into the
    bands' slabs (pad slots land in the window past the band's rows, which
    is dropped)."""
    m, k = a.shape
    n = x.shape[1]
    bm, bk, R = a.bm, a.bk, a.band_rows
    kb = -(-k // bk)
    xp = torch.zeros((kb * bk, n), dtype=x.dtype, device=x.device)
    xp[:k] = x
    xt = xp.view(kb, bk, n)[a.block_cols.long()]              # (S, bk, n)
    prod = torch.bmm(a.blocks.to(x.dtype), xt)                # (S, bm, n)
    windows = R // bm + 1
    band = torch.arange(a.bands, device=x.device).repeat_interleave(a.max_nb)
    out = torch.zeros((a.bands * windows, bm, n), dtype=x.dtype,
                      device=x.device)
    out.index_add_(0, band * windows + a.local_rows.long(), prod)
    out = out.view(a.bands, windows * bm, n)[:, :R]
    return out.reshape(a.bands * R, n)[:m]
