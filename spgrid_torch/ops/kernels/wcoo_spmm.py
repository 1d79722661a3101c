"""Windowed slot-chunk COO SpMM: Y = A @ X with A in DeviceWCOO layout.

Counterpart of ``spgrid/ops/pallas/wcoo_spmm.py`` (format ``wcoo_pallas``);
the CUDA kernel is ``spgrid_torch/csrc/wcoo_spmm.cu``. ``wcoo_spmm`` takes
X (k, n) and returns Y (m, n): no transposed XT/YT and no padding of X.
It launches the kernel for CUDA tensors and takes ``wcoo_spmm_plain`` only
for CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from spgrid_torch.formats.wcoo import LANE, WCOOMatrix, csr_to_wcoo
from spgrid_torch.ops.kernels import _build, check_operands
from spgrid_torch.ops.layouts import group_ptr, to_device


@dataclasses.dataclass
class DeviceWCOO:
    """The slot arrays and chunk windows of
    ``spgrid.ops.pallas.wcoo_spmm.DeviceWCOO`` on a torch device, with
    ``tile_ptr``/``tile_chunks``, the chunks of each 128-row tile (a row
    block's chunks are consecutive, its subblocks are not), in place of the
    chunks' row block, subblock and first-chunk flag."""

    cols: torch.Tensor            # (nchunks_pad8, 128) int32, col in window
    rows: torch.Tensor            # (nchunks_pad8, 128) int32, row in subblock
    values: torch.Tensor          # (nchunks_pad8, 128), 0 in pad slots
    chunk_window: torch.Tensor    # (nchunks,) int32
    tile_ptr: torch.Tensor        # (tiles+1,) int32
    tile_chunks: torch.Tensor     # (nchunks,) int32
    shape: Tuple[int, int]
    nnz: int
    R: int                        # rows of a row block, a multiple of 128
    utilization: float
    name: str = "wcoo"

    @property
    def num_rowblocks(self) -> int:
        return -(-self.shape[0] // self.R)

    @property
    def tiles(self) -> int:
        return len(self.tile_ptr) - 1

    def chunk_tile(self) -> torch.Tensor:
        """(nchunks,) int64: the 128-row tile (row block · R/128 + subblock)
        each chunk lands on, from ``tile_ptr``/``tile_chunks``."""
        dev = self.tile_ptr.device
        owner = torch.repeat_interleave(torch.arange(self.tiles, device=dev),
                                        torch.diff(self.tile_ptr).long())
        tile = torch.empty(len(self.chunk_window), dtype=torch.long,
                           device=dev)
        tile[self.tile_chunks.long()] = owner
        return tile

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.cols, self.rows, self.values, self.chunk_window,
            self.tile_ptr, self.tile_chunks))

    @classmethod
    def from_arrays(cls, cols, rows, values, chunk_window, chunk_rowblock,
                    chunk_sub, shape, nnz: int, R: int,
                    utilization: float, name: str = "wcoo", *,
                    device) -> "DeviceWCOO":
        if R % LANE or np.asarray(cols).shape[1:] != (LANE,):
            raise ValueError(f"the kernel takes W = {LANE} slots and R a "
                             f"multiple of {LANE}, got "
                             f"{np.asarray(cols).shape[1:]} and R={R}")
        subs = R // LANE
        tile = (np.asarray(chunk_rowblock, np.int64) * subs
                + np.asarray(chunk_sub, np.int64))
        ptr, order = group_ptr(tile, -(-shape[0] // R) * subs)
        return cls(cols=to_device(cols, device, np.int32),
                   rows=to_device(rows, device, np.int32),
                   values=to_device(values, device),
                   chunk_window=to_device(chunk_window, device, np.int32),
                   tile_ptr=to_device(ptr, device),
                   tile_chunks=to_device(order, device), shape=tuple(shape),
                   nnz=int(nnz), R=int(R), utilization=float(utilization),
                   name=name)

    @classmethod
    def from_wcoo(cls, w: WCOOMatrix, *, device) -> "DeviceWCOO":
        return cls.from_arrays(w.cols_in_window, w.row_local, w.values,
                               w.chunk_window, w.chunk_rowblock, w.chunk_sub,
                               w.shape, w.nnz, w.R, w.utilization, w.name,
                               device=device)

    @classmethod
    def from_csr(cls, csr, R: int = 1024, *, device) -> "DeviceWCOO":
        return cls.from_wcoo(csr_to_wcoo(csr, R=R), device=device)


def wcoo_spmm(a: DeviceWCOO, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) f32 = A @ X for f32 X (k, n)."""
    if x.dim() != 2 or x.shape[0] != a.shape[1]:
        raise ValueError(f"x must be ({a.shape[1]}, n), got {tuple(x.shape)}")
    check_operands("wcoo_spmm", x.device, x=(x, torch.float32),
                   values=(a.values, torch.float32),
                   cols=(a.cols, torch.int32), rows=(a.rows, torch.int32),
                   chunk_window=(a.chunk_window, torch.int32),
                   tile_ptr=(a.tile_ptr, torch.int32),
                   tile_chunks=(a.tile_chunks, torch.int32))
    if x.device.type == "cpu":
        return wcoo_spmm_plain(a, x)
    if x.device.type != "cuda":
        raise ValueError(f"wcoo_spmm: no kernel for device {x.device}")
    m, k = a.shape
    n = x.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.spgrid_wcoo_spmm(
            a.tile_ptr.data_ptr(), a.tile_chunks.data_ptr(),
            a.chunk_window.data_ptr(), a.cols.data_ptr(), a.rows.data_ptr(),
            a.values.data_ptr(), x.data_ptr(), y.data_ptr(), a.tiles, m, k,
            n, stream)
    _build.check(code, "wcoo_spmm")
    wcoo_spmm.launches += 1
    return y


wcoo_spmm.launches = 0


def wcoo_spmm_plain(a: DeviceWCOO, x: torch.Tensor) -> torch.Tensor:
    """The same product in plain torch, in x's dtype: every live slot (value
    not 0, X row inside X) gathers its row of X, scaled by its value, and
    ``index_add_`` sums them into its row of Y."""
    m, k = a.shape
    nch = len(a.chunk_window)
    vals = a.values[:nch].reshape(-1)
    xrow = (a.chunk_window.long()[:, None] * LANE
            + a.cols[:nch].long()).reshape(-1)
    row = (a.chunk_tile()[:, None] * LANE + a.rows[:nch].long()).reshape(-1)
    live = (vals != 0) & (xrow < k)
    y = torch.zeros((m, x.shape[1]), dtype=x.dtype, device=x.device)
    y.index_add_(0, row[live], vals[live].to(x.dtype)[:, None] * x[xrow[live]])
    return y
