"""Windowed slot-chunk COO SpMM: Y = A @ X with A in DeviceWCOO layout.

Counterpart of ``spgrid/ops/pallas/wcoo_spmm.py`` (format ``wcoo_pallas``);
the CUDA kernel is ``spgrid_torch/csrc/wcoo_spmm.cu`` over the shared walk
of ``csrc/slot_rows.cuh``. ``wcoo_spmm`` takes X (k, n) and returns Y
(m, n): no transposed XT/YT and no padding of X. It launches the kernel for
CUDA tensors, which reads the layout's row-ordered live-slot stream
(``ops/kernels/slot_rows.py``), and takes ``wcoo_spmm_plain``, which reads
the padded chunks, only for CPU tensors. The kernel has two forms: f32 and
bf16 (``wcoo_spmm_bf16``: bf16 values and X, each product rounded to bf16
before it is added into the f32 sum, Y rounded once, as XLA computes the
Pallas body's ``g * vals`` at bf16 on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from spgrid_torch.formats.csr import value_dtype
from spgrid_torch.formats.wcoo import LANE, WCOOMatrix, csr_to_wcoo
from spgrid_torch.ops.kernels import check_form, check_operands, runs_plain
from spgrid_torch.ops.kernels.slot_rows import (
    RowStream, check_rows, launch_rows, row_stream, stream_tensors)
from spgrid_torch.ops.layouts import group_ptr, to_device, torch_dtype
from spgrid_torch.ops.xla import acc_dtype


def wcoo_row_stream(cols, rows, values, chunk_window, chunk_tile, shape):
    """The stream of a WCOO layout: slot s of chunk c (the chunk's pad rows
    past ``len(chunk_window)`` are not read) adds to row 128 tile + rows
    from X row 128 window + cols, in chunk and then slot order."""
    nch = len(chunk_window)
    xrows = (np.asarray(chunk_window, np.int64)[:, None] * LANE
             + np.asarray(cols)[:nch].astype(np.int64))
    out = (np.asarray(chunk_tile, np.int64)[:, None] * LANE
           + np.asarray(rows)[:nch].astype(np.int64))
    return row_stream(out, xrows, np.asarray(values)[:nch], *shape)


@dataclasses.dataclass
class DeviceWCOO(RowStream):
    """The slot arrays and chunk windows of
    ``spgrid.ops.pallas.wcoo_spmm.DeviceWCOO`` on a torch device, with
    ``tile_ptr``/``tile_chunks``, the chunks of each 128-row tile (a row
    block's chunks are consecutive, its subblocks are not), in place of the
    chunks' row block, subblock and first-chunk flag, and the row-ordered
    live-slot stream that the kernel reads (``slot_rows.py``)."""

    cols: torch.Tensor            # (nchunks_pad8, 128) int32, col in window
    rows: torch.Tensor            # (nchunks_pad8, 128) int32, row in subblock
    values: torch.Tensor          # (nchunks_pad8, 128) f32 or bf16, 0 in
                                  # pad slots
    chunk_window: torch.Tensor    # (nchunks,) int32
    tile_ptr: torch.Tensor        # (tiles+1,) int32
    tile_chunks: torch.Tensor     # (nchunks,) int32
    # the row stream: S live slots by output row, in chunk and slot order
    row_slot: torch.Tensor        # (m + 1,) int32, row r's live slots
    slot_vals: torch.Tensor       # (S,) value of each live slot (as
                                  # values)
    slot_xrows: torch.Tensor      # (S,) int32, X row of each live slot
    long_rows: torch.Tensor       # (L,) int32, rows of > LONG_ROW slots
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
        return self.stream_nbytes + sum(
            t.numel() * t.element_size() for t in (
                self.cols, self.rows, self.values, self.chunk_window,
                self.tile_ptr, self.tile_chunks))

    @classmethod
    def from_arrays(cls, cols, rows, values, chunk_window, chunk_rowblock,
                    chunk_sub, shape, nnz: int, R: int,
                    utilization: float, name: str = "wcoo", *, device,
                    dtype: torch.dtype = torch.float32) -> "DeviceWCOO":
        """The layout of a WCOO matrix's arrays, its values in ``dtype``
        (f32, or bf16 for a matrix whose values are bf16)."""
        if R % LANE or np.asarray(cols).shape[1:] != (LANE,):
            raise ValueError(f"the kernel takes W = {LANE} slots and R a "
                             f"multiple of {LANE}, got "
                             f"{np.asarray(cols).shape[1:]} and R={R}")
        subs = R // LANE
        tile = (np.asarray(chunk_rowblock, np.int64) * subs
                + np.asarray(chunk_sub, np.int64))
        ptr, order = group_ptr(tile, -(-shape[0] // R) * subs)
        stream = stream_tensors(
            wcoo_row_stream(cols, rows, values, chunk_window, tile, shape),
            device)
        stream["slot_vals"] = stream["slot_vals"].to(dtype)
        return cls(cols=to_device(cols, device, np.int32),
                   rows=to_device(rows, device, np.int32),
                   values=to_device(values, device).to(dtype),
                   chunk_window=to_device(chunk_window, device, np.int32),
                   tile_ptr=to_device(ptr, device),
                   tile_chunks=to_device(order, device),
                   **stream, shape=tuple(shape),
                   nnz=int(nnz), R=int(R), utilization=float(utilization),
                   name=name)

    @classmethod
    def from_wcoo(cls, w: WCOOMatrix, *, device,
                  dtype: torch.dtype = torch.float32) -> "DeviceWCOO":
        return cls.from_arrays(w.cols_in_window, w.row_local, w.values,
                               w.chunk_window, w.chunk_rowblock, w.chunk_sub,
                               w.shape, w.nnz, w.R, w.utilization, w.name,
                               device=device, dtype=dtype)

    @classmethod
    def from_csr(cls, csr, R: int = 1024, *, device) -> "DeviceWCOO":
        return cls.from_wcoo(csr_to_wcoo(csr, R=R), device=device,
                             dtype=torch_dtype(value_dtype(csr)))


def _run(wrapper, a: DeviceWCOO, x: torch.Tensor,
         dtype: torch.dtype) -> torch.Tensor:
    kernel = wrapper.__name__
    if x.dim() != 2 or x.shape[0] != a.shape[1]:
        raise ValueError(f"x must be ({a.shape[1]}, n), got {tuple(x.shape)}")
    check_operands(kernel, x.device, x=(x, dtype), values=(a.values, dtype),
                   cols=(a.cols, torch.int32), rows=(a.rows, torch.int32),
                   chunk_window=(a.chunk_window, torch.int32),
                   tile_ptr=(a.tile_ptr, torch.int32),
                   tile_chunks=(a.tile_chunks, torch.int32))
    check_rows(kernel, a, x, dtype)
    if runs_plain(kernel, x.device):
        return wcoo_spmm_plain(a, x)
    return launch_rows(wrapper, "spgrid_" + kernel, a, x)


def wcoo_spmm(a: DeviceWCOO, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) = A @ X in X's dtype: f32 X (k, n), or bf16 X for a bf16
    layout (``wcoo_spmm_bf16``)."""
    check_form("wcoo_spmm", x.dtype)
    if x.dtype == torch.bfloat16:
        return wcoo_spmm_bf16(a, x)
    return _run(wcoo_spmm, a, x, torch.float32)


wcoo_spmm.launches = 0


def wcoo_spmm_bf16(a: DeviceWCOO, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) bf16 = A @ X for a bf16 layout and bf16 X (k, n): each
    product rounded to bf16, added in f32 in the stream's order, each
    element of Y rounded once."""
    return _run(wcoo_spmm_bf16, a, x, torch.bfloat16)


wcoo_spmm_bf16.launches = 0


def wcoo_spmm_plain(a: DeviceWCOO, x: torch.Tensor) -> torch.Tensor:
    """The same product in plain torch, in x's dtype: every live slot (value
    not 0, X row inside X) gathers its row of X, scaled by its value, and
    ``index_add_`` sums them into its row of Y, in chunk and slot order.
    bf16: each product rounded to bf16 (the multiply in bf16), the sum in
    f32, Y rounded once."""
    m, k = a.shape
    nch = len(a.chunk_window)
    vals = a.values[:nch].reshape(-1)
    xrow = (a.chunk_window.long()[:, None] * LANE
            + a.cols[:nch].long()).reshape(-1)
    row = (a.chunk_tile()[:, None] * LANE + a.rows[:nch].long()).reshape(-1)
    live = (vals != 0) & (xrow < k)
    acc = acc_dtype(x)
    y = torch.zeros((m, x.shape[1]), dtype=acc, device=x.device)
    y.index_add_(0, row[live],
                 (vals[live].to(x.dtype)[:, None] * x[xrow[live]]).to(acc))
    return y.to(x.dtype)
