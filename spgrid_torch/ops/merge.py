"""Merge-path SpMM as torch ops — the counterpart of ``DeviceMerge`` and
``merge_spmm`` in ``spgrid/ops/merge.py``.

The layout is the JAX one, array for array: the nnz stream cut into blocks
of ``block_nnz`` (512) nonzeros, each block cut early so that it spans at
most ``ROWS_CAP`` (128) rows; per block the nnz's columns, values and rows
local to the block's first row (pads: column 0, value 0, local 0); and
``out_rows``, the global row of each (block, local) pair, clipped to the
sacrificial row m. Every block carries the same work whatever the skew.

The JAX package reduces a block's gathered X rows into its 128-row strip
by a value-weighted one-hot matmul, the TPU's way to scatter on its matrix
unit; the port scatters the weighted rows into the strips directly
(``index_add_``), then adds the strips into their global rows through
``out_rows``, the merge-path carry fix-up, in chunks of blocks under the
same ``_CHUNK_BYTES`` budget. Sums run in f32 (f64 for an f64 X). On a
CUDA device ``index_add_`` adds with atomics, so the last bits may differ
from call to call.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from spgrid_torch.formats.csr import CSRMatrix
from spgrid_torch.ops.layouts import nbytes, to_device
from spgrid_torch.ops.xla import acc_dtype

ROWS_CAP = 128
_CHUNK_BYTES = 1 << 28      # gathered-intermediate budget a chunk of blocks


def merge_arrays(csr: CSRMatrix, block_nnz: int = 512):
    """Host arrays of the layout, as ``spgrid.ops.merge.DeviceMerge``
    builds them: (cols (B, T) int32, values (B, T), local_rows (B, T)
    int32, out_rows (B * ROWS_CAP,) int32)."""
    m, _ = csr.shape
    T = block_nnz
    rows = np.repeat(np.arange(max(m, 1), dtype=np.int64), csr.degrees)
    cols = csr.col_idx.astype(np.int64)
    vals = np.asarray(csr.values)
    nnz = csr.nnz

    # cut points: every T nnz, and earlier where a block would span more
    # than ROWS_CAP rows
    cuts = [0]
    while cuts[-1] < nnz:
        s = cuts[-1]
        e = min(s + T, nnz)
        limit_row = rows[s] + ROWS_CAP
        if e > s and rows[e - 1] >= limit_row:
            e = int(np.searchsorted(rows, limit_row, side="left"))
            e = max(e, s + 1)
        cuts.append(e)
    B = len(cuts) - 1
    starts = np.asarray(cuts[:-1], dtype=np.int64)

    cols_b = np.zeros((B, T), np.int32)
    vals_b = np.zeros((B, T), vals.dtype)
    locals_b = np.zeros((B, T), np.int32)
    base_rows = rows[starts] if nnz else np.zeros(B, np.int64)
    for b in range(B):
        s, e = cuts[b], cuts[b + 1]
        cols_b[b, : e - s] = cols[s:e]
        vals_b[b, : e - s] = vals[s:e]
        locals_b[b, : e - s] = rows[s:e] - base_rows[b]
    out_rows = np.minimum(base_rows[:, None]
                          + np.arange(ROWS_CAP, dtype=np.int64)[None, :],
                          m).astype(np.int32)
    return cols_b, vals_b, locals_b, out_rows.reshape(-1)


@dataclasses.dataclass
class DeviceMerge:
    """Equal-nnz blocks on a torch device (see the module docstring)."""

    cols: torch.Tensor          # (B, T) int32
    values: torch.Tensor        # (B, T)
    local_rows: torch.Tensor    # (B, T) int32
    out_rows: torch.Tensor      # (B * ROWS_CAP,) int32
    shape: Tuple[int, int]
    nnz: int
    block_nnz: int
    name: str = "merge"

    @property
    def nbytes(self) -> int:
        return nbytes(self.cols, self.values, self.local_rows, self.out_rows)

    @classmethod
    def from_csr(cls, csr: CSRMatrix, block_nnz: int = 512, *,
                 device) -> "DeviceMerge":
        cols, vals, local_rows, out_rows = merge_arrays(csr, block_nnz)
        return cls(to_device(cols, device), to_device(vals, device),
                   to_device(local_rows, device), to_device(out_rows, device),
                   tuple(csr.shape), csr.nnz, block_nnz, csr.name)


def merge_spmm(a: DeviceMerge, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X with the layout's nnz balance; x may be (k,) or (k, n)."""
    squeeze = x.dim() == 1
    x2 = x[:, None] if squeeze else x
    B, T = a.cols.shape
    m = a.shape[0]
    n = x2.shape[1]
    acc = acc_dtype(x2)
    y = torch.zeros((m + 1, n), dtype=acc, device=x.device)
    # blocks a chunk, as the JAX package cuts them: the gathered rows come
    # to 4 x _CHUNK_BYTES at most (f32) and the strips to ROWS_CAP / T of
    # that; the weights multiply the gathered rows in place
    chunk = max(1, int(_CHUNK_BYTES // max(T * n * 4, 1)) * 4)
    for b0 in range(0, B, chunk):
        b1 = min(b0 + chunk, B)
        weighted = x2.index_select(0, a.cols[b0:b1].reshape(-1)).to(
            acc).mul_(a.values[b0:b1].reshape(-1, 1).to(acc))
        strip = (a.local_rows[b0:b1] + ROWS_CAP * torch.arange(
            b1 - b0, device=x.device)[:, None]).reshape(-1)
        strips = torch.zeros(((b1 - b0) * ROWS_CAP, n), dtype=acc,
                             device=x.device)
        strips.index_add_(0, strip, weighted)
        y.index_add_(0, a.out_rows[b0 * ROWS_CAP:b1 * ROWS_CAP], strips)
    y = y[:m].to(x.dtype)
    return y[:, 0] if squeeze else y
