"""Merge-path SpMM as torch ops — the counterpart of ``DeviceMerge`` and
``merge_spmm`` in ``spgrid/ops/merge.py``.

The layout is the JAX one, array for array: the nnz stream cut into blocks
of ``block_nnz`` (512) nonzeros, each block cut early so that it spans at
most ``ROWS_CAP`` (128) rows; per block the nnz's columns, values and rows
local to the block's first row (pads: column 0, value 0, local 0); and
``out_rows``, the global row of each (block, local) pair, clipped to the
sacrificial row m. Every block carries the same work whatever the skew.

A block's gathered X rows reduce into its 128-row strip by a
value-weighted one-hot matmul, as the JAX package does (``torch.bmm``, TF32
off), in chunks of blocks whose gathered rows and one-hot weights stay
under 4 x ``_CHUNK_BYTES``; a chunk's strips and the strip rows its fix-up
reads each take at most a quarter of its gathered rows (ROWS_CAP of
block_nnz rows), and their sums the chunk's rows of Y. The merge-path carry fix-up then adds the
strip rows into their global rows: the strip rows a block's nnz reach
(locals 0 up to its last) ascend in global row block after block
(``fix_rows``), so ``xla.segment_sum`` at ``row_ptr``, each global row's
first among them, sums them into Y's rows, an empty row 0. In one chunk
(every call at n = 512 up to 1,024 blocks) its result is Y; over several,
each chunk writes the rows it reaches, and a row that a chunk edge cuts
takes the later part as one add to the part written before. Sums run in
f32 (f64 for an f64 X). No element takes two adds in one launch, so a call
gives the same bits every time.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from spgrid_torch.formats.csr import CSRMatrix, value_dtype
from spgrid_torch.ops.dense import at_high, full_f32
from spgrid_torch.ops.layouts import nbytes, to_device, values_to_device
from spgrid_torch.ops.xla import acc_dtype, segment_sum

ROWS_CAP = 128
_CHUNK_BYTES = 1 << 28      # intermediate budget a chunk of blocks, over 4


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
    fix_rows: torch.Tensor      # (F,) int64, the strip rows reached
    row_ptr: torch.Tensor       # (m+1,) int64: each global row's first
                                # entry of fix_rows
    fix_ptr: np.ndarray         # (B+1,) host: block b's entries of fix_rows
    row_ptr_host: np.ndarray    # host copy of row_ptr
    name: str = "merge"

    @property
    def nbytes(self) -> int:
        return nbytes(self.cols, self.values, self.local_rows, self.out_rows,
                      self.fix_rows, self.row_ptr)

    @classmethod
    def from_csr(cls, csr: CSRMatrix, block_nnz: int = 512, *,
                 device) -> "DeviceMerge":
        cols, vals, local_rows, out_rows = merge_arrays(csr, block_nnz)
        # strip rows 0 .. last local of each block (pads are local 0)
        reach = local_rows.max(axis=1, initial=0).astype(np.int64) + 1
        fix_ptr = np.concatenate([[0], np.cumsum(reach)])
        block = np.repeat(np.arange(len(reach), dtype=np.int64), reach)
        strip = (block * ROWS_CAP + np.arange(block.size, dtype=np.int64)
                 - np.repeat(fix_ptr[:-1], reach))
        row_ptr = np.searchsorted(out_rows[strip],
                                  np.arange(csr.m + 1)).astype(np.int64)
        return cls(to_device(cols, device),
                   values_to_device(vals, device, value_dtype(csr)),
                   to_device(local_rows, device), to_device(out_rows, device),
                   tuple(csr.shape), csr.nnz, block_nnz,
                   to_device(strip, device), to_device(row_ptr, device),
                   fix_ptr, row_ptr, csr.name)


def merge_spmm(a: DeviceMerge, x: torch.Tensor,
               precision=None) -> torch.Tensor:
    """Y = A @ X with the layout's nnz balance; x may be (k,) or (k, n). At
    matmul ``precision`` 'high' the one-hot product by ``dense.at_high``."""
    squeeze = x.dim() == 1
    x2 = x[:, None] if squeeze else x
    B, T = a.cols.shape
    m = a.shape[0]
    n = x2.shape[1]
    acc = acc_dtype(x2)
    if B == 0:
        y = torch.zeros((m, n), dtype=acc, device=x.device)
        return (y[:, 0] if squeeze else y).to(x.dtype)
    full_f32()
    # blocks a chunk: the gathered rows (T n a block) and the one-hot
    # weights (ROWS_CAP T) come to 4 x _CHUNK_BYTES at most
    chunk = max(1, int(_CHUNK_BYTES // (T * max(n, ROWS_CAP) * 4)) * 4)
    y = None if B <= chunk else torch.empty((m, n), dtype=acc,
                                            device=x.device)
    q0 = 0          # the first row of the chunk's sums
    for b0 in range(0, B, chunk):
        b1 = min(b0 + chunk, B)
        g = x2.index_select(0, a.cols[b0:b1].reshape(-1)).to(
            acc).reshape(b1 - b0, T, n)
        onehot = torch.zeros((b1 - b0, ROWS_CAP, T), dtype=acc,
                             device=x.device).scatter_(
            1, a.local_rows[b0:b1, None, :].long(),
            a.values[b0:b1, None, :].to(acc))
        strips = (at_high(torch.bmm, onehot, g) if precision == "high"
                  else torch.bmm(onehot, g)).view(-1, n)
        del g, onehot
        lo, hi = int(a.fix_ptr[b0]), int(a.fix_ptr[b1])
        reached = strips.index_select(0, a.fix_rows[lo:hi] - b0 * ROWS_CAP)
        del strips
        # rows q0 .. q1: q1 holds the chunk's last reached strip row, or is
        # the last row of Y
        q1 = (m - 1 if b1 == B
              else int(np.searchsorted(a.row_ptr_host, hi - 1, "right")) - 1)
        sums = segment_sum(reached,
                           a.row_ptr[q0:q1 + 2].clamp(lo, hi) - lo)
        if y is None:
            y = sums
        elif b0 == 0:
            y[:q1 + 1] = sums
        else:
            # row q0 was written by the chunk before
            y[q0:q0 + 1].add_(sums[:1])
            y[q0 + 1:q1 + 1] = sums[1:]
        q0 = q1
    y = y.to(x.dtype)
    return y[:, 0] if squeeze else y
