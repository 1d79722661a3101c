"""Gather-ELL SpMM as torch ops — the counterpart of ``DeviceGELL`` and
``gell_spmm`` in ``spgrid/ops/gell.py`` (formats ``gell``, ``gell16`` and
``cv_gell``).

The layout is the JAX one: S slots a row (``ceil(1.25 x the mean
degree)``, or the largest degree where that is at most 2 more), m padded
to a multiple of 8, the first S nnz of each row in its slots (pads: column
0, value 0) and the rest in a row-sorted COO tail. The JAX package's gather
windows (``_plan_windows``) are left out: they dodge a v5e gather-rate
cliff and define no numeric class.

A call gathers the X rows of a chunk of rows' slots (``_chunk_rows``, under
the JAX package's 3 GB budget less the resident operands), multiplies them
in place by the slot values and sums over the slots in f32, then sums the
tail's products a row (``xla.segment_sum`` at ``tail_ptr``) and adds each
row's sum to its row once. The gather is f32 in every mode, 4
bytes an element (the JAX package gathers bf16 planes), so a chunk holds
as many rows as the budget takes at 4n bytes a slot. The modes carry the JAX modes' numeric
classes, not their bf16 planes:

- ``f32`` (``gell``): X and the values as they are: exact.
- ``split16`` (``gell16``): X' = hi + lo with hi = X truncated to bf16 (an
  integer mask, as ``_trunc_bf16``) and lo = X - hi rounded to bf16, and
  the values split the same way, both formed once a call.
- ``bf16`` (``cv_gell``): X' = X rounded to bf16, the values split as in
  ``split16``.

The tail multiplies its f32 values by X', as ``_add_tail`` does. No
element takes two adds in one launch, so a call gives the same bits every
time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from spgrid_torch.formats.csr import CSRMatrix
from spgrid_torch.ops.layouts import nbytes, round_up, to_device
from spgrid_torch.ops.xla import segment_sum

MODES = ("f32", "split16", "bf16")
_CHUNK_BUDGET = 3 << 30     # bytes of gathered intermediate a chunk
_MIN_BUDGET = 1 << 28       # the budget's floor once the residents are off


def gell_arrays(csr: CSRMatrix, slots: Optional[int] = None):
    """Host arrays of the layout, as ``spgrid.ops.gell.DeviceGELL`` builds
    them: (cols (m_pad, S) int32, values (m_pad, S) f32, tail_rows,
    tail_cols, tail_vals, S)."""
    m, _ = csr.shape
    deg = csr.degrees
    if slots is None:
        avg = csr.nnz / max(m, 1)
        slots = max(1, int(np.ceil(avg * 1.25)))
        # a slightly wider ELL that holds everything beats a tail
        if deg.size and int(deg.max()) <= slots + 2:
            slots = int(deg.max())
    slots = max(1, slots)
    m_pad = round_up(max(m, 1), 8)
    cols = np.zeros((m_pad, slots), dtype=np.int32)
    vals = np.zeros((m_pad, slots), dtype=np.float32)
    row_of = np.repeat(np.arange(m, dtype=np.int64), deg)
    within = (np.arange(csr.nnz, dtype=np.int64)
              - np.repeat(csr.row_ptr[:-1].astype(np.int64), deg))
    take = within < slots
    cols[row_of[take], within[take]] = csr.col_idx[take].astype(np.int32)
    vals[row_of[take], within[take]] = csr.values[take]
    tail = ~take
    return (cols, vals, row_of[tail].astype(np.int32),
            csr.col_idx[tail].astype(np.int32),
            csr.values[tail].astype(np.float32), slots)


@dataclasses.dataclass
class DeviceGELL:
    """ELL slots (m_pad, S) and a row-sorted COO tail on a torch device
    (see the module docstring); ``mode`` is one of ``MODES``. The tail's
    rows are held as the rows that have a tail (``tail_keys``) and the
    pointer of their runs (``tail_ptr``): the JAX ``tail_rows`` are
    ``np.repeat(tail_keys, diff(tail_ptr))``."""

    cols: torch.Tensor        # (m_pad, S) int32
    values: torch.Tensor      # (m_pad, S) f32
    tail_keys: torch.Tensor   # (r,) int64, ascending
    tail_ptr: torch.Tensor    # (r+1,) int64
    tail_cols: torch.Tensor   # (t,) int32
    tail_vals: torch.Tensor   # (t,) f32
    shape: Tuple[int, int]
    nnz: int
    slots: int
    mode: str
    name: str = "gell"

    @property
    def nbytes(self) -> int:
        return nbytes(self.cols, self.values, self.tail_keys, self.tail_ptr,
                      self.tail_cols, self.tail_vals)

    @classmethod
    def from_csr(cls, csr: CSRMatrix, slots: Optional[int] = None,
                 mode: str = "f32", *, device) -> "DeviceGELL":
        if mode not in MODES:
            raise ValueError(f"gell: mode must be one of {MODES}, got "
                             f"{mode!r}")
        cols, vals, trows, tcols, tvals, slots = gell_arrays(csr, slots)
        keys, starts = np.unique(trows, return_index=True)
        ptr = np.append(starts, trows.size)
        return cls(*(to_device(a, device, dtype) for a, dtype in (
                       (cols, None), (vals, None), (keys, np.int64),
                       (ptr, np.int64), (tcols, None), (tvals, None))),
                   shape=tuple(csr.shape), nnz=csr.nnz, slots=slots,
                   mode=mode, name=csr.name)


def trunc_bf16(t: torch.Tensor) -> torch.Tensor:
    """f32 truncated to a bf16-representable f32 by masking the low 16 bits
    (an integer AND, as the JAX package's ``_trunc_bf16``)."""
    return (t.view(torch.int32) & -0x10000).view(torch.float32)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to the nearest bf16, ties to even, back in f32."""
    return t.to(torch.bfloat16).to(torch.float32)


def split16(t: torch.Tensor) -> torch.Tensor:
    """hi + lo: hi = ``trunc_bf16(t)``, lo = ``round_bf16(t - hi)``; the sum
    is exact in f32 (16 significant bits)."""
    hi = trunc_bf16(t)
    return hi + round_bf16(t - hi)


def gathered_x(x: torch.Tensor, mode: str) -> torch.Tensor:
    """The X that ``mode`` gathers (f32): X, ``split16(X)`` or X rounded to
    bf16. The gate of ``gell16`` and ``cv_gell`` holds a row to the f64
    product on this X."""
    if mode == "split16":
        return split16(x)
    if mode == "bf16":
        return round_bf16(x)
    return x


def _chunk_rows(m_pad: int, slots: int, n: int,
                budget: Optional[int] = None) -> int:
    """Rows a chunk, a multiple of 8, so that its gathered f32 rows (4n
    bytes a slot, the chunk's one intermediate) stay under ``budget``
    bytes; at least 8 (the JAX package's ``_chunk_rows``)."""
    if budget is None:
        budget = _CHUNK_BUDGET
    per_row = max(slots * n * 4, 1)
    rows = max(budget // per_row, 8)
    rows = min(rows, m_pad)
    return -(-rows // 8) * 8


def gell_spmm(a: DeviceGELL, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X in the layout's mode, summed in f32; x may be (k,) or
    (k, n)."""
    squeeze = x.dim() == 1
    x2 = x[:, None] if squeeze else x
    m = a.shape[0]
    m_pad, S = a.cols.shape
    n = x2.shape[1]
    xg = gathered_x(x2.to(torch.float32), a.mode)
    vals = a.values if a.mode == "f32" else split16(a.values)
    resident = 2 * x2.numel() * 4 + m_pad * n * 4
    rb = _chunk_rows(m_pad, S, n,
                     budget=max(_CHUNK_BUDGET - resident, _MIN_BUDGET))
    y = torch.empty((m_pad, n), dtype=torch.float32, device=x.device)
    for r0 in range(0, m_pad, rb):
        r1 = min(r0 + rb, m_pad)
        g = xg.index_select(0, a.cols[r0:r1].reshape(-1)).reshape(
            r1 - r0, S, n)
        torch.sum(g.mul_(vals[r0:r1, :, None]), dim=1, out=y[r0:r1])
    y = y[:m]
    if a.tail_cols.numel():
        tail = xg.index_select(0, a.tail_cols).mul_(a.tail_vals[:, None])
        y.index_add_(0, a.tail_keys, segment_sum(tail, a.tail_ptr))
    y = y.to(x.dtype)
    return y[:, 0] if squeeze else y
