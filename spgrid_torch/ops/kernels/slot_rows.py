"""The row-ordered live-slot stream that the two slot SpMM kernels read
(``spgrid_torch/csrc/slot_rows.cuh``): its host build, the walk's launch
shape, its launch and its product in plain torch.

The padded layouts (WCOO chunks, banded groups) hold mostly empty slots:
pad slots, coverage chunks, pad groups, slots whose X row lies past k. The
stream keeps only the live slots (value not 0, X row inside X), each as its
f32 value and its whole X row (int32), ordered by output row and, within a
row, in the layout's slot order, so the order of each row's sum is fixed.
``row_slot`` (m + 1,) int32 points at each row's slots: row r's are
``row_slot[r]:row_slot[r + 1]``; ``long_rows`` lists the rows of more than
``LONG_ROW`` slots, which a second kernel walks a CTA a row. Layouts build
the stream in ``from_arrays`` (``wcoo_spmm.wcoo_row_stream``,
``wcoo_spmm_aligned.bands_row_stream``, both through ``row_stream``);
``wcoo_spmm`` and ``wcoo_spmm_aligned`` read it on the card, their plain
versions keep reading the padded arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from spgrid_torch.ops.kernels import _build, check_operands
from spgrid_torch.ops.layouts import to_device

SLAB = 128           # columns of a warp's slab for each C
MAX_SLOTS = 2 ** 31 - 1024

# The walk (csrc/slot_rows.cuh): a CTA of WARPS warps, a warp a row; a warp
# covers a slab of 128 C columns, C float4 (or 4 C floats) a lane, C chosen
# from n by the kernel's launch (``walk_shape`` repeats the choice).
WARPS = 8
UNROLL_LOADS = 4     # U C 16-byte X loads in flight a lane: U = 4 / C
LONG_ROW = 128       # rows of more slots go to the long-row walk


def stream_order(rows, xrows, values, m: int, k: int):
    """(order, row_slot (m + 1,) int32): the indices of the live slots
    among slots given in the layout's order, each with its output row and
    X row, stably sorted by output row (the stream's order), and where
    each row's begin there."""
    rows = np.asarray(rows, np.int64).reshape(-1)
    xrows = np.asarray(xrows, np.int64).reshape(-1)
    values = np.asarray(values).reshape(-1)
    live = np.flatnonzero((values != 0) & (xrows < k))
    if live.size >= MAX_SLOTS:
        raise ValueError("row stream: too many slots for int32")
    rows = rows[live]
    if rows.size and (rows.min() < 0 or rows.max() >= m):
        raise ValueError(f"row stream: a live slot's row lies outside "
                         f"0..{m - 1}")
    counts = np.bincount(rows, minlength=m)
    return (live[np.argsort(rows, kind="stable")],
            np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))


def row_stream(rows, xrows, values, m: int, k: int):
    """(row_slot (m + 1,) int32, values (S,), X rows (S,) int32, long rows
    (L,) int32) of the live slots among slots given in the layout's order,
    each with its output row and X row: stably sorted by output row
    (``stream_order``)."""
    order, row_slot = stream_order(rows, xrows, values, m, k)
    return (row_slot, np.asarray(values).reshape(-1)[order],
            np.asarray(xrows).reshape(-1)[order].astype(np.int32),
            np.flatnonzero(np.diff(row_slot) > LONG_ROW).astype(np.int32))


STREAM_FIELDS = ("row_slot", "slot_vals", "slot_xrows", "long_rows")


class RowStream:
    """What the layouts that carry a row stream (``stream_fields``, all of
    ``STREAM_FIELDS`` unless a layout says otherwise) share."""

    stream_fields = STREAM_FIELDS

    @property
    def num_slots(self) -> int:
        return len(self.slot_vals)

    @property
    def stream_nbytes(self) -> int:
        """Bytes of what the kernel reads of the layout: the row stream."""
        return sum(getattr(self, f).numel() * getattr(self, f).element_size()
                   for f in self.stream_fields)


def stream_tensors(stream, device, fields=STREAM_FIELDS) -> dict:
    """``row_stream``'s arrays as the layout's ``fields`` (its first ones)
    on ``device``."""
    return {f: to_device(a, device) for f, a in zip(fields, stream)}


def walk_shape(m: int, n: int):
    """(CTAs along the rows, column slabs, C, U) of the walk: C float4 a
    lane, 1, 2 or 4 (128, 256 or 512 columns a warp), U = 4 / C."""
    c = 1 if n <= SLAB else 2 if n <= 2 * SLAB else 4
    return -(-m // WARPS), -(-n // (SLAB * c)), c, UNROLL_LOADS // c


def check_rows(kernel: str, a, x: torch.Tensor,
               values: torch.dtype = torch.float32) -> None:
    """Raise unless the row stream of ``a`` (its ``stream_fields``) is what
    the kernel takes: values of type ``values``, int32 otherwise."""
    check_operands(kernel, x.device, **{
        f: (getattr(a, f), values if f == "slot_vals" else torch.int32)
        for f in a.stream_fields})


def launch_rows(wrapper, symbol: str, a, x: torch.Tensor) -> torch.Tensor:
    """Launch the walk, and the long-row walk where ``a`` has long rows,
    through the C entry point ``symbol`` into a new Y of X's dtype; count
    the launch on ``wrapper`` (one, with or without the long-row walk)."""
    m = a.shape[0]
    n = x.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    num_long = len(a.long_rows)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, symbol)(
            a.row_slot.data_ptr(), a.slot_vals.data_ptr(),
            a.slot_xrows.data_ptr(), a.long_rows.data_ptr(), x.data_ptr(),
            y.data_ptr(), m, n, LONG_ROW, num_long, stream)
    _build.check(code, wrapper.__name__)
    wrapper.launches += 1
    return y


def rows_product(a, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X over the row stream of ``a``, in x's dtype: each live slot
    adds value · X[its X row] to its row (``index_add_``)."""
    m = a.shape[0]
    row = torch.repeat_interleave(torch.arange(m, device=x.device),
                                  torch.diff(a.row_slot.long()))
    y = torch.zeros((m, x.shape[1]), dtype=x.dtype, device=x.device)
    y.index_add_(0, row, a.slot_vals.to(x.dtype)[:, None]
                 * x[a.slot_xrows.long()])
    return y
