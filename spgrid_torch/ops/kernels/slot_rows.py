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

The SpMV row streams of a bf16 layout (WROW v1's, ``wcoo_spmv``'s) also
mark where each of a row's groups starts (``mark_groups``): their Pallas
bodies round each group's sum for a row to bf16 before adding it into the
f32 row, so the bf16 walks must know the groups. The mark is bit 31 of the
slot's x index (``GROUP_START``; an x index lies below 2^31), so the
stream keeps its 6 bytes a live slot; ``X_INDEX`` masks it off.
"""

from __future__ import annotations

import numpy as np
import torch

from spgrid_torch.ops.kernels import _build, check_operands
from spgrid_torch.ops.layouts import to_device
from spgrid_torch.ops.xla import segment_sum

SLAB = 128           # columns of a warp's slab for each C
MAX_SLOTS = 2 ** 31 - 1024

# The walk (csrc/slot_rows.cuh): a CTA of WARPS warps, a warp a row; a warp
# covers a slab of 128 C columns, C float4 (or 4 C floats) a lane, C chosen
# from n by the kernel's launch (``walk_shape`` repeats the choice).
WARPS = 8
UNROLL_LOADS = 4     # U C 16-byte X loads in flight a lane: U = 4 / C
LONG_ROW = 128       # rows of more slots go to the long-row walk
LONG_WARPS = 16      # warps of the long-row walk, each summing a run


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


# bit 31 of a marked stream's x index: the slot opens a group of its row
GROUP_START = np.int32(-2 ** 31)
X_INDEX = 0x7FFFFFFF


def mark_groups(xidx, groups, row_slot) -> np.ndarray:
    """The x indices ``xidx`` (S,) of a row stream with ``GROUP_START`` set
    on each slot that opens one of its row's groups: a row's first slot and
    each slot whose group (``groups``, (S,), the layout's group of each
    slot) differs from the slot's before it. A row's slots of one group
    are consecutive in the stream."""
    groups = np.asarray(groups).reshape(-1)
    row_slot = np.asarray(row_slot, np.int64)
    start = np.ones(len(groups), bool)
    start[1:] = groups[1:] != groups[:-1]
    start[row_slot[:-1][np.diff(row_slot) > 0]] = True
    xidx = np.asarray(xidx, np.int32)
    return np.where(start, xidx | GROUP_START, xidx).astype(np.int32)


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


def walk_sums(terms: torch.Tensor, row_slot: torch.Tensor) -> torch.Tensor:
    """(m, ...) sums of a row stream's ``terms`` (in stream order, row r's
    at ``row_slot[r]:row_slot[r + 1]``) as the walk adds them: a row of at
    most ``LONG_ROW`` terms from 0 in order; a longer row's ``LONG_WARPS``
    runs of ceil(count / LONG_WARPS) terms each from 0 in order, then the
    runs' sums added in run order (the long-row walk)."""
    y = segment_sum(terms, row_slot)
    counts = torch.diff(row_slot)
    for r in torch.nonzero(counts > LONG_ROW).flatten().tolist():
        beg, end = int(row_slot[r]), int(row_slot[r + 1])
        run = -(-(end - beg) // LONG_WARPS)
        bounds = torch.tensor([min(end, beg + w * run)
                               for w in range(LONG_WARPS)] + [end],
                              device=terms.device) - beg
        parts = segment_sum(terms[beg:end], bounds)
        total = parts[0]
        for w in range(1, LONG_WARPS):
            total = total + parts[w]
        y[r] = total
    return y


def bf16_rounded(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest, ties to even) and widened back to
    f32: one bf16 operation of the Pallas bodies, computed in f32 and
    rounded, as XLA computes it on the CPU."""
    return t.to(torch.bfloat16).float()


def group_sums(parts: torch.Tensor) -> torch.Tensor:
    """(G, 128) f32: each group's ``parts`` (G, R, 128) summed over R in
    f32, in order, and rounded to bf16, as the Pallas SpMV bodies round a
    group's sum at bf16."""
    gsum = parts[:, 0].float()
    for r in range(1, parts.shape[1]):
        gsum = gsum + parts[:, r]
    return bf16_rounded(gsum)


def add_groups_in_order(parts: torch.Tensor, owner: torch.Tensor,
                        owners: int) -> torch.Tensor:
    """(owners, 128) f32, as the Pallas SpMV bodies sum at bf16: each
    group's ``group_sums`` of ``parts`` (G, R, 128); then row o the f32
    sum, from 0 in group order, of the groups whose ``owner`` (G,), sorted,
    is o."""
    gsum = group_sums(parts)
    owner = owner.long()
    y = torch.zeros((owners, parts.shape[2]), dtype=torch.float32,
                    device=parts.device)
    if owner.numel() == 0:
        return y
    counts = torch.bincount(owner, minlength=owners)
    rank = (torch.arange(owner.numel(), device=owner.device)
            - (torch.cumsum(counts, 0) - counts)[owner])
    for r in range(int(counts.max())):
        at = rank == r      # one group of each owner at most
        y[owner[at]] += gsum[at]
    return y
