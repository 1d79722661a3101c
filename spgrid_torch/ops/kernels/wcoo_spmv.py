"""Aligned-slot SpMV: y = A @ x with A in DeviceWCOOAligned layout.

Counterpart of ``spgrid/ops/pallas/wcoo_spmv.py`` (format ``wcoo_spmv``); the
CUDA kernel is ``spgrid_torch/csrc/wcoo_spmv.cu``. ``wcoo_spmv`` takes x (k,)
and returns y (m,), x unpadded. It launches the kernel for CUDA tensors,
which reads the layout's row-ordered live-slot stream
(``ops/kernels/slot_rows.py``) in row tiles of equal work (``row_tiles``),
and takes ``wcoo_spmv_plain``, which reads the padded groups, only for CPU
tensors.

A group is (8, 128) slots: row w = window within the group's 1024-column
superwindow, lane = row within its 128-row target block
(``formats.wcoo.csr_to_wcoo_aligned``); groups are sorted by target block.

At bf16 (``wcoo_spmv_bf16``: a layout built from a bf16 matrix, bf16
values, x and y) the form rounds where XLA rounds the Pallas body on the
CPU: a group's products for a row (its windows) summed in f32 (a bf16
product that feeds only that sum stays f32, exact) and the sum rounded to
bf16 before it is added into the f32 row, y rounded once. A row can hold
several groups of one superwindow (collisions of the aligned layout make
extra groups), so the row stream marks where each of a row's groups starts
(bit 31 of ``slot_xrows``, ``slot_rows.mark_groups``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from spgrid_torch.formats.csr import value_dtype
from spgrid_torch.formats.wcoo import LANE, csr_to_wcoo_aligned
from spgrid_torch.ops.kernels import (
    _build, check_form, check_operands, runs_plain)
from spgrid_torch.ops.kernels.slot_rows import (
    LONG_ROW, STREAM_FIELDS, RowStream, add_groups_in_order, check_rows,
    mark_groups, rows_product, stream_order, stream_tensors)
from spgrid_torch.ops.layouts import group_ptr, to_device, torch_dtype

GROUP_ROWS = 8       # windows of a superwindow == slot rows of a group
# The kernel (csrc/wcoo_spmv.cu): a CTA of THREADS threads a row tile, a
# thread a row; a tile holds at most TILE_SLOTS live slots, staged in shared
# memory, unless it is one longer row. TILE_SLOTS is the rule, the fastest
# of phase 1's sweep over TILE_CHOICES on MAIN_LINE (PERF.md §6); the kernel
# takes any of TILE_CHOICES.
THREADS = 256
TILE_CHOICES = (512, 1024, 2048)
TILE_SLOTS = 2048


def row_tiles(row_slot, tile_slots: int = TILE_SLOTS) -> np.ndarray:
    """tile_row (T + 1,) int32: tile i is rows ``tile_row[i]:tile_row[i +
    1]``, whole rows taken greedily in order while the tile holds at most
    ``tile_slots`` live slots and ``THREADS`` rows; a row of more slots is a
    tile of its own. Every row lies in one tile; m = 0 gives no tile."""
    if tile_slots not in TILE_CHOICES:
        raise ValueError(f"wcoo_spmv: tile_slots must be one of "
                         f"{TILE_CHOICES}, got {tile_slots}")
    ptr = np.asarray(row_slot, np.int64)
    m = len(ptr) - 1
    tiles = [0]
    r = 0
    while r < m:
        end = int(np.searchsorted(ptr, ptr[r] + tile_slots, "right")) - 1
        r = max(min(end, r + THREADS, m), r + 1)
        tiles.append(r)
    return np.asarray(tiles, np.int32)


def aligned_row_stream(cols, values, g_sw, g_sub, shape,
                       marked: bool = False):
    """The stream of an aligned layout: slot (w, lane) of group g adds to
    row 128 g_sub + lane from x index 1024 g_sw + 128 w + col, col read as
    an unsigned byte, in group, window and lane order (the order in which
    the padded walk summed each row): ``slot_rows.row_stream``'s arrays,
    the x indices marked with the starts of each row's groups where
    ``marked`` (``slot_rows.mark_groups``)."""
    slots = (-1, GROUP_ROWS, LANE)
    w = np.arange(GROUP_ROWS)[:, None]
    col = np.asarray(cols, np.int8).view(np.uint8).reshape(slots)
    xrows = (np.asarray(g_sw, np.int64)[:, None, None] * (GROUP_ROWS * LANE)
             + w * LANE + col)
    out = np.broadcast_to(np.asarray(g_sub, np.int64)[:, None, None] * LANE
                          + np.arange(LANE), xrows.shape)
    values = np.asarray(values).reshape(-1)
    order, row_slot = stream_order(out, xrows, values, *shape)
    xidx = xrows.reshape(-1)[order].astype(np.int32)
    if marked:
        xidx = mark_groups(xidx, order // (GROUP_ROWS * LANE), row_slot)
    return (row_slot, values[order], xidx,
            np.flatnonzero(np.diff(row_slot) > LONG_ROW).astype(np.int32))


@dataclasses.dataclass
class DeviceWCOOAligned(RowStream):
    """``csr_to_wcoo_aligned``'s groups on a torch device, plus
    ``block_ptr``: the groups of target block b are ``block_ptr[b]:
    block_ptr[b + 1]``. (The JAX layout pads the groups to a multiple of 256
    for its grid; the port does not.) Also the row-ordered live-slot stream
    that the kernel reads (``slot_rows.py``) and its row tiles at
    ``tile_slots`` (``row_tiles``). The stream has no ``long_rows``: the
    kernel takes a row past a tile's slots as a tile of its own."""

    stream_fields = STREAM_FIELDS[:3]

    cols: torch.Tensor        # (G*8, 128) int8, col % 128 of each slot
    values: torch.Tensor      # (G*8, 128) f32 or bf16, 0 in empty slots
    g_sw: torch.Tensor        # (G,) int32, superwindow of each group
    g_sub: torch.Tensor       # (G,) int32, target block of each group, sorted
    block_ptr: torch.Tensor   # (ceil(m / 128) + 1,) int32
    # the row stream: S live slots by output row, in group, window, lane order
    row_slot: torch.Tensor    # (m + 1,) int32, row r's live slots
    slot_vals: torch.Tensor   # (S,) value of each live slot
    slot_xrows: torch.Tensor  # (S,) int32, x index | GROUP_START at bf16
    tile_row: torch.Tensor    # (T + 1,) int32, the kernel's row tiles
    shape: Tuple[int, int]
    nnz: int
    utilization: float
    num_groups: int
    name: str = ""
    tile_slots: int = TILE_SLOTS

    @property
    def blocks(self) -> int:
        return len(self.block_ptr) - 1

    @property
    def tiles(self) -> int:
        return len(self.tile_row) - 1

    @property
    def nbytes(self) -> int:
        return self.stream_nbytes + sum(t.numel() * t.element_size() for t in (
            self.tile_row, self.cols, self.values, self.g_sw, self.block_ptr))

    def tiled(self, tile_slots: int) -> "DeviceWCOOAligned":
        """The same layout with its row tiles cut at ``tile_slots``."""
        tiles = row_tiles(self.row_slot.cpu().numpy(), tile_slots)
        return dataclasses.replace(
            self, tile_row=to_device(tiles, self.row_slot.device),
            tile_slots=tile_slots)

    @classmethod
    def from_arrays(cls, cols, values, g_sw, g_sub, shape, nnz: int,
                    utilization: float, num_groups: int, name: str = "", *,
                    device, dtype: torch.dtype = torch.float32
                    ) -> "DeviceWCOOAligned":
        """Host arrays → device layout, its values in ``dtype`` (f32, or
        bf16 for a matrix whose values are bf16); groups past
        ``num_groups`` (the JAX layout's padding) are dropped. The row
        stream (marked with the groups' starts at bf16) and its tiles are
        built here, on the host, from the padded groups."""
        G = int(num_groups)
        sub = np.asarray(g_sub, np.int64)[:G]
        if np.any(np.diff(sub) < 0):
            raise ValueError("wcoo_spmv: groups must be sorted by target "
                             "block")
        ptr, _ = group_ptr(sub, max(-(-shape[0] // LANE), 1))
        rows = G * GROUP_ROWS
        cols = np.asarray(cols).reshape(-1, LANE)[:rows]
        values = np.asarray(values).reshape(-1, LANE)[:rows]
        sw = np.asarray(g_sw)[:G]
        stream = aligned_row_stream(cols, values, sw, sub, shape,
                                    marked=dtype == torch.bfloat16)
        fields = stream_tensors(stream, device, cls.stream_fields)
        fields["slot_vals"] = fields["slot_vals"].to(dtype)
        return cls(cols=to_device(cols, device, np.int8),
                   values=to_device(values, device).to(dtype),
                   g_sw=to_device(sw, device, np.int32),
                   g_sub=to_device(sub, device, np.int32),
                   block_ptr=to_device(ptr, device), **fields,
                   tile_row=to_device(row_tiles(stream[0]), device),
                   shape=tuple(shape), nnz=int(nnz),
                   utilization=float(utilization), num_groups=G, name=name)

    @classmethod
    def from_csr(cls, csr, *, device) -> "DeviceWCOOAligned":
        cols, vals, g_sw, g_sub, G, util = csr_to_wcoo_aligned(csr)
        return cls.from_arrays(cols, vals, g_sw, g_sub, csr.shape, csr.nnz,
                               util, G, csr.name, device=device,
                               dtype=torch_dtype(value_dtype(csr)))


def launch(a: DeviceWCOOAligned, x: torch.Tensor, y: torch.Tensor) -> None:
    """One launch of the kernel (the bf16 form for a bf16 x) into ``y``
    over ``a``'s row tiles at ``a.tile_slots``, uncounted (``a.tiled(s)``
    for sweeps and tests); ``wcoo_spmv`` is the entry point."""
    name = "wcoo_spmv_bf16" if x.dtype == torch.bfloat16 else "wcoo_spmv"
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(_build.library(), f"spgrid_{name}")(
            a.tile_row.data_ptr(), a.row_slot.data_ptr(),
            a.slot_vals.data_ptr(), a.slot_xrows.data_ptr(), x.data_ptr(),
            y.data_ptr(), a.tiles, a.tile_slots, stream)
    _build.check(code, name)


def wcoo_spmv(a: DeviceWCOOAligned, x: torch.Tensor) -> torch.Tensor:
    """y (m,) = A @ x in x's dtype: f32 x (k,), or bf16 x for a bf16 layout
    (``wcoo_spmv_bf16``)."""
    check_form("wcoo_spmv", x.dtype)
    if x.dtype == torch.bfloat16:
        return wcoo_spmv_bf16(a, x)
    return _run(wcoo_spmv, a, x, torch.float32)


wcoo_spmv.launches = 0


def wcoo_spmv_bf16(a: DeviceWCOOAligned, x: torch.Tensor) -> torch.Tensor:
    """y (m,) bf16 = A @ x for a bf16 layout and bf16 x (k,): each group's
    f32 sum of products for a row rounded to bf16 before the f32 add, y
    rounded once."""
    return _run(wcoo_spmv_bf16, a, x, torch.bfloat16)


wcoo_spmv_bf16.launches = 0


def _run(wrapper, a: DeviceWCOOAligned, x: torch.Tensor,
         dtype: torch.dtype) -> torch.Tensor:
    name = wrapper.__name__
    if x.dim() != 1 or x.shape[0] != a.shape[1]:
        raise ValueError(f"x must be ({a.shape[1]},), got {tuple(x.shape)}")
    check_operands(name, x.device, x=(x, dtype), values=(a.values, dtype),
                   cols=(a.cols, torch.int8), g_sw=(a.g_sw, torch.int32),
                   block_ptr=(a.block_ptr, torch.int32),
                   tile_row=(a.tile_row, torch.int32))
    check_rows(name, a, x, dtype)
    if runs_plain(name, x.device):
        return wcoo_spmv_plain(a, x)
    y = torch.empty((a.shape[0],), dtype=dtype, device=x.device)
    if a.shape[0] == 0:
        return y
    launch(a, x, y)
    wrapper.launches += 1
    return y


def wcoo_spmv_plain(a: DeviceWCOOAligned, x: torch.Tensor) -> torch.Tensor:
    """The same product in plain torch, in x's dtype: slot (w, t) of group g
    adds value · x[1024 g_sw[g] + 128 w + col] to row 128 g_sub[g] + t, for
    slots whose value is not 0 and x index lies inside x: f32 and f64 by
    ``index_add_``; bf16 as the Pallas body, the products of a group's 8
    windows summed in f32 in window order and rounded to bf16,
    the groups of a block added into its f32 rows in group order, y
    rounded once."""
    m, k = a.shape
    slots = (GROUP_ROWS, LANE)
    vals = a.values.view(-1, *slots)
    w = torch.arange(GROUP_ROWS, device=x.device)[:, None]
    lane = torch.arange(LANE, device=x.device)
    xi = (a.g_sw.long()[:, None, None] * (GROUP_ROWS * LANE) + w * LANE
          + a.cols.view(-1, *slots).long())
    live = (vals != 0) & (xi < k)
    if x.dtype == torch.bfloat16:
        p = torch.zeros(vals.shape, dtype=torch.float32, device=x.device)
        p[live] = vals[live].float() * x.float()[xi[live]]
        y2 = add_groups_in_order(p, a.g_sub, a.blocks)
        return y2.reshape(-1)[:m].to(x.dtype)
    row = (a.g_sub.long()[:, None, None] * LANE + lane).expand(-1, *slots)
    y = torch.zeros((m,), dtype=x.dtype, device=x.device)
    y.index_add_(0, row[live], vals[live].to(x.dtype) * x[xi[live]])
    return y


def wcoo_spmv_rows_plain(a: DeviceWCOOAligned,
                         x: torch.Tensor) -> torch.Tensor:
    """The same product over the row stream, what the kernel reads, in
    plain torch and x's dtype (for tests; an f32 layout)."""
    return rows_product(a, x[:, None])[:, 0]
