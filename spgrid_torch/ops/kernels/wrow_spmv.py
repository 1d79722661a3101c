"""Window-row packed SpMV: y = A @ x with A in DeviceWROW layout.

Counterpart of ``spgrid/ops/pallas/wrow_spmv.py`` (format ``wrow_spmv``).
Its two variants are two CUDA kernels: v1, the default,
``spgrid_torch/csrc/wrow_spmv.cu`` (one CTA per target block, a thread a
row, reading the row-ordered live-slot stream), and v2,
``spgrid_torch/csrc/wrow_spmv_v2.cu`` (``wrow_spmv_v2``: equal ranges of
live slots per CTA, an accumulator carried across a range, reading the
piece-ordered live-slot stream). ``wrow_spmv`` takes x (k,) and returns y
(m,), x unpadded. It launches a kernel for CUDA tensors and takes
``wrow_spmv_plain`` only for CPU tensors.

A piece is one 128-lane row of slots holding the nnz of one (128-row target
block, 128-column window, depth), lane = row within the block; a group is
8 pieces of one target block, and a block's groups are consecutive. Both
streams keep only the live slots, those whose value is not 0 and whose x
index lies inside x. v2's (``DeviceWROW.slot_*``,
``ops/kernels/slot_stream.py``) keeps them piece by piece, each with its
value, its x index and its row (lane) in the block; ``wrow_stream_plain``
is the product over it. v1's (``DeviceWROW.row_*``, built by
``slot_rows.stream_order``) keeps them by output row and, within a row, in
piece order (the order in which the padded pieces sum the row), each with
its value and its x index, ``row_slot`` pointing at each row's, and
``row_piece``, each slot's piece's place in its group (0..7), which only
the ``spmv_ablate`` probe reads; ``wrow_rows_plain`` is the product over it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from spgrid_torch.ops.kernels import _build, check_operands
from spgrid_torch.ops.kernels.slot_rows import stream_order
from spgrid_torch.ops.kernels.slot_stream import (
    check_stream, launch_stream, live_slot_stream, row_bytes,
    stream_product)
from spgrid_torch.ops.layouts import group_ptr, to_device

LANE = 128
GROUP_PIECES = 8


def csr_to_wrow(csr):
    """Pack a CSR matrix into WROW pieces and groups, as ``spgrid.ops.pallas.
    wrow_spmv.csr_to_wrow`` does.

    Returns (cols int8 (P, 128), vals (P, 128), piece_w (P,), group_sub (G,),
    num_groups, utilization); P == 8 G, pieces padded per target block to a
    multiple of 8 (window 0, zero values)."""
    m, k = csr.shape
    nnz = csr.nnz
    if nnz == 0:
        return (np.zeros((8, LANE), np.int8),
                np.zeros((8, LANE), csr.values.dtype), np.zeros(8, np.int32),
                np.zeros(1, np.int32), 1, 0.0)
    rows = np.repeat(np.arange(m, dtype=np.int64), csr.degrees)
    cols = csr.col_idx.astype(np.int64)
    sub = rows // LANE
    win = cols // LANE
    lane = rows % LANE
    cw = (cols % LANE).astype(np.int8)

    # depth = occurrence index among nnz sharing (sub, win, lane)
    nwin = -(-k // LANE)
    poskey = (sub * nwin + win) * LANE + lane
    order = np.argsort(poskey, kind="stable")
    pk = poskey[order]
    first = np.empty(nnz, dtype=bool)
    first[0] = True
    first[1:] = pk[1:] != pk[:-1]
    start = np.maximum.accumulate(
        np.where(first, np.arange(nnz, dtype=np.int64), 0))
    depth = np.arange(nnz, dtype=np.int64) - start

    # piece id = dense rank of (sub, win, depth)
    pkey = (sub[order] * nwin + win[order]) * (depth.max() + 1) + depth
    uniq, pid = np.unique(pkey, return_inverse=True)
    P0 = len(uniq)
    p_sub = (uniq // (depth.max() + 1) // nwin).astype(np.int64)
    p_win = (uniq // (depth.max() + 1) % nwin).astype(np.int32)

    counts = np.bincount(p_sub, minlength=int(sub.max()) + 1)
    tot = counts + (-counts) % GROUP_PIECES
    G = int(tot.sum()) // GROUP_PIECES
    starts_out = np.concatenate([[0], np.cumsum(tot)])
    starts_in = np.concatenate([[0], np.cumsum(counts)])
    dest = starts_out[p_sub] + (np.arange(P0) - starts_in[p_sub])

    cols_p = np.zeros((G * GROUP_PIECES, LANE), np.int8)
    vals_p = np.zeros((G * GROUP_PIECES, LANE), csr.values.dtype)
    piece_w = np.zeros(G * GROUP_PIECES, np.int32)
    piece_w[dest] = p_win
    cols_p[dest[pid], lane[order]] = cw[order]
    vals_p[dest[pid], lane[order]] = csr.values[order]
    group_sub = np.repeat(np.arange(len(tot), dtype=np.int32),
                          tot // GROUP_PIECES)
    util = nnz / (G * GROUP_PIECES * LANE)
    return cols_p, vals_p, piece_w, group_sub, G, util


@dataclasses.dataclass
class DeviceWROW:
    """``csr_to_wrow``'s flat arrays on a torch device, plus ``block_ptr``:
    the groups of target block b are ``block_ptr[b]:block_ptr[b + 1]``,
    the live-slot stream that v2 reads and the row-ordered one that v1
    reads. (The JAX layout pads groups to 128 and reshapes the metadata
    into rows of 8 steps for the TPU's scalar memory; the port keeps
    neither.)"""

    cols: torch.Tensor        # (P, 128) int8, col % 128 of each slot
    values: torch.Tensor      # (P, 128), 0 in pad slots
    piece_w: torch.Tensor     # (P,) int32, window of each piece
    group_sub: torch.Tensor   # (G,) int32, target block of each group, sorted
    block_ptr: torch.Tensor   # (ceil(m / 128) + 1,) int32
    # the live-slot stream: S live slots in piece, then lane order
    slot_ptr: torch.Tensor    # (P + 1,) int32, piece p's live slots
    block_slot: torch.Tensor  # (blocks + 1,) int32, block b's live slots
    slot_vals: torch.Tensor   # (S,) value of each live slot
    slot_cols: torch.Tensor   # (S,) int32, x index of each live slot
    slot_rows: torch.Tensor   # (S,) uint8, row (lane) | PIECE_START
    # the row-ordered stream: the same S slots by row, then piece
    row_slot: torch.Tensor    # (m + 1,) int32, row r's live slots
    row_vals: torch.Tensor    # (S,) value of each live slot
    row_cols: torch.Tensor    # (S,) int32, x index of each live slot
    row_piece: torch.Tensor   # (S,) uint8, its piece's place in its group
    shape: Tuple[int, int]
    nnz: int
    utilization: float
    num_groups: int
    name: str = ""

    @property
    def blocks(self) -> int:
        return len(self.block_ptr) - 1

    @property
    def num_slots(self) -> int:
        return len(self.slot_vals)

    @property
    def stream_nbytes(self) -> int:
        """Bytes of what v2 reads of the layout: the stream's values, x
        indices, rows and block pointer."""
        return sum(t.numel() * t.element_size() for t in (
            self.block_slot, self.slot_vals, self.slot_cols, self.slot_rows))

    @property
    def row_nbytes(self) -> int:
        """Bytes of what v1 reads of the layout: the row stream's values, x
        indices and row pointer."""
        return sum(t.numel() * t.element_size() for t in (
            self.row_slot, self.row_vals, self.row_cols))

    @property
    def nbytes(self) -> int:
        return self.stream_nbytes + self.row_nbytes + sum(
            t.numel() * t.element_size() for t in (
                self.cols, self.values, self.piece_w, self.block_ptr,
                self.slot_ptr, self.row_piece))

    @classmethod
    def from_arrays(cls, cols, values, piece_w, group_sub, shape, nnz: int,
                    utilization: float, num_groups: int, name: str = "", *,
                    device) -> "DeviceWROW":
        """Flat host arrays → device layout; groups past ``num_groups`` (the
        JAX layout's padding) are dropped. The live-slot streams are built
        here, on the host, from the padded pieces: the row stream is the
        piece-ordered one stably sorted by output row."""
        G = int(num_groups)
        sub = np.asarray(group_sub, np.int64).reshape(-1)[:G]
        if np.any(np.diff(sub) < 0):
            raise ValueError("wrow: groups must be sorted by target block")
        ptr, _ = group_ptr(sub, max(-(-shape[0] // LANE), 1))
        P = G * GROUP_PIECES
        cols = np.asarray(cols)[:P]
        values = np.asarray(values)[:P]
        piece_w = np.asarray(piece_w).reshape(-1)[:P]
        piece, lane, x_index, slot_ptr, block_slot = live_slot_stream(
            values, cols, piece_w, ptr, shape[1], GROUP_PIECES)
        slot_vals = values[piece, lane]
        order, row_slot = stream_order(
            sub[piece // GROUP_PIECES] * LANE + lane, x_index, slot_vals,
            shape[0], shape[1])
        return cls(cols=to_device(cols, device, np.int8),
                   values=to_device(values, device),
                   piece_w=to_device(piece_w, device, np.int32),
                   group_sub=to_device(sub, device, np.int32),
                   block_ptr=to_device(ptr, device),
                   slot_ptr=to_device(slot_ptr, device),
                   block_slot=to_device(block_slot, device),
                   slot_vals=to_device(slot_vals, device),
                   slot_cols=to_device(x_index, device, np.int32),
                   slot_rows=to_device(row_bytes(lane, slot_ptr), device),
                   row_slot=to_device(row_slot, device),
                   row_vals=to_device(slot_vals[order], device),
                   row_cols=to_device(x_index[order], device, np.int32),
                   row_piece=to_device(piece[order] % GROUP_PIECES, device,
                                       np.uint8),
                   shape=tuple(shape), nnz=int(nnz),
                   utilization=float(utilization), num_groups=G, name=name)

    @classmethod
    def from_csr(cls, csr, *, device) -> "DeviceWROW":
        cols, vals, pw, gsub, G, util = csr_to_wrow(csr)
        return cls.from_arrays(cols, vals, pw, gsub, csr.shape, csr.nnz,
                               util, G, csr.name, device=device)


def _check(kernel: str, a: DeviceWROW, x: torch.Tensor) -> None:
    if x.dim() != 1 or x.shape[0] != a.shape[1]:
        raise ValueError(f"x must be ({a.shape[1]},), got {tuple(x.shape)}")
    check_operands(kernel, x.device, x=(x, torch.float32),
                   values=(a.values, torch.float32), cols=(a.cols, torch.int8),
                   piece_w=(a.piece_w, torch.int32),
                   group_sub=(a.group_sub, torch.int32),
                   block_ptr=(a.block_ptr, torch.int32))
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: no kernel for device {x.device}")


def wrow_spmv(a: DeviceWROW, x: torch.Tensor,
              variant: str = "v1") -> torch.Tensor:
    """y (m,) f32 = A @ x for f32 x (k,); ``variant`` "v1" (the default) or
    "v2" (``wrow_spmv_v2``), as the JAX ``wrow_spmv`` takes it. v1's
    kernel reads the row stream, a thread a row."""
    if variant == "v2":
        return wrow_spmv_v2(a, x)
    if variant != "v1":
        raise ValueError(f"wrow_spmv: variant must be 'v1' or 'v2', got "
                         f"{variant!r}")
    _check("wrow_spmv", a, x)
    check_operands("wrow_spmv", x.device, row_slot=(a.row_slot, torch.int32),
                   row_vals=(a.row_vals, torch.float32),
                   row_cols=(a.row_cols, torch.int32))
    if x.device.type == "cpu":
        return wrow_spmv_plain(a, x)
    m = a.shape[0]
    y = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.spgrid_wrow_spmv(
            a.row_slot.data_ptr(), a.row_vals.data_ptr(),
            a.row_cols.data_ptr(), x.data_ptr(), y.data_ptr(), a.blocks, m,
            stream)
    _build.check(code, "wrow_spmv")
    wrow_spmv.launches += 1
    return y


wrow_spmv.launches = 0

def wrow_spmv_v2(a: DeviceWROW, x: torch.Tensor,
                 slots_per_cta: int | None = None) -> torch.Tensor:
    """y (m,) f32 = A @ x for f32 x (k,), variant v2: each CTA walks
    ``slots_per_cta`` consecutive slots of the live-slot stream (None: one
    wave of the card, ``slot_stream.default_slots_per_cta``); blocks that
    straddle two CTAs' ranges are combined by a second pass (the same y as
    v1, to f32 rounding)."""
    _check("wrow_spmv_v2", a, x)
    check_stream("wrow_spmv_v2", a, x, slots_per_cta)
    if x.device.type == "cpu":
        return wrow_spmv_plain(a, x)
    return launch_stream(wrow_spmv_v2, a, x, slots_per_cta)


wrow_spmv_v2.launches = 0


def wrow_stream_plain(a: DeviceWROW, x: torch.Tensor) -> torch.Tensor:
    """The product in plain torch over the live-slot stream, which v2's
    kernel reads, in x's dtype."""
    return stream_product(a, x)


def wrow_rows_plain(a: DeviceWROW, x: torch.Tensor) -> torch.Tensor:
    """The product in plain torch over the row stream, which v1's kernel
    reads, in x's dtype: each live slot adds value · x[its x index] to its
    row (``index_add_``)."""
    m = a.shape[0]
    row = torch.repeat_interleave(torch.arange(m, device=x.device),
                                  torch.diff(a.row_slot.long()))
    y = torch.zeros((m,), dtype=x.dtype, device=x.device)
    y.index_add_(0, row, a.row_vals.to(x.dtype) * x[a.row_cols.long()])
    return y


def wrow_spmv_plain(a: DeviceWROW, x: torch.Tensor) -> torch.Tensor:
    """The same product in plain torch, in x's dtype, for both variants:
    slot t of piece p adds value · x[128 piece_w[p] + col] to row
    128 group_sub[p // 8] + t (``index_add_``), for slots whose value is
    not 0 and x index lies inside x."""
    m, k = a.shape
    lane = torch.arange(LANE, device=x.device)
    sub = a.group_sub.long().repeat_interleave(GROUP_PIECES)
    row = (sub[:, None] * LANE + lane).expand(-1, LANE)
    xi = a.piece_w.long()[:, None] * LANE + a.cols.long()
    live = (a.values != 0) & (xi < k)
    y = torch.zeros((m,), dtype=x.dtype, device=x.device)
    y.index_add_(0, row[live], a.values[live].to(x.dtype) * x[xi[live]])
    return y
