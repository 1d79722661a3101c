"""WCOO — windowed slot-chunk COO, the hypersparse layouts' host packers.

The port's own copy of ``csr_to_wcoo`` and ``csr_to_wcoo_aligned`` from
``spgrid/formats/wcoo.py``, element for element (pinned by
``tests/test_torch_wcoo.py``).

``csr_to_wcoo``: nnz sorted by (row block of R rows, 128-column window,
128-row subblock, row, col) and cut into chunks of 128 slots, each within
one (row block, window, subblock) tile. A chunk carries its window, row
block, subblock and whether it is its row block's first; each slot its
column within the window, its row within the subblock and its value. Pad
slots hold column 0, row 0 and value 0. A row block without nnz gets one
empty "coverage" chunk (window 0, subblock 0). Utilization = nnz /
(chunks · 128).

``csr_to_wcoo_aligned``: (8, 128) slot groups whose slot position is set by
the coordinates: sublane = window within the 1024-column superwindow, lane
= row within the 128-row subblock; nnz that collide go to further groups
("depth").
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


LANE = 128          # window columns == chunk slots == subblock rows


@dataclasses.dataclass
class WCOOMatrix:
    """Host-side packed chunks (device layout: ops.kernels.wcoo_spmm)."""

    cols_in_window: np.ndarray   # (nchunks_pad8, W) int32, col - window*W
    row_local: np.ndarray        # (nchunks_pad8, W) int32, row % W (in subblock)
    values: np.ndarray           # (nchunks_pad8, W) dtype, 0 in padding slots
    chunk_window: np.ndarray     # (nchunks,) int32
    chunk_rowblock: np.ndarray   # (nchunks,) int32  (row // R)
    chunk_sub: np.ndarray        # (nchunks,) int32  ((row % R) // 128)
    chunk_first: np.ndarray      # (nchunks,) int32, 1 = first chunk of block
    shape: Tuple[int, int]
    nnz: int
    R: int                       # output row-block rows (multiple of W)
    W: int = LANE                # window cols == chunk slots (128 on HW)
    name: str = "wcoo"

    @property
    def num_chunks(self) -> int:
        return len(self.chunk_window)

    @property
    def utilization(self) -> float:
        return self.nnz / max(self.num_chunks * self.W, 1)

    @property
    def num_rowblocks(self) -> int:
        return -(-self.shape[0] // self.R)

    @property
    def mem_footprint(self) -> int:
        return (self.cols_in_window.nbytes + self.row_local.nbytes
                + self.values.nbytes + self.chunk_window.nbytes
                + self.chunk_rowblock.nbytes + self.chunk_sub.nbytes
                + self.chunk_first.nbytes)


def csr_to_wcoo(csr, R: int = 1024, W: int = LANE) -> WCOOMatrix:
    """Pack a CSR matrix into WCOO chunks of W slots (the device layout
    takes W = 128 only)."""
    m, k = csr.shape
    nnz = csr.nnz
    if R % W:
        raise ValueError(f"R must be a multiple of W={W}")

    if nnz == 0:
        nch = -(-m // R) or 1
        z = np.zeros((nch + (-nch) % 8, W), dtype=np.int32)
        return WCOOMatrix(z, z.copy(), np.zeros(z.shape, csr.values.dtype),
                          np.zeros(nch, np.int32),
                          np.arange(nch, dtype=np.int32) % max(-(-m // R), 1),
                          np.zeros(nch, np.int32), np.ones(nch, np.int32),
                          csr.shape, 0, R, W, csr.name)

    rows = np.repeat(np.arange(m, dtype=np.int64), csr.degrees)
    cols = csr.col_idx.astype(np.int64)
    vals = csr.values

    rb = rows // R
    sub = (rows % R) // W
    win = cols // W
    num_win = -(-k // W)
    subs_per_rb = R // W
    order = np.lexsort((cols, rows, sub, win, rb))
    rows, cols, vals = rows[order], cols[order], vals[order]
    rb, sub, win = rb[order], sub[order], win[order]

    # tile id = (rb, win, sub); chunks = W-slot pieces of a tile.
    tile = (rb * num_win + win) * subs_per_rb + sub
    tile_change = np.empty(nnz, dtype=bool)
    tile_change[0] = True
    tile_change[1:] = tile[1:] != tile[:-1]
    tile_start_idx = np.maximum.accumulate(
        np.where(tile_change, np.arange(nnz, dtype=np.int64), 0))
    in_tile = np.arange(nnz, dtype=np.int64) - tile_start_idx
    piece = in_tile // W
    chunk_key = np.empty(nnz, dtype=bool)
    chunk_key[0] = True
    chunk_key[1:] = tile_change[1:] | (piece[1:] != piece[:-1])
    chunk_id = np.cumsum(chunk_key) - 1
    nchunks = int(chunk_id[-1]) + 1
    slot = in_tile % W

    cw = np.zeros((nchunks, W), dtype=np.int32)
    rl = np.zeros((nchunks, W), dtype=np.int32)
    vv = np.zeros((nchunks, W), dtype=csr.values.dtype)
    cw[chunk_id, slot] = (cols - win * W).astype(np.int32)
    rl[chunk_id, slot] = (rows % W).astype(np.int32)
    vv[chunk_id, slot] = vals

    chunk_starts = np.flatnonzero(chunk_key)
    c_win = win[chunk_starts].astype(np.int32)
    c_rb = rb[chunk_starts].astype(np.int32)
    c_sub = sub[chunk_starts].astype(np.int32)

    # Every row block must be visited at least once so its output tile gets
    # zeroed — insert an empty chunk for row blocks with no nnz.
    mb = -(-m // R)
    present = np.zeros(mb, dtype=bool)
    present[c_rb] = True
    missing = np.flatnonzero(~present).astype(np.int32)
    if len(missing):
        cw = np.concatenate([cw, np.zeros((len(missing), W), np.int32)])
        rl = np.concatenate([rl, np.zeros((len(missing), W), np.int32)])
        vv = np.concatenate([vv, np.zeros((len(missing), W), vv.dtype)])
        c_win = np.concatenate([c_win, np.zeros(len(missing), np.int32)])
        c_sub = np.concatenate([c_sub, np.zeros(len(missing), np.int32)])
        c_rb = np.concatenate([c_rb, missing])
        order2 = np.argsort(c_rb, kind="stable")
        cw, rl, vv = cw[order2], rl[order2], vv[order2]
        c_win, c_rb, c_sub = c_win[order2], c_rb[order2], c_sub[order2]
        nchunks += len(missing)

    c_first = np.empty(nchunks, dtype=np.int32)
    c_first[0] = 1
    c_first[1:] = (c_rb[1:] != c_rb[:-1]).astype(np.int32)

    # Slot arrays are fetched in 8-chunk (1024-slot) blocks on device — pad
    # the chunk count so the last block is in range.
    pad = (-nchunks) % 8
    if pad:
        cw = np.concatenate([cw, np.zeros((pad, W), np.int32)])
        rl = np.concatenate([rl, np.zeros((pad, W), np.int32)])
        vv = np.concatenate([vv, np.zeros((pad, W), vv.dtype)])

    return WCOOMatrix(cw, rl, vv,
                      c_win, c_rb, c_sub, c_first, csr.shape, nnz, R, W,
                      csr.name)


def csr_to_wcoo_aligned(csr):
    """Aligned-slot packing (the wcoo_spmv and wcoo_bands layouts).

    Slot position inside an (8, 128) group is *determined* by the nnz
    coordinates: sublane = (col//128) % 8 (window within the 1024-col
    superwindow), lane = row % 128 (target row within the 128-row subblock).
    Colliding nnz (same row, same window) go to extra depth layers.  The
    reduction then degenerates to a sublane sum — no one-hot, no scatter.

    Returns (cols, vals, group_superwindow, group_subrow, num_groups, util):
      cols  (G, 8, 128) int32 — col % 128 per slot (0 for empty slots)
      vals  (G, 8, 128) dtype — 0 for empty slots
      group_superwindow (G,) int32 — superwindow id (1024-col unit)
      group_subrow      (G,) int32 — subblock id (128-row unit)
    """
    m, k = csr.shape
    nnz = csr.nnz
    if nnz == 0:
        z = np.zeros((1, 8, LANE), np.int32)
        return (z, np.zeros((1, 8, LANE), csr.values.dtype),
                np.zeros(1, np.int32), np.zeros(1, np.int32), 1, 0.0)

    rows = np.repeat(np.arange(m, dtype=np.int64), csr.degrees)
    cols = csr.col_idx.astype(np.int64)
    vals = csr.values

    sub = rows // LANE
    sw = cols // (8 * LANE)
    w8 = (cols // LANE) % 8
    rl = rows % LANE
    cw = (cols % LANE).astype(np.int32)

    # depth = occurrence index among nnz sharing (sub, sw, w8, rl)
    num_sw = -(-k // (8 * LANE))
    poskey = ((sub * num_sw + sw) * 8 + w8) * LANE + rl
    order = np.argsort(poskey, kind="stable")
    pk = poskey[order]
    first = np.empty(nnz, dtype=bool)
    first[0] = True
    first[1:] = pk[1:] != pk[:-1]
    start = np.maximum.accumulate(
        np.where(first, np.arange(nnz, dtype=np.int64), 0))
    depth = np.arange(nnz, dtype=np.int64) - start

    # group key = (sub, sw, depth); build dense group ids
    tilekey = sub[order] * num_sw + sw[order]
    gkey = tilekey * (depth.max() + 1) + depth
    uniq, gid = np.unique(gkey, return_inverse=True)
    G = len(uniq)

    cols_a = np.zeros((G, 8, LANE), dtype=np.int32)
    vals_a = np.zeros((G, 8, LANE), dtype=csr.values.dtype)
    cols_a[gid, w8[order], rl[order]] = cw[order]
    vals_a[gid, w8[order], rl[order]] = vals[order]

    g_tile = uniq // (depth.max() + 1)
    g_sw = (g_tile % num_sw).astype(np.int32)
    g_sub = (g_tile // num_sw).astype(np.int32)
    util = nnz / (G * 8 * LANE)
    return cols_a, vals_a, g_sw, g_sub, G, util
