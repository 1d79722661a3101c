"""SCOO: column-windowed COO SpMM, the counterpart of ``spgrid/ops/scoo.py``.

The JAX package built this layout for the TPU's gather: entries sorted by
(row chunk of R rows, column window of W columns), each (chunk, window)
block padded to a shared slot count E, so that every gather reads a window
of X small enough to stay fast; the entries past E in a heavy block spill
to a row-sorted COO tail. ``DeviceSCOO`` holds that plan and those arrays
verbatim (E chosen by the same cost of padded slots plus weighted spill).

The JAX op walks the chunks, and in each chunk the windows, scatter-adding
a block's products into the chunk's rows. ``scoo_spmm`` walks the chunks
too and gathers X through each entry's window (window j's row j W + its
local column), but sums each row's products in one fixed order (windows
ascending, slots ascending: ``main_order``) with ``xla.segment_sum``, then
adds the spill tail's row sums: a torch op with no atomics, the same bits
every call.
"""

from __future__ import annotations

import numpy as np
import torch

from spgrid_torch.formats.csr import CSRMatrix
from spgrid_torch.ops.layouts import nbytes, round_up, segment_ptr, \
    to_device
from spgrid_torch.ops.xla import segment_sum


class DeviceSCOO:
    """(nb, ns, E) padded block-COO with window-local coordinates, a spill
    tail, and the orders of their row sums."""

    def __init__(self, csr: CSRMatrix, chunk_rows: int = 1 << 15,
                 window_cols: int = 1 << 15, *, device):
        m, k = csr.shape
        R = min(chunk_rows, round_up(max(m, 8), 8))
        W = min(window_cols, k)
        nb = -(-m // R)
        ns = -(-k // W)
        rows = np.repeat(np.arange(m, dtype=np.int64), csr.degrees)
        cols = csr.col_idx.astype(np.int64)
        vals = csr.values.astype(np.float32)
        blk = (rows // R) * ns + cols // W
        order = np.argsort(blk, kind="stable")
        rows, cols, vals, blk = (rows[order], cols[order], vals[order],
                                 blk[order])
        counts = np.bincount(blk, minlength=nb * ns)
        # the slot cap E minimizing nb*ns*E padded slots plus 8 times the
        # spilled entries (the JAX package's two-tier choice)
        SPILL_W = 8
        cands = np.unique(np.concatenate(([8], counts[counts >= 8])))
        spills = np.array([np.maximum(counts - int(e), 0).sum()
                           for e in cands], dtype=np.int64)
        E = int(cands[np.argmin(nb * ns * cands + SPILL_W * spills)])
        off = np.zeros(nb * ns + 1, np.int64)
        np.cumsum(counts, out=off[1:])
        pos = np.arange(csr.nnz, dtype=np.int64) - off[blk]
        keep = pos < E
        slot = pos[keep] + blk[keep] * E
        lrow = np.full(nb * ns * E, R, np.int32)      # pad -> sacrificial row
        lcol = np.zeros(nb * ns * E, np.int32)
        lval = np.zeros(nb * ns * E, np.float32)
        lrow[slot] = (rows[keep] % R).astype(np.int32)
        lcol[slot] = (cols[keep] % W).astype(np.int32)
        lval[slot] = vals[keep]
        # spill tail: global-coordinate COO, row-sorted, padded to x8 with
        # row m-1 and value 0
        sp = ~keep
        so = np.argsort(rows[sp], kind="stable")
        srow = rows[sp][so].astype(np.int32)
        scol = cols[sp][so].astype(np.int32)
        sval = vals[sp][so]
        spad = round_up(srow.size, 8) if srow.size else 0
        # the row sums' order: each row's kept slots by (window, slot)
        main = slot[np.lexsort((slot, rows[keep]))]
        main_ptr = segment_ptr(rows[keep], m)
        self.rows = to_device(lrow.reshape(nb, ns, E), device)
        self.cols = to_device(lcol.reshape(nb, ns, E), device)
        self.values = to_device(lval.reshape(nb, ns, E), device)
        self.srows = to_device(np.pad(srow, (0, spad - srow.size),
                                      constant_values=m - 1), device)
        self.scols = to_device(np.pad(scol, (0, spad - scol.size)), device)
        self.svalues = to_device(np.pad(sval, (0, spad - sval.size)), device)
        self.main_order = to_device(main, device, np.int64)
        self.main_ptr = to_device(main_ptr, device)
        self.spill_ptr = to_device(segment_ptr(srow, m), device)
        self.chunk_ptr = tuple(int(main_ptr[min(i * R, m)])
                               for i in range(nb + 1))
        self.num_spill = int(srow.size)
        self.shape = tuple(csr.shape)
        self.nnz = csr.nnz
        self.plan = (nb, ns, R, W, E)
        self.name = csr.name

    @classmethod
    def from_csr(cls, csr: CSRMatrix, *, device, **kw) -> "DeviceSCOO":
        return cls(csr, device=device, **kw)

    @property
    def mem_footprint(self) -> int:
        """The JAX layout's bytes: 12 a slot and a spill entry."""
        return self.rows.numel() * 12 + self.srows.numel() * 12

    @property
    def nbytes(self) -> int:
        return nbytes(self.rows, self.cols, self.values, self.srows,
                      self.scols, self.svalues, self.main_order,
                      self.main_ptr, self.spill_ptr)


def scoo_spmm(a: DeviceSCOO, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X in f32; x may be (k,) or (k, n). A chunk of R rows at a
    time: each kept entry's X row read through its window (j W + local
    column), weighted, and the chunk's rows summed in ``main_order``; then
    the spill tail's row sums added."""
    squeeze = x.dim() == 1
    x2 = x[:, None] if squeeze else x
    nb, ns, R, W, E = a.plan
    m = a.shape[0]
    n = x2.shape[1]
    cols = a.cols.reshape(-1)
    vals = a.values.reshape(-1)
    y = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    for i in range(nb):
        r0, r1 = i * R, min((i + 1) * R, m)
        s, e = a.chunk_ptr[i], a.chunk_ptr[i + 1]
        sl = a.main_order[s:e]
        gcol = (sl // E % ns) * W + cols.index_select(0, sl)
        prods = x2.index_select(0, gcol).to(torch.float32).mul_(
            vals.index_select(0, sl)[:, None])
        y[r0:r1] = segment_sum(prods, a.main_ptr[r0:r1 + 1] - s)
    if a.num_spill:
        ns_ = a.num_spill
        p = x2.index_select(0, a.scols[:ns_]).to(torch.float32).mul_(
            a.svalues[:ns_, None])
        y += segment_sum(p, a.spill_ptr)
    y = y.to(x2.dtype)
    return y[:, 0] if squeeze else y
