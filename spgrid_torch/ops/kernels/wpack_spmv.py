"""Multi-row packed SpMV: y = A @ x with A in DeviceWPACK layout.

Counterpart of ``spgrid/ops/pallas/wpack_spmv.py`` (format ``wpack_spmv``);
the CUDA kernel is ``spgrid_torch/csrc/wpack_spmv.cu``. ``wpack_spmv``
takes x (k,) and returns y (m,), x unpadded. It launches the kernel for
CUDA tensors and takes ``wpack_spmv_plain`` only for CPU tensors.

A piece is up to 128 nnz of one (128-row target block, wsel·128-column
window), in lanes sorted by target row; ``starts``/``ends`` give, for each
row of the block, the piece's lanes that hold that row (an absent row has
start 1, end 0). ``sel`` picks the 128-column sub-window of each lane, so
slot t of piece p reads x[(piece_w[p] + sel[p, t]) · 128 + cols[p, t]]. A
group is 8 pieces of one target block, and a block's groups are
consecutive.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from spgrid_torch.ops.kernels import _build, check_operands
from spgrid_torch.ops.layouts import group_ptr, to_device

LANE = 128
GROUP_PIECES = 8


def pick_wsel(csr) -> int:
    """The window width in 128-column units (1, 2 or 4), as ``spgrid.ops.
    pallas.wpack_spmv.pick_wsel`` chooses it: the narrowest whose mean nnz
    per occupied (128-row block, 128-column window) run is >= ~64."""
    m, k = csr.shape
    if csr.nnz == 0:
        return 1
    rows = np.repeat(np.arange(m, dtype=np.int64), csr.degrees)
    key = (rows // LANE) * (-(-k // LANE)) + csr.col_idx // LANE
    c_mean = csr.nnz / max(len(np.unique(key)), 1)
    if c_mean >= 64:
        return 1
    if c_mean >= 32:
        return 2
    return 4


def csr_to_wpack(csr, wsel: int | None = None):
    """Pack a CSR matrix into WPACK pieces and groups, as ``spgrid.ops.
    pallas.wpack_spmv.csr_to_wpack`` does.

    Returns (cols int8 (P, 128), vals (P, 128), ends int8 (P, 128), starts
    int8 (P, 128), sel int8 (P, 128), piece_w (P,), group_sub (G,),
    num_groups, utilization, wsel); P == 8 G, pieces padded per target block
    to a multiple of 8 (window 0, zero values, absent-row maps). piece_w is
    the piece's first 128-column window (window · wsel)."""
    m, k = csr.shape
    nnz = csr.nnz
    dt = csr.values.dtype
    if wsel is None:
        wsel = pick_wsel(csr)
    if nnz == 0:
        return (np.zeros((8, LANE), np.int8), np.zeros((8, LANE), dt),
                np.zeros((8, LANE), np.int8), np.ones((8, LANE), np.int8),
                np.zeros((8, LANE), np.int8), np.zeros(8, np.int32),
                np.zeros(1, np.int32), 1, 0.0, 1)
    wl = LANE * wsel
    rows = np.repeat(np.arange(m, dtype=np.int64), csr.degrees)
    cols = csr.col_idx.astype(np.int64)
    b = rows // LANE
    w = cols // wl
    order = np.lexsort((cols, rows, w, b))
    b, w, rows, cols = b[order], w[order], rows[order], cols[order]
    vals_s = csr.values[order]
    tr = (rows % LANE).astype(np.int64)
    off = cols % wl
    cw = (off % LANE).astype(np.int8)
    sel = (off // LANE).astype(np.int8)

    # pieces: <=128-nnz chunks of each (b, w) run
    nwin = -(-k // wl)
    bw_key = b * nwin + w
    runs, run_id, run_cnt = np.unique(bw_key, return_inverse=True,
                                      return_counts=True)
    run_start = np.concatenate([[0], np.cumsum(run_cnt)])[:-1]
    rank = np.arange(nnz, dtype=np.int64) - run_start[run_id]
    pieces_per_run = -(-run_cnt // LANE)
    run_piece0 = np.concatenate([[0], np.cumsum(pieces_per_run)])[:-1]
    pid = run_piece0[run_id] + rank // LANE
    lane = (rank % LANE).astype(np.int64)
    P0 = int(pieces_per_run.sum())
    p_b = (runs // nwin)[np.repeat(np.arange(len(runs)), pieces_per_run)]
    p_w = (runs % nwin)[np.repeat(np.arange(len(runs)), pieces_per_run)]

    # pieces padded per target block to a multiple of 8
    counts = np.bincount(p_b, minlength=int(b.max()) + 1)
    tot = counts + (-counts) % GROUP_PIECES
    G = int(tot.sum()) // GROUP_PIECES
    starts_out = np.concatenate([[0], np.cumsum(tot)])
    starts_in = np.concatenate([[0], np.cumsum(counts)])
    dest = starts_out[p_b] + (np.arange(P0) - starts_in[p_b])

    P = G * GROUP_PIECES
    cols_p = np.zeros((P, LANE), np.int8)
    vals_p = np.zeros((P, LANE), dt)
    ends_p = np.zeros((P, LANE), np.int8)
    starts_p = np.ones((P, LANE), np.int8)
    sel_p = np.zeros((P, LANE), np.int8)
    piece_w = np.zeros(P, np.int32)
    piece_w[dest] = p_w * wsel
    dpid = dest[pid]
    cols_p[dpid, lane] = cw
    vals_p[dpid, lane] = vals_s
    sel_p[dpid, lane] = sel

    # per-piece row-segment lane maps (lanes sorted by target row)
    first = np.ones(nnz, dtype=bool)
    first[1:] = (dpid[1:] != dpid[:-1]) | (tr[1:] != tr[:-1])
    last = np.ones(nnz, dtype=bool)
    last[:-1] = first[1:]
    starts_p[dpid[first], tr[first]] = lane[first]
    ends_p[dpid[last], tr[last]] = lane[last]

    group_sub = np.repeat(np.arange(len(tot), dtype=np.int32),
                          tot // GROUP_PIECES)
    util = nnz / (P * LANE)
    return (cols_p, vals_p, ends_p, starts_p, sel_p, piece_w, group_sub, G,
            util, wsel)


@dataclasses.dataclass
class DeviceWPACK:
    """``csr_to_wpack``'s flat arrays on a torch device, plus ``block_ptr``:
    the groups of target block b are ``block_ptr[b]:block_ptr[b + 1]``.
    (The JAX layout pads groups to 128 and reshapes the metadata into rows
    of 8 steps for the TPU's scalar memory; the port keeps neither.)"""

    cols: torch.Tensor        # (P, 128) int8, col % 128 of each slot
    values: torch.Tensor      # (P, 128), 0 in pad slots
    ends: torch.Tensor        # (P, 128) int8, last lane of each row
    starts: torch.Tensor      # (P, 128) int8, first lane of each row
    sel: torch.Tensor         # (P, 128) int8, sub-window of each slot
    piece_w: torch.Tensor     # (P,) int32, first window of each piece
    group_sub: torch.Tensor   # (G,) int32, target block of each group, sorted
    block_ptr: torch.Tensor   # (ceil(m / 128) + 1,) int32
    shape: Tuple[int, int]
    nnz: int
    utilization: float
    num_groups: int
    wsel: int
    name: str = ""

    @property
    def blocks(self) -> int:
        return len(self.block_ptr) - 1

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.cols, self.values, self.ends, self.starts, self.sel,
            self.piece_w, self.block_ptr))

    @classmethod
    def from_arrays(cls, cols, values, ends, starts, sel, piece_w, group_sub,
                    shape, nnz: int, utilization: float, num_groups: int,
                    wsel: int, name: str = "", *, device) -> "DeviceWPACK":
        """Flat host arrays → device layout; groups past ``num_groups`` (the
        JAX layout's padding) are dropped."""
        G = int(num_groups)
        sub = np.asarray(group_sub, np.int64).reshape(-1)[:G]
        if np.any(np.diff(sub) < 0):
            raise ValueError("wpack: groups must be sorted by target block")
        ptr, _ = group_ptr(sub, max(-(-shape[0] // LANE), 1))
        P = G * GROUP_PIECES

        def slots(a):
            return to_device(np.asarray(a)[:P], device, np.int8)

        return cls(cols=slots(cols), values=to_device(np.asarray(values)[:P],
                                                      device),
                   ends=slots(ends), starts=slots(starts), sel=slots(sel),
                   piece_w=to_device(np.asarray(piece_w).reshape(-1)[:P],
                                     device, np.int32),
                   group_sub=to_device(sub, device, np.int32),
                   block_ptr=to_device(ptr, device), shape=tuple(shape),
                   nnz=int(nnz), utilization=float(utilization), num_groups=G,
                   wsel=int(wsel), name=name)

    @classmethod
    def from_csr(cls, csr, wsel: int | None = None, *,
                 device) -> "DeviceWPACK":
        (cols, vals, ends, starts, sel, pw, gsub, G, util,
         wsel) = csr_to_wpack(csr, wsel)
        return cls.from_arrays(cols, vals, ends, starts, sel, pw, gsub,
                               csr.shape, csr.nnz, util, G, wsel, csr.name,
                               device=device)


def wpack_spmv(a: DeviceWPACK, x: torch.Tensor) -> torch.Tensor:
    """y (m,) f32 = A @ x for f32 x (k,)."""
    if x.dim() != 1 or x.shape[0] != a.shape[1]:
        raise ValueError(f"x must be ({a.shape[1]},), got {tuple(x.shape)}")
    check_operands("wpack_spmv", x.device, x=(x, torch.float32),
                   values=(a.values, torch.float32), cols=(a.cols, torch.int8),
                   ends=(a.ends, torch.int8), starts=(a.starts, torch.int8),
                   sel=(a.sel, torch.int8), piece_w=(a.piece_w, torch.int32),
                   block_ptr=(a.block_ptr, torch.int32))
    if x.device.type == "cpu":
        return wpack_spmv_plain(a, x)
    if x.device.type != "cuda":
        raise ValueError(f"wpack_spmv: no kernel for device {x.device}")
    m, k = a.shape
    y = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.spgrid_wpack_spmv(
            a.block_ptr.data_ptr(), a.piece_w.data_ptr(), a.cols.data_ptr(),
            a.sel.data_ptr(), a.starts.data_ptr(), a.ends.data_ptr(),
            a.values.data_ptr(), x.data_ptr(), y.data_ptr(), a.blocks, m, k,
            stream)
    _build.check(code, "wpack_spmv")
    wpack_spmv.launches += 1
    return y


wpack_spmv.launches = 0


def wpack_spmv_plain(a: DeviceWPACK, x: torch.Tensor) -> torch.Tensor:
    """The same product in plain torch, in x's dtype, without the prefix
    difference: each lane's row is the last present row whose first lane
    is at or before it (rows rise with the lane), and each live slot adds
    value · x[index] to that row (``index_add_``). A slot is live when its
    value is not 0, its x index lies inside x and a row owns it."""
    m, k = a.shape
    P = a.cols.shape[0]
    starts, ends = a.starts.long(), a.ends.long()
    piece, row = torch.nonzero(starts <= ends, as_tuple=True)
    mark = torch.full((P, LANE), -1, dtype=torch.long, device=x.device)
    mark[piece, starts[piece, row]] = row
    owner = torch.cummax(mark, dim=1).values
    sub = a.group_sub.long().repeat_interleave(GROUP_PIECES)
    xi = (a.piece_w.long()[:, None] + a.sel.long()) * LANE + a.cols.long()
    live = (a.values != 0) & (xi < k) & (owner >= 0)
    y = torch.zeros((m,), dtype=x.dtype, device=x.device)
    y.index_add_(0, (sub[:, None] * LANE + owner)[live],
                 a.values[live].to(x.dtype) * x[xi[live]])
    return y
