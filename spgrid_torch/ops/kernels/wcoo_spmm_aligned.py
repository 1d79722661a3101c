"""Aligned-slot banded SpMM: Y = A @ X with A in DeviceWCOOBands layout.

Counterpart of ``spgrid/ops/pallas/wcoo_spmm_aligned.py`` (format
``wcoo_bands``); the CUDA kernel is ``spgrid_torch/csrc/wcoo_bands.cu`` over
the shared walk of ``csrc/slot_rows.cuh``. ``wcoo_spmm_aligned`` takes X
(k, n) and returns Y (m, n), X unpadded, in X's dtype: f32, or bf16
(``wcoo_spmm_aligned_bf16``: a layout built from a bf16 matrix, bf16 values
and X, each product rounded to bf16 before it is added into the f32 sum,
as the Pallas kernel's bf16 multiply rounds it, and Y rounded once). It
launches the kernel for CUDA tensors, which reads the layout's row-ordered
live-slot stream (``ops/kernels/slot_rows.py``), and takes
``wcoo_spmm_aligned_plain``, which reads the padded groups, only for CPU
tensors; an f64 X raises.

The bf16 form walks X in column slabs (``launch_plan``: the slab rule in
Python, the widest slab, which measured fastest; ``launch_shape`` asks the
card), a lane 16 bytes of an X row where n % 8 == 0 and X and Y lie on 16
bytes; ``launch`` runs it at any slab, uncounted, for sweeps and tests.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from spgrid_torch.formats.wcoo import LANE, csr_to_wcoo_aligned
from spgrid_torch.formats.csr import value_dtype
from spgrid_torch.ops.kernels import (
    _build, check_form, check_operands, runs_plain)
from spgrid_torch.ops.kernels.slot_rows import (
    LONG_ROW, SLAB, UNROLL_LOADS, WARPS, RowStream, check_rows, launch_rows,
    row_stream, stream_tensors, walk_sums)
from spgrid_torch.ops.layouts import (
    group_ptr, round_up, to_device, torch_dtype)
from spgrid_torch.ops.xla import acc_dtype

G_STEP = 16          # groups of a step; a step's groups share its superwindow
GROUP_ROWS = 8       # windows of a superwindow == slot rows of a group


def bands_arrays(csr, band_rows: int = 4096):
    """Host arrays of the banded layout, as ``spgrid.ops.pallas.
    wcoo_spmm_aligned.DeviceWCOOBands.from_csr`` builds them: (cols int8
    (T*8, 128), values (T*8, 128), g_sw (steps,), g_lb (steps padded to 8,
    G_STEP), utilization, bands, mbb, steps_per_band).

    Groups are sorted by (band, superwindow, row block); each (band,
    superwindow) run is padded to a multiple of G_STEP and each band to the
    longest band. Pad groups keep their run's superwindow, hold zero values
    and target the sacrificial row block ``mbb``."""
    m, k = csr.shape
    R = min(band_rows, round_up(max(m, LANE), LANE))
    mbb = R // LANE
    cols_a, vals_a, g_sw, g_sub, G, util = csr_to_wcoo_aligned(csr)
    band = g_sub // mbb
    bands = max(-(-(-(-m // LANE)) // mbb), int(band.max(initial=0)) + 1, 1)
    lb = g_sub - band * mbb
    order = np.lexsort((g_sub, g_sw, band))
    band, sw, lb = band[order], g_sw[order], lb[order]
    cols_a, vals_a = cols_a[order], vals_a[order]

    run_id = np.zeros(G, dtype=np.int64)
    if G > 1:
        run_id[1:] = np.cumsum((band[1:] != band[:-1]) | (sw[1:] != sw[:-1]))
    run_len = np.bincount(run_id)
    run_pad = (-run_len) % G_STEP
    band_len = np.zeros(bands, dtype=np.int64)
    np.add.at(band_len, band[np.unique(run_id, return_index=True)[1]],
              run_len + run_pad)
    gb_max = round_up(max(int(band_len.max(initial=0)), G_STEP), G_STEP)
    steps_per_band = gb_max // G_STEP

    T = bands * gb_max
    out_cols = np.zeros((T, GROUP_ROWS, LANE), np.int32)
    out_vals = np.zeros((T, GROUP_ROWS, LANE), vals_a.dtype)
    out_sw = np.zeros(T, np.int32)
    out_lb = np.full(T, mbb, np.int32)
    first_of_run = np.ones(G, dtype=bool)
    if G > 1:
        first_of_run[1:] = run_id[1:] != run_id[:-1]
    run_starts = np.flatnonzero(first_of_run)
    cum_pad = np.concatenate([[0], np.cumsum(run_pad)])
    run_band = band[run_starts]
    band_first_run = np.searchsorted(run_band, np.arange(bands), "left")
    pad_before_run = cum_pad[:-1] - cum_pad[band_first_run[run_band]]
    idx_in_band = np.arange(G) - np.concatenate(
        [[0], np.cumsum(np.bincount(band)[:-1])])[band]
    dest = band * gb_max + idx_in_band + pad_before_run[run_id]
    out_cols[dest] = cols_a
    out_vals[dest] = vals_a
    out_sw[dest] = sw
    out_lb[dest] = lb
    # pad groups take the superwindow of the real group before them in
    # their band (0 at a band's start)
    filled = np.zeros(T, dtype=bool)
    filled[dest] = True
    for b in range(bands):
        seg = slice(b * gb_max, (b + 1) * gb_max)
        if filled[seg].any():
            idxs = np.where(filled[seg], np.arange(gb_max), 0)
            np.maximum.accumulate(idxs, out=idxs)
            out_sw[seg] = out_sw[seg][idxs]
    step_sw = out_sw.reshape(-1, G_STEP)[:, 0].copy()
    lb2 = out_lb.reshape(-1, G_STEP)
    pad8 = (-lb2.shape[0]) % 8
    if pad8:
        lb2 = np.concatenate([lb2, np.full((pad8, G_STEP), mbb, np.int32)])
    return (out_cols.reshape(-1, LANE).astype(np.int8),
            out_vals.reshape(-1, LANE), step_sw, lb2, util, bands, mbb,
            steps_per_band)


def bands_row_stream(cols, values, g_sw, block_ptr, block_groups, shape):
    """The stream of a banded layout: slot (w, lane) of real group g of
    block b adds to row 128 b + lane from X row 1024 sw + 128 w + col, sw
    the superwindow of g's step and col read as an unsigned byte, in group
    and then slot order. Pad groups and the sacrificial row block are in
    no block's list and are never read."""
    g = np.asarray(block_groups, np.int64)
    ptr = np.asarray(block_ptr, np.int64)
    block = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    slots = (-1, GROUP_ROWS, LANE)
    w = np.arange(GROUP_ROWS)[:, None]
    col = np.asarray(cols, np.int8).view(np.uint8).reshape(slots)[g]
    xrows = (np.asarray(g_sw, np.int64)[g // G_STEP][:, None, None]
             * (GROUP_ROWS * LANE) + w * LANE + col)
    out = np.broadcast_to(block[:, None, None] * LANE + np.arange(LANE),
                          xrows.shape)
    return row_stream(out, xrows, np.asarray(values).reshape(slots)[g],
                      *shape)


@dataclasses.dataclass
class DeviceWCOOBands(RowStream):
    """The arrays of ``spgrid.ops.pallas.wcoo_spmm_aligned.DeviceWCOOBands``
    on a torch device, plus ``block_ptr``/``block_groups``: the groups of
    each 128-row block ``band * mbb + lb``, in group order (inside a band
    groups are sorted by superwindow first, so a block's are not
    consecutive). Pad groups belong to no block. Also the row-ordered
    live-slot stream that the kernel reads (``slot_rows.py``)."""

    cols: torch.Tensor          # (T*8, 128) int8, col % 128 of each slot
    values: torch.Tensor        # (T*8, 128) f32 or bf16, 0 in empty slots
    g_sw: torch.Tensor          # (steps,) int32, superwindow of each step
    g_lb: torch.Tensor          # (steps_pad8, G_STEP) int32, pad -> mbb
    block_ptr: torch.Tensor     # (bands*mbb + 1,) int32
    block_groups: torch.Tensor  # (real groups,) int32
    # the row stream: S live slots by output row, in group and slot order
    row_slot: torch.Tensor      # (m + 1,) int32, row r's live slots
    slot_vals: torch.Tensor     # (S,) value of each live slot (as values)
    slot_xrows: torch.Tensor    # (S,) int32, X row of each live slot
    long_rows: torch.Tensor     # (L,) int32, rows of > LONG_ROW slots
    shape: Tuple[int, int]
    nnz: int
    utilization: float
    bands: int
    mbb: int                    # 128-row blocks of a band
    steps_per_band: int
    name: str = ""

    @property
    def blocks(self) -> int:
        return len(self.block_ptr) - 1

    @property
    def nbytes(self) -> int:
        return self.stream_nbytes + sum(
            t.numel() * t.element_size() for t in (
                self.cols, self.values, self.g_sw, self.block_ptr,
                self.block_groups))

    @classmethod
    def from_arrays(cls, cols, values, g_sw, g_lb, shape, nnz: int,
                    utilization: float, bands: int, mbb: int,
                    steps_per_band: int, name: str = "", *, device,
                    dtype: torch.dtype = torch.float32) -> "DeviceWCOOBands":
        """The layout of ``bands_arrays``' arrays, its values in ``dtype``
        (f32, or bf16 for a matrix whose values are bf16)."""
        T = bands * steps_per_band * G_STEP
        lb = np.asarray(g_lb, np.int64).reshape(-1)[:T]
        band = np.arange(T) // (steps_per_band * G_STEP)
        ptr, groups = group_ptr(np.where(lb < mbb, band * mbb + lb, -1),
                                bands * mbb)
        stream = stream_tensors(
            bands_row_stream(cols, values, g_sw, ptr, groups, shape), device)
        stream["slot_vals"] = stream["slot_vals"].to(dtype)
        return cls(cols=to_device(cols, device, np.int8),
                   values=to_device(values, device).to(dtype),
                   g_sw=to_device(g_sw, device, np.int32),
                   g_lb=to_device(g_lb, device, np.int32),
                   block_ptr=to_device(ptr, device),
                   block_groups=to_device(groups, device),
                   **stream, shape=tuple(shape),
                   nnz=int(nnz), utilization=float(utilization),
                   bands=int(bands), mbb=int(mbb),
                   steps_per_band=int(steps_per_band), name=name)

    @classmethod
    def from_csr(cls, csr, band_rows: int = 4096, *,
                 device) -> "DeviceWCOOBands":
        (cols, vals, g_sw, g_lb, util, bands, mbb,
         spb) = bands_arrays(csr, band_rows)
        return cls.from_arrays(cols, vals, g_sw, g_lb, csr.shape, csr.nnz,
                               util, bands, mbb, spb, csr.name, device=device,
                               dtype=torch_dtype(value_dtype(csr)))


def _check(kernel: str, a: DeviceWCOOBands, x: torch.Tensor,
           dtype: torch.dtype) -> None:
    if x.dim() != 2 or x.shape[0] != a.shape[1]:
        raise ValueError(f"x must be ({a.shape[1]}, n), got {tuple(x.shape)}")
    check_operands(kernel, x.device, x=(x, dtype), values=(a.values, dtype),
                   cols=(a.cols, torch.int8), g_sw=(a.g_sw, torch.int32),
                   block_ptr=(a.block_ptr, torch.int32),
                   block_groups=(a.block_groups, torch.int32))
    check_rows(kernel, a, x, dtype)


# The bf16 walk's slabs (csrc/wcoo_bands.cu, bands_slab): powers of two
# from 64 to MAX_SLAB columns, the rule's the widest (one slab of n where n
# is no wider); SETS sets of rows a warp, BUDGET raw registers of X a lane,
# at most MAX_U slots in flight (csrc/slot_rows.cuh).
MAX_SLAB = 512
SETS = 2
BUDGET = 32
MAX_U = 8


class BandsShape(NamedTuple):
    """The bf16 walk's launch: ``slab`` columns a slab, ``slabs`` of them,
    ``rows`` rows a CTA, ``lanes`` lanes a row, ``u`` slots in flight a
    lane."""

    slab: int
    slabs: int
    rows: int
    lanes: int
    u: int


def launch_plan(n: int, vec: int, slab: int = 0) -> BandsShape:
    """What ``csrc/wcoo_bands.cu``'s ``launch_bands`` launches for X (k, n)
    at ``slab`` (0: the rule) in form ``vec`` (2: 16 bytes a lane, 1: 8, 0:
    an element): the kernel's rule in Python; ``launch_shape`` asks the
    card."""
    slab = min(slab or MAX_SLAB, n)
    slabs = -(-n // slab)
    if vec != 2:
        c = 1 if slab <= SLAB else 2 if slab <= 2 * SLAB else 4
        return BandsShape(slab, slabs, WARPS, 32, UNROLL_LOADS // c)
    vectors = -(-slab // 8)
    p = 1
    while p < vectors:
        p *= 2
    lanes = min(p, 32)
    per_lane = p // lanes
    u = MAX_U
    while u > 1 and (u > lanes or 4 * per_lane * u > BUDGET
                     or 4 * per_lane * u + 8 * per_lane > BUDGET + 8):
        u //= 2
    return BandsShape(slab, slabs, WARPS * SETS * 32 // lanes, lanes, u)


def launch_shape(n: int, vec: int, slab: int = 0) -> BandsShape:
    """The launch the bf16 walk makes on the current card for X (k, n) at
    ``slab`` (0: its rule) in form ``vec`` (as ``launch_plan``)."""
    shape = (ctypes.c_int * 5)()
    _build.check(_build.library().spgrid_wcoo_bands_bf16_shape(
        n, slab, vec, ctypes.addressof(shape)), "wcoo_spmm_aligned_bf16")
    return BandsShape(*shape)


def vector_form(x: torch.Tensor, y: torch.Tensor) -> int:
    """The bf16 walk's form for X and Y (as ``bands_vec``): 2 where n % 8 ==
    0 and both lie on 16 bytes, 1 where n % 4 == 0 and on 8, else 0."""
    n = x.shape[1]
    at = x.data_ptr() | y.data_ptr()
    return 2 if n % 8 == 0 and at % 16 == 0 else (
        1 if n % 4 == 0 and at % 8 == 0 else 0)


def launch(a: DeviceWCOOBands, x: torch.Tensor, y: torch.Tensor,
           slab: int = 0) -> None:
    """One launch of the bf16 walk (and the long-row walk) into ``y`` at
    ``slab`` (0: the rule; a power of two from 64 to 512), uncounted;
    ``wcoo_spmm_aligned_bf16`` is the entry point."""
    m = a.shape[0]
    n = x.shape[1]
    if m == 0 or n == 0:
        return
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _build.library().spgrid_wcoo_bands_bf16(
            a.row_slot.data_ptr(), a.slot_vals.data_ptr(),
            a.slot_xrows.data_ptr(), a.long_rows.data_ptr(), x.data_ptr(),
            y.data_ptr(), m, n, LONG_ROW, len(a.long_rows), slab, stream)
    _build.check(code, "wcoo_spmm_aligned_bf16")


def _run(wrapper, a: DeviceWCOOBands, x: torch.Tensor,
         dtype: torch.dtype) -> torch.Tensor:
    _check(wrapper.__name__, a, x, dtype)
    if runs_plain(wrapper.__name__, x.device):
        return wcoo_spmm_aligned_plain(a, x)
    if dtype != torch.bfloat16:
        return launch_rows(wrapper, "spgrid_wcoo_bands", a, x)
    y = torch.empty((a.shape[0], x.shape[1]), dtype=dtype, device=x.device)
    launch(a, x, y)
    wrapper.launches += 1
    return y


def wcoo_spmm_aligned(a: DeviceWCOOBands, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) = A @ X in X's dtype: f32 X (k, n), or bf16 X for a bf16
    layout (``wcoo_spmm_aligned_bf16``)."""
    check_form("wcoo_spmm_aligned", x.dtype)
    if x.dtype == torch.bfloat16:
        return wcoo_spmm_aligned_bf16(a, x)
    return _run(wcoo_spmm_aligned, a, x, torch.float32)


wcoo_spmm_aligned.launches = 0


def wcoo_spmm_aligned_bf16(a: DeviceWCOOBands,
                           x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) bf16 = A @ X for a bf16 layout and bf16 X (k, n): each
    product rounded to bf16, added in f32, each element of Y rounded
    once."""
    return _run(wcoo_spmm_aligned_bf16, a, x, torch.bfloat16)


wcoo_spmm_aligned_bf16.launches = 0


def wcoo_spmm_aligned_plain(a: DeviceWCOOBands,
                            x: torch.Tensor) -> torch.Tensor:
    """The same product in plain torch, in x's dtype: slot (w, lane) of a
    real group adds value · X[1024 sw + 128 w + col] to row 128 block + lane,
    for slots whose value is not 0 and X row lies inside X, each row's
    products summed in slot order as the walk sums them
    (``slot_rows.walk_sums``: the same bits on the card and on the CPU).
    bf16: each product rounded to bf16, added in f32, Y rounded once."""
    m, k = a.shape
    g = a.block_groups.long()
    block = torch.repeat_interleave(
        torch.arange(a.blocks, device=x.device),
        (a.block_ptr[1:] - a.block_ptr[:-1]).long())
    slots = (GROUP_ROWS, LANE)
    vals = a.values.view(-1, *slots)[g]
    w = torch.arange(GROUP_ROWS, device=x.device)[:, None]
    lane = torch.arange(LANE, device=x.device)
    xrow = (a.g_sw.long()[g // G_STEP][:, None, None] * (GROUP_ROWS * LANE)
            + w * LANE + a.cols.view(-1, *slots)[g].long())
    row = (block[:, None, None] * LANE + lane).expand(-1, *slots)
    live = (vals != 0) & (xrow < k)
    prods = vals[live].to(x.dtype)[:, None] * x[xrow[live]]
    acc = acc_dtype(x)
    # each row's products in slot order (the stream's), summed as the walk
    # sums them: one fixed order on the card as on the CPU
    row = row[live]
    order = torch.sort(row, stable=True).indices
    offsets = torch.zeros(m + 1, dtype=torch.int64, device=x.device)
    offsets[1:] = torch.cumsum(torch.bincount(row, minlength=m), 0)
    return walk_sums(prods.to(acc)[order], offsets).to(x.dtype)
