"""Vertical-panel SpMM: Y = A @ X with A in DevicePanels layout.

Counterpart of ``spgrid/ops/pallas/panel_spmm.py``; the CUDA kernels are
``spgrid_torch/csrc/panel_spmm.cu``'s four forms: f32 panels
(``panel_pallas``), bf16 panels with f32 X and Y (``cv_panel``:
``DevicePanels.as_bf16``, bf16 panels times X rounded to bf16, f32 sums, as
the Pallas kernel multiplies bf16 panels at precision "default", whatever
the ambient precision), bf16 panels with bf16 X and Y (``panel_pallas`` at
dtype bf16: f32 sums, Y rounded once), and f32 panels at matmul precision
'high' (``panel_spmm_bf16x3``: the panels and X split into bf16 hi and lo
parts, P_hi X_hi + P_hi X_lo + P_lo X_hi summed in f32). ``panel_spmm(...,
precision=)`` launches the form its panels, X and the precision take for
CUDA tensors (``panel_spmm_bf16`` counts the cv_panel form's launches,
``panel_spmm_bf16_xy`` the bf16 form's) and takes its plain version
(``panel_spmm_plain``, ``panel_spmm_bf16x3_plain``) only for CPU tensors;
an f64 X, or a precision without a form, raises.

The f32 form runs the tensor-core tile of ``csrc/block_mma.cuh`` as
``bsr_spmm`` does, a band being a row of blocks whose blocks are its panel
slots: one tile a (band, 128-row slice of it, 64 columns of X), its
contraction (the band's real panels, 32 columns a step) split across a
cluster where the tiles alone would leave the card idle (``launch_grid``
reports the launch). The bf16 forms launch the same tiles but walk only
the slots live in their slice (``DevicePanels.slice_ptr``/``slice_slots``),
64 columns a step into bf16 ``wgmma`` (``csrc/bf16_mma.cuh``): the bf16
panels' form on the pipelined tile (TMA, a producer warpgroup, 128
columns of X a tile) where TMA takes its operands, cv_panel's through a
``cp.async`` ring. The 3-pass form splits the live slices' panel rows and
X once into bf16 planes (in scratch the wrapper allocates: ``x3_shape``;
the panel rows packed, 128 rows a live (panel, slice) pair),
then walks the live slots on the TMA-fed 3-pass tile of
``csrc/bf16x3.cuh``, 128 columns of X a tile.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from spgrid_torch.formats.csr import CSRMatrix, itemsize, value_dtype
from spgrid_torch.ops.kernels import (
    OTHER_PRECISIONS, _build, check_form, check_operands, runs_plain)
from spgrid_torch.ops.dense import full_f32
from spgrid_torch.ops.kernels.bf16x3 import bmm_bf16x3
from spgrid_torch.ops.kernels.block_mma import LaunchShape, query
from spgrid_torch.ops.layouts import (
    LayoutRefused, round_up, values_to_device)
from spgrid_torch.ops.xla import acc_dtype

# Rows of the kernels' tile (``ROWS`` of ``csrc/block_mma.cuh``): the bf16
# form's live-slice index lists a band's live slots in slices of this many.
SLICE_ROWS = 128


def panel_arrays(csr: CSRMatrix, bk: int = 128, band_rows: int = 2048,
                 max_bytes: int = 4 << 30):
    """Host arrays of the panel layout, as ``spgrid.ops.pallas.panel_spmm.
    DevicePanels.from_csr`` builds them: (block_cols, panels, counts,
    num_panels, R, bands, max_p). ``counts[band]`` is the band's number of
    real panels; its slots past that are pad slots."""
    return _panel_layout(csr, bk, band_rows, max_bytes)[:7]


def _panel_layout(csr: CSRMatrix, bk: int, band_rows: int, max_bytes: int):
    """``panel_arrays``' arrays, then each nnz's slot and row in its band."""
    m, k = csr.shape
    R = min(band_rows, round_up(max(m, 8), 8))
    bands = -(-m // R)
    kb = -(-k // bk)
    rows = np.repeat(np.arange(m, dtype=np.int64), csr.degrees)
    cols = csr.col_idx.astype(np.int64)
    key = (rows // R) * kb + cols // bk
    uniq, inv = np.unique(key, return_inverse=True)
    num_panels = len(uniq)
    est = num_panels * R * bk * itemsize(value_dtype(csr))
    if est > max_bytes:
        raise LayoutRefused(
            f"panels would need ~{est/2**30:.1f} GiB "
            f"({num_panels} nonempty (R={R}, bk={bk}) panels); "
            f"matrix too scattered for the panel layout")
    u_band = uniq // kb
    u_col = (uniq % kb).astype(np.int32)
    counts = np.bincount(u_band, minlength=bands)
    max_p = max(int(counts.max(initial=1)), 1)
    starts = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(num_panels) - starts[u_band] + u_band * max_p

    pcols = np.zeros(bands * max_p, dtype=np.int32)
    panels = np.zeros((bands * max_p, R, bk), dtype=csr.values.dtype)
    pcols[slot] = u_col
    panels[slot[inv], rows % R, cols % bk] = csr.values
    # pad slots repeat the band's last real column
    for b in range(bands):
        s, e = starts[b], starts[b + 1]
        last = int(u_col[e - 1]) if e > s else 0
        pcols[b * max_p + (e - s): (b + 1) * max_p] = last
    return (pcols, panels, counts.astype(np.int32), num_panels, R, bands,
            max_p, slot[inv], rows % R)


def live_slices(slots: np.ndarray, rows: np.ndarray, bands: int,
                band_rows: int, max_p: int):
    """The live-slice index of the bf16 kernel's walk: (slice_ptr,
    slice_slots), int32. For entries at panel slot ``slots[e]``, row
    ``rows[e]`` of its band, slice ``band * slices + row // SLICE_ROWS``
    (slices = ceil(band_rows / SLICE_ROWS)) lists the slots that hold an
    entry in it, ascending (in column order), at
    ``slice_slots[slice_ptr[slice]:slice_ptr[slice + 1]]``."""
    slices = -(-band_rows // SLICE_ROWS)
    num_slots = bands * max_p
    slots = np.asarray(slots, dtype=np.int64)
    pair = np.unique((slots // max_p * slices
                      + np.asarray(rows, dtype=np.int64) // SLICE_ROWS)
                     * num_slots + slots)
    ptr = np.zeros(bands * slices + 1, dtype=np.int32)
    ptr[1:] = np.cumsum(np.bincount(pair // num_slots,
                                    minlength=bands * slices))
    return ptr, (pair % num_slots).astype(np.int32)


@dataclasses.dataclass
class DevicePanels:
    """Nonempty (band, block-col) vertical panels, band-major col-sorted.

    Bands are padded to ``max_p`` panel slots; pad slots repeat the previous
    slot's column and hold zero panels. ``counts`` holds each band's number
    of real panels, so the f32 kernel skips the pad slots; ``slice_ptr`` and
    ``slice_slots`` (``live_slices``) list each 128-row slice's live slots,
    the bf16 kernel's walk."""

    block_cols: torch.Tensor    # (bands*max_p,) int32
    panels: torch.Tensor        # (bands*max_p, R, bk)
    counts: torch.Tensor        # (bands,) int32
    shape: Tuple[int, int]
    nnz: int
    num_panels: int             # true panel count
    band_rows: int              # R
    bands: int
    max_p: int
    slice_ptr: torch.Tensor     # (bands*ceil(R/128) + 1,) int32
    slice_slots: torch.Tensor   # (slice_ptr[-1],) int32

    @property
    def bk(self) -> int:
        return self.panels.shape[2]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.block_cols, self.panels, self.counts, self.slice_ptr,
            self.slice_slots))

    def as_bf16(self) -> "DevicePanels":
        """The same layout with its panels rounded to bf16 (to nearest, ties
        to even: ``cv_panel``'s panels)."""
        return dataclasses.replace(self, panels=self.panels.to(
            torch.bfloat16))

    @classmethod
    def from_csr(cls, csr: CSRMatrix, bk: int = 128, band_rows: int = 2048,
                 max_bytes: int = 4 << 30, *, device) -> "DevicePanels":
        """The layout of ``csr``; its live-slice index follows the CSR's
        pattern, so an explicit zero keeps its slice live."""
        (pcols, panels, counts, num_panels, R, bands, max_p, slots,
         rows) = _panel_layout(csr, bk, band_rows, max_bytes)
        slice_ptr, slice_slots = live_slices(slots, rows, bands, R, max_p)
        return cls(
            block_cols=torch.from_numpy(pcols).to(device),
            panels=values_to_device(panels, device, value_dtype(csr)),
            counts=torch.from_numpy(counts).to(device),
            shape=csr.shape, nnz=csr.nnz, num_panels=num_panels,
            band_rows=R, bands=bands, max_p=max_p,
            slice_ptr=torch.from_numpy(slice_ptr).to(device),
            slice_slots=torch.from_numpy(slice_slots).to(device))


def _check(a: DevicePanels, x: torch.Tensor, precision=None) -> None:
    if x.dim() != 2 or x.shape[0] != a.shape[1]:
        raise ValueError(f"x must be ({a.shape[1]}, n), got {tuple(x.shape)}")
    check_form("panel_spmm", x.dtype, precision=precision,
               other_precisions=OTHER_PRECISIONS)
    if a.panels.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"panel_spmm: panels must be f32 or bf16, got "
                        f"{a.panels.dtype}")
    if x.dtype == torch.bfloat16 and a.panels.dtype != torch.bfloat16:
        raise TypeError("panel_spmm: a bf16 X takes bf16 panels "
                        "(DevicePanels.as_bf16)")
    check_operands("panel_spmm", x.device, x=(x, x.dtype),
                   panels=(a.panels, a.panels.dtype),
                   block_cols=(a.block_cols, torch.int32),
                   counts=(a.counts, torch.int32),
                   slice_ptr=(a.slice_ptr, torch.int32),
                   slice_slots=(a.slice_slots, torch.int32))


def launch_grid(a: DevicePanels, n: int,
                x_dtype: torch.dtype = torch.float32) -> LaunchShape:
    """The launch of the form ``a``'s panels and an X of ``x_dtype`` take at
    n columns of X on the card ``a`` lies on, as ``spgrid_panel_spmm`` or
    ``spgrid_panel_spmm_bf16`` makes it (the cluster depends on the card's
    SM count; the bf16 form runs the pipelined tile of 128 columns where n
    and bk are multiples of 8)."""
    with torch.cuda.device(a.panels.device):
        if a.panels.dtype != torch.bfloat16:
            return query("spgrid_panel_spmm_shape", "panel_spmm", a.bands,
                         a.band_rows, n)
        return query("spgrid_panel_spmm_bf16_shape", "panel_spmm", a.bands,
                     a.band_rows, a.bk, n, int(x_dtype == torch.bfloat16))


def launch(a: DevicePanels, x: torch.Tensor, y: torch.Tensor,
           cluster: int = 0) -> None:
    """One launch of the form ``a``'s panels and ``x`` take into ``y`` (m,
    n) at a given cluster (0: the launch rule), uncounted: for sweeps and
    tests."""
    m, k = a.shape
    n = x.shape[1]
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if a.panels.dtype == torch.bfloat16:
            entry = "spgrid_panel_spmm_bf16"
            code = lib.spgrid_panel_spmm_bf16(
                a.slice_ptr.data_ptr(), a.slice_slots.data_ptr(),
                a.block_cols.data_ptr(), a.panels.data_ptr(), x.data_ptr(),
                y.data_ptr(), a.bands, a.max_p, a.band_rows, a.bk, m, k, n,
                int(x.dtype == torch.bfloat16), cluster, stream)
        else:
            entry = "spgrid_panel_spmm"
            code = lib.spgrid_panel_spmm(
                a.counts.data_ptr(), a.block_cols.data_ptr(),
                a.panels.data_ptr(), x.data_ptr(), y.data_ptr(), a.bands,
                a.max_p, a.band_rows, a.bk, m, k, n, cluster, stream)
    _build.check(code, entry[len("spgrid_"):])


def x3_shape(a: DevicePanels, n: int):
    """(the 3-pass form's tile launch, the bytes of its split planes) for
    ``a`` at n columns of X on the card ``a`` lies on, as
    ``spgrid_panel_spmm_bf16x3_shape`` reports them."""
    shape = (ctypes.c_int * 6)()
    scratch = ctypes.c_longlong()
    with torch.cuda.device(a.panels.device):
        _build.check(_build.library().spgrid_panel_spmm_bf16x3_shape(
            a.bands, a.slice_slots.numel(), a.band_rows, a.bk, a.shape[1], n,
            ctypes.addressof(shape), ctypes.addressof(scratch)),
            "panel_spmm_bf16x3")
    return LaunchShape(*shape), scratch.value


def x3_launch(a: DevicePanels, x: torch.Tensor, y: torch.Tensor,
              cluster: int = 0) -> None:
    """Y (m, n) = A @ X at matmul precision 'high' into ``y`` (its split
    planes in new scratch), the tile's cluster given (0: the launch rule),
    uncounted: for sweeps and tests."""
    m, k = a.shape
    n = x.shape[1]
    scratch = torch.empty(x3_shape(a, n)[1], dtype=torch.uint8,
                          device=x.device)
    with torch.cuda.device(x.device):
        _build.check(_build.library().spgrid_panel_spmm_bf16x3(
            a.slice_ptr.data_ptr(), a.slice_slots.data_ptr(),
            a.block_cols.data_ptr(), a.panels.data_ptr(), x.data_ptr(),
            y.data_ptr(), scratch.data_ptr(), a.bands, a.slice_slots.numel(),
            a.band_rows, a.bk, m, k, n, cluster,
            torch.cuda.current_stream().cuda_stream), "panel_spmm_bf16x3")


def x3_split_launch(a: DevicePanels, x: torch.Tensor,
                    scratch: torch.Tensor) -> None:
    """The 3-pass form's split alone on the card (the live pairs' panel
    rows, packed 128 rows a pair, then X) into ``scratch`` of the bytes
    ``x3_shape`` reports, uncounted: for tests and timing."""
    with torch.cuda.device(x.device):
        _build.check(_build.library().spgrid_panel_spmm_bf16x3_split(
            a.slice_ptr.data_ptr(), a.slice_slots.data_ptr(),
            a.panels.data_ptr(), x.data_ptr(), scratch.data_ptr(), a.bands,
            a.slice_slots.numel(), a.band_rows, a.bk, x.shape[0], x.shape[1],
            torch.cuda.current_stream().cuda_stream), "panel_spmm_bf16x3")


def _run(wrapper, a: DevicePanels, x: torch.Tensor,
         plain=None) -> torch.Tensor:
    """Y in X's dtype by the plain version on the CPU, or by one counted
    launch on the card."""
    if runs_plain(wrapper.__name__, x.device):
        return (plain or panel_spmm_plain)(a, x)
    y = torch.empty((a.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if wrapper is panel_spmm_bf16x3:
        x3_launch(a, x, y)
    else:
        launch(a, x, y)
    wrapper.launches += 1
    return y


def panel_spmm(a: DevicePanels, x: torch.Tensor,
               precision=None) -> torch.Tensor:
    """Y (m, n) = A @ X in X's dtype at matmul ``precision`` (None: the
    dtype's own): f32 X (k, n) ('high': ``panel_spmm_bf16x3``); bf16
    panels go to ``panel_spmm_bf16`` (f32 X, at any precision: cv_panel's
    body pins its own) or ``panel_spmm_bf16_xy`` (bf16 X)."""
    _check(a, x, precision)
    if x.dtype == torch.bfloat16:
        return panel_spmm_bf16_xy(a, x)
    if a.panels.dtype == torch.bfloat16:
        return panel_spmm_bf16(a, x)
    if precision == "high":
        return panel_spmm_bf16x3(a, x)
    return _run(panel_spmm, a, x)


panel_spmm.launches = 0


def panel_spmm_bf16(a: DevicePanels, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) f32 = A @ round_bf16(X) for bf16 panels and f32 X (k, n):
    the bf16 form's kernel (``cv_panel``)."""
    _check(a, x)
    if a.panels.dtype != torch.bfloat16 or x.dtype != torch.float32:
        raise TypeError("panel_spmm_bf16: panels must be bf16 "
                        "(DevicePanels.as_bf16) and X f32")
    return _run(panel_spmm_bf16, a, x)


panel_spmm_bf16.launches = 0


def panel_spmm_bf16_xy(a: DevicePanels, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) bf16 = A @ X for bf16 panels and bf16 X (k, n): f32 sums,
    each element of Y rounded once (``panel_pallas`` at dtype bf16)."""
    _check(a, x)
    if x.dtype != torch.bfloat16:
        raise TypeError("panel_spmm_bf16_xy: X must be bf16")
    return _run(panel_spmm_bf16_xy, a, x)


panel_spmm_bf16_xy.launches = 0


def panel_spmm_bf16x3(a: DevicePanels, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) f32 = A @ X for f32 panels and X (k, n) at matmul precision
    'high': three bf16 passes summed in f32 (``panel_spmm_bf16x3_plain``
    says in what order)."""
    _check(a, x, "high")
    if a.panels.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("panel_spmm_bf16x3: panels and X must be f32")
    return _run(panel_spmm_bf16x3, a, x, panel_spmm_bf16x3_plain)


panel_spmm_bf16x3.launches = 0


def _slot_tiles(a: DevicePanels, xp: torch.Tensor, n: int) -> torch.Tensor:
    """The X tile of every slot, (S, bk, n), from X padded with zero rows
    to whole block columns (``xp``)."""
    return xp.view(xp.shape[0] // a.bk, a.bk, n)[a.block_cols.long()]


def _bands_sum(a: DevicePanels, prod: torch.Tensor) -> torch.Tensor:
    """The slots' products (S, R, n) added into their bands in slot order
    (``index_add_``; pad slots add zero panels), as Y (m, n)."""
    n = prod.shape[2]
    band = torch.arange(a.bands, device=prod.device).repeat_interleave(
        a.max_p)
    out = torch.zeros((a.bands, a.band_rows, n), dtype=prod.dtype,
                      device=prod.device)
    out.index_add_(0, band, prod)
    return out.reshape(a.bands * a.band_rows, n)[:a.shape[0]]


def _padded_x(a: DevicePanels, x: torch.Tensor, dtype: torch.dtype):
    """X in ``dtype``, zero rows appended to whole block columns."""
    k, n = x.shape
    xp = torch.zeros((-(-k // a.bk) * a.bk, n), dtype=dtype, device=x.device)
    xp[:k] = x
    return xp


def panel_spmm_bf16x3_plain(a: DevicePanels,
                            x: torch.Tensor) -> torch.Tensor:
    """The 3-pass form's product in plain torch, f32: each slot's panel
    times its X tile by ``bmm_bf16x3`` (each pass's sum in f64 rounded once
    to f32, the cross passes added, then the hi pass), added into its band
    in slot order, as the Pallas kernel's ``o_ref +=`` does."""
    n = x.shape[1]
    xt = _slot_tiles(a, _padded_x(a, x, torch.float32), n)
    return _bands_sum(a, bmm_bf16x3(a.panels, xt))


def panel_spmm_plain(a: DevicePanels, x: torch.Tensor) -> torch.Tensor:
    """The same product in plain torch, in x's dtype (TF32 off; bf16:
    widened to f32, summed in f32 and rounded once at the end): gather the
    X tile of every slot, one batched matmul over the slots, ``index_add_``
    into the bands (pad slots add zero panels). For bf16 panels X is
    rounded to bf16 first, and both are widened to the sum's type."""
    full_f32()
    n = x.shape[1]
    acc = acc_dtype(x)
    xp = _padded_x(a, (x.to(torch.bfloat16).to(acc)
                       if a.panels.dtype == torch.bfloat16 else x), acc)
    prod = torch.bmm(a.panels.to(acc), _slot_tiles(a, xp, n))  # (S, R, n)
    return _bands_sum(a, prod).to(x.dtype)
