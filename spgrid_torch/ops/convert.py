"""Carry layouts built by the JAX package over to the port.

Each function takes a JAX layout's array leaves as numpy arrays
(``np.asarray(leaf)``) followed by its static fields, in the order of the
layout's ``tree_flatten``, and returns the port's layout on ``device``.
Values a JAX layout holds in bf16 (a bf16 numpy type, which only
``ml_dtypes`` provides) come over as the port's bf16 tensors, through the
f32 numbers they are.
"""

from __future__ import annotations

import numpy as np
import torch

from spgrid_torch.ops.attention import SparseAttention
from spgrid_torch.ops.kernels.bsr_spmm_cstat import DeviceBSRCol
from spgrid_torch.ops.kernels.dgell import DeviceDGELL
from spgrid_torch.ops.kernels.panel_spmm import DevicePanels, live_slices
from spgrid_torch.ops.kernels.wcoo_spmm import DeviceWCOO
from spgrid_torch.ops.kernels.wcoo_spmm_aligned import DeviceWCOOBands
from spgrid_torch.ops.kernels.wcoo_spmv import DeviceWCOOAligned
from spgrid_torch.ops.kernels.wpack_spmv import DeviceWPACK
from spgrid_torch.ops.kernels.wrow_spmv import DeviceWROW
from spgrid_torch.formats.csr import BF16
from spgrid_torch.ops.layouts import DeviceBSR, torch_dtype


def host_values(a):
    """(values, the name of their type): a JAX layout's value leaf as a
    numpy array, bf16 values as the f32 numbers they are."""
    a = np.asarray(a)
    if a.dtype.name == BF16:
        return a.astype(np.float32), BF16
    return a, a.dtype.name


def bsr_from_jax(block_rows, block_cols, row_starts, blocks, shape,
                 nnz: int, num_blocks: int, *, device) -> DeviceBSR:
    """``spgrid.ops.layouts.DeviceBSR`` → DeviceBSR. ``row_ptr`` is rebuilt
    from ``block_rows``: the JAX ``row_starts`` misses the coverage blocks
    of empty block rows."""
    blocks, dtype = host_values(blocks)
    return DeviceBSR.from_arrays(block_rows, block_cols, row_starts, blocks,
                                 shape, nnz, num_blocks, device=device,
                                 dtype=dtype)


def _band_counts(block_cols: np.ndarray, panels: np.ndarray, bands: int,
                 max_p: int) -> np.ndarray:
    """Real panels per band. Real panels of a band have strictly increasing
    columns and pad slots repeat the last one; a band whose only panel is
    all zeros is an empty band (its slot 0 is a pad slot at column 0)."""
    cols = np.asarray(block_cols).reshape(bands, max_p)
    counts = 1 + np.sum(np.diff(cols, axis=1) > 0, axis=1)
    zero = ~np.asarray(panels).reshape(bands, max_p, -1)[:, 0].any(axis=1)
    counts[(counts == 1) & zero] = 0
    return counts.astype(np.int32)


def panels_from_jax(block_cols, panels, shape, nnz: int, num_panels: int,
                    band_rows: int, bands: int, max_p: int, *,
                    device) -> DevicePanels:
    """``spgrid.ops.pallas.panel_spmm.DevicePanels`` → DevicePanels, with
    each band's real-panel count recovered from the slots and the live-slice
    index from the panels' nonzero rows (the JAX layout carries no CSR, so
    a slice that holds only explicit zeros is not live)."""
    # np.array copies: leaves of JAX arrays are read-only views
    cols = np.array(block_cols, dtype=np.int32)
    vals, dtype = host_values(panels)
    vals = np.array(vals)
    slice_ptr, slice_slots = live_slices(
        *np.nonzero(vals.any(axis=2)), int(bands), int(band_rows),
        int(max_p))
    return DevicePanels(
        block_cols=torch.from_numpy(cols).to(device),
        panels=torch.from_numpy(vals).to(device).to(torch_dtype(dtype)),
        counts=torch.from_numpy(
            _band_counts(cols, vals, bands, max_p)).to(device),
        shape=tuple(shape), nnz=int(nnz), num_panels=int(num_panels),
        band_rows=int(band_rows), bands=int(bands), max_p=int(max_p),
        slice_ptr=torch.from_numpy(slice_ptr).to(device),
        slice_slots=torch.from_numpy(slice_slots).to(device))


def wcoo_from_jax(cols, rows, values, chunk_window, chunk_rowblock,
                  chunk_sub, chunk_first, shape, nnz: int, W: int, R: int,
                  num_rowblocks: int, utilization: float, name: str, *,
                  device) -> DeviceWCOO:
    """``spgrid.ops.pallas.wcoo_spmm.DeviceWCOO`` → DeviceWCOO, with the
    chunks of each 128-row tile indexed (``from_arrays`` refuses W other
    than 128). ``chunk_first``, the TPU tile's zeroing flag, is dropped: a
    CTA writes its whole tile."""
    values, dtype = host_values(values)
    return DeviceWCOO.from_arrays(cols, rows, values, chunk_window,
                                  chunk_rowblock, chunk_sub, shape, nnz, R,
                                  utilization, name, device=device,
                                  dtype=torch_dtype(dtype))


def bands_from_jax(cols, values, g_sw, g_lb, shape, nnz: int,
                   utilization: float, bands: int, mbb: int,
                   steps_per_band: int, name: str, *,
                   device) -> DeviceWCOOBands:
    """``spgrid.ops.pallas.wcoo_spmm_aligned.DeviceWCOOBands`` →
    DeviceWCOOBands, with the groups of each 128-row block indexed."""
    values, dtype = host_values(values)
    return DeviceWCOOBands.from_arrays(cols, values, g_sw, g_lb, shape, nnz,
                                       utilization, bands, mbb,
                                       steps_per_band, name, device=device,
                                       dtype=torch_dtype(dtype))


def wcoo_aligned_from_jax(cols, values, g_sw, g_sub, shape, nnz: int,
                          utilization: float, num_groups: int, name: str, *,
                          device) -> DeviceWCOOAligned:
    """``spgrid.ops.pallas.wcoo_spmv.DeviceWCOOAligned`` →
    DeviceWCOOAligned, without the JAX layout's pad groups."""
    values, dtype = host_values(values)
    return DeviceWCOOAligned.from_arrays(cols, values, g_sw, g_sub, shape,
                                         nnz, utilization, num_groups, name,
                                         device=device,
                                         dtype=torch_dtype(dtype))


def wrow_from_jax(cols, values, piece_w, group_sub, shape, nnz: int,
                  utilization: float, num_groups: int, name: str, *,
                  device) -> DeviceWROW:
    """``spgrid.ops.pallas.wrow_spmv.DeviceWROW`` → DeviceWROW: the
    metadata rows of 8 steps flattened and the pad groups dropped."""
    values, dtype = host_values(values)
    return DeviceWROW.from_arrays(cols, values, piece_w, group_sub, shape,
                                  nnz, utilization, num_groups, name,
                                  device=device, dtype=torch_dtype(dtype))


def bsrc_from_jax(local_rows, block_cols, blocks, shape, nnz: int,
                  num_blocks: int, band_rows: int, bands: int, max_nb: int, *,
                  device) -> DeviceBSRCol:
    """``spgrid.ops.pallas.bsr_spmm_cstat.DeviceBSRCol`` → DeviceBSRCol,
    with each band's real-slot count recovered from the slots."""
    blocks, dtype = host_values(blocks)
    return DeviceBSRCol.from_arrays(local_rows, block_cols, blocks, shape,
                                    nnz, num_blocks, band_rows, bands, max_nb,
                                    device=device, dtype=torch_dtype(dtype))


def dgell_from_jax(cols, values, tail_rows, tail_cols, tail_vals, shape,
                   nnz: int, slots: int, rb: int, name: str, *,
                   device) -> DeviceDGELL:
    """``spgrid.ops.pallas.dgell.DeviceDGELL`` → DeviceDGELL: the columns'
    slot-major steps of ``rb`` rows undone, the 128-lane value padding and
    the pad rows dropped. The JAX layout holds its values in f32 at every
    dtype, as the port's does."""
    m = shape[0]
    steps = -(-max(m, 1) // rb)
    cols = (np.asarray(cols)[:steps].reshape(steps, slots, rb)
            .transpose(0, 2, 1).reshape(steps * rb, slots)[:m])
    values = np.asarray(values)[:m, :slots]
    return DeviceDGELL.from_arrays(cols, values, tail_rows, tail_cols,
                                   tail_vals, shape, nnz, slots, name,
                                   device=device)


def wpack_from_jax(cols, values, ends, starts, sel, piece_w, group_sub,
                   shape, nnz: int, utilization: float, num_groups: int,
                   wsel: int, name: str, *, device) -> DeviceWPACK:
    """``spgrid.ops.pallas.wpack_spmv.DeviceWPACK`` → DeviceWPACK: the
    metadata rows of 8 steps flattened and the pad groups dropped."""
    values, dtype = host_values(values)
    return DeviceWPACK.from_arrays(cols, values, ends, starts, sel, piece_w,
                                   group_sub, shape, nnz, utilization,
                                   num_groups, wsel, name, device=device,
                                   dtype=torch_dtype(dtype))


def attention_from_jax(wk, wq, wv, mask, *, device) -> SparseAttention:
    """``spgrid.ops.attention.SparseAttention`` → SparseAttention; each
    argument is one DeviceBSR's ``bsr_from_jax`` arguments as a tuple."""
    return SparseAttention(
        *(bsr_from_jax(*leaves, device=device) for leaves in (wk, wq, wv, mask)))
