"""Carry layouts built by the JAX package over to the port.

Each function takes a JAX layout's array leaves as numpy arrays
(``np.asarray(leaf)``) followed by its static fields, in the order of the
layout's ``tree_flatten``, and returns the port's layout on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from spgrid_torch.ops.attention import SparseAttention
from spgrid_torch.ops.kernels.panel_spmm import DevicePanels
from spgrid_torch.ops.layouts import DeviceBSR


def bsr_from_jax(block_rows, block_cols, row_starts, blocks, shape,
                 nnz: int, num_blocks: int, *, device) -> DeviceBSR:
    """``spgrid.ops.layouts.DeviceBSR`` → DeviceBSR. ``row_ptr`` is rebuilt
    from ``block_rows``: the JAX ``row_starts`` misses the coverage blocks
    of empty block rows."""
    return DeviceBSR.from_arrays(block_rows, block_cols, row_starts, blocks,
                                 shape, nnz, num_blocks, device=device)


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
    each band's real-panel count recovered from the slots."""
    # np.array copies: leaves of JAX arrays are read-only views
    cols = np.array(block_cols, dtype=np.int32)
    vals = np.array(panels)
    return DevicePanels(
        block_cols=torch.from_numpy(cols).to(device),
        panels=torch.from_numpy(vals).to(device),
        counts=torch.from_numpy(
            _band_counts(cols, vals, bands, max_p)).to(device),
        shape=tuple(shape), nnz=int(nnz), num_panels=int(num_panels),
        band_rows=int(band_rows), bands=int(bands), max_p=int(max_p))


def attention_from_jax(wk, wq, wv, mask, *, device) -> SparseAttention:
    """``spgrid.ops.attention.SparseAttention`` → SparseAttention; each
    argument is one DeviceBSR's ``bsr_from_jax`` arguments as a tuple."""
    return SparseAttention(
        *(bsr_from_jax(*leaves, device=device) for leaves in (wk, wq, wv, mask)))
