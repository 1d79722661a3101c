"""COO and SELL-C-sigma SpMM and SpMV as torch ops — the counterparts of
``spmm_coo``, ``spmv_coo``, ``spmm_sell`` and ``spmv_sell`` in
``spgrid/ops/xla.py``.

The JAX package leaves these to XLA (a gather, a weighted sum and a segment
sum), outside any Pallas kernel, so the port leaves them to torch ops:
``index_select`` for ``take`` and ``index_add_`` into m + 1 rows for
``segment_sum`` (the pad entries add 0 to row m, which is sliced off). The
products and sums run in f32 (f64 for an f64 X). Every size is known on the
host, so a call can be captured in a CUDA graph.

Bits: on a CUDA device ``index_add_`` adds with atomics, so COO's sums may
differ in the last bits from call to call. SELL writes each slot and each
row once (``index_copy_``), and its bits are the same every call.
"""

from __future__ import annotations

import torch

from spgrid_torch.ops.layouts import DeviceCOO, DeviceSELL


def acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 sums, except for an f64 X (as the JAX package's ``_acc_dtype``)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def spmm_coo(coo: DeviceCOO, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) = A @ X: each nnz's row of X, weighted by its value, added
    into its row."""
    m = coo.shape[0]
    acc = acc_dtype(x)
    prods = x.index_select(0, coo.cols).to(acc).mul_(
        coo.values[:, None].to(acc))
    y = torch.zeros((m + 1, x.shape[1]), dtype=acc, device=x.device)
    y.index_add_(0, coo.rows, prods)
    return y[:m].to(x.dtype)


def spmv_coo(coo: DeviceCOO, x: torch.Tensor) -> torch.Tensor:
    """y (m,) = A @ x for x (k,)."""
    return spmm_coo(coo, x[:, None])[:, 0]


def spmm_sell(sell: DeviceSELL, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) = A @ X from the SELL-C-sigma buckets: per width bucket the
    gathered X rows of its (s, C, w) slots, weighted and summed over w, into
    the buckets' slots; then the slots back to their rows through
    ``perm``."""
    m = sell.shape[0]
    n = x.shape[1]
    m_pad = sell.perm.shape[0]
    acc = acc_dtype(x)
    # the buckets' slices cover every slot once, and perm every row once
    y_perm = torch.empty((m_pad, n), dtype=acc, device=x.device)
    lane = torch.arange(sell.C, device=x.device)
    for cols, vals, srows in zip(sell.bucket_cols, sell.bucket_vals,
                                 sell.bucket_slice_rows):
        s, C, w = cols.shape
        g = x.index_select(0, cols.reshape(-1)).reshape(s, C, w, n).to(acc)
        part = g.mul_(vals[..., None].to(acc)).sum(dim=2)   # (s, C, n)
        slots = (srows[:, None] + lane[None, :]).reshape(-1)
        y_perm.index_copy_(0, slots, part.reshape(s * C, n))
    y = torch.empty((m_pad, n), dtype=acc, device=x.device)
    y.index_copy_(0, sell.perm.long(), y_perm)
    return y[:m].to(x.dtype)


def spmv_sell(sell: DeviceSELL, x: torch.Tensor) -> torch.Tensor:
    """y (m,) = A @ x for x (k,)."""
    return spmm_sell(sell, x[:, None])[:, 0]
