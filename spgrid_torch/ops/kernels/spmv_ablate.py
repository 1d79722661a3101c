"""WROW SpMV ablation: WROW v1's row walk in five variants, each with one
stage of the walk deleted.

Counterpart of the Pallas probe ``scripts/exp_spmv_ablate.py``
(``_spmv_variant``); the CUDA kernel is ``spgrid_torch/csrc/spmv_ablate.cu``,
which runs the walk of ``csrc/wrow_rows.cuh`` that ``wrow_spmv`` (v1)
runs, over the layout's row-ordered live-slot stream. ``spmv_ablate``
launches it for CUDA tensors and takes ``spmv_ablate_plain`` only for CPU
tensors. Only ``"full"`` computes y = A @ x (WROW v1's kernel, bit for
bit); the other variants are wrong by design, timing probes. For piece p of
group g, its index r in the group, w = piece_w[p], c = cols[p, t] and b =
group_sub[g], slot t adds

    full      v · x[128 w + c]  to y[128 b + t]
    nogather  v · x[128 w + t]  to y[128 b + t]
    noload    v · x[128 r + c]  to y[128 b + t]
    normw     v · x[128 w + c]  to y[t]
    empty     v                 to y[t]

An x index at or past k reads 0 (the JAX probe's x is zero-padded to whole
windows, the port's is not), a slot whose value is 0 reads no x, and rows
past m are cut off. normw and empty sum every CTA into y[0:128] with
atomics, in an order that changes from run to run. The kernel reads only
the live slots, each with its piece's place r in its group
(``DeviceWROW.row_piece``); ``spmv_ablate_rows_plain`` is the same table
over that stream.
"""

from __future__ import annotations

import torch

from spgrid_torch.ops.kernels import _build, check_operands, runs_plain
from spgrid_torch.ops.kernels.wrow_spmv import (
    GROUP_PIECES, LANE, DeviceWROW, _check,
)

VARIANTS = ("full", "nogather", "noload", "normw", "empty")


def _variant(variant: str) -> int:
    if variant not in VARIANTS:
        raise ValueError(f"spmv_ablate: variant must be one of {VARIANTS}, "
                         f"got {variant!r}")
    return VARIANTS.index(variant)


def spmv_ablate(a: DeviceWROW, x: torch.Tensor, variant: str) -> torch.Tensor:
    """y (m,) f32 of ``variant`` for f32 x (k,)."""
    code_v = _variant(variant)
    _check("spmv_ablate", a, x, torch.float32)
    check_operands("spmv_ablate", x.device, row_slot=(a.row_slot, torch.int32),
                   row_vals=(a.row_vals, torch.float32),
                   row_cols=(a.row_cols, torch.int32),
                   row_piece=(a.row_piece, torch.uint8))
    if runs_plain("spmv_ablate", x.device):
        return spmv_ablate_plain(a, x, variant)
    m, k = a.shape
    accumulate = variant in ("normw", "empty")
    y = (torch.zeros if accumulate else torch.empty)(
        (m,), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.spgrid_spmv_ablate(
            a.row_slot.data_ptr(), a.row_vals.data_ptr(),
            a.row_cols.data_ptr(), a.row_piece.data_ptr(), x.data_ptr(),
            y.data_ptr(), code_v, a.blocks, m, k, stream)
    _build.check(code, "spmv_ablate")
    spmv_ablate.launches += 1
    return y


spmv_ablate.launches = 0


def _scatter(m, row, xi, values, x, variant):
    """y (m,) in x's dtype: each slot adds ``values`` (times x[xi] where xi
    lies inside x, else 0; the values alone for "empty") to ``row``."""
    k = x.shape[0]
    if variant == "empty":
        keep = row < m
        add = values[keep]
    else:
        keep = (values != 0) & (xi < k) & (row < m)
        add = values[keep] * x[xi[keep]]
    y = torch.zeros((m,), dtype=x.dtype, device=x.device)
    y.index_add_(0, row[keep], add)
    return y


def spmv_ablate_plain(a: DeviceWROW, x: torch.Tensor,
                      variant: str) -> torch.Tensor:
    """The same variant in plain torch over the padded pieces, with
    ``index_add_``, in x's dtype (f64 for an f64 x)."""
    _variant(variant)
    m, _ = a.shape
    P = a.cols.shape[0]
    lane = torch.arange(LANE, device=x.device)[None, :]
    if variant in ("normw", "empty"):
        row = lane.expand(P, LANE)
    else:
        sub = a.group_sub.long().repeat_interleave(GROUP_PIECES)
        row = sub[:, None] * LANE + lane
    col = a.cols.long()
    if variant == "nogather":
        xi = a.piece_w.long()[:, None] * LANE + lane
    elif variant == "noload":
        r = torch.arange(P, device=x.device) % GROUP_PIECES
        xi = r[:, None] * LANE + col
    else:
        xi = a.piece_w.long()[:, None] * LANE + col
    return _scatter(m, row, xi, a.values.to(x.dtype), x, variant)


def spmv_ablate_rows_plain(a: DeviceWROW, x: torch.Tensor,
                           variant: str) -> torch.Tensor:
    """The same variant in plain torch over the row stream that the kernel
    reads (``row_slot``, ``row_vals``, ``row_cols``, ``row_piece``), with
    ``index_add_``, in x's dtype."""
    _variant(variant)
    m, _ = a.shape
    q = torch.repeat_interleave(torch.arange(m, device=x.device),
                                torch.diff(a.row_slot.long()))
    xi = a.row_cols.long()
    if variant == "nogather":
        xi = (xi & ~(LANE - 1)) + q % LANE
    elif variant == "noload":
        xi = a.row_piece.long() * LANE + xi % LANE
    row = q % LANE if variant in ("normw", "empty") else q
    return _scatter(m, row, xi, a.row_vals.to(x.dtype), x, variant)
