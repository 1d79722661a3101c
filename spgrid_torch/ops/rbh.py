"""Reorder-block hybrid (RBH): a column reordering that gathers each 128-row
block's nnz into a few 128-column windows, the blocks that come out dense
enough multiplied by the block kernel, the rest by a gather format — the
counterpart of ``spgrid/ops/rbh.py``.

The inspect step (``DeviceRBH.from_csr``) is the JAX package's, step for
step: it prices the identity, first-use and centroid column orders
(``formats/reorder.py``) by the cost model's constants (``ops/costmodel.py``:
a block pass, ``residual_nnz`` a residual nnz, an X row gather a column
for a reordering), keeps the cheapest, splits the nnz at ``auto_threshold``
nnz a 128^2 block (at most ``MAX_HI_BLOCKS`` blocks, densest first) and
picks the residual's format (sell, merge or coo) by
``estimate_spmm_time`` on the residual's own features. On the card the
constants are the H100's, so the split and the residual are the card's.

The port's parts: the permutation a ``torch.long`` tensor on the layout's
device, applied per call by ``x.index_select(0, perm)``; the block part a
``DeviceBSR`` (bm = bk = 128, a zero coverage block for each empty block
row, as the JAX layout) multiplied by the port's ``bsr_spmm`` CUDA kernel;
the residual the port's ``DeviceSELL``, ``DeviceMerge`` or ``DeviceCOO``
with its torch ops.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from spgrid_torch.formats.csr import (
    COOMatrix, CSRMatrix, coo_to_csr, value_dtype,
)
from spgrid_torch.formats.reorder import (
    centroid_col_order, first_use_col_order,
)
from spgrid_torch.ops import costmodel
from spgrid_torch.ops.kernels.bsr_spmm import bsr_spmm
from spgrid_torch.ops.layouts import DeviceBSR, DeviceCOO, DeviceSELL
from spgrid_torch.ops.merge import DeviceMerge, merge_spmm
from spgrid_torch.ops.xla import spmm_coo, spmm_sell

BLOCK = 128
# dense-block byte budget: same 2GB wall as the bsr applicability gate
# (costmodel.estimate_spmm_time) — the hybrid never densifies past it
MAX_HI_BLOCKS = (2 << 30) // (BLOCK * BLOCK * 4)
RESIDUALS = {"sell": (DeviceSELL, spmm_sell),
             "merge": (DeviceMerge, merge_spmm),
             "coo": (DeviceCOO, spmm_coo)}


def _block_pass(n: int) -> float:
    """Seconds of one 128x128 block pass at n columns (the cost model's
    per-block term)."""
    C = costmodel.C
    return max(BLOCK * n * 4 / C.eff_bw,
               2.0 * BLOCK * BLOCK * n / C.mxu_f32) + C.grid_step


def auto_threshold(n: int = 512) -> int:
    """Break-even nnz per 128x128 block: below it the gather residual is
    cheaper than a full block pass (the JAX package's rule, on the
    constants of ``costmodel.C``)."""
    res_per_nnz = costmodel.C.residual_nnz * (n / 512.0)
    return max(8, int(_block_pass(n) / res_per_nnz))


def _block_counts(rows: np.ndarray, cols_new: np.ndarray, k: int):
    """Per occupied 128x128 block nnz counts (keys, inverse, counts)."""
    kb = (k + BLOCK - 1) // BLOCK
    key = (rows.astype(np.int64) // BLOCK) * kb + (cols_new // BLOCK)
    return np.unique(key, return_inverse=True, return_counts=True)


def _hi_mask(rows, cols_new, k, thresh: int) -> Tuple[np.ndarray, int]:
    """Boolean per-nnz mask of entries in dense-enough blocks + block count,
    honoring the 2GB densification budget (densest blocks kept first)."""
    _, inv, cnt = _block_counts(rows, cols_new, k)
    keep = cnt >= thresh
    nb = int(keep.sum())
    if nb > MAX_HI_BLOCKS:
        order = np.argsort(-cnt)[:MAX_HI_BLOCKS]
        keep = np.zeros(len(cnt), dtype=bool)
        keep[order] = True
        keep &= cnt >= thresh
        nb = int(keep.sum())
    return keep[inv], nb


@dataclasses.dataclass
class SplitStats:
    """Inspect-step record (printed by the dispatch phase)."""

    method: str           # "identity" | "first_use" | "centroid"
    threshold: int
    hi_nnz: int
    lo_nnz: int
    hi_blocks: int
    hi_fill: float        # mean nnz / (128*128) over kept blocks
    hi_frac: float        # hi_nnz / nnz — the reorderable fraction

    def as_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class DeviceRBH:
    """The hybrid on a torch device: an optional column permutation, the
    block part and the residual part (either may be None)."""

    perm: Optional[torch.Tensor]     # (k,) int64: X row of column j
    bsr: Optional[DeviceBSR]
    res: object                      # DeviceSELL | DeviceMerge | DeviceCOO
    res_fmt: Optional[str]           # "sell" | "merge" | "coo" | None
    shape: Tuple[int, int]
    nnz: int
    stats: SplitStats
    name: str = "rbh"

    @property
    def coverage_blocks(self) -> int:
        """Zero blocks the block part holds for its empty block rows: the
        kernel reads and multiplies them for nothing."""
        return 0 if self.bsr is None else (self.bsr.num_blocks
                                           - self.stats.hi_blocks)

    @property
    def nbytes(self) -> int:
        tot = 0 if self.perm is None else self.perm.numel() * 8
        if self.bsr is not None:
            tot += self.bsr.nbytes
        if self.res is not None:
            tot += self.res.nbytes
        return tot

    @classmethod
    def from_csr(cls, csr: CSRMatrix, *, n_hint: int = 512,
                 threshold: Optional[int] = None,
                 residual: str = "auto",
                 methods: Tuple[str, ...] = ("identity", "first_use",
                                             "centroid"),
                 device) -> "DeviceRBH":
        C = costmodel.C
        thresh = auto_threshold(n_hint) if threshold is None else threshold
        rows = np.repeat(np.arange(csr.m, dtype=np.int64), csr.degrees)
        cols = csr.col_idx.astype(np.int64)

        # inspect: score each candidate ordering by its estimated executor
        # cost — block passes over kept blocks + gather residual + (for
        # non-identity orders) the per-call X perm-gather
        per_block = _block_pass(n_hint)
        res_per_nnz = C.residual_nnz * (n_hint / 512.0)
        src_big = csr.k * n_hint * 4 > (1 << 26)
        perm_cost = csr.k / (C.gather_slow if src_big else C.gather_fast)
        best = None
        for method in methods:
            if method == "identity":
                perm_np, cnew = None, cols
            else:
                perm_np = (first_use_col_order(csr) if method == "first_use"
                           else centroid_col_order(csr))
                inv = np.empty(csr.k, dtype=np.int64)
                inv[perm_np] = np.arange(csr.k)
                cnew = inv[cols]
            mask, nb = _hi_mask(rows, cnew, csr.k, thresh)
            lo = csr.nnz - int(mask.sum())
            cost = nb * per_block + lo * res_per_nnz \
                + (0.0 if method == "identity" else perm_cost)
            if best is None or cost < best[0]:
                best = (cost, method, perm_np, cnew, mask, nb)
        _, method, perm_np, cnew, mask, nb = best

        hi_nnz = int(mask.sum())
        if hi_nnz == 0 or nb == 0:
            method, perm_np, cnew = "identity", None, cols
            mask = np.zeros(csr.nnz, dtype=bool)
            hi_nnz, nb = 0, 0

        def _sub(sel) -> CSRMatrix:
            # in csr's value type (a bf16 matrix's parts are bf16)
            return coo_to_csr(COOMatrix(
                rows[sel].astype(np.int32), cnew[sel].astype(np.int32),
                csr.values[sel], csr.shape, csr.name),
                sum_duplicates=False).astype(value_dtype(csr))

        bsr = None
        if hi_nnz:
            bsr = DeviceBSR.from_csr(_sub(mask), bm=BLOCK, bk=BLOCK,
                                     device=device)
        res, res_fmt = None, None
        lo_nnz = csr.nnz - hi_nnz
        if lo_nnz:
            lo = _sub(~mask)
            res_fmt = residual
            if residual == "auto":
                # the cost model's pick on the residual's own features
                from spgrid_torch.features import matrix_features
                lf = matrix_features(lo)
                res_fmt = min(("sell", "merge", "coo"),
                              key=lambda fmt: costmodel.estimate_spmm_time(
                                  lf, fmt, n_hint))
            if res_fmt not in RESIDUALS:
                raise ValueError(f"unknown residual fmt {residual!r}")
            res = RESIDUALS[res_fmt][0].from_csr(lo, device=device)
        stats = SplitStats(method=method, threshold=thresh, hi_nnz=hi_nnz,
                           lo_nnz=lo_nnz, hi_blocks=nb,
                           hi_fill=(hi_nnz / max(nb, 1)) / (BLOCK * BLOCK),
                           hi_frac=hi_nnz / max(csr.nnz, 1))
        perm = None if perm_np is None else torch.from_numpy(
            perm_np.astype(np.int64)).to(device)
        return cls(perm, bsr, res, res_fmt, tuple(csr.shape), csr.nnz,
                   stats, csr.name)


def rbh_spmm(a: DeviceRBH, x: torch.Tensor, precision=None) -> torch.Tensor:
    """Y = A @ X at matmul ``precision`` (None: the dtype's own; 'high': the
    block part on ``bsr_spmm``'s 3-pass form and a merge remainder on
    ``merge_spmm``'s; coo and sell contract through no dot). The
    column-perm gather on X is part of the call, so a measured time holds
    its whole cost."""
    xp = x if a.perm is None else x.index_select(0, a.perm)
    y = None
    if a.bsr is not None:
        y = bsr_spmm(a.bsr, xp, precision=precision)
    if a.res is not None:
        spmm = RESIDUALS[a.res_fmt][1]
        yr = (spmm(a.res, xp, precision=precision) if a.res_fmt == "merge"
              else spmm(a.res, xp))
        y = yr if y is None else (y + yr.to(y.dtype))
    if y is None:
        y = torch.zeros((a.shape[0], x.shape[1]), dtype=x.dtype,
                        device=x.device)
    return y.to(x.dtype)
