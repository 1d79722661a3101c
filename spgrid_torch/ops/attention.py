"""Sparse-attention pipeline: K/Q/V weight SpMM → masked SDDMM → final SpMM.

Counterpart of ``spgrid/ops/attention.py``: the weights W_K, W_Q, W_V and the
attention mask are DeviceBSRs, the three weight products and the final
product run the BSR SpMM kernel and the masked scores run the SDDMM kernel.
Softmax between SDDMM and the final SpMM exists and is off by default, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spgrid.formats.csr import CSRMatrix
from spgrid_torch.ops.kernels.bsr_spmm import bsr_spmm
from spgrid_torch.ops.kernels.sddmm import bsr_sddmm
from spgrid_torch.ops.layouts import DeviceBSR


@dataclasses.dataclass
class SparseAttention:
    """Pipeline operands on the device: three weight BSRs and the mask BSR."""

    wk: DeviceBSR
    wq: DeviceBSR
    wv: DeviceBSR
    mask: DeviceBSR

    @classmethod
    def from_csr(cls, wk: CSRMatrix, wq: CSRMatrix, wv: CSRMatrix,
                 mask: CSRMatrix, bm: int = 128, bk: int = 128,
                 mask_bm: int = 128, mask_bk: int = 128, *,
                 device) -> "SparseAttention":
        return cls(
            wk=DeviceBSR.from_csr(wk, bm=bm, bk=bk, device=device),
            wq=DeviceBSR.from_csr(wq, bm=bm, bk=bk, device=device),
            wv=DeviceBSR.from_csr(wv, bm=bm, bk=bk, device=device),
            mask=DeviceBSR.from_csr(mask, bm=mask_bm, bk=mask_bk,
                                    device=device),
        )

    @property
    def flops_per_col(self) -> float:
        """Pipeline flop model 2*(nnz_K+nnz_Q+nnz_V+2*nnz_mask)*n, divided
        by n."""
        return 2.0 * (self.wk.nnz + self.wq.nnz + self.wv.nnz
                      + 2 * self.mask.nnz)


def blocksparse_softmax(mask: DeviceBSR, s_blocks: torch.Tensor) -> torch.Tensor:
    """Row softmax over mask nonzeros, on block values.

    Pad blocks (block_row == mb) fold into segment mb, which is dropped.
    Mask zeros inside stored blocks are excluded through the mask values.
    """
    mb, bm = mask.mb, mask.bm
    rows = mask.block_rows.long()
    valid = mask.blocks != 0
    s_masked = torch.where(valid, s_blocks,
                           torch.full_like(s_blocks, -torch.inf))
    blk_max = s_masked.amax(dim=2)                               # (nb, bm)
    row_max = torch.full((mb + 1, bm), -torch.inf, dtype=s_blocks.dtype,
                         device=s_blocks.device)
    row_max.scatter_reduce_(0, rows[:, None].expand(-1, bm), blk_max, "amax")
    row_max = torch.clamp(row_max, min=-1e30)
    e = torch.where(valid, torch.exp(s_blocks - row_max[rows][:, :, None]),
                    torch.zeros_like(s_blocks))
    row_sum = torch.zeros((mb + 1, bm), dtype=s_blocks.dtype,
                          device=s_blocks.device)
    row_sum.index_add_(0, rows, e.sum(dim=2))
    return e / torch.clamp(row_sum[rows], min=1e-30)[:, :, None]


def attention_pipeline(attn: SparseAttention, x: torch.Tensor, *,
                       softmax: bool = False):
    """Run the 5-stage pipeline; returns (y, stages dict).

      K = W_K @ X ; Q = W_Q @ X ; V = W_V @ X          (3x weight SpMM)
      S = mask ⊙ (Q @ K^T)                              (SDDMM)
      Y = S @ V                                         (final SpMM)
    """
    k = bsr_spmm(attn.wk, x)
    q = bsr_spmm(attn.wq, x)
    v = bsr_spmm(attn.wv, x)
    s_blocks = bsr_sddmm(attn.mask, q, k)
    if softmax:
        s_blocks = blocksparse_softmax(attn.mask, s_blocks)
    y = bsr_spmm(attn.mask.with_blocks(s_blocks), v)
    return y, {"K": k, "Q": q, "V": v, "S": s_blocks, "Y": y}


def gold_pipeline(wk: CSRMatrix, wq: CSRMatrix, wv: CSRMatrix,
                  mask: CSRMatrix, x: np.ndarray,
                  softmax: bool = False) -> np.ndarray:
    """float64 host oracle of the full 5-stage chain.

    A copy of ``spgrid.ops.attention.gold_pipeline``, which cannot be
    imported without JAX; ``tests/test_torch_pipeline.py`` pins the two."""
    x64 = np.asarray(x, dtype=np.float64)
    k = wk.astype(np.float64).to_dense() @ x64
    q = wq.astype(np.float64).to_dense() @ x64
    v = wv.astype(np.float64).to_dense() @ x64
    md = mask.astype(np.float64).to_dense()
    s = md * (q @ k.T)
    if softmax:
        neg = np.where(md != 0, s, -np.inf)
        mx = np.max(neg, axis=1, keepdims=True)
        mx = np.where(np.isfinite(mx), mx, 0.0)
        e = np.where(md != 0, np.exp(s - mx), 0.0)
        s = e / np.maximum(e.sum(axis=1, keepdims=True), 1e-30)
    return s @ v
