"""Sparse-attention pipeline: K/Q/V weight SpMM → masked SDDMM → final SpMM.

Counterpart of ``spgrid/ops/attention.py``: the weights W_K, W_Q, W_V and the
attention mask are DeviceBSRs, the three weight products and the final
product run the BSR SpMM kernel and the masked scores run the SDDMM kernel.
With ``xla_only`` (the JAX package's ``use_pallas=False``, the CLI's
``--xla-only``) they run the JAX package's XLA baselines as torch ops
instead: ``xla.spmm_bsr`` and ``sddmm_bsr_xla``. Softmax between SDDMM and
the final SpMM exists and is off by default, as in the JAX package.

At matmul precision 'high' (``precision="high"``, f32) every stage runs its
3-pass form: the kernels' ``bsr_spmm_bf16x3`` and ``bsr_sddmm_bf16x3``, or
the torch ops' ``dense.at_high``, as the JAX pipeline's dots compute under
``jax.default_matmul_precision("high")`` on the TPU.

Stage types follow the JAX package's: at bf16 the SpMMs and the SDDMM
kernel return bf16 (the kernels' bf16 forms), the XLA baseline's SDDMM
returns f32, and the scores are cast to X's type before the final SpMM.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from spgrid_torch.formats.csr import CSRMatrix
from spgrid_torch.ops.dense import at_high, full_f32
from spgrid_torch.ops.kernels.bsr_spmm import bsr_spmm
from spgrid_torch.ops.kernels.sddmm import (
    bsr_sddmm, bsr_sddmm_plain, gather_panels)
from spgrid_torch.ops.layouts import DeviceBSR
from spgrid_torch.ops.xla import acc_dtype, segment_sum, spmm_bsr


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
    A block row's sum is ``xla.segment_sum`` over the row-sorted blocks at
    ``row_ptr``, so the sums give the same bits on every call. bf16 scores
    are taken in f32 and the result rounded once to bf16.
    """
    out_dtype = s_blocks.dtype
    s_blocks = s_blocks.to(acc_dtype(s_blocks))
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
    row_sum[:mb] = segment_sum(e.sum(dim=2), mask.row_ptr.long())
    return (e / torch.clamp(row_sum[rows], min=1e-30)[:, :, None]).to(
        out_dtype)


def _bmm_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.bmm(a, b.transpose(1, 2))


def sddmm_bsr_xla(mask: DeviceBSR, q: torch.Tensor, k: torch.Tensor,
                  precision=None) -> torch.Tensor:
    """The JAX package's XLA baseline SDDMM on the mask's blocks
    (``_sddmm_bsr_xla``): the Q and K row panels gathered by block
    coordinates (a zero Q panel for the pad row mb), one batched product and
    the mask, in f32 with TF32 off. It is the gather and product of the
    SDDMM kernel's plain version, so the two are one function; at matmul
    ``precision`` 'high' the product is ``dense.at_high``'s."""
    full_f32()
    acc = acc_dtype(q)
    if precision != "high":
        return bsr_sddmm_plain(mask, q.to(acc), k.to(acc))
    qg, kg = gather_panels(mask, q, k, acc)
    return at_high(_bmm_t, qg, kg) * mask.blocks.to(acc)


def stage_ops(xla_only: bool = False, precision=None):
    """(SpMM, SDDMM) of the pipeline at matmul ``precision`` (None: the
    dtype's own): the kernels, or the JAX package's XLA baselines as torch
    ops."""
    ops = (spmm_bsr, sddmm_bsr_xla) if xla_only else (bsr_spmm, bsr_sddmm)
    if precision is None:
        return ops
    return tuple(functools.partial(op, precision=precision) for op in ops)


def attention_pipeline(attn: SparseAttention, x: torch.Tensor, *,
                       xla_only: bool = False, softmax: bool = False,
                       precision=None):
    """Run the 5-stage pipeline at matmul ``precision`` (None: the dtype's
    own); returns (y, stages dict).

      K = W_K @ X ; Q = W_Q @ X ; V = W_V @ X          (3x weight SpMM)
      S = mask ⊙ (Q @ K^T)                              (SDDMM)
      Y = S @ V                                         (final SpMM)
    """
    spmm, sddmm = stage_ops(xla_only, precision)
    k = spmm(attn.wk, x)
    q = spmm(attn.wq, x)
    v = spmm(attn.wv, x)
    s_blocks = sddmm(attn.mask, q, k)
    if softmax:
        s_blocks = blocksparse_softmax(attn.mask, s_blocks)
    y = spmm(attn.mask.with_blocks(s_blocks.to(x.dtype)), v)
    return y, {"K": k, "Q": q, "V": v, "S": s_blocks, "Y": y}


def make_pipeline_step(attn: SparseAttention, *, xla_only: bool = False,
                       precision=None):
    """The pipeline as one X -> Y callable: the step ``run_pipeline`` times
    and gates."""

    def step(x: torch.Tensor) -> torch.Tensor:
        return attention_pipeline(attn, x, xla_only=xla_only,
                                  precision=precision)[0]

    return step


def gold_pipeline(wk: CSRMatrix, wq: CSRMatrix, wv: CSRMatrix,
                  mask: CSRMatrix, x: np.ndarray,
                  softmax: bool = False) -> np.ndarray:
    """float64 host oracle of the full 5-stage chain.

    The port's copy of ``spgrid.ops.attention.gold_pipeline``;
    ``tests/test_torch_pipeline.py`` pins the two."""
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
