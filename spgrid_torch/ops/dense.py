"""Densified SpMM and the dense GEMM bound — the counterpart of
``spmm_dense`` and ``gemm`` in ``spgrid/ops/xla.py``.

The JAX package leaves these products to XLA outside any Pallas kernel, so
the port leaves them to ``torch.matmul``. TF32 is switched off for both
cuBLAS and cuDNN, the analogue of the JAX harness forcing HIGHEST: an f32
product then runs in full f32 and meets the 1e-4 gate. cuBLAS's reduced
precision reduction for bf16 products is switched off too: the JAX
package's product sums bf16 operands in f32 (``preferred_element_type``)
and rounds once, and so does cuBLAS then. An f64 product is cuBLAS's
DGEMM, native f64 on the card.
"""

from __future__ import annotations

import torch


def full_f32() -> None:
    """TF32 off for cuBLAS and cuDNN: f32 products in full f32; and bf16
    products summed in f32 (no reduced-precision reduction)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def gemm(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    full_f32()
    return torch.matmul(a, x)


def spmm_dense(a_dense: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The sparse matrix materialized dense; flops are still counted sparse
    (2*nnz*n) by the harness."""
    full_f32()
    return torch.matmul(a_dense, x)
