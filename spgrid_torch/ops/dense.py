"""Densified SpMM and the dense GEMM bound — the counterpart of
``spmm_dense`` and ``gemm`` in ``spgrid/ops/xla.py``.

The JAX package leaves these products to XLA outside any Pallas kernel, so
the port leaves them to ``torch.matmul``. TF32 is switched off for both
cuBLAS and cuDNN, the analogue of the JAX harness forcing HIGHEST: an f32
product then runs in full f32 and meets the 1e-4 gate.
"""

from __future__ import annotations

import torch


def _full_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def gemm(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    _full_f32()
    return torch.matmul(a, x)


def spmm_dense(a_dense: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The sparse matrix materialized dense; flops are still counted sparse
    (2*nnz*n) by the harness."""
    _full_f32()
    return torch.matmul(a_dense, x)
