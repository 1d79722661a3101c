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

At matmul precision 'high' (the TPU's three bf16 passes, which the JAX
package's dots at ambient precision compute under
``jax.default_matmul_precision("high")``) an f32 product is ``at_high``'s:
the operands split into their bf16 parts, three f32 products of those
parts (TF32 off; a bf16 x bf16 product is exact in f32), a_hi b_lo + a_lo
b_hi, then plus a_hi b_hi. The torch-op formats whose JAX dot takes the
ambient precision use it: ``dense``, ``bsr``, ``ell``, ``merge`` and the
pipeline's XLA SDDMM.
"""

from __future__ import annotations

import torch

from spgrid_torch.ops.kernels.bf16x3 import split_bf16


def full_f32() -> None:
    """TF32 off for cuBLAS and cuDNN: f32 products in full f32; and bf16
    products summed in f32 (no reduced-precision reduction)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def at_high(product, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``product(a, b)`` (a matmul, batched matmul or einsum of f32
    operands) at matmul precision 'high': a and b split into bf16 parts
    (``split_bf16``), product(a_hi, b_lo) + product(a_lo, b_hi), then plus
    product(a_hi, b_hi), each in f32 with TF32 off."""
    full_f32()
    ah, al = split_bf16(a)
    bh, bl = split_bf16(b)
    return (product(ah, bl) + product(al, bh)) + product(ah, bh)


def gemm(a: torch.Tensor, x: torch.Tensor, precision=None) -> torch.Tensor:
    """A @ X, at matmul ``precision`` 'high' by ``at_high``."""
    if precision == "high":
        return at_high(torch.matmul, a, x)
    full_f32()
    return torch.matmul(a, x)


def spmm_dense(a_dense: torch.Tensor, x: torch.Tensor,
               precision=None) -> torch.Tensor:
    """The sparse matrix materialized dense; flops are still counted sparse
    (2*nnz*n) by the harness. At matmul ``precision`` 'high' by
    ``at_high``."""
    return gemm(a_dense, x, precision)
