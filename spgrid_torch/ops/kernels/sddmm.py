"""Block-sparse SDDMM: the block values of mask ⊙ (Q @ Kᵀ) on a DeviceBSR
mask.

Counterpart of ``spgrid/ops/pallas/sddmm.py``; the CUDA kernel is
``spgrid_torch/csrc/sddmm.cu``, in three forms: f32, bf16
(``bsr_sddmm_bf16``: bf16 mask, Q and K, the f32 sum times the mask value
in f32, rounded once to bf16, as the Pallas kernel runs at dtype bf16) and
the 3-pass bf16 form of f32 operands (``bsr_sddmm_bf16x3``: the Pallas
kernel's dot at matmul precision 'high', Q and K split into bf16 hi and lo
parts, Q_hi K_hi + Q_hi K_lo + Q_lo K_hi summed in f32).
``bsr_sddmm(..., precision=)`` launches the form of Q's dtype and the
precision for CUDA tensors and takes its plain version
(``bsr_sddmm_plain``, ``bsr_sddmm_bf16x3_plain``) only for CPU tensors; an
f64 Q, or a precision without a form, raises.

The kernel runs the tensor-core tile of ``csrc/block_mma.cuh``: one
tile a (mask block, 128-row slice of it, 64 of its columns), its
contraction (d, 32 a step) split across a cluster where the tiles alone
would leave the card idle (``launch_grid`` reports the launch); the mask
multiplies the summed tile once. The bf16 and 3-pass forms run the bf16
step of ``csrc/bf16_mma.cuh``, 64 of d a step.
"""

from __future__ import annotations

import torch

from spgrid_torch.ops.kernels import (
    _build, check_form, check_operands, runs_plain)
from spgrid_torch.ops.kernels.block_mma import LaunchShape, query
from spgrid_torch.ops.layouts import DeviceBSR
from spgrid_torch.ops.xla import acc_dtype


def _check(mask: DeviceBSR, q: torch.Tensor, k: torch.Tensor,
           dtype: torch.dtype) -> None:
    if q.dim() != 2 or k.dim() != 2 or q.shape[1] != k.shape[1]:
        raise ValueError(f"q (mq, d) and k (mk, d) must share d, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    check_operands("bsr_sddmm", q.device, q=(q, dtype), k=(k, dtype),
                   mask_blocks=(mask.blocks, dtype),
                   block_rows=(mask.block_rows, torch.int32),
                   block_cols=(mask.block_cols, torch.int32))


def launch_grid(mask: DeviceBSR, precision: str = "highest") -> LaunchShape:
    """The launch of the form ``mask``'s blocks take for its stored blocks
    (pad blocks included) on the card ``mask`` lies on, as
    ``spgrid_bsr_sddmm``, ``spgrid_bsr_sddmm_bf16`` or, for f32 blocks at
    ``precision`` 'high', ``spgrid_bsr_sddmm_bf16x3`` makes it (the
    cluster depends on the card's SM count)."""
    nb, bm, bk = mask.blocks.shape
    if mask.blocks.dtype == torch.bfloat16:
        entry = "spgrid_bsr_sddmm_bf16_shape"
    elif precision == "high":
        entry = "spgrid_bsr_sddmm_bf16x3_shape"
    else:
        entry = "spgrid_bsr_sddmm_shape"
    with torch.cuda.device(mask.blocks.device):
        return query(entry, "bsr_sddmm", nb, bm, bk)


def _launch(wrapper, mask: DeviceBSR, q: torch.Tensor,
            k: torch.Tensor) -> torch.Tensor:
    """The block values by the form of Q's dtype into a new output; count
    the launch on ``wrapper``."""
    nb, bm, bk = mask.blocks.shape
    out = torch.empty((nb, bm, bk), dtype=q.dtype, device=q.device)
    if nb == 0:
        return out
    lib = _build.library()
    entry = getattr(lib, "spgrid_" + wrapper.__name__)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = entry(mask.block_rows.data_ptr(), mask.block_cols.data_ptr(),
                     mask.blocks.data_ptr(), q.data_ptr(), k.data_ptr(),
                     out.data_ptr(), nb, bm, bk, q.shape[0], k.shape[0],
                     q.shape[1], 0, stream)
    _build.check(code, wrapper.__name__)
    wrapper.launches += 1
    return out


def _run(wrapper, mask: DeviceBSR, q: torch.Tensor, k: torch.Tensor,
         dtype: torch.dtype, plain=None) -> torch.Tensor:
    _check(mask, q, k, dtype)
    if runs_plain(wrapper.__name__, q.device):
        return (plain or bsr_sddmm_plain)(mask, q, k)
    return _launch(wrapper, mask, q, k)


# the forms at a precision other than the operand type's own
OTHER_PRECISIONS = ((torch.float32, "high"),)


def bsr_sddmm(mask: DeviceBSR, q: torch.Tensor, k: torch.Tensor,
              precision=None) -> torch.Tensor:
    """(nb, bm, bk) block values aligned with ``mask.blocks``, in Q's dtype
    (f32, or bf16: ``bsr_sddmm_bf16``) at matmul ``precision`` (None: the
    dtype's own; 'high' for f32 operands: ``bsr_sddmm_bf16x3``); pad
    blocks (block_row = mb) give zero blocks."""
    check_form("bsr_sddmm", q.dtype, precision=precision,
               other_precisions=OTHER_PRECISIONS)
    if q.dtype == torch.bfloat16:
        return bsr_sddmm_bf16(mask, q, k)
    if precision == "high":
        return bsr_sddmm_bf16x3(mask, q, k)
    return _run(bsr_sddmm, mask, q, k, torch.float32)


bsr_sddmm.launches = 0


def bsr_sddmm_bf16(mask: DeviceBSR, q: torch.Tensor,
                   k: torch.Tensor) -> torch.Tensor:
    """(nb, bm, bk) bf16 block values for a bf16 mask, Q and K: each the
    f32 dot product times the mask value in f32, rounded once."""
    return _run(bsr_sddmm_bf16, mask, q, k, torch.bfloat16)


bsr_sddmm_bf16.launches = 0


def bsr_sddmm_bf16x3(mask: DeviceBSR, q: torch.Tensor,
                     k: torch.Tensor) -> torch.Tensor:
    """(nb, bm, bk) f32 block values for an f32 mask, Q and K at matmul
    precision 'high': three bf16 passes summed in f32, times the mask
    value (``bsr_sddmm_bf16x3_plain`` says in what order)."""
    return _run(bsr_sddmm_bf16x3, mask, q, k, torch.float32,
                bsr_sddmm_bf16x3_plain)


bsr_sddmm_bf16x3.launches = 0


def _panels(mask: DeviceBSR, q: torch.Tensor, k: torch.Tensor,
            dtype: torch.dtype):
    """(Q panels (nb, bm, d), K panels (nb, bk, d)) of every block in
    ``dtype``: the gather of ``spgrid.ops.attention._sddmm_bsr_xla`` (Q
    and K row panels by block coordinates, a zero Q panel for the pad row
    mb)."""
    nb, bm, bk = mask.blocks.shape
    mbq = -(-q.shape[0] // bm) + 1
    mbk = -(-k.shape[0] // bk)
    d = q.shape[1]
    qp = torch.zeros((mbq * bm, d), dtype=dtype, device=q.device)
    qp[:q.shape[0]] = q
    kp = torch.zeros((mbk * bk, d), dtype=dtype, device=q.device)
    kp[:k.shape[0]] = k
    return (qp.view(mbq, bm, d)[mask.block_rows.long()],
            kp.view(mbk, bk, d)[mask.block_cols.long()])


def split_bf16(t: torch.Tensor):
    """(hi, lo): the bf16 parts of f32 ``t``, hi = t rounded to bf16 and lo
    = (t - hi) rounded (to nearest, ties to even; t - hi is exact in f32),
    as f32 tensors."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def bsr_sddmm_bf16x3_plain(mask: DeviceBSR, q: torch.Tensor,
                           k: torch.Tensor) -> torch.Tensor:
    """The 3-pass form's block values in plain torch, f32: Q and K split
    (``split_bf16``), each pass's sum over d formed in f64 and rounded once
    to f32 (a bf16 x bf16 product is exact in f64, and so is the sum of up
    to d of them whose magnitudes lie within 2^37 of each other, so the
    order of the sum does not matter), then in f32 the cross passes
    Q_hi K_lo + Q_lo K_hi, then that plus Q_hi K_hi, times the mask value.
    The dropped Q_lo K_lo term is what sets it apart from the f32 product."""
    qg, kg = _panels(mask, q.float(), k.float(), torch.float32)
    qh, ql = split_bf16(qg)
    kh, kl = split_bf16(kg)

    def dot(a, b):
        return torch.bmm(a.double(), b.double().transpose(1, 2)).float()

    cross = dot(qh, kl) + dot(ql, kh)
    return (cross + dot(qh, kh)) * mask.blocks.float()


def bsr_sddmm_plain(mask: DeviceBSR, q: torch.Tensor,
                    k: torch.Tensor) -> torch.Tensor:
    """The same block values in plain torch, in q's dtype (bf16: widened to
    f32, the product and the mask in f32, rounded once at the end): the
    gather of ``spgrid.ops.attention._sddmm_bsr_xla`` (Q and K row panels by
    block coordinates, a zero Q panel for the pad row mb) and one batched
    product."""
    acc = acc_dtype(q)
    qg, kg = _panels(mask, q, k, acc)
    return (torch.bmm(qg, kg.transpose(1, 2))
            * mask.blocks.to(acc)).to(q.dtype)
