"""Block-sparse SDDMM: the block values of mask ⊙ (Q @ Kᵀ) on a DeviceBSR
mask.

Counterpart of ``spgrid/ops/pallas/sddmm.py``; the CUDA kernel is
``spgrid_torch/csrc/sddmm.cu``, in two forms: f32 and bf16
(``bsr_sddmm_bf16``: bf16 mask, Q and K, the f32 sum times the mask value
in f32, rounded once to bf16, as the Pallas kernel runs at dtype bf16).
``bsr_sddmm`` launches the form of Q's dtype for CUDA tensors and takes
``bsr_sddmm_plain`` only for CPU tensors; an f64 Q raises.

The kernel runs the tensor-core tile of ``csrc/block_mma.cuh``: one
tile a (mask block, 128-row slice of it, 64 of its columns), its
contraction (d, 32 a step) split across a cluster where the tiles alone
would leave the card idle (``launch_grid`` reports the launch); the mask
multiplies the summed tile once. The bf16 form runs the bf16 step of
``csrc/bf16_mma.cuh``, 64 of d a step.
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


def launch_grid(mask: DeviceBSR) -> LaunchShape:
    """The launch of the form ``mask``'s blocks take for its stored blocks
    (pad blocks included) on the card ``mask`` lies on, as
    ``spgrid_bsr_sddmm`` or ``spgrid_bsr_sddmm_bf16`` makes it (the cluster
    depends on the card's SM count)."""
    nb, bm, bk = mask.blocks.shape
    entry = ("spgrid_bsr_sddmm_bf16_shape"
             if mask.blocks.dtype == torch.bfloat16
             else "spgrid_bsr_sddmm_shape")
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
         dtype: torch.dtype) -> torch.Tensor:
    _check(mask, q, k, dtype)
    if runs_plain(wrapper.__name__, q.device):
        return bsr_sddmm_plain(mask, q, k)
    return _launch(wrapper, mask, q, k)


def bsr_sddmm(mask: DeviceBSR, q: torch.Tensor,
              k: torch.Tensor) -> torch.Tensor:
    """(nb, bm, bk) block values aligned with ``mask.blocks``, in Q's dtype
    (f32, or bf16: ``bsr_sddmm_bf16``); pad blocks (block_row = mb) give
    zero blocks."""
    check_form("bsr_sddmm", q.dtype)
    if q.dtype == torch.bfloat16:
        return bsr_sddmm_bf16(mask, q, k)
    return _run(bsr_sddmm, mask, q, k, torch.float32)


bsr_sddmm.launches = 0


def bsr_sddmm_bf16(mask: DeviceBSR, q: torch.Tensor,
                   k: torch.Tensor) -> torch.Tensor:
    """(nb, bm, bk) bf16 block values for a bf16 mask, Q and K: each the
    f32 dot product times the mask value in f32, rounded once."""
    return _run(bsr_sddmm_bf16, mask, q, k, torch.bfloat16)


bsr_sddmm_bf16.launches = 0


def bsr_sddmm_plain(mask: DeviceBSR, q: torch.Tensor,
                    k: torch.Tensor) -> torch.Tensor:
    """The same block values in plain torch, in q's dtype (bf16: widened to
    f32, the product and the mask in f32, rounded once at the end): the
    gather of ``spgrid.ops.attention._sddmm_bsr_xla`` (Q and K row panels by
    block coordinates, a zero Q panel for the pad row mb) and one batched
    product."""
    nb, bm, bk = mask.blocks.shape
    mbq = -(-q.shape[0] // bm) + 1
    mbk = -(-k.shape[0] // bk)
    d = q.shape[1]
    acc = acc_dtype(q)
    qp = torch.zeros((mbq * bm, d), dtype=acc, device=q.device)
    qp[:q.shape[0]] = q
    kp = torch.zeros((mbk * bk, d), dtype=acc, device=q.device)
    kp[:k.shape[0]] = k
    qg = qp.view(mbq, bm, d)[mask.block_rows.long()]          # (nb, bm, d)
    kg = kp.view(mbk, bk, d)[mask.block_cols.long()]          # (nb, bk, d)
    return (torch.bmm(qg, kg.transpose(1, 2))
            * mask.blocks.to(acc)).to(q.dtype)
