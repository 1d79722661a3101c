"""Block-sparse SDDMM: the block values of mask ⊙ (Q @ Kᵀ) on a DeviceBSR
mask.

Counterpart of ``spgrid/ops/pallas/sddmm.py``; the CUDA kernel is
``spgrid_torch/csrc/sddmm.cu``. ``bsr_sddmm`` launches it for CUDA tensors
and takes ``bsr_sddmm_plain`` only for CPU tensors.

The kernel runs the tensor-core tile of ``csrc/block_mma.cuh``: one
tile a (mask block, 128-row slice of it, 64 of its columns), its
contraction (d, 32 a step) split across a cluster where the tiles alone
would leave the card idle (``launch_grid`` reports the launch); the mask
multiplies the summed tile once.
"""

from __future__ import annotations

import torch

from spgrid_torch.ops.kernels import _build, check_operands
from spgrid_torch.ops.kernels.block_mma import LaunchShape, query
from spgrid_torch.ops.layouts import DeviceBSR


def _check(mask: DeviceBSR, q: torch.Tensor, k: torch.Tensor) -> None:
    if q.dim() != 2 or k.dim() != 2 or q.shape[1] != k.shape[1]:
        raise ValueError(f"q (mq, d) and k (mk, d) must share d, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    check_operands("bsr_sddmm", q.device, q=(q, torch.float32),
                   k=(k, torch.float32),
                   mask_blocks=(mask.blocks, torch.float32),
                   block_rows=(mask.block_rows, torch.int32),
                   block_cols=(mask.block_cols, torch.int32))


def launch_grid(mask: DeviceBSR) -> LaunchShape:
    """The kernel's launch for ``mask``'s stored blocks (pad blocks
    included) on the card ``mask`` lies on, as ``spgrid_bsr_sddmm`` makes it
    (the cluster depends on the card's SM count)."""
    nb, bm, bk = mask.blocks.shape
    with torch.cuda.device(mask.blocks.device):
        return query("spgrid_bsr_sddmm_shape", "bsr_sddmm", nb, bm, bk)


def bsr_sddmm(mask: DeviceBSR, q: torch.Tensor,
              k: torch.Tensor) -> torch.Tensor:
    """(nb, bm, bk) f32 block values aligned with ``mask.blocks``; pad blocks
    (block_row = mb) give zero blocks."""
    _check(mask, q, k)
    if q.device.type == "cpu":
        return bsr_sddmm_plain(mask, q, k)
    if q.device.type != "cuda":
        raise ValueError(f"bsr_sddmm: no kernel for device {q.device}")
    nb, bm, bk = mask.blocks.shape
    out = torch.empty((nb, bm, bk), dtype=torch.float32, device=q.device)
    if nb == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.spgrid_bsr_sddmm(
            mask.block_rows.data_ptr(), mask.block_cols.data_ptr(),
            mask.blocks.data_ptr(), q.data_ptr(), k.data_ptr(),
            out.data_ptr(), nb, bm, bk, q.shape[0], k.shape[0], q.shape[1],
            0, stream)
    _build.check(code, "bsr_sddmm")
    bsr_sddmm.launches += 1
    return out


bsr_sddmm.launches = 0


def bsr_sddmm_plain(mask: DeviceBSR, q: torch.Tensor,
                    k: torch.Tensor) -> torch.Tensor:
    """The same block values in plain torch, in q's dtype: the gather of
    ``spgrid.ops.attention._sddmm_bsr_xla`` (Q and K row panels by block
    coordinates, a zero Q panel for the pad row mb) and one batched
    product."""
    nb, bm, bk = mask.blocks.shape
    mbq = -(-q.shape[0] // bm) + 1
    mbk = -(-k.shape[0] // bk)
    d = q.shape[1]
    qp = torch.zeros((mbq * bm, d), dtype=q.dtype, device=q.device)
    qp[:q.shape[0]] = q
    kp = torch.zeros((mbk * bk, d), dtype=q.dtype, device=q.device)
    kp[:k.shape[0]] = k
    qg = qp.view(mbq, bm, d)[mask.block_rows.long()]          # (nb, bm, d)
    kg = kp.view(mbk, bk, d)[mask.block_cols.long()]          # (nb, bk, d)
    return torch.bmm(qg, kg.transpose(1, 2)) * mask.blocks.to(q.dtype)
