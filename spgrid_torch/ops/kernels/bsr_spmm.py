"""Block-sparse-row SpMM: Y = A @ X with A in DeviceBSR layout.

Counterpart of ``spgrid/ops/pallas/bsr_spmm.py``; the CUDA kernel is
``spgrid_torch/csrc/bsr_spmm.cu``. ``bsr_spmm`` launches it for CUDA
tensors and takes ``bsr_spmm_plain`` only for CPU tensors.
"""

from __future__ import annotations

import torch

from spgrid_torch.ops.kernels import _build, check_operands
from spgrid_torch.ops.layouts import DeviceBSR


def _check(a: DeviceBSR, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] != a.shape[1]:
        raise ValueError(f"x must be ({a.shape[1]}, n), got {tuple(x.shape)}")
    check_operands("bsr_spmm", x.device, x=(x, torch.float32),
                   blocks=(a.blocks, torch.float32),
                   block_cols=(a.block_cols, torch.int32),
                   row_ptr=(a.row_ptr, torch.int32))


def bsr_spmm(a: DeviceBSR, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) f32 = A @ X for f32 X (k, n)."""
    _check(a, x)
    if x.device.type == "cpu":
        return bsr_spmm_plain(a, x)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_spmm: no kernel for device {x.device}")
    m, k = a.shape
    n = x.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.spgrid_bsr_spmm(
            a.row_ptr.data_ptr(), a.block_cols.data_ptr(),
            a.blocks.data_ptr(), x.data_ptr(), y.data_ptr(),
            a.mb, a.bm, a.bk, m, k, n, stream)
    _build.check(code, "bsr_spmm")
    bsr_spmm.launches += 1
    return y


bsr_spmm.launches = 0


def bsr_spmm_plain(a: DeviceBSR, x: torch.Tensor) -> torch.Tensor:
    """The same product in plain torch, in x's dtype: gather the X tile of
    every block, one batched matmul over the blocks, ``index_add_`` into the
    block rows (pad blocks land in a dropped row block ``mb``)."""
    m, k = a.shape
    n = x.shape[1]
    bm, bk, mb = a.bm, a.bk, a.mb
    kb = -(-k // bk)
    xp = torch.zeros((kb * bk, n), dtype=x.dtype, device=x.device)
    xp[:k] = x
    xt = xp.view(kb, bk, n)[a.block_cols.long()]              # (nb, bk, n)
    prod = torch.bmm(a.blocks.to(x.dtype), xt)                # (nb, bm, n)
    out = torch.zeros((mb + 1, bm, n), dtype=x.dtype, device=x.device)
    out.index_add_(0, a.block_rows.long(), prod)
    return out[:mb].reshape(mb * bm, n)[:m]
