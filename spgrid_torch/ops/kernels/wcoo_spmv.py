"""Aligned-slot SpMV: y = A @ x with A in DeviceWCOOAligned layout.

Counterpart of ``spgrid/ops/pallas/wcoo_spmv.py`` (format ``wcoo_spmv``); the
CUDA kernel is ``spgrid_torch/csrc/wcoo_spmv.cu``. ``wcoo_spmv`` takes x (k,)
and returns y (m,), x unpadded. It launches the kernel for CUDA tensors and
takes ``wcoo_spmv_plain`` only for CPU tensors.

A group is (8, 128) slots: row w = window within the group's 1024-column
superwindow, lane = row within its 128-row target block
(``formats.wcoo.csr_to_wcoo_aligned``); groups are sorted by target block.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from spgrid_torch.formats.wcoo import LANE, csr_to_wcoo_aligned
from spgrid_torch.ops.kernels import _build, check_operands
from spgrid_torch.ops.layouts import group_ptr, to_device

GROUP_ROWS = 8       # windows of a superwindow == slot rows of a group


@dataclasses.dataclass
class DeviceWCOOAligned:
    """``csr_to_wcoo_aligned``'s groups on a torch device, plus
    ``block_ptr``: the groups of target block b are ``block_ptr[b]:
    block_ptr[b + 1]``. (The JAX layout pads the groups to a multiple of 256
    for its grid; the port does not.)"""

    cols: torch.Tensor        # (G*8, 128) int8, col % 128 of each slot
    values: torch.Tensor      # (G*8, 128), 0 in empty slots
    g_sw: torch.Tensor        # (G,) int32, superwindow of each group
    g_sub: torch.Tensor       # (G,) int32, target block of each group, sorted
    block_ptr: torch.Tensor   # (ceil(m / 128) + 1,) int32
    shape: Tuple[int, int]
    nnz: int
    utilization: float
    num_groups: int
    name: str = ""

    @property
    def blocks(self) -> int:
        return len(self.block_ptr) - 1

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.cols, self.values, self.g_sw, self.block_ptr))

    @classmethod
    def from_arrays(cls, cols, values, g_sw, g_sub, shape, nnz: int,
                    utilization: float, num_groups: int, name: str = "", *,
                    device) -> "DeviceWCOOAligned":
        """Host arrays → device layout; groups past ``num_groups`` (the JAX
        layout's padding) are dropped."""
        G = int(num_groups)
        sub = np.asarray(g_sub, np.int64)[:G]
        if np.any(np.diff(sub) < 0):
            raise ValueError("wcoo_spmv: groups must be sorted by target "
                             "block")
        ptr, _ = group_ptr(sub, max(-(-shape[0] // LANE), 1))
        rows = G * GROUP_ROWS
        return cls(cols=to_device(np.asarray(cols).reshape(-1, LANE)[:rows],
                                  device, np.int8),
                   values=to_device(
                       np.asarray(values).reshape(-1, LANE)[:rows], device),
                   g_sw=to_device(np.asarray(g_sw)[:G], device, np.int32),
                   g_sub=to_device(sub, device, np.int32),
                   block_ptr=to_device(ptr, device), shape=tuple(shape),
                   nnz=int(nnz), utilization=float(utilization),
                   num_groups=G, name=name)

    @classmethod
    def from_csr(cls, csr, *, device) -> "DeviceWCOOAligned":
        cols, vals, g_sw, g_sub, G, util = csr_to_wcoo_aligned(csr)
        return cls.from_arrays(cols, vals, g_sw, g_sub, csr.shape, csr.nnz,
                               util, G, csr.name, device=device)


def wcoo_spmv(a: DeviceWCOOAligned, x: torch.Tensor) -> torch.Tensor:
    """y (m,) f32 = A @ x for f32 x (k,)."""
    if x.dim() != 1 or x.shape[0] != a.shape[1]:
        raise ValueError(f"x must be ({a.shape[1]},), got {tuple(x.shape)}")
    check_operands("wcoo_spmv", x.device, x=(x, torch.float32),
                   values=(a.values, torch.float32), cols=(a.cols, torch.int8),
                   g_sw=(a.g_sw, torch.int32),
                   block_ptr=(a.block_ptr, torch.int32))
    if x.device.type == "cpu":
        return wcoo_spmv_plain(a, x)
    if x.device.type != "cuda":
        raise ValueError(f"wcoo_spmv: no kernel for device {x.device}")
    m, k = a.shape
    y = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.spgrid_wcoo_spmv(
            a.block_ptr.data_ptr(), a.g_sw.data_ptr(), a.cols.data_ptr(),
            a.values.data_ptr(), x.data_ptr(), y.data_ptr(), a.blocks, m, k,
            stream)
    _build.check(code, "wcoo_spmv")
    wcoo_spmv.launches += 1
    return y


wcoo_spmv.launches = 0


def wcoo_spmv_plain(a: DeviceWCOOAligned, x: torch.Tensor) -> torch.Tensor:
    """The same product in plain torch, in x's dtype: slot (w, t) of group g
    adds value · x[1024 g_sw[g] + 128 w + col] to row 128 g_sub[g] + t
    (``index_add_``), for slots whose value is not 0 and x index lies
    inside x."""
    m, k = a.shape
    slots = (GROUP_ROWS, LANE)
    vals = a.values.view(-1, *slots)
    w = torch.arange(GROUP_ROWS, device=x.device)[:, None]
    lane = torch.arange(LANE, device=x.device)
    xi = (a.g_sw.long()[:, None, None] * (GROUP_ROWS * LANE) + w * LANE
          + a.cols.view(-1, *slots).long())
    row = (a.g_sub.long()[:, None, None] * LANE + lane).expand(-1, *slots)
    live = (vals != 0) & (xi < k)
    y = torch.zeros((m,), dtype=x.dtype, device=x.device)
    y.index_add_(0, row[live], vals[live].to(x.dtype) * x[xi[live]])
    return y
