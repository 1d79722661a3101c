"""Gather-ELL SpMM: Y = A @ X with A in DeviceDGELL layout (ELL slots plus a
COO tail).

Counterpart of ``spgrid/ops/pallas/dgell.py`` (format ``dgell``); the CUDA
kernel is ``spgrid_torch/csrc/dgell.cu``. ``dgell_spmm`` launches it for
CUDA tensors and takes ``dgell_spmm_plain`` only for CPU tensors.

Each row keeps its first ``slots`` nnz in ELL slots; the nnz at positions
>= slots within a row form the COO tail, which the wrapper adds after the
kernel with ``index_add_`` on the same stream, as the JAX package combines
it in XLA outside its Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from spgrid_torch.ops.kernels import _build, check_operands
from spgrid_torch.ops.layouts import to_device

MAX_SLOTS = 128


def pick_slots(csr) -> int:
    """The JAX layout's slot count: ceil(1.25 x the mean degree), or the
    largest degree when that is at most 2 more, capped at 128."""
    m = csr.shape[0]
    deg = csr.degrees
    slots = max(1, int(np.ceil(csr.nnz / max(m, 1) * 1.25)))
    if deg.size and int(deg.max()) <= slots + 2:
        slots = int(deg.max())
    return min(slots, MAX_SLOTS)


def dgell_arrays(csr):
    """(cols (m, slots) int32, values (m, slots) f32, tail_rows, tail_cols,
    tail_vals, slots) with ``pick_slots``'s slot count: slot s of row r
    holds the row's s-th nnz; empty slots hold column 0 and value 0."""
    m, _ = csr.shape
    slots = pick_slots(csr)
    deg = csr.degrees
    row_of = np.repeat(np.arange(m, dtype=np.int64), deg)
    within = (np.arange(csr.nnz, dtype=np.int64)
              - np.repeat(csr.row_ptr[:-1].astype(np.int64), deg))
    take = within < slots
    cols = np.zeros((m, slots), np.int32)
    vals = np.zeros((m, slots), np.float32)
    cols[row_of[take], within[take]] = csr.col_idx[take]
    vals[row_of[take], within[take]] = csr.values[take]
    tail = ~take
    return (cols, vals, row_of[tail].astype(np.int32),
            csr.col_idx[tail].astype(np.int32),
            csr.values[tail].astype(np.float32), slots)


@dataclasses.dataclass
class DeviceDGELL:
    """ELL slots and the COO tail on a torch device. (The JAX layout blocks
    the columns slot-major in steps of rb rows and pads the values to 128
    lanes for the TPU; the port keeps neither.)"""

    cols: torch.Tensor        # (m, slots) int32
    values: torch.Tensor      # (m, slots) f32, 0 in empty slots
    tail_rows: torch.Tensor   # (t,) int32
    tail_cols: torch.Tensor   # (t,) int32
    tail_vals: torch.Tensor   # (t,) f32
    shape: Tuple[int, int]
    nnz: int
    slots: int
    name: str = ""

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.cols, self.values, self.tail_rows, self.tail_cols,
            self.tail_vals))

    @classmethod
    def from_arrays(cls, cols, values, tail_rows, tail_cols, tail_vals,
                    shape, nnz: int, slots: int, name: str = "", *,
                    device) -> "DeviceDGELL":
        return cls(cols=to_device(cols, device, np.int32),
                   values=to_device(values, device, np.float32),
                   tail_rows=to_device(tail_rows, device, np.int32),
                   tail_cols=to_device(tail_cols, device, np.int32),
                   tail_vals=to_device(tail_vals, device, np.float32),
                   shape=tuple(shape), nnz=int(nnz), slots=int(slots),
                   name=name)

    @classmethod
    def from_csr(cls, csr, *, device) -> "DeviceDGELL":
        cols, vals, t_rows, t_cols, t_vals, slots = dgell_arrays(csr)
        return cls.from_arrays(cols, vals, t_rows, t_cols, t_vals, csr.shape,
                               csr.nnz, slots, csr.name, device=device)


def _check(a: DeviceDGELL, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] != a.shape[1]:
        raise ValueError(f"x must be ({a.shape[1]}, n), got {tuple(x.shape)}")
    check_operands("dgell_spmm", x.device, x=(x, torch.float32),
                   cols=(a.cols, torch.int32), values=(a.values, torch.float32),
                   tail_rows=(a.tail_rows, torch.int32),
                   tail_cols=(a.tail_cols, torch.int32),
                   tail_vals=(a.tail_vals, torch.float32))


def dgell_spmm(a: DeviceDGELL, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) f32 = A @ X for f32 X (k, n)."""
    _check(a, x)
    if x.device.type == "cpu":
        return dgell_spmm_plain(a, x)
    if x.device.type != "cuda":
        raise ValueError(f"dgell_spmm: no kernel for device {x.device}")
    m, _ = a.shape
    n = x.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.spgrid_dgell(a.cols.data_ptr(), a.values.data_ptr(),
                                x.data_ptr(), y.data_ptr(), m, a.slots, n,
                                stream)
        _build.check(code, "dgell_spmm")
        dgell_spmm.launches += 1
        if a.tail_rows.numel():
            y.index_add_(0, a.tail_rows,
                         a.tail_vals[:, None] * x[a.tail_cols])
    return y


dgell_spmm.launches = 0


def dgell_spmm_plain(a: DeviceDGELL, x: torch.Tensor,
                     chunk_elems: int = 1 << 25) -> torch.Tensor:
    """The same product in plain torch, in x's dtype: per chunk of rows, the
    X rows of every slot gathered and summed with their values, then the
    tail added with ``index_add_``. Chunks keep the gathered (rows, slots,
    n) block under ``chunk_elems``."""
    m, _ = a.shape
    n = x.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rows = max(1, chunk_elems // max(a.slots * n, 1))
    for r0 in range(0, m, rows):
        cols = a.cols[r0:r0 + rows].long()
        vals = a.values[r0:r0 + rows].to(x.dtype)
        y[r0:r0 + rows] = torch.einsum("rs,rsn->rn", vals, x[cols])
    if a.tail_rows.numel():
        y.index_add_(0, a.tail_rows.long(),
                     a.tail_vals.to(x.dtype)[:, None]
                     * x[a.tail_cols.long()])
    return y
