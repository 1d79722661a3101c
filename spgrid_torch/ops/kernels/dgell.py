"""Gather-ELL SpMM: Y = A @ X with A in DeviceDGELL layout (ELL slots plus a
COO tail).

Counterpart of ``spgrid/ops/pallas/dgell.py`` (format ``dgell``); the CUDA
kernel is ``spgrid_torch/csrc/dgell.cu``. ``dgell_spmm`` launches it for
CUDA tensors and takes ``dgell_spmm_plain`` only for CPU tensors.

Each row keeps its first ``slots`` nnz in ELL slots; the nnz at positions
>= slots within a row form the COO tail, sorted by row, ``tail_ptr``
pointing at each row's. The kernel sums a row's slots and then its tail nnz
in one pass and writes each element of Y once (the JAX package adds the
tail in XLA outside its Pallas kernel). It walks X in column slabs that
stay in L2, the slab width C chosen on the card from k, n and its L2 size
(``launch_shape`` reports it). Its bf16 form (``dgell_spmm_bf16``, the
Pallas kernel at dtype bf16) reads bf16 X, widening it on load, keeps the
values f32 (the JAX layout holds them in f32 at every dtype, as
``DeviceDGELL`` does), sums the slots and the tail in f32 and rounds each
element of Y once, after the tail.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from spgrid_torch.ops.kernels import (
    _build, check_form, check_operands, runs_plain)
from spgrid_torch.ops.layouts import to_device
from spgrid_torch.ops.xla import acc_dtype

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
    """ELL slots and the COO tail on a torch device, the values in f32 for
    a matrix of any value type (those of a bf16 matrix are the f32 numbers
    bf16 holds). (The JAX layout blocks the columns slot-major in steps of
    rb rows and pads the values to 128 lanes for the TPU; the port keeps
    neither.)"""

    cols: torch.Tensor        # (m, slots) int32
    values: torch.Tensor      # (m, slots) f32, 0 in empty slots
    tail_rows: torch.Tensor   # (t,) int32, sorted
    tail_cols: torch.Tensor   # (t,) int32
    tail_vals: torch.Tensor   # (t,) f32
    tail_ptr: torch.Tensor    # (m + 1,) int32, row r's tail nnz
    shape: Tuple[int, int]
    nnz: int
    slots: int
    name: str = ""

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.cols, self.values, self.tail_rows, self.tail_cols,
            self.tail_vals, self.tail_ptr))

    @classmethod
    def from_arrays(cls, cols, values, tail_rows, tail_cols, tail_vals,
                    shape, nnz: int, slots: int, name: str = "", *,
                    device) -> "DeviceDGELL":
        """Host arrays → device layout; the tail is sorted by row (stably,
        so each row's nnz keep their order) and ``tail_ptr`` built here."""
        m = int(shape[0])
        rows = np.asarray(tail_rows, np.int64).reshape(-1)
        if rows.size and (rows.min() < 0 or rows.max() >= m):
            raise ValueError(f"dgell: a tail row lies outside 0..{m - 1}")
        order = np.argsort(rows, kind="stable")
        tail_ptr = np.concatenate([[0], np.cumsum(np.bincount(
            rows, minlength=m))])
        return cls(cols=to_device(cols, device, np.int32),
                   values=to_device(values, device, np.float32),
                   tail_rows=to_device(rows[order], device, np.int32),
                   tail_cols=to_device(np.asarray(tail_cols).reshape(-1)[
                       order], device, np.int32),
                   tail_vals=to_device(np.asarray(tail_vals).reshape(-1)[
                       order], device, np.float32),
                   tail_ptr=to_device(tail_ptr, device, np.int32),
                   shape=tuple(shape), nnz=int(nnz), slots=int(slots),
                   name=name)

    @classmethod
    def from_csr(cls, csr, *, device) -> "DeviceDGELL":
        cols, vals, t_rows, t_cols, t_vals, slots = dgell_arrays(csr)
        return cls.from_arrays(cols, vals, t_rows, t_cols, t_vals, csr.shape,
                               csr.nnz, slots, csr.name, device=device)


def _check(kernel: str, a: DeviceDGELL, x: torch.Tensor,
           dtype: torch.dtype) -> None:
    if x.dim() != 2 or x.shape[0] != a.shape[1]:
        raise ValueError(f"x must be ({a.shape[1]}, n), got {tuple(x.shape)}")
    check_operands(kernel, x.device, x=(x, dtype),
                   cols=(a.cols, torch.int32), values=(a.values, torch.float32),
                   tail_rows=(a.tail_rows, torch.int32),
                   tail_cols=(a.tail_cols, torch.int32),
                   tail_vals=(a.tail_vals, torch.float32),
                   tail_ptr=(a.tail_ptr, torch.int32))


class SlabShape(NamedTuple):
    """A launch of the kernel: X's columns in ``slabs`` slabs of ``slab``
    (the last may be narrower), CTAs of ``rows`` rows, ``lanes`` lanes a
    row."""

    slab: int
    slabs: int
    rows: int
    lanes: int


def launch_shape(k: int, n: int, slab: int = 0, vec: bool = True,
                 dtype: torch.dtype = torch.float32) -> SlabShape:
    """The launch the kernel's form for X of ``dtype`` (f32 or bf16) makes
    on the current card for X (k, n) at ``slab`` (0: its rule, from k, n
    and the card's L2 at f32, the widest slab at bf16), in the vector form
    (``vec``) or the scalar one."""
    shape = (ctypes.c_int * 4)()
    entry = ("spgrid_dgell_bf16_shape" if dtype == torch.bfloat16
             else "spgrid_dgell_shape")
    _build.check(getattr(_build.library(), entry)(
        k, n, slab, int(vec), ctypes.addressof(shape)), "dgell_spmm")
    return SlabShape(*shape)


def launch(a: DeviceDGELL, x: torch.Tensor, y: torch.Tensor,
           slab: int = 0) -> None:
    """One launch of the form of X's dtype (f32, or bf16 X and Y) into
    ``y`` at slab width ``slab`` (0: the kernel's rule; a power of two from
    8 to 512, or n, for sweeps and tests), uncounted; ``dgell_spmm`` is the
    entry point."""
    m, k = a.shape
    entry = ("spgrid_dgell_bf16" if x.dtype == torch.bfloat16
             else "spgrid_dgell")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(_build.library(), entry)(
            a.cols.data_ptr(), a.values.data_ptr(), a.tail_ptr.data_ptr(),
            a.tail_cols.data_ptr(), a.tail_vals.data_ptr(), x.data_ptr(),
            y.data_ptr(), m, k, a.slots, x.shape[1], slab, stream)
    _build.check(code, "dgell_spmm")


def _run(wrapper, a: DeviceDGELL, x: torch.Tensor,
         dtype: torch.dtype) -> torch.Tensor:
    _check(wrapper.__name__, a, x, dtype)
    if runs_plain(wrapper.__name__, x.device):
        return dgell_spmm_plain(a, x)
    m, _ = a.shape
    n = x.shape[1]
    y = torch.empty((m, n), dtype=dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    launch(a, x, y)
    wrapper.launches += 1
    return y


def dgell_spmm(a: DeviceDGELL, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) = A @ X in X's dtype, f32 or bf16 (``dgell_spmm_bf16``):
    one launch, slots and tail."""
    check_form("dgell_spmm", x.dtype)
    if x.dtype == torch.bfloat16:
        return dgell_spmm_bf16(a, x)
    return _run(dgell_spmm, a, x, torch.float32)


dgell_spmm.launches = 0


def dgell_spmm_bf16(a: DeviceDGELL, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) bf16 = A @ X for bf16 X (k, n) and the layout's f32 values:
    X widened, the slots and then the tail summed in f32, each element of Y
    rounded once."""
    return _run(dgell_spmm_bf16, a, x, torch.bfloat16)


dgell_spmm_bf16.launches = 0


def dgell_spmm_plain(a: DeviceDGELL, x: torch.Tensor,
                     chunk_elems: int = 1 << 25) -> torch.Tensor:
    """The same product in plain torch, in x's dtype: per chunk of rows, the
    X rows of every slot gathered and summed with their values, then the
    tail added with ``index_add_``. Chunks keep the gathered (rows, slots,
    n) block under ``chunk_elems``. bf16: X widened, the sums in f32, Y
    rounded once (the JAX function's ``xf`` and ``astype``)."""
    m, _ = a.shape
    n = x.shape[1]
    out = x.dtype
    acc = acc_dtype(x)
    x = x.to(acc)
    y = torch.empty((m, n), dtype=acc, device=x.device)
    rows = max(1, chunk_elems // max(a.slots * n, 1))
    for r0 in range(0, m, rows):
        cols = a.cols[r0:r0 + rows].long()
        vals = a.values[r0:r0 + rows].to(acc)
        y[r0:r0 + rows] = torch.einsum("rs,rsn->rn", vals, x[cols])
    if a.tail_rows.numel():
        y.index_add_(0, a.tail_rows.long(),
                     a.tail_vals.to(acc)[:, None] * x[a.tail_cols.long()])
    return y.to(out)


def dgell_rows_plain(a: DeviceDGELL, x: torch.Tensor) -> torch.Tensor:
    """The product in plain torch in the kernel's order, in x's dtype: each
    row's ELL slots in slot order, then its tail nnz in order
    (``tail_ptr``), one position at a time for every row. bf16: X widened,
    the sums in f32, Y rounded once (each product of a bf16 X element and
    a value that bf16 holds is exact in f32, so this is the kernel's FMA
    chain bit for bit)."""
    m, _ = a.shape
    out = x.dtype
    acc = acc_dtype(x)
    x = x.to(acc)
    y = torch.zeros((m, x.shape[1]), dtype=acc, device=x.device)
    vals = a.values.to(acc)
    for s in range(a.slots):
        y += vals[:, s, None] * x[a.cols[:, s].long()]
    ptr = a.tail_ptr.long()
    count = ptr[1:] - ptr[:-1]
    tail_vals = a.tail_vals.to(acc)
    for t in range(int(count.max()) if m else 0):
        rows = torch.nonzero(count > t).squeeze(1)
        at = ptr[rows] + t
        y[rows] += tail_vals[at, None] * x[a.tail_cols[at].long()]
    return y.to(out)
