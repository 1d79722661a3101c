"""Block-sparse-row SpMM: Y = A @ X with A in DeviceBSR layout.

Counterpart of ``spgrid/ops/pallas/bsr_spmm.py``; the CUDA kernels are
``spgrid_torch/csrc/bsr_spmm.cu``'s, in two forms: f32 (blocks, X and Y)
and bf16 (``bsr_spmm_bf16``: bf16 blocks and X, f32 sums, Y rounded once
to bf16, as the Pallas kernel runs at dtype bf16). ``bsr_spmm`` launches
the form of X's dtype for CUDA tensors and takes ``bsr_spmm_plain`` only
for CPU tensors; an f64 X raises.

The f32 kernel runs the tensor-core tile of ``csrc/block_mma.cuh``: one
tile a (block row, 128-row slice of it, 64 columns of X), its contraction
(the block row's blocks, 32 columns a step) split across a cluster where
the tiles alone would leave the card idle (``launch_grid`` reports the
launch). The bf16 form takes the two routes of the layout's
``BlockRoute`` (``DeviceBSR.route``, split by block row when the layout is
built; ``DeviceBSR.from_csr(..., route="tile"|"entry")`` forces one): the
block rows whose blocks hold more than the threshold's entries on average
run the bf16 tile of ``csrc/bf16_mma.cuh`` (the pipelined TMA tile, 128
columns of X, where TMA takes the operands, else the ``cp.async`` tile);
the other rows are walked entry by entry (``slot_rows.cuh``). A call
counts one launch of ``bsr_spmm_bf16``, and one of each kernel it ran on
``tile_launches`` and ``entry_launches``.
"""

from __future__ import annotations

import dataclasses

import torch

from spgrid_torch.ops.kernels import (
    _build, check_form, check_operands, runs_plain)
from spgrid_torch.ops.kernels.block_mma import LaunchShape, query
from spgrid_torch.ops.kernels.slot_rows import LONG_ROW
from spgrid_torch.ops.layouts import BlockRoute, DeviceBSR, all_tile_route
from spgrid_torch.ops.xla import acc_dtype


def _check(a: DeviceBSR, x: torch.Tensor, dtype: torch.dtype) -> None:
    if x.dim() != 2 or x.shape[0] != a.shape[1]:
        raise ValueError(f"x must be ({a.shape[1]}, n), got {tuple(x.shape)}")
    check_operands("bsr_spmm", x.device, x=(x, dtype),
                   blocks=(a.blocks, dtype),
                   block_cols=(a.block_cols, torch.int32),
                   row_ptr=(a.row_ptr, torch.int32))
    if dtype == torch.bfloat16 and a.route is not None:
        r = a.route
        check_operands("bsr_spmm", x.device, slot_vals=(r.slot_vals, dtype),
                       **{f: (getattr(r, f), torch.int32) for f in (
                           "tile_slices", "row_slot", "slot_xrows",
                           "walk_rows", "long_rows")})


def route_of(a: DeviceBSR) -> BlockRoute:
    """The bf16 form's split of ``a``: its own, or every block on the tile
    route where it carries none."""
    return a.route if a.route is not None else all_tile_route(a)


def launch_grid(a: DeviceBSR, n: int) -> LaunchShape:
    """The launch of the form ``a``'s blocks take for ``a`` at n columns of
    X on the card ``a`` lies on, as ``spgrid_bsr_spmm`` or
    ``spgrid_bsr_spmm_bf16`` makes it (the cluster depends on the card's SM
    count). The bf16 form's is its tile route's (tiles 0 where every slice
    takes the entry route)."""
    with torch.cuda.device(a.blocks.device):
        if a.blocks.dtype != torch.bfloat16:
            return query("spgrid_bsr_spmm_shape", "bsr_spmm", a.mb, a.bm, n)
        slices = route_of(a).tile_slices.numel()
        if slices == 0:
            shape = query("spgrid_bsr_spmm_bf16_shape", "bsr_spmm", 1, a.bk,
                          n)
            return LaunchShape(0, 0, *dataclasses.astuple(shape)[2:])
        return query("spgrid_bsr_spmm_bf16_shape", "bsr_spmm", slices, a.bk,
                     n)


def launch(a: DeviceBSR, x: torch.Tensor, y: torch.Tensor,
           cluster: int = 0) -> tuple:
    """Y (m, n) = A @ X into ``y`` by the form of X's dtype, the tile's
    cluster given (0: the launch rule), uncounted: for sweeps and tests.
    Returns the kernels it launched (the bf16 form: "tile" and "entry" as
    its route has slices of each)."""
    m, k = a.shape
    n = x.shape[1]
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if x.dtype != torch.bfloat16:
            _build.check(lib.spgrid_bsr_spmm(
                a.row_ptr.data_ptr(), a.block_cols.data_ptr(),
                a.blocks.data_ptr(), x.data_ptr(), y.data_ptr(), a.mb, a.bm,
                a.bk, m, k, n, cluster, stream), "bsr_spmm")
            return ("tile",)
        r = route_of(a)
        ran = []
        slices = r.tile_slices.numel()
        if slices:
            _build.check(lib.spgrid_bsr_spmm_bf16(
                a.row_ptr.data_ptr(), a.block_cols.data_ptr(),
                a.blocks.data_ptr(), r.tile_slices.data_ptr(), x.data_ptr(),
                y.data_ptr(), slices, a.blocks.shape[0], a.bm, a.bk, m, k, n,
                cluster, stream), "bsr_spmm_bf16")
            ran.append("tile")
        rows = r.walk_rows.numel()
        if rows:
            _build.check(lib.spgrid_bsr_spmm_bf16_entries(
                r.row_slot.data_ptr(), r.slot_vals.data_ptr(),
                r.slot_xrows.data_ptr(), r.walk_rows.data_ptr(),
                r.long_rows.data_ptr(), x.data_ptr(), y.data_ptr(), rows, n,
                LONG_ROW, r.long_rows.numel(), stream), "bsr_spmm_bf16")
            ran.append("entry")
        return tuple(ran)


def _launch(wrapper, a: DeviceBSR, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X by the form of X's dtype into a new Y; count the launch on
    ``wrapper`` (the bf16 form: also each kernel it ran)."""
    m = a.shape[0]
    n = x.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    ran = launch(a, x, y)
    wrapper.launches += 1
    if wrapper is bsr_spmm_bf16:
        bsr_spmm_bf16.tile_launches += "tile" in ran
        bsr_spmm_bf16.entry_launches += "entry" in ran
    return y


def _run(wrapper, a: DeviceBSR, x: torch.Tensor,
         dtype: torch.dtype) -> torch.Tensor:
    _check(a, x, dtype)
    if runs_plain(wrapper.__name__, x.device):
        return bsr_spmm_plain(a, x)
    return _launch(wrapper, a, x)


def bsr_spmm(a: DeviceBSR, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) = A @ X in X's dtype: f32 X (k, n) with f32 blocks, or bf16
    X with bf16 blocks (``bsr_spmm_bf16``)."""
    check_form("bsr_spmm", x.dtype)
    if x.dtype == torch.bfloat16:
        return bsr_spmm_bf16(a, x)
    return _run(bsr_spmm, a, x, torch.float32)


bsr_spmm.launches = 0


def bsr_spmm_bf16(a: DeviceBSR, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) bf16 = A @ X for bf16 blocks and bf16 X (k, n): f32 sums,
    each element of Y rounded once."""
    return _run(bsr_spmm_bf16, a, x, torch.bfloat16)


bsr_spmm_bf16.launches = 0
bsr_spmm_bf16.tile_launches = 0
bsr_spmm_bf16.entry_launches = 0


def bsr_spmm_plain(a: DeviceBSR, x: torch.Tensor) -> torch.Tensor:
    """The same product in plain torch, in x's dtype (bf16: widened to f32,
    summed in f32 and rounded once at the end): gather the X tile of every
    block, one batched matmul over the blocks, ``index_add_`` into the
    block rows (pad blocks land in a dropped row block ``mb``)."""
    m, k = a.shape
    n = x.shape[1]
    bm, bk, mb = a.bm, a.bk, a.mb
    acc = acc_dtype(x)
    kb = -(-k // bk)
    xp = torch.zeros((kb * bk, n), dtype=acc, device=x.device)
    xp[:k] = x
    xt = xp.view(kb, bk, n)[a.block_cols.long()]              # (nb, bk, n)
    prod = torch.bmm(a.blocks.to(acc), xt)                    # (nb, bm, n)
    out = torch.zeros((mb + 1, bm, n), dtype=acc, device=x.device)
    out.index_add_(0, a.block_rows.long(), prod)
    return out[:mb].reshape(mb * bm, n)[:m].to(x.dtype)
