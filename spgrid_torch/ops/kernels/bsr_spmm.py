"""Block-sparse-row SpMM: Y = A @ X with A in DeviceBSR layout.

Counterpart of ``spgrid/ops/pallas/bsr_spmm.py``; the CUDA kernels are
``spgrid_torch/csrc/bsr_spmm.cu``'s, in three forms: f32 (blocks, X and
Y), bf16 (``bsr_spmm_bf16``: bf16 blocks and X, f32 sums, Y rounded once
to bf16, as the Pallas kernel runs at dtype bf16) and the 3-pass bf16 form
of f32 operands (``bsr_spmm_bf16x3``: the Pallas kernel's dot at matmul
precision 'high', blocks and X split into bf16 hi and lo parts, A_hi X_hi +
A_hi X_lo + A_lo X_hi summed in f32). ``bsr_spmm(..., precision=)``
launches the form of X's dtype and the precision for CUDA tensors and takes
its plain version (``bsr_spmm_plain``, ``bsr_spmm_bf16x3_plain``) only for
CPU tensors; an f64 X, or a precision without a form, raises.

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
``tile_launches`` and ``entry_launches``. The 3-pass form splits the
blocks and X once into bf16 planes (in scratch the wrapper allocates:
``x3_shape``), then runs the TMA-fed 3-pass tile of ``csrc/bf16x3.cuh``
over every block row's slices, 128 columns of X a tile.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from spgrid_torch.ops.kernels import (
    OTHER_PRECISIONS, _build, check_form, check_operands, runs_plain)
from spgrid_torch.ops.kernels.bf16x3 import bmm_bf16x3
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


def x3_shape(a: DeviceBSR, n: int):
    """(the 3-pass form's tile launch, the bytes of its split planes) for
    ``a`` at n columns of X on the card ``a`` lies on, as
    ``spgrid_bsr_spmm_bf16x3_shape`` reports them."""
    shape = (ctypes.c_int * 6)()
    scratch = ctypes.c_longlong()
    with torch.cuda.device(a.blocks.device):
        _build.check(_build.library().spgrid_bsr_spmm_bf16x3_shape(
            a.blocks.shape[0], a.mb, a.bm, a.bk, a.shape[1], n,
            ctypes.addressof(shape), ctypes.addressof(scratch)),
            "bsr_spmm_bf16x3")
    return LaunchShape(*shape), scratch.value


def x3_launch(a: DeviceBSR, x: torch.Tensor, y: torch.Tensor,
              cluster: int = 0) -> None:
    """Y (m, n) = A @ X at matmul precision 'high' into ``y`` (its split
    planes in new scratch), the tile's cluster given (0: the launch rule),
    uncounted: for sweeps and tests."""
    m, k = a.shape
    n = x.shape[1]
    scratch = torch.empty(x3_shape(a, n)[1], dtype=torch.uint8,
                          device=x.device)
    with torch.cuda.device(x.device):
        _build.check(_build.library().spgrid_bsr_spmm_bf16x3(
            a.row_ptr.data_ptr(), a.block_cols.data_ptr(),
            a.blocks.data_ptr(), x.data_ptr(), y.data_ptr(),
            scratch.data_ptr(), a.blocks.shape[0], a.mb, a.bm, a.bk, m, k, n,
            cluster, torch.cuda.current_stream().cuda_stream),
            "bsr_spmm_bf16x3")


def _launch(wrapper, a: DeviceBSR, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X by the form of X's dtype into a new Y; count the launch on
    ``wrapper`` (the bf16 form: also each kernel it ran)."""
    m = a.shape[0]
    n = x.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    if wrapper is bsr_spmm_bf16x3:
        x3_launch(a, x, y)
        wrapper.launches += 1
        return y
    ran = launch(a, x, y)
    wrapper.launches += 1
    if wrapper is bsr_spmm_bf16:
        bsr_spmm_bf16.tile_launches += "tile" in ran
        bsr_spmm_bf16.entry_launches += "entry" in ran
    return y


def _run(wrapper, a: DeviceBSR, x: torch.Tensor, dtype: torch.dtype,
         plain=None) -> torch.Tensor:
    _check(a, x, dtype)
    if runs_plain(wrapper.__name__, x.device):
        return (plain or bsr_spmm_plain)(a, x)
    return _launch(wrapper, a, x)


def bsr_spmm(a: DeviceBSR, x: torch.Tensor, precision=None) -> torch.Tensor:
    """Y (m, n) = A @ X in X's dtype at matmul ``precision`` (None: the
    dtype's own): f32 X (k, n) with f32 blocks ('high': ``bsr_spmm_bf16x3``),
    or bf16 X with bf16 blocks (``bsr_spmm_bf16``)."""
    check_form("bsr_spmm", x.dtype, precision=precision,
               other_precisions=OTHER_PRECISIONS)
    if x.dtype == torch.bfloat16:
        return bsr_spmm_bf16(a, x)
    if precision == "high":
        return bsr_spmm_bf16x3(a, x)
    return _run(bsr_spmm, a, x, torch.float32)


bsr_spmm.launches = 0


def bsr_spmm_bf16(a: DeviceBSR, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) bf16 = A @ X for bf16 blocks and bf16 X (k, n): f32 sums,
    each element of Y rounded once."""
    return _run(bsr_spmm_bf16, a, x, torch.bfloat16)


bsr_spmm_bf16.launches = 0
bsr_spmm_bf16.tile_launches = 0
bsr_spmm_bf16.entry_launches = 0


def bsr_spmm_bf16x3(a: DeviceBSR, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) f32 = A @ X for f32 blocks and X (k, n) at matmul precision
    'high': three bf16 passes summed in f32 (``bsr_spmm_bf16x3_plain`` says
    in what order)."""
    return _run(bsr_spmm_bf16x3, a, x, torch.float32, bsr_spmm_bf16x3_plain)


bsr_spmm_bf16x3.launches = 0


def _x_tiles(a: DeviceBSR, x: torch.Tensor, dtype: torch.dtype):
    """The X tile of every block, (nb, bk, n) in ``dtype``: X padded with
    zero rows to whole block columns."""
    k, n = x.shape
    kb = -(-k // a.bk)
    xp = torch.zeros((kb * a.bk, n), dtype=dtype, device=x.device)
    xp[:k] = x
    return xp.view(kb, a.bk, n)[a.block_cols.long()]


def _block_rows_sum(a: DeviceBSR, prod: torch.Tensor) -> torch.Tensor:
    """The blocks' products (nb, bm, n) added into their block rows in block
    order (``index_add_``; pad blocks land in a dropped row block ``mb``),
    as Y (m, n)."""
    out = torch.zeros((a.mb + 1, a.bm, prod.shape[2]), dtype=prod.dtype,
                      device=prod.device)
    out.index_add_(0, a.block_rows.long(), prod)
    return out[:a.mb].reshape(a.mb * a.bm, prod.shape[2])[:a.shape[0]]


def bsr_spmm_bf16x3_plain(a: DeviceBSR, x: torch.Tensor) -> torch.Tensor:
    """The 3-pass form's product in plain torch, f32: each block times its
    X tile by ``bmm_bf16x3`` (each pass's sum in f64 rounded once to f32,
    the cross passes added, then the hi pass), added into its block row in
    block order, as the Pallas kernel's ``o_ref +=`` does."""
    return _block_rows_sum(a, bmm_bf16x3(a.blocks, _x_tiles(
        a, x, torch.float32)))


def bsr_spmm_plain(a: DeviceBSR, x: torch.Tensor) -> torch.Tensor:
    """The same product in plain torch, in x's dtype (bf16: widened to f32,
    summed in f32 and rounded once at the end): gather the X tile of every
    block, one batched matmul over the blocks, ``index_add_`` into the
    block rows (pad blocks land in a dropped row block ``mb``)."""
    acc = acc_dtype(x)
    prod = torch.bmm(a.blocks.to(acc), _x_tiles(a, x, acc))  # (nb, bm, n)
    return _block_rows_sum(a, prod).to(x.dtype)
