"""Gather along one axis of a 2-D f32 array: ``take_along_axis``.

Counterpart of the Pallas probe ``scripts/exp_lanegather.py``
(``try_compile`` and the gather kernels it compiles); the CUDA kernel is
``spgrid_torch/csrc/lanegather.cu``. ``lanegather`` launches it for CUDA
tensors and takes ``lanegather_plain`` only for CPU tensors.

``lanegather(src, idx, 1)[i, j] = src[i, idx[i, j]]`` (idx has src's rows)
and ``lanegather(src, idx, 0)[i, j] = src[idx[i, j], j]`` (idx has src's
columns); the output has idx's shape. Indices must lie inside src along the
axis: the plain version raises on one that does not, the kernel reads 0.

The kernel has two paths, ``STAGED`` (a CTA copies its tile of src into
shared memory and gathers there) and ``DIRECT`` (a thread an element,
gathering from device memory). The rule in the ``.cu`` takes the direct
path on every call; ``launch`` asks for either path by name, for the A/B
of the two, and ``card_plan`` asks the built kernel for a path's launch.
``walk_plain`` repeats each path's walk in torch, tile by tile.
``launch_floor`` launches an empty kernel: the card's launch floor.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from spgrid_torch.ops.kernels import _build, check_operands

RULE, DIRECT, STAGED = 0, 1, 2


class Plan(NamedTuple):
    """A launch: the path, the staged tile (rows for axis 1, columns for
    axis 0; 0 on the direct path) and the CTAs."""
    path: int
    tile: int
    ctas: int


def card_plan(s0: int, s1: int, i0: int, i1: int, axis: int,
              path: int = RULE) -> Plan:
    """The built kernel's launch at ``path`` (``RULE``: the rule's) for src
    (s0, s1) and idx (i0, i1); raises where the staged path is asked for
    and no tile fits."""
    out = (ctypes.c_int * 3)()
    _build.check(_build.library().spgrid_lanegather_shape(
        s0, s1, i0, i1, axis, path, ctypes.addressof(out)), "lanegather")
    return Plan(*out)


def _check(src: torch.Tensor, idx: torch.Tensor, axis: int) -> None:
    if axis not in (0, 1):
        raise ValueError(f"lanegather: axis must be 0 or 1, got {axis}")
    if src.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"lanegather: src and idx must be 2-D, got "
                         f"{tuple(src.shape)} and {tuple(idx.shape)}")
    other = 1 - axis
    if idx.shape[other] != src.shape[other]:
        raise ValueError(f"lanegather: along axis {axis} idx {tuple(idx.shape)}"
                         f" must match src {tuple(src.shape)} in dim {other}")
    check_operands("lanegather", src.device, src=(src, torch.float32),
                   idx=(idx, torch.int32))
    if src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lanegather: no kernel for device {src.device}")


def lanegather(src: torch.Tensor, idx: torch.Tensor,
               axis: int) -> torch.Tensor:
    """out (idx's shape) f32 = take_along_axis(src, idx, axis), for f32 src
    and int32 idx, both 2-D; on the card by the rule's path."""
    _check(src, idx, axis)
    if src.device.type == "cpu":
        return lanegather_plain(src, idx, axis)
    out = torch.empty(idx.shape, dtype=torch.float32, device=src.device)
    launch(src, idx, out, axis)
    lanegather.launches += 1
    return out


lanegather.launches = 0


def launch(src: torch.Tensor, idx: torch.Tensor, out: torch.Tensor,
           axis: int, path: int = RULE) -> None:
    """One launch of the kernel into ``out`` by ``path`` (``RULE``,
    ``DIRECT`` or ``STAGED``), uncounted, for the A/B of the two paths and
    tests; ``lanegather`` is the entry point."""
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _build.library().spgrid_lanegather(
            src.data_ptr(), idx.data_ptr(), out.data_ptr(), src.shape[0],
            src.shape[1], idx.shape[0], idx.shape[1], axis, path, stream)
    _build.check(code, "lanegather")


def launch_floor(device) -> None:
    """One launch of an empty kernel (a CTA of 32 threads that writes
    nothing) on ``device``'s current stream, uncounted: timed beside the
    gathers, it is the least a launch costs."""
    with torch.cuda.device(device):
        code = _build.library().spgrid_launch_floor(
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "launch_floor")


def lanegather_plain(src: torch.Tensor, idx: torch.Tensor,
                     axis: int) -> torch.Tensor:
    """The same gather in plain torch (``torch.take_along_dim``), in src's
    dtype."""
    return torch.take_along_dim(src, idx.long(), dim=axis)


def walk_plain(src: torch.Tensor, idx: torch.Tensor, axis: int,
               tile: int = 0) -> torch.Tensor:
    """The kernel's walk in torch: the direct path element by element
    (``tile`` 0), or the staged path CTA by CTA with ``tile`` rows (axis 1)
    or columns (axis 0) a CTA, each CTA copying its tile of src and then
    gathering from the copy at tile-local positions; an index outside src
    reads 0, as in the kernel."""
    s0, s1 = src.shape
    g = idx.long()
    out = torch.zeros(idx.shape, dtype=src.dtype, device=src.device)
    if tile == 0:
        inside = (g >= 0) & (g < src.shape[axis])
        safe = torch.where(inside, g, 0)
        return torch.where(inside, torch.take_along_dim(src, safe, dim=axis),
                           out)
    for lo in range(0, s0 if axis == 1 else s1, tile):
        if axis == 1:
            part = src[lo:lo + tile].clone()
            gt = g[lo:lo + tile]
            inside = (gt >= 0) & (gt < s1)
            got = torch.take_along_dim(part, torch.where(inside, gt, 0), 1)
            out[lo:lo + tile] = torch.where(inside, got, 0.0)
        else:
            part = src[:, lo:lo + tile].clone()
            gt = g[:, lo:lo + tile]
            inside = (gt >= 0) & (gt < s0)
            got = torch.take_along_dim(part, torch.where(inside, gt, 0), 0)
            out[:, lo:lo + tile] = torch.where(inside, got, 0.0)
    return out
