"""Gather along one axis of a 2-D f32 array: ``take_along_axis``.

Counterpart of the Pallas probe ``scripts/exp_lanegather.py``
(``try_compile`` and the gather kernels it compiles); the CUDA kernel is
``spgrid_torch/csrc/lanegather.cu``. ``lanegather`` launches it for CUDA
tensors and takes ``lanegather_plain`` only for CPU tensors.

``lanegather(src, idx, 1)[i, j] = src[i, idx[i, j]]`` (idx has src's rows)
and ``lanegather(src, idx, 0)[i, j] = src[idx[i, j], j]`` (idx has src's
columns); the output has idx's shape. Indices must lie inside src along the
axis: the plain version raises on one that does not, the kernel reads 0.
"""

from __future__ import annotations

import torch

from spgrid_torch.ops.kernels import _build, check_operands


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
    and int32 idx, both 2-D."""
    _check(src, idx, axis)
    if src.device.type == "cpu":
        return lanegather_plain(src, idx, axis)
    out = torch.empty(idx.shape, dtype=torch.float32, device=src.device)
    lib = _build.library()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.spgrid_lanegather(
            src.data_ptr(), idx.data_ptr(), out.data_ptr(), src.shape[0],
            src.shape[1], idx.shape[0], idx.shape[1], axis, stream)
    _build.check(code, "lanegather")
    lanegather.launches += 1
    return out


lanegather.launches = 0


def lanegather_plain(src: torch.Tensor, idx: torch.Tensor,
                     axis: int) -> torch.Tensor:
    """The same gather in plain torch (``torch.take_along_dim``), in src's
    dtype."""
    return torch.take_along_dim(src, idx.long(), dim=axis)
