"""Two gather probes: rows of x gathered by asynchronous per-row copies
(``dma_gather``) and a chain of dependent in-row gathers
(``shuffle_bench``).

Counterparts of the Pallas probes ``dma_gather`` and ``shuffle_bench`` of
``scripts/exp_pallas_gather.py``; both CUDA kernels are in
``spgrid_torch/csrc/pallas_gather.cu``. Each wrapper launches its kernel
for CUDA tensors and takes its plain version only for CPU tensors.
Indices must lie inside x (``dma_gather``) or the row (``shuffle_bench``):
the plain versions raise on one that does not, the kernels read 0.
"""

from __future__ import annotations

import torch

from spgrid_torch.ops.kernels import _build, check_operands

LANE = 128
# a row must fit one stage of the kernel's shared memory, two stages a CTA
MAX_N = 16384


def _device(kernel: str, t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: no kernel for device {t.device}")


def dma_gather(x: torch.Tensor, idx2: torch.Tensor, G: int) -> torch.Tensor:
    """out (steps · G, n) f32 = x[idx2.reshape(-1)] for f32 x (k, n) and
    int32 idx2 (steps, G): G rows a step, as the JAX probe's grid takes
    them (steps include any pad rows of idx2)."""
    if x.dim() != 2 or idx2.dim() != 2:
        raise ValueError(f"dma_gather: x and idx2 must be 2-D, got "
                         f"{tuple(x.shape)} and {tuple(idx2.shape)}")
    if G < 1 or idx2.shape[1] != G:
        raise ValueError(f"dma_gather: idx2 must be (steps, G={G}), got "
                         f"{tuple(idx2.shape)}")
    k, n = x.shape
    if not 1 <= n <= MAX_N or k < 1:
        raise ValueError(f"dma_gather: x must be (k >= 1, 1 <= n <= {MAX_N}),"
                         f" got {tuple(x.shape)}")
    check_operands("dma_gather", x.device, x=(x, torch.float32),
                   idx2=(idx2, torch.int32))
    _device("dma_gather", x)
    if x.device.type == "cpu":
        return dma_gather_plain(x, idx2)
    steps = idx2.shape[0]
    out = torch.empty((steps * G, n), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.spgrid_dma_gather(x.data_ptr(), idx2.data_ptr(),
                                     out.data_ptr(), k, n, steps, G, stream)
    _build.check(code, "dma_gather")
    dma_gather.launches += 1
    return out


dma_gather.launches = 0


def dma_gather_plain(x: torch.Tensor, idx2: torch.Tensor) -> torch.Tensor:
    """The same rows in plain torch (``index_select``), in x's dtype."""
    return x.index_select(0, idx2.reshape(-1))


def shuffle_bench(src: torch.Tensor, idx: torch.Tensor,
                  reps: int) -> torch.Tensor:
    """acc (rows, 128) f32 after ``reps`` steps of acc =
    take_along_axis(acc, idx, 1) + 1.0 from acc = src, all steps in one
    launch; src f32 and idx int32, both (rows, 128)."""
    if src.dim() != 2 or src.shape[1] != LANE or idx.shape != src.shape:
        raise ValueError(f"shuffle_bench: src and idx must both be (rows, "
                         f"{LANE}), got {tuple(src.shape)} and "
                         f"{tuple(idx.shape)}")
    if reps < 0:
        raise ValueError(f"shuffle_bench: reps must be >= 0, got {reps}")
    check_operands("shuffle_bench", src.device, src=(src, torch.float32),
                   idx=(idx, torch.int32))
    _device("shuffle_bench", src)
    if src.device.type == "cpu":
        return shuffle_bench_plain(src, idx, reps)
    out = torch.empty_like(src)
    lib = _build.library()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.spgrid_shuffle_bench(src.data_ptr(), idx.data_ptr(),
                                        out.data_ptr(), src.shape[0], reps,
                                        stream)
    _build.check(code, "shuffle_bench")
    shuffle_bench.launches += 1
    return out


shuffle_bench.launches = 0


def shuffle_bench_plain(src: torch.Tensor, idx: torch.Tensor,
                        reps: int) -> torch.Tensor:
    """The same chain in plain torch, one ``take_along_dim`` a step, in
    src's dtype."""
    acc, ix = src.clone(), idx.long()
    for _ in range(reps):
        acc = torch.take_along_dim(acc, ix, dim=1) + 1.0
    return acc
