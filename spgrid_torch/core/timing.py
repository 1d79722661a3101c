"""Timing protocol: warm-up, then a timed loop until a minimum time and a
minimum number of launches are both reached.

On a CUDA device the loop is bracketed by CUDA events on the current stream,
so the time is the device's; on the CPU (where the port's tests run) it is
the host clock. The call enqueues work eagerly, so the time per launch is
the larger of the kernel's run time and the host's cost to enqueue it.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class TimedResult:
    time_per_iter_s: float
    iters: int
    total_time_s: float
    flops: Optional[float] = None       # per-iteration flop count, if known
    bytes_accessed: Optional[float] = None

    @property
    def gflops(self) -> Optional[float]:
        if self.flops is None:
            return None
        return self.flops / self.time_per_iter_s / 1e9

    @property
    def gbytes_per_s(self) -> Optional[float]:
        if self.bytes_accessed is None:
            return None
        return self.bytes_accessed / self.time_per_iter_s / 1e9


def _run_batch(fn: Callable, args: tuple, iters: int,
               device: torch.device) -> float:
    """Seconds that ``iters`` calls of ``fn(*args)`` take on ``device``."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    if device.type == "cpu":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return time.perf_counter() - t0
    raise ValueError(f"no timer for device {device}")


def time_kernel(fn: Callable, *args, device, warmup_iters: int = 10,
                min_time_s: float = 0.5, min_iters: int = 32,
                flops: Optional[float] = None,
                bytes_accessed: Optional[float] = None) -> TimedResult:
    """Time ``fn(*args)`` on ``device`` ('cuda' or 'cpu').

    Runs ``warmup_iters`` calls, then timed batches until at least
    ``min_time_s`` seconds and ``min_iters`` calls are measured; the result
    is the measured time over the measured calls."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if warmup_iters > 0:
        _run_batch(fn, args, warmup_iters, device)
    batch = max(min_iters, 1)
    total, iters = 0.0, 0
    while True:
        total += _run_batch(fn, args, batch, device)
        iters += batch
        if total >= min_time_s and iters >= min_iters:
            break
        per = max(total / iters, 1e-9)
        batch = min(max(math.ceil((min_time_s - total) / per),
                        min_iters - iters, 1), 1 << 16)
    return TimedResult(time_per_iter_s=total / iters, iters=iters,
                       total_time_s=total, flops=flops,
                       bytes_accessed=bytes_accessed)
