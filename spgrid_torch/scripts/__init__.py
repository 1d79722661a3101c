"""The port's probe drivers, named after their counterparts in the repo's
``scripts/``:

    python -m spgrid_torch.scripts.exp_spmv_ablate [m avg bw]
    python -m spgrid_torch.scripts.exp_pallas_gather [xla] [dma] [shuffle]
    python -m spgrid_torch.scripts.exp_lanegather
    python -m spgrid_torch.scripts.exp_wpack_ablate [m avg bw]

and the drivers of the SDDMM study and the dtype legs (``sddmm_study``,
``run_bf16_leg``, ``run_f64_sweep``), whose docstrings give their output.
Each probe driver runs its CUDA kernels on the card at the JAX script's default sizes;
``--platform cpu`` runs the kernels' plain versions on the CPU instead.
Without a CUDA device and without that flag each exits non-zero, as
``python -m spgrid_torch.bench`` does. Times come from
``core.timing.time_kernel`` (CUDA events on the card), run ``REPEATS``
times: a driver prints the median and the spread (largest less smallest
over the median). On the card each repeat times at least
``MIN_TIME_S`` seconds of replays of ``GRAPH_CALLS`` calls captured in one
CUDA graph, so a time is the device's alone: the host's cost to enqueue an
eager call exceeds the run time of the shorter probes' kernels. On the CPU
the times only show that the path runs: each repeat is a few calls.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from typing import Callable, Optional, Tuple

import torch

from spgrid_torch.core.timing import cuda_graph, time_kernel

REPEATS = 3
MIN_TIME_S = 0.3        # each repeat's timed seconds on the card, as the
                        # JAX scripts
GRAPH_CALLS = 20


def parser(prog: str, description: str) -> argparse.ArgumentParser:
    """An argument parser with the drivers' shared ``--platform``."""
    ap = argparse.ArgumentParser(prog=prog, description=description)
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default), or cpu for the kernels' plain "
                         "versions")
    return ap


def device_of(prog: str, platform: str) -> Optional[torch.device]:
    """The device to run on, or None (with a message) when the card is asked
    for and there is none."""
    if platform == "cuda" and not torch.cuda.is_available():
        print(f"{prog}: no CUDA device; pass --platform cpu to run the plain "
              f"versions on the CPU", file=sys.stderr)
        return None
    return torch.device(platform)


def timed(fn: Callable, *args,
          device: torch.device) -> Tuple[float, float]:
    """(median seconds a call, spread) over ``REPEATS`` runs of
    ``time_kernel``; on the card, of replays of ``GRAPH_CALLS`` calls."""
    call, per, min_time_s = (lambda: fn(*args)), 1, 0.0
    if torch.device(device).type == "cuda":
        call, per = cuda_graph(call, GRAPH_CALLS).replay, GRAPH_CALLS
        min_time_s = MIN_TIME_S
    times = sorted(
        time_kernel(call, device=device, warmup_iters=2,
                    min_time_s=min_time_s, min_iters=4).time_per_iter_s / per
        for _ in range(REPEATS))
    median = times[len(times) // 2]
    return median, (times[-1] - times[0]) / median


def sm_clock_mhz() -> Optional[float]:
    """The card's SM clock now, from nvidia-smi; None where it cannot be
    read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
