"""The headline row on the card: one JSON line.

    python -m spgrid_torch.bench.headline

Runs ``bench.py``'s matrix and configuration — the 512 x 512 DLMC twin
(~39 % dense), f32 SpMM at n = 512, ``min_time_s=1.0``, ``warmup_iters=5``
— through ``dense``, ``panel_cuda`` and ``bsr_cuda`` on the CUDA device,
gates each against the host f64 oracle (eps 1e-4), and prints the best
passing row as ``spmm_dlmc_n512_f32_gflops``. ``vs_baseline`` divides by
251.0 GFLOPS, the reference's MKL CSR row on a 24-thread AMD EPYC
(BASELINE.md). Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import json
import sys

import torch

from spgrid.formats.csr import CSRMatrix
from spgrid.gen import artificial_matrix_generation
from spgrid_torch.bench.harness import run_spmm
from spgrid_torch.core.config import BenchConfig

METRIC = "spmm_dlmc_n512_f32_gflops"
BASELINE_GFLOPS = 251.0
KERNELS = ("dense", "panel_cuda", "bsr_cuda")


def headline_matrix() -> CSRMatrix:
    return artificial_matrix_generation(
        512, 512, 256, 32, "normal", seed=14, placement="random", bw=1.0,
        name="dlmc_twin_512_0.5")


def headline_config() -> BenchConfig:
    return BenchConfig(num_cols=512, dtype="float32", min_time_s=1.0,
                       warmup_iters=5)


def run_headline(device) -> list:
    """One row per kernel of ``KERNELS``."""
    csr, config = headline_matrix(), headline_config()
    return [run_spmm(csr, kernel, config, device=device) for kernel in KERNELS]


def headline_line(rows: list, device_name: str) -> dict:
    """The headline JSON object from the best row that passed its gate."""
    passed = [r for r in rows if r["errors_passed"]]
    if not passed:
        raise RuntimeError("no kernel passed the accuracy gate")
    best = max(passed, key=lambda r: r["gflops"])
    return {"metric": METRIC, "value": best["gflops"], "unit": "GFLOPS",
            "vs_baseline": best["gflops"] / BASELINE_GFLOPS,
            "kernel": best["kernel"], "device": device_name}


def main() -> int:
    if not torch.cuda.is_available():
        print("spgrid_torch.bench.headline: no CUDA device", file=sys.stderr)
        return 1
    rows = run_headline("cuda")
    print(json.dumps(headline_line(rows, torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
