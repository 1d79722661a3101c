"""Roofline model of the H100 and the reference flop and byte models.

The flop and byte formulas are those of ``spgrid/core/roofline.py``; the chip
constants are NVIDIA's H100 data sheet (dense rates, no structured
sparsity). A card may run below its data-sheet power limit, and then below
these peaks: results carry the card's name and power limit beside them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbytes_per_s: float       # device-memory bandwidth
    peak_bf16_tflops: float       # tensor cores, bf16 in / f32 accumulate
    peak_f32_tflops: float        # CUDA cores, f32 FMA (no tensor cores)
    peak_tf32_tflops: float = 0.0  # tensor cores, TF32 in (0: none)
    peak_f64_tflops: float = 0.0  # tensor cores, f64 (0: none)
    l2_mbytes: float = 50.0
    hbm_gbytes: float = 80.0


H100_SXM = ChipSpec(
    name="h100_sxm", hbm_gbytes_per_s=3350.0, peak_bf16_tflops=989.0,
    peak_f32_tflops=67.0, peak_tf32_tflops=495.0, peak_f64_tflops=67.0,
    l2_mbytes=50.0, hbm_gbytes=80.0,
)
H100_PCIE = ChipSpec(
    name="h100_pcie", hbm_gbytes_per_s=2000.0, peak_bf16_tflops=756.0,
    peak_f32_tflops=51.0, peak_tf32_tflops=378.0, peak_f64_tflops=51.0,
    l2_mbytes=50.0, hbm_gbytes=80.0,
)


def chip_for_name(device_name: str) -> Optional[ChipSpec]:
    """The spec of a card from ``torch.cuda.get_device_name()``, or None for
    a card this table does not hold."""
    name = device_name.lower()
    if "h100" not in name:
        return None
    return H100_PCIE if "pcie" in name else H100_SXM


def roofline_time(flops: float, bytes_accessed: float, chip: ChipSpec,
                  dtype: str = "float32") -> float:
    """Speed-of-light time (s): max of compute-bound and memory-bound time.
    bf16 work goes at the tensor cores' bf16 rate, f64 work at their f64
    rate (the data sheet's FP64 tensor-core figure), f32 work at the card's
    fastest f32-accurate rate: the CUDA cores' FMA or 3xTF32 on the tensor
    cores (three TF32 products a flop), the larger."""
    if dtype == "bfloat16":
        peak = chip.peak_bf16_tflops
    elif dtype == "float64":
        peak = chip.peak_f64_tflops
    else:
        peak = max(chip.peak_f32_tflops, chip.peak_tf32_tflops / 3)
    t_compute = flops / (peak * 1e12) if flops else 0.0
    t_memory = bytes_accessed / (chip.hbm_gbytes_per_s * 1e9) if bytes_accessed else 0.0
    return max(t_compute, t_memory)


def spmm_flops(nnz: int, n: int) -> float:
    """2*nnz*n — the reference flop model for all sparse ops, counted on the
    original CSR nnz regardless of format."""
    return 2.0 * nnz * max(n, 1)


def gemm_flops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def csr_bytes(nnz: int, m: int, n: int, k_cols: int, val_bytes: int = 4,
              idx_bytes: int = 4) -> float:
    """Minimum device-memory traffic for CSR SpMM: the matrix footprint
    ``nnz*(val+idx) + (m+1)*idx`` plus one read of x(k, n) and one write of
    y(m, n)."""
    mat = nnz * (val_bytes + idx_bytes) + (m + 1) * idx_bytes
    dense = (k_cols + m) * max(n, 1) * val_bytes if n else 0
    return float(mat + dense)
