"""The port's hand-written CUDA kernels (sources in ``spgrid_torch/csrc``).

Each module holds a kernel's wrapper, its plain PyTorch version and a launch
count. A wrapper launches its kernel for CUDA tensors and takes the plain
version only for CPU tensors.
"""

from __future__ import annotations


def launch_counts() -> dict:
    """Launches of each kernel since the last reset, by kernel name."""
    from spgrid_torch.ops.kernels import bsr_spmm, panel_spmm, sddmm
    return {"bsr_spmm": bsr_spmm.bsr_spmm.launches,
            "panel_spmm": panel_spmm.panel_spmm.launches,
            "bsr_sddmm": sddmm.bsr_sddmm.launches}


def reset_launch_counts() -> None:
    from spgrid_torch.ops.kernels import bsr_spmm, panel_spmm, sddmm
    bsr_spmm.bsr_spmm.launches = 0
    panel_spmm.panel_spmm.launches = 0
    sddmm.bsr_sddmm.launches = 0
