"""The port's hand-written CUDA kernels (sources in ``spgrid_torch/csrc``).

Each module holds a kernel's wrapper, its plain PyTorch version and a launch
count. A wrapper launches its kernel for CUDA tensors and takes the plain
version only for CPU tensors. The count is of the wrapper's launches: one for
each call that runs the kernel on the card, however many CUDA kernels the
call starts (a stream walk and its carry combine, a row walk and its
long-row walk).
"""

from __future__ import annotations

import torch

def _wrappers() -> dict:
    """Each kernel's wrapper, which carries its launch count, by name."""
    from spgrid_torch.ops.kernels import (
        bsr_spmm, bsr_spmm_cstat, dgell, lanegather, pallas_gather,
        panel_spmm, sddmm, spmv_ablate, wcoo_spmm, wcoo_spmm_aligned,
        wcoo_spmv, wpack_spmv, wrow_spmv,
    )
    return {"bsr_spmm": bsr_spmm.bsr_spmm,
            "bsr_spmm_bf16": bsr_spmm.bsr_spmm_bf16,
            "panel_spmm": panel_spmm.panel_spmm,
            "panel_spmm_bf16": panel_spmm.panel_spmm_bf16,
            "panel_spmm_bf16_xy": panel_spmm.panel_spmm_bf16_xy,
            "bsr_sddmm": sddmm.bsr_sddmm,
            "bsr_sddmm_bf16": sddmm.bsr_sddmm_bf16,
            "wcoo_spmm": wcoo_spmm.wcoo_spmm,
            "wcoo_spmm_aligned": wcoo_spmm_aligned.wcoo_spmm_aligned,
            "wcoo_spmm_aligned_bf16":
                wcoo_spmm_aligned.wcoo_spmm_aligned_bf16,
            "wcoo_spmv": wcoo_spmv.wcoo_spmv,
            "wrow_spmv": wrow_spmv.wrow_spmv,
            "bsr_spmm_cstat": bsr_spmm_cstat.bsr_spmm_cstat,
            "dgell": dgell.dgell_spmm,
            "wpack_spmv": wpack_spmv.wpack_spmv,
            "wrow_spmv_v2": wrow_spmv.wrow_spmv_v2,
            "lanegather": lanegather.lanegather,
            "dma_gather": pallas_gather.dma_gather,
            "shuffle_bench": pallas_gather.shuffle_bench,
            "spmv_ablate": spmv_ablate.spmv_ablate,
            "wpack_ablate": wpack_spmv.wpack_ablate}


def launch_counts() -> dict:
    """Launches of each kernel since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


# the operand types of the kernels that have a bf16 form beside the f32 one
FORMS = (torch.float32, torch.bfloat16)


def check_form(kernel: str, dtype: torch.dtype, forms=FORMS) -> None:
    """Raise unless the kernel has a form for operands of ``dtype`` (one of
    ``forms``): no kernel computes in another type and calls the result
    ``dtype``."""
    if dtype not in forms:
        names = ", ".join(str(f).replace("torch.", "") for f in forms)
        raise TypeError(f"{kernel}: no {str(dtype).replace('torch.', '')} "
                        f"form (it has {names}; ROADMAP.md lists the forms "
                        f"still to port)")


def runs_plain(kernel: str, device: torch.device) -> bool:
    """True for operands on the CPU, whose call takes the kernel's plain
    version; False on the card, whose call launches the kernel; any other
    device raises."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: no kernel for device {device}")
    return device.type == "cpu"


def check_operands(kernel: str, device: torch.device, **tensors) -> None:
    """Raise unless every tensor, given as ``name=(tensor, dtype)``, has that
    dtype, lies on ``device`` (the first operand's) and is contiguous: what
    the kernels take."""
    for name, (t, dtype) in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{kernel}: {name} on {t.device}, operands on "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
