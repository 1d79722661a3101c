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

from spgrid_torch.core.config import own_precision


def _wrappers() -> dict:
    """Each kernel's wrapper, which carries its launch count, by name."""
    from spgrid_torch.ops.kernels import (
        bsr_spmm, bsr_spmm_cstat, dgell, lanegather, pallas_gather,
        panel_spmm, sddmm, spmv_ablate, wcoo_spmm, wcoo_spmm_aligned,
        wcoo_spmv, wpack_spmv, wrow_spmv,
    )
    return {"bsr_spmm": bsr_spmm.bsr_spmm,
            "bsr_spmm_bf16": bsr_spmm.bsr_spmm_bf16,
            "bsr_spmm_bf16x3": bsr_spmm.bsr_spmm_bf16x3,
            "panel_spmm": panel_spmm.panel_spmm,
            "panel_spmm_bf16": panel_spmm.panel_spmm_bf16,
            "panel_spmm_bf16_xy": panel_spmm.panel_spmm_bf16_xy,
            "panel_spmm_bf16x3": panel_spmm.panel_spmm_bf16x3,
            "bsr_sddmm": sddmm.bsr_sddmm,
            "bsr_sddmm_bf16": sddmm.bsr_sddmm_bf16,
            "bsr_sddmm_bf16x3": sddmm.bsr_sddmm_bf16x3,
            "wcoo_spmm": wcoo_spmm.wcoo_spmm,
            "wcoo_spmm_bf16": wcoo_spmm.wcoo_spmm_bf16,
            "wcoo_spmm_aligned": wcoo_spmm_aligned.wcoo_spmm_aligned,
            "wcoo_spmm_aligned_bf16":
                wcoo_spmm_aligned.wcoo_spmm_aligned_bf16,
            "wcoo_spmv": wcoo_spmv.wcoo_spmv,
            "wcoo_spmv_bf16": wcoo_spmv.wcoo_spmv_bf16,
            "wrow_spmv": wrow_spmv.wrow_spmv,
            "wrow_spmv_bf16": wrow_spmv.wrow_spmv_bf16,
            "bsr_spmm_cstat": bsr_spmm_cstat.bsr_spmm_cstat,
            "bsr_spmm_cstat_bf16": bsr_spmm_cstat.bsr_spmm_cstat_bf16,
            "bsr_spmm_cstat_bf16x3": bsr_spmm_cstat.bsr_spmm_cstat_bf16x3,
            "dgell": dgell.dgell_spmm,
            "dgell_bf16": dgell.dgell_spmm_bf16,
            "wpack_spmv": wpack_spmv.wpack_spmv,
            "wpack_spmv_bf16": wpack_spmv.wpack_spmv_bf16,
            "wpack_spmv_bf16_prefix": wpack_spmv.wpack_spmv_bf16_prefix,
            "wrow_spmv_v2": wrow_spmv.wrow_spmv_v2,
            "wrow_spmv_v2_bf16": wrow_spmv.wrow_spmv_v2_bf16,
            "lanegather": lanegather.lanegather,
            "dma_gather": pallas_gather.dma_gather,
            "shuffle_bench": pallas_gather.shuffle_bench,
            "spmv_ablate": spmv_ablate.spmv_ablate,
            "wpack_ablate": wpack_spmv.wpack_ablate}


def launch_counts() -> dict:
    """Launches of each kernel since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    """Every wrapper's count to 0, with its counts of the kernels a call
    may start (``bsr_spmm_bf16.tile_launches``, ``.entry_launches``)."""
    for fn in _wrappers().values():
        for name in list(vars(fn)):
            if name.endswith("launches"):
                setattr(fn, name, 0)


# the operand types of the kernels that have a bf16 form beside the f32 one
FORMS = (torch.float32, torch.bfloat16)
# the forms at a precision other than the operand type's own: the 3-pass
# bf16 forms of f32 operands at matmul precision 'high' (3c, 1c, 2c, 4c)
OTHER_PRECISIONS = ((torch.float32, "high"),)


def check_form(kernel: str, dtype: torch.dtype, forms=FORMS,
               precision=None, other_precisions=()) -> None:
    """Raise unless the kernel has a form for operands of ``dtype`` (one of
    ``forms``) at matmul ``precision`` (None: the type's own; the kernel's
    forms at other precisions are ``other_precisions``, (type, precision)
    pairs): no kernel computes in another type or at another precision and
    calls the result that. A form computes at its type's own precision
    (``core.config.own_precision``)."""
    name = str(dtype).replace("torch.", "")
    if dtype not in forms:
        names = ", ".join(str(f).replace("torch.", "") for f in forms)
        raise TypeError(f"{kernel}: no {name} form (it has {names}; "
                        f"ROADMAP.md lists the forms still to port)")
    if (precision is not None and precision != own_precision(name)
            and (dtype, precision) not in other_precisions):
        raise ValueError(f"{kernel}: no form at matmul precision "
                         f"{precision!r} for {name} operands (ROADMAP.md "
                         f"lists the forms still to port)")


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
