"""Format names of the port's first slice: build the device operand, pick the
SpMM function.

``JAX_NAME`` maps each format to its counterpart in ``spgrid.ops.dispatch``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from spgrid.formats.csr import CSRMatrix
from spgrid_torch.ops.dense import spmm_dense
from spgrid_torch.ops.kernels.bsr_spmm import bsr_spmm
from spgrid_torch.ops.kernels.panel_spmm import DevicePanels, panel_spmm
from spgrid_torch.ops.layouts import DeviceBSR

FORMATS = ("dense", "bsr_cuda", "panel_cuda")
JAX_NAME = {"dense": "dense", "bsr_cuda": "bsr_pallas",
            "panel_cuda": "panel_pallas"}


def build(csr: CSRMatrix, fmt: str, *, device, bm: Optional[int] = None,
          bk: int = 128):
    """The device operand of ``csr`` for format ``fmt``; bm defaults to 128
    for the BSR kernel, as ``spgrid.ops.dispatch.build`` does for
    ``bsr_pallas``."""
    if fmt == "dense":
        return torch.from_numpy(csr.to_dense()).to(device)
    if fmt == "bsr_cuda":
        return DeviceBSR.from_csr(csr, bm=bm or 128, bk=bk, device=device)
    if fmt == "panel_cuda":
        return DevicePanels.from_csr(csr, bk=bk, device=device)
    raise ValueError(f"unknown format {fmt!r}; the port has {FORMATS}")


def spmm_fn(fmt: str) -> Callable:
    if fmt not in FORMATS:
        raise ValueError(f"unknown format {fmt!r}; the port has {FORMATS}")
    return {"dense": spmm_dense, "bsr_cuda": bsr_spmm,
            "panel_cuda": panel_spmm}[fmt]
