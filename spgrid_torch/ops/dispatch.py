"""Format names of the port: build the device operand, pick the SpMM
function.

``JAX_NAME`` maps each format to its counterpart in ``spgrid.ops.dispatch``.
The two SpMV formats take a (k, 1) operand and return (m, 1), as the JAX
package's bench adapters do; a wider operand raises.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from spgrid_torch.formats.csr import CSRMatrix
from spgrid_torch.ops.dense import spmm_dense
from spgrid_torch.ops.kernels.bsr_spmm import bsr_spmm
from spgrid_torch.ops.kernels.panel_spmm import DevicePanels, panel_spmm
from spgrid_torch.ops.kernels.wcoo_spmm import DeviceWCOO, wcoo_spmm
from spgrid_torch.ops.kernels.wcoo_spmm_aligned import (
    DeviceWCOOBands, wcoo_spmm_aligned,
)
from spgrid_torch.ops.kernels.wcoo_spmv import DeviceWCOOAligned, wcoo_spmv
from spgrid_torch.ops.kernels.wrow_spmv import DeviceWROW, wrow_spmv
from spgrid_torch.ops.layouts import DeviceBSR

JAX_NAME = {"dense": "dense", "bsr_cuda": "bsr_pallas",
            "panel_cuda": "panel_pallas", "wcoo_cuda": "wcoo_pallas",
            "wcoo_bands_cuda": "wcoo_bands", "wcoo_spmv_cuda": "wcoo_spmv",
            "wrow_spmv_cuda": "wrow_spmv"}
FORMATS = tuple(JAX_NAME)


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
    layout = {"wcoo_cuda": DeviceWCOO, "wcoo_bands_cuda": DeviceWCOOBands,
              "wcoo_spmv_cuda": DeviceWCOOAligned,
              "wrow_spmv_cuda": DeviceWROW}.get(fmt)
    if layout is None:
        raise ValueError(f"unknown format {fmt!r}; the port has {FORMATS}")
    return layout.from_csr(csr, device=device)


def _spmv_2d(spmv: Callable, name: str) -> Callable:
    """Bench adapter: an SpMV kernel on a (k, 1) dense operand."""

    def spmm(a, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 2 or x.shape[1] != 1:
            raise ValueError(f"{name} is an SpMV kernel (n must be 1); got "
                             f"x of shape {tuple(x.shape)}")
        return spmv(a, x[:, 0].contiguous())[:, None]

    return spmm


_SPMM = {"dense": spmm_dense, "bsr_cuda": bsr_spmm,
         "panel_cuda": panel_spmm, "wcoo_cuda": wcoo_spmm,
         "wcoo_bands_cuda": wcoo_spmm_aligned,
         "wcoo_spmv_cuda": _spmv_2d(wcoo_spmv, "wcoo_spmv_cuda"),
         "wrow_spmv_cuda": _spmv_2d(wrow_spmv, "wrow_spmv_cuda")}


def spmm_fn(fmt: str) -> Callable:
    if fmt not in FORMATS:
        raise ValueError(f"unknown format {fmt!r}; the port has {FORMATS}")
    return _SPMM[fmt]
