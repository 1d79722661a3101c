"""Format names of the port: build the device operand, pick the SpMM
function.

``JAX_NAME`` maps each format to its counterpart in ``spgrid.ops.dispatch``.
The three SpMV formats take a (k, 1) operand and return (m, 1), as the JAX
package's bench adapters do; a wider operand raises. ``coo``, ``sell``,
``merge`` and the GELL formats are torch ops (the JAX package's XLA
compositions); the ``_cuda`` formats and ``dense``'s matmul run on kernels.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from spgrid_torch.formats.csr import CSRMatrix
from spgrid_torch.ops.dense import spmm_dense
from spgrid_torch.ops.gell import DeviceGELL, gell_spmm
from spgrid_torch.ops.kernels.bsr_spmm import bsr_spmm
from spgrid_torch.ops.kernels.bsr_spmm_cstat import (
    DeviceBSRCol, bsr_spmm_cstat,
)
from spgrid_torch.ops.kernels.dgell import DeviceDGELL, dgell_spmm
from spgrid_torch.ops.kernels.panel_spmm import DevicePanels, panel_spmm
from spgrid_torch.ops.kernels.wcoo_spmm import DeviceWCOO, wcoo_spmm
from spgrid_torch.ops.kernels.wcoo_spmm_aligned import (
    DeviceWCOOBands, wcoo_spmm_aligned,
)
from spgrid_torch.ops.kernels.wcoo_spmv import DeviceWCOOAligned, wcoo_spmv
from spgrid_torch.ops.kernels.wpack_spmv import DeviceWPACK, wpack_spmv
from spgrid_torch.ops.kernels.wrow_spmv import DeviceWROW, wrow_spmv
from spgrid_torch.ops.layouts import DeviceBSR, DeviceCOO, DeviceSELL
from spgrid_torch.ops.merge import DeviceMerge, merge_spmm
from spgrid_torch.ops.xla import spmm_coo, spmm_sell

JAX_NAME = {"dense": "dense", "bsr_cuda": "bsr_pallas",
            "panel_cuda": "panel_pallas", "wcoo_cuda": "wcoo_pallas",
            "wcoo_bands_cuda": "wcoo_bands", "wcoo_spmv_cuda": "wcoo_spmv",
            "wrow_spmv_cuda": "wrow_spmv", "bsrc_cuda": "bsrc_pallas",
            "dgell_cuda": "dgell", "wpack_spmv_cuda": "wpack_spmv",
            "coo": "coo", "sell": "sell", "merge": "merge", "gell": "gell",
            "gell16": "gell16", "cv_gell": "cv_gell"}
FORMATS = tuple(JAX_NAME)
# the GELL formats' modes (spgrid_torch/ops/gell.py)
GELL_MODE = {"gell": "f32", "gell16": "split16", "cv_gell": "bf16"}


def build(csr: CSRMatrix, fmt: str, *, device, bm: Optional[int] = None,
          bk: int = 128):
    """The device operand of ``csr`` for format ``fmt``; bm defaults to 128
    for the block kernels, as ``spgrid.ops.dispatch.build`` does for
    ``bsr_pallas`` and ``bsrc_pallas``."""
    if fmt == "dense":
        return torch.from_numpy(csr.to_dense()).to(device)
    if fmt == "bsr_cuda":
        return DeviceBSR.from_csr(csr, bm=bm or 128, bk=bk, device=device)
    if fmt == "bsrc_cuda":
        return DeviceBSRCol.from_csr(csr, bm=bm or 128, bk=bk, device=device)
    if fmt == "panel_cuda":
        return DevicePanels.from_csr(csr, bk=bk, device=device)
    if fmt in GELL_MODE:
        return DeviceGELL.from_csr(csr, mode=GELL_MODE[fmt], device=device)
    layout = {"wcoo_cuda": DeviceWCOO, "wcoo_bands_cuda": DeviceWCOOBands,
              "wcoo_spmv_cuda": DeviceWCOOAligned,
              "wrow_spmv_cuda": DeviceWROW, "dgell_cuda": DeviceDGELL,
              "wpack_spmv_cuda": DeviceWPACK, "coo": DeviceCOO,
              "sell": DeviceSELL, "merge": DeviceMerge}.get(fmt)
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
         "wrow_spmv_cuda": _spmv_2d(wrow_spmv, "wrow_spmv_cuda"),
         "bsrc_cuda": bsr_spmm_cstat, "dgell_cuda": dgell_spmm,
         "wpack_spmv_cuda": _spmv_2d(wpack_spmv, "wpack_spmv_cuda"),
         "coo": spmm_coo, "sell": spmm_sell, "merge": merge_spmm,
         "gell": gell_spmm, "gell16": gell_spmm, "cv_gell": gell_spmm}


def spmm_fn(fmt: str) -> Callable:
    if fmt not in FORMATS:
        raise ValueError(f"unknown format {fmt!r}; the port has {FORMATS}")
    return _SPMM[fmt]
