"""Format names of the port: build the device operand, pick the SpMM
function, and pick the format (``select_format``, the cost model's choice;
``autotune_spmm``, the fastest measured) — the counterpart of
``spgrid/ops/dispatch.py``.

``JAX_NAME`` maps each format to its counterpart in ``spgrid.ops.dispatch``,
the name the cost model and a row's ``fmt`` column speak; ``PORT_NAME`` maps
back.
The three SpMV formats take a (k, 1) operand and return (m, 1), as the JAX
package's bench adapters do; a wider operand raises. ``coo``, ``sell``,
``bsr``, ``merge``, ``ell``, ``csc``, ``ldu``, ``cv_bf16``, ``cv_int8``,
``scoo`` and the GELL formats are torch ops (the JAX package's XLA
compositions; ``bsr`` is the batched block product of ``xla.spmm_bsr``, not
an AUTO candidate); the ``_cuda`` formats and ``dense``'s matmul run on
kernels (``cv_panel_cuda`` on the bf16 form of the panel kernel); ``rbh``
runs ``bsr_spmm`` on its block part and a torch-op format on the rest.

Every format runs at f32. At bf16 and f64 a format runs only where it has a
form at that dtype (``DTYPE_FORMATS``): at bf16 every format (the torch
ops, ``dense``, every kernel's bf16 form, and ``rbh``, whose block part
runs ``bsr_spmm``'s); at f64 ``dense`` and the torch ops
that sum in f64 (not those that sum in f32 whatever X's type,
``F32_SUM_FORMATS``, nor any kernel: no format computes in f32 and calls
the result f64). ``build``
raises for any other, naming ROADMAP.md, and ``select_format`` and
``autotune_spmm`` pick only among those that run.

Matmul precision (``runs_at``'s ``precision``): at its dtype's own every
such format runs. At f32 'high' every format runs: those whose JAX dot
takes the ambient precision (``AMBIENT_FORMATS``) on their 3-pass form
(``spmm_fn(fmt, "high")``: the kernels' ``*_bf16x3`` forms, the torch ops'
``dense.at_high``), the rest as they are, since they contract through no
such dot (wcoo pins HIGHEST, cv_panel 'default', GELL multiplies bf16
planes, the others sum elementwise products) and compute the same at every
precision. At f32 'default' only the rest run (and the harness refuses
the dispatch kernels there: JAX's ``auto`` chooses among every format); at
bf16 and f64 only the dtype's own precision. ROADMAP.md lists the forms
still to port.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from spgrid_torch.core.config import own_precision
from spgrid_torch.features import MatrixFeatures, matrix_features
from spgrid_torch.formats.csr import CSRMatrix, value_dtype
from spgrid_torch.ops import costmodel
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
from spgrid_torch.ops.layouts import (
    DeviceBSR, DeviceCOO, DeviceCSC, DeviceCV, DeviceELL, DeviceLDU,
    DeviceSELL, values_to_device,
)
from spgrid_torch.ops.merge import DeviceMerge, merge_spmm
from spgrid_torch.ops.rbh import DeviceRBH, rbh_spmm
from spgrid_torch.ops.scoo import DeviceSCOO, scoo_spmm
from spgrid_torch.ops.xla import (
    spmm_bsr, spmm_coo, spmm_csc, spmm_cv, spmm_ell, spmm_ldu, spmm_sell,
)

JAX_NAME = {"dense": "dense", "bsr_cuda": "bsr_pallas",
            "panel_cuda": "panel_pallas", "wcoo_cuda": "wcoo_pallas",
            "wcoo_bands_cuda": "wcoo_bands", "wcoo_spmv_cuda": "wcoo_spmv",
            "wrow_spmv_cuda": "wrow_spmv", "bsrc_cuda": "bsrc_pallas",
            "dgell_cuda": "dgell", "wpack_spmv_cuda": "wpack_spmv",
            "coo": "coo", "sell": "sell", "merge": "merge", "gell": "gell",
            "gell16": "gell16", "cv_gell": "cv_gell", "rbh": "rbh",
            "bsr": "bsr", "ell": "ell", "csc": "csc", "ldu": "ldu",
            "cv_bf16": "cv_bf16", "cv_int8": "cv_int8", "scoo": "scoo",
            "cv_panel_cuda": "cv_panel"}
PORT_NAME = {jax: port for port, jax in JAX_NAME.items()}
FORMATS = tuple(JAX_NAME)
# the GELL formats' modes (spgrid_torch/ops/gell.py)
GELL_MODE = {"gell": "f32", "gell16": "split16", "cv_gell": "bf16"}
# the formats that run on kernels: the port's CUDA kernels, and rbh's block
# part; every other format is a torch op or dense's matmul
KERNEL_FORMATS = ("bsr_cuda", "panel_cuda", "wcoo_cuda", "wcoo_bands_cuda",
                  "wcoo_spmv_cuda", "wrow_spmv_cuda", "bsrc_cuda",
                  "dgell_cuda", "wpack_spmv_cuda", "cv_panel_cuda", "rbh")
# the torch ops that sum in f32 whatever X's type (as the JAX package's):
# no f64 form
F32_SUM_FORMATS = ("gell", "gell16", "cv_gell", "cv_bf16", "cv_int8", "scoo")
# the formats that run at each dtype other than f32: at bf16 every one (the
# torch ops, dense, and each kernel's bf16 form); at f64 the torch ops that
# sum in f64 and dense
DTYPE_FORMATS = {
    "bfloat16": FORMATS,
    "float64": tuple(f for f in FORMATS
                     if f not in KERNEL_FORMATS + F32_SUM_FORMATS),
}


# the formats whose JAX dot takes the ambient matmul precision on f32
# operands: each has a form at 'high' (spmm_fn's precision)
AMBIENT_FORMATS = ("dense", "bsr_cuda", "panel_cuda", "bsrc_cuda", "rbh",
                   "bsr", "ell", "merge")


def runs_at(fmt: str, dtype: str, precision: Optional[str] = None) -> bool:
    """Whether format ``fmt`` has a form at ``dtype`` and matmul
    ``precision`` (None: the dtype's own)."""
    if precision is not None and precision != own_precision(dtype):
        return dtype == "float32" and (precision == "high"
                                       or fmt not in AMBIENT_FORMATS)
    return dtype == "float32" or fmt in DTYPE_FORMATS[dtype]


def build(csr: CSRMatrix, fmt: str, *, device, bm: Optional[int] = None,
          bk: int = 128):
    """The device operand of ``csr`` for format ``fmt``, in ``csr``'s value
    type; bm defaults to 128 for the block kernels and to 8 for ``bsr``, as
    ``spgrid.ops.dispatch.build`` does for ``bsr_pallas``, ``bsrc_pallas``
    and ``bsr``. A format with no form at that type raises."""
    if fmt not in FORMATS:
        raise ValueError(f"unknown format {fmt!r}; the port has {FORMATS}")
    dtype = value_dtype(csr)
    if not runs_at(fmt, dtype):
        raise ValueError(f"format {fmt!r} has no {dtype} form in the port "
                         f"(ROADMAP.md lists the forms still to port); at "
                         f"{dtype} the port runs "
                         f"{', '.join(DTYPE_FORMATS[dtype])}")
    if fmt == "dense":
        return values_to_device(csr.to_dense(), device, dtype)
    if fmt == "bsr_cuda":
        return DeviceBSR.from_csr(csr, bm=bm or 128, bk=bk, device=device)
    if fmt == "bsr":
        return DeviceBSR.from_csr(csr, bm=bm or 8, bk=bk, device=device)
    if fmt == "bsrc_cuda":
        return DeviceBSRCol.from_csr(csr, bm=bm or 128, bk=bk, device=device)
    if fmt == "panel_cuda":
        return DevicePanels.from_csr(csr, bk=bk, device=device)
    if fmt == "cv_panel_cuda":
        return DevicePanels.from_csr(csr, bk=bk, device=device).as_bf16()
    if fmt in ("cv_bf16", "cv_int8"):
        return DeviceCV.from_csr(csr, mode=fmt[3:], device=device)
    if fmt in GELL_MODE:
        return DeviceGELL.from_csr(csr, mode=GELL_MODE[fmt], device=device)
    if fmt == "rbh":
        return DeviceRBH.from_csr(csr, device=device)
    layout = {"wcoo_cuda": DeviceWCOO, "wcoo_bands_cuda": DeviceWCOOBands,
              "wcoo_spmv_cuda": DeviceWCOOAligned,
              "wrow_spmv_cuda": DeviceWROW, "dgell_cuda": DeviceDGELL,
              "wpack_spmv_cuda": DeviceWPACK, "coo": DeviceCOO,
              "sell": DeviceSELL, "merge": DeviceMerge, "ell": DeviceELL,
              "csc": DeviceCSC, "ldu": DeviceLDU,
              "scoo": DeviceSCOO}[fmt]
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
         "gell": gell_spmm, "gell16": gell_spmm, "cv_gell": gell_spmm,
         "rbh": rbh_spmm, "bsr": spmm_bsr, "ell": spmm_ell,
         "csc": spmm_csc, "ldu": spmm_ldu, "cv_bf16": spmm_cv,
         "cv_int8": spmm_cv, "scoo": scoo_spmm, "cv_panel_cuda": panel_spmm}


def spmm_fn(fmt: str, precision: Optional[str] = None) -> Callable:
    """The SpMM of format ``fmt`` at matmul ``precision`` (None: the
    operands' own): a format of ``AMBIENT_FORMATS`` takes the precision,
    every other computes the same at every precision."""
    if fmt not in FORMATS:
        raise ValueError(f"unknown format {fmt!r}; the port has {FORMATS}")
    if precision is not None and fmt in AMBIENT_FORMATS:
        return functools.partial(_SPMM[fmt], precision=precision)
    return _SPMM[fmt]


def select_format(f: MatrixFeatures, n: int = 512,
                  tolerance: float = 0.0, dtype: str = "float32",
                  precision: Optional[str] = None) -> str:
    """The port's format for ``auto`` dispatch, as
    ``spgrid.ops.dispatch.select_format`` picks it: for an SpMV (n = 1)
    below 5 % density the WROW SpMV; otherwise the cost model's argmin
    (``costmodel.select_format_cost``) under the card's constants. At a
    ``tolerance`` of ``costmodel.CV_TOLERANCE`` or more the value-compressed
    candidates join. Only the candidates with a form at ``dtype`` and
    ``precision`` take part (``runs_at``)."""
    if (n == 1 and f.density < 0.05
            and runs_at("wrow_spmv_cuda", dtype, precision)):
        return "wrow_spmv_cuda"
    cands = costmodel.AUTO_CANDIDATES
    if tolerance >= costmodel.CV_TOLERANCE:
        cands = cands + costmodel.tolerant_candidates(f, n)
    cands = tuple(c for c in cands
                  if runs_at(PORT_NAME[c], dtype, precision))
    return PORT_NAME[costmodel.select_format_cost(f, n, candidates=cands)]


@dataclasses.dataclass
class AutotuneResult:
    best: str                   # the port's format name
    times: Dict[str, float]     # seconds a call (inf = skipped or out of
                                # device memory)


def autotune_spmm(csr: CSRMatrix, x: torch.Tensor, candidates=None, *,
                  precision: Optional[str] = None,
                  features: Optional[MatrixFeatures] = None,
                  warmup_iters: int = 3, min_time_s: float = 0.05,
                  min_iters: int = 5,
                  dense_limit: int = 1 << 26) -> AutotuneResult:
    """Time each candidate on ``x``'s device and return the fastest: the
    JAX package's ``autotune_spmm``. Candidates default to the port's names
    of ``costmodel.AUTO_CANDIDATES``; a format the cost model calls
    inapplicable (an infinite estimate), or ``dense`` past ``dense_limit``
    elements, is skipped without being built. A call is timed by the
    harness's ``time_call``: by CUDA-graph replay on the card, on the host
    clock on the CPU. A candidate that fails to build or to run raises:
    nothing hides a kernel that did not launch. Only a candidate that
    runs out of device memory is left out (its time inf), and a call
    raises when no candidate ran. The default candidates are those with a
    form at ``csr``'s value type and matmul ``precision`` (None: the type's
    own), each timed at that precision (``spmm_fn``)."""
    from spgrid_torch.bench.harness import time_call
    from spgrid_torch.core.config import BenchConfig
    if candidates is None:
        candidates = tuple(
            PORT_NAME[c] for c in costmodel.AUTO_CANDIDATES
            if runs_at(PORT_NAME[c], value_dtype(csr), precision))
    feats = features if features is not None else matrix_features(csr)
    n = x.shape[1] if x.dim() == 2 else 1
    config = BenchConfig(warmup_iters=warmup_iters, min_time_s=min_time_s,
                         min_iters=min_iters)
    times: Dict[str, float] = {}
    for fmt in candidates:
        if fmt == "dense" and csr.m * csr.k > dense_limit:
            times[fmt] = math.inf
            continue
        if not np.isfinite(costmodel.estimate_spmm_time(
                feats, JAX_NAME[fmt], n)):
            times[fmt] = math.inf
            continue
        try:
            a = build(csr, fmt, device=x.device)
            times[fmt] = time_call(spmm_fn(fmt, precision), a, x,
                                   config=config,
                                   device=x.device,
                                   out_bytes=csr.m * n * x.element_size()
                                   ).time_per_iter_s
        except torch.OutOfMemoryError as e:
            print(f"autotune: {fmt} ran out of device memory: {e}")
            times[fmt] = math.inf
    best = min(times, key=times.get) if times else None
    if best is None or times[best] == math.inf:
        # returning one anyway would make the caller build a format
        # autotune refused to measure
        raise RuntimeError(
            f"autotune: no runnable candidate among {list(times)}")
    return AutotuneResult(best=best, times=times)
