"""Single-run harness: build → time → gate → row.

Counterpart of ``run_spmm`` and ``run_pipeline`` in
``spgrid/bench/harness.py``. A row is a dict keyed by the JAX ``BenchRow``'s
field names, for the fields the port fills. ``device`` is 'cuda' for a
measurement on the card or 'cpu' for the port's CPU path; the row's
``device`` field names the hardware the time was taken on.

On the card a call is timed by the config's ``timing_protocol``: 'graph'
(the default) replays calls captured in a CUDA graph, so the time is the
device's, as the JAX harness's fused chained loop measures it; 'eager'
times eager calls. Each captured call keeps its output in the graph's
memory pool, so a row captures ``graph_calls(output bytes)`` calls: at most
``GRAPH_CALLS``, fewer where their outputs would pass ``GRAPH_BYTES``, and
never fewer than 2. On the CPU calls are timed eagerly on the host clock.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from spgrid_torch.formats.csr import CSRMatrix
from spgrid_torch.gen.masks import create_mask
from spgrid_torch.core.config import BenchConfig
from spgrid_torch.core.metrics import error_metrics, gold_spmm_fast
from spgrid_torch.core.roofline import (
    chip_for_name, csr_bytes, roofline_time, spmm_flops,
)
from spgrid_torch.core.timing import time_kernel, time_kernel_graph
from spgrid_torch.features import matrix_features, value_features
from spgrid_torch.ops import dispatch
from spgrid_torch.ops.gell import gathered_x
from spgrid_torch.ops.attention import (
    SparseAttention, attention_pipeline, gold_pipeline,
)
from spgrid_torch.ops.kernels.bsr_spmm import bsr_spmm
from spgrid_torch.ops.kernels.sddmm import bsr_sddmm


GRAPH_CALLS = 20            # calls captured in one graph, at most
GRAPH_BYTES = 2 << 30       # their outputs' bytes, at most (2 calls apart)
ROOFLINE_FRAC_CAP = 9.99    # as the JAX harness writes roofline_frac
VALUE_SAMPLE = 1 << 20      # values the value features read, at most


def make_x(k: int, n: int, dtype: str, seed: int) -> np.ndarray:
    """Deterministic dense operand in [0.5, 1.5) — the port's copy of
    ``spgrid.bench.harness.make_x``, so the same seed gives the same X in
    both packages."""
    rng = np.random.default_rng(seed ^ 0x5EED)
    x = rng.random((k, n)) + 0.5
    return x.astype(dtype)


def _device_fields(device: torch.device):
    """(name for the row, ChipSpec or None) of the hardware on ``device``."""
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        chip = chip_for_name(name)
        return (chip.name if chip else name), chip
    return device.type, None


def _gate_fields(m) -> dict:
    return dict(mae=m.mae, max_ae=m.max_ae, mse=m.mse, mape=m.mape,
                smape=m.smape, lnQ_error=m.lnQ_error, mlare=m.mlare,
                gmare=m.gmare, errors_passed=int(m.passed))


def _f32_only(config: BenchConfig) -> None:
    if config.dtype != "float32":
        raise ValueError(f"the port's kernels are f32 only, got {config.dtype}")


def gold_class(fmt: str) -> str:
    """The row's gate class, as the JAX harness names it: ``gell16`` and
    ``cv_gell`` gate on the X they gather; every other format is
    ``exact``."""
    return fmt if fmt in dispatch.GELL_MODE and fmt != "gell" else "exact"


def gate_x(x: np.ndarray, fmt: str) -> np.ndarray:
    """The X a row's f64 gold multiplies: X itself for the exact class;
    for ``gell16`` and ``cv_gell`` the X their mode gathers (the JAX
    harness's transformed X), formed by torch on the CPU."""
    if gold_class(fmt) == "exact":
        return x
    return gathered_x(torch.from_numpy(np.ascontiguousarray(x, np.float32)),
                      dispatch.GELL_MODE[fmt]).numpy()


def graph_calls(out_bytes: float) -> int:
    """Calls to capture in one graph whose calls each write ``out_bytes``."""
    return max(2, min(GRAPH_CALLS, int(GRAPH_BYTES // max(out_bytes, 1))))


def time_call(fn, *args, config: BenchConfig, device: torch.device,
              out_bytes: float, min_time_s: Optional[float] = None,
              flops: Optional[float] = None,
              bytes_accessed: Optional[float] = None):
    """``fn(*args)`` timed as ``config.timing_protocol`` says on the card,
    and eagerly on the host clock elsewhere. A call that cannot be captured
    in a graph raises: the graph protocol never falls back to eager
    timing."""
    kw = dict(device=device, warmup_iters=config.warmup_iters,
              min_time_s=(config.min_time_s if min_time_s is None
                          else min_time_s),
              min_iters=config.min_iters, flops=flops,
              bytes_accessed=bytes_accessed)
    if device.type == "cuda" and config.timing_protocol == "graph":
        return time_kernel_graph(fn, *args, calls=graph_calls(out_bytes),
                                 **kw)
    return time_kernel(fn, *args, **kw)


def _cached_features(csr):
    """Structural features, computed once a matrix object (a sweep runs
    every kernel on the same matrix)."""
    f = getattr(csr, "_spgrid_torch_feats", None)
    if f is None:
        f = matrix_features(csr)
        csr._spgrid_torch_feats = f
    return f


def _cached_value_features(csr):
    """Value features of at most ``VALUE_SAMPLE`` evenly strided values,
    computed once a matrix object."""
    vf = getattr(csr, "_spgrid_torch_value_feats", None)
    if vf is None:
        vsample = (csr.values if csr.nnz <= VALUE_SAMPLE
                   else csr.values[:: csr.nnz // VALUE_SAMPLE + 1])
        vf = value_features(np.asarray(vsample))
        csr._spgrid_torch_value_feats = vf
    return vf


_FEATURE_CACHES = ("_spgrid_torch_feats", "_spgrid_torch_value_feats")


def _as_dtype(csr, dtype: str):
    """``csr`` in ``dtype``. A cast is made once a matrix object and keeps
    the feature caches: the structure does not change, and the value
    features come from the cast's values whichever object computes them."""
    if csr.values.dtype == np.dtype(dtype):
        return csr
    cached = getattr(csr, "_spgrid_torch_cast", None)
    if cached is not None and cached[0] == dtype:
        return cached[1]
    cast = csr.astype(dtype)
    for attr in _FEATURE_CACHES:
        if hasattr(csr, attr):
            setattr(cast, attr, getattr(csr, attr))
    csr._spgrid_torch_cast = (dtype, cast)
    return cast


def feature_fields(csr) -> dict:
    """The row's 9 structural and 3 value feature columns, as the JAX
    harness fills them."""
    f = _cached_features(csr)
    vf = _cached_value_features(csr)
    return dict(
        density=f.density, avg_nnz_per_row=f.avg_nnz_per_row,
        std_nnz_per_row=f.std_nnz_per_row, avg_bw_scaled=f.avg_bw_scaled,
        std_bw_scaled=f.std_bw_scaled, avg_sc_scaled=f.avg_sc_scaled,
        skew=f.skew, avg_num_neighbours=f.avg_num_neighbours,
        cross_row_similarity=f.cross_row_similarity,
        val_unique_fraction=vf.unique_fraction,
        val_exp_unique=float(vf.exp_unique),
        val_kmeans_rel_error_8=vf.kmeans_rel_error_8)


def run_spmm(csr: CSRMatrix, kernel: str = "bsr_cuda",
             config: Optional[BenchConfig] = None, *, device,
             check_accuracy: bool = True) -> dict:
    """Time Y = A @ X for one format and gate it against the host f64 oracle
    (eps 1e-4 at f32, as the JAX harness), on the X of the format's gate
    class (``gate_x``)."""
    config = config or BenchConfig()
    _f32_only(config)
    device = torch.device(device)
    n = config.num_cols
    csr = _as_dtype(csr, config.dtype)
    x = make_x(csr.k, n, config.dtype, config.seed)
    xd = torch.from_numpy(x).to(device)
    a = dispatch.build(csr, kernel, device=device)
    fn = dispatch.spmm_fn(kernel)

    flops = spmm_flops(csr.nnz, n)
    vb = np.dtype(config.dtype).itemsize
    bytes_accessed = (float((csr.m * csr.k + (csr.k + csr.m) * n) * vb)
                      if kernel == "dense"
                      else csr_bytes(csr.nnz, csr.m, n, csr.k, val_bytes=vb))
    timed = time_call(fn, a, xd, config=config, device=device,
                      out_bytes=csr.m * n * vb, flops=flops,
                      bytes_accessed=bytes_accessed)
    name, chip = _device_fields(device)
    sol = (roofline_time(flops, bytes_accessed, chip, config.dtype)
           if chip else math.nan)
    fmt_bytes = (a.numel() * a.element_size() if kernel == "dense"
                 else a.nbytes)
    row = dict(
        matrix_name=csr.name, kernel=kernel, fmt=kernel, dtype=config.dtype,
        device=name, num_devices=1, input_columns=n, csr_m=csr.m,
        csr_k=csr.k, csr_nnz=csr.nnz,
        csr_mem_footprint_mb=csr.mem_footprint / (1 << 20),
        fmt_mem_footprint_mb=fmt_bytes / (1 << 20),
        time=timed.time_per_iter_s, iters=timed.iters, gflops=timed.gflops,
        gbytes_per_s=timed.gbytes_per_s, sol_time=sol,
        roofline_frac=min(sol / timed.time_per_iter_s, ROOFLINE_FRAC_CAP),
        **feature_fields(csr),
    )
    if check_accuracy:
        gold = gold_spmm_fast(csr.row_ptr, csr.col_idx, csr.values,
                              gate_x(x, kernel))
        test = fn(a, xd).cpu().numpy()
        m = error_metrics(gold, test, epsilon=1e-4)
        row.update(_gate_fields(m))
        if not m.passed:
            print(f"Test failed! {csr.name} {kernel}: "
                  f"max_rel_diff={m.max_rel_diff:.3e}")
    return row


def run_pipeline(wk: CSRMatrix, wq: CSRMatrix, wv: CSRMatrix,
                 mask: Optional[CSRMatrix] = None,
                 config: Optional[BenchConfig] = None, *, device,
                 check_accuracy: bool = True) -> dict:
    """Time the 5-stage sparse-attention pipeline as one step and stage by
    stage (GFLOPS per stage), and gate the step against ``gold_pipeline``
    (eps 1e-3 at f32, as the JAX harness). Without ``mask`` the config's
    mask is made, as in the JAX harness."""
    config = config or BenchConfig()
    _f32_only(config)
    device = torch.device(device)
    n = config.num_cols
    if mask is None:
        mask = create_mask(config.sparse_attention_type, wk.m,
                           config.sparsity, config.band_size, config.seed,
                           dtype=np.dtype(config.dtype))
    x = make_x(wk.k, n, config.dtype, config.seed)
    xd = torch.from_numpy(x).to(device)
    wk, wq, wv, mask = (c.astype(config.dtype) for c in (wk, wq, wv, mask))
    attn = SparseAttention.from_csr(wk, wq, wv, mask, device=device)

    def step(at, xc):
        return attention_pipeline(at, xc)[0]

    _, stages = attention_pipeline(attn, xd)
    out_bytes = {s: t.numel() * t.element_size() for s, t in stages.items()}

    def timed(fn, *args, out, min_time_s=None, flops=None):
        return time_call(fn, *args, config=config, device=device,
                         out_bytes=out, min_time_s=min_time_s, flops=flops)

    whole = timed(step, attn, xd, out=sum(out_bytes.values()),
                  flops=attn.flops_per_col * n)

    s_bsr = attn.mask.with_blocks(stages["S"])
    stage_min = min(0.2, config.min_time_s)
    stage_time = {
        "K": timed(bsr_spmm, attn.wk, xd, out=out_bytes["K"],
                   min_time_s=stage_min),
        "Q": timed(bsr_spmm, attn.wq, xd, out=out_bytes["Q"],
                   min_time_s=stage_min),
        "V": timed(bsr_spmm, attn.wv, xd, out=out_bytes["V"],
                   min_time_s=stage_min),
        "S": timed(bsr_sddmm, attn.mask, stages["Q"], stages["K"],
                   out=out_bytes["S"], min_time_s=stage_min),
        "Y": timed(bsr_spmm, s_bsr, stages["V"], out=out_bytes["Y"],
                   min_time_s=stage_min),
    }
    stage_flops = {"K": spmm_flops(wk.nnz, n), "Q": spmm_flops(wq.nnz, n),
                   "V": spmm_flops(wv.nnz, n), "S": spmm_flops(mask.nnz, n),
                   "Y": spmm_flops(mask.nnz, n)}
    gf = {s: stage_flops[s] / stage_time[s].time_per_iter_s / 1e9
          for s in stage_flops}
    name, _ = _device_fields(device)
    row = dict(
        matrix_name=f"pipeline_{wk.name}", kernel="pipeline_cuda", fmt="bsr",
        dtype=config.dtype, device=name, num_devices=1, input_columns=n,
        csr_m=wk.m, csr_k=wk.k, csr_nnz=wk.nnz + wq.nnz + wv.nnz + mask.nnz,
        time=whole.time_per_iter_s, iters=whole.iters, gflops=whole.gflops,
        gflops_spmm_K=gf["K"], gflops_spmm_Q=gf["Q"], gflops_spmm_V=gf["V"],
        gflops_sddmm=gf["S"], gflops_final_spmm=gf["Y"],
    )
    if check_accuracy:
        gold = gold_pipeline(wk, wq, wv, mask, x)
        test = step(attn, xd).cpu().numpy()
        m = error_metrics(gold, test, epsilon=1e-3)
        row.update(_gate_fields(m))
        if not m.passed:
            print(f"Test failed! pipeline: max_rel_diff={m.max_rel_diff:.3e}")
    return row
