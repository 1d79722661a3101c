"""Single-run harness: build → time → gate → row.

Counterpart of ``run_spmm`` and ``run_pipeline`` in
``spgrid/bench/harness.py``. A row is a dict keyed by the JAX ``BenchRow``'s
field names, for the fields the port fills. ``device`` is 'cuda' for a
measurement on the card or 'cpu' for the port's CPU path; the row's
``device`` field names the hardware the time was taken on.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from spgrid.formats.csr import CSRMatrix
from spgrid.gen.masks import create_mask
from spgrid_torch.core.config import BenchConfig
from spgrid_torch.core.metrics import error_metrics, gold_spmm_fast
from spgrid_torch.core.roofline import (
    chip_for_name, csr_bytes, roofline_time, spmm_flops,
)
from spgrid_torch.core.timing import time_kernel
from spgrid_torch.ops import dispatch
from spgrid_torch.ops.attention import (
    SparseAttention, attention_pipeline, gold_pipeline,
)
from spgrid_torch.ops.kernels.bsr_spmm import bsr_spmm
from spgrid_torch.ops.kernels.sddmm import bsr_sddmm


def make_x(k: int, n: int, dtype: str, seed: int) -> np.ndarray:
    """Deterministic dense operand in [0.5, 1.5) — a copy of
    ``spgrid.bench.harness.make_x`` (which imports JAX), so the same seed
    gives the same X in both packages."""
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


def run_spmm(csr: CSRMatrix, kernel: str = "bsr_cuda",
             config: Optional[BenchConfig] = None, *, device,
             check_accuracy: bool = True) -> dict:
    """Time Y = A @ X for one format and gate it against the host f64 oracle
    (eps 1e-4 at f32, as the JAX harness)."""
    config = config or BenchConfig()
    _f32_only(config)
    device = torch.device(device)
    n = config.num_cols
    csr = csr.astype(config.dtype)
    x = make_x(csr.k, n, config.dtype, config.seed)
    xd = torch.from_numpy(x).to(device)
    a = dispatch.build(csr, kernel, device=device)
    fn = dispatch.spmm_fn(kernel)

    flops = spmm_flops(csr.nnz, n)
    vb = np.dtype(config.dtype).itemsize
    bytes_accessed = (float((csr.m * csr.k + (csr.k + csr.m) * n) * vb)
                      if kernel == "dense"
                      else csr_bytes(csr.nnz, csr.m, n, csr.k, val_bytes=vb))
    timed = time_kernel(fn, a, xd, device=device,
                        warmup_iters=config.warmup_iters,
                        min_time_s=config.min_time_s,
                        min_iters=config.min_iters, flops=flops,
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
        roofline_frac=sol / timed.time_per_iter_s,
    )
    if check_accuracy:
        gold = gold_spmm_fast(csr.row_ptr, csr.col_idx, csr.values, x)
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

    def timed(fn, *args, min_time_s=config.min_time_s, flops=None):
        return time_kernel(fn, *args, device=device,
                           warmup_iters=config.warmup_iters,
                           min_time_s=min_time_s,
                           min_iters=config.min_iters, flops=flops)

    whole = timed(step, attn, xd, flops=attn.flops_per_col * n)

    _, stages = attention_pipeline(attn, xd)
    s_bsr = attn.mask.with_blocks(stages["S"])
    stage_min = min(0.2, config.min_time_s)
    stage_time = {
        "K": timed(bsr_spmm, attn.wk, xd, min_time_s=stage_min),
        "Q": timed(bsr_spmm, attn.wq, xd, min_time_s=stage_min),
        "V": timed(bsr_spmm, attn.wv, xd, min_time_s=stage_min),
        "S": timed(bsr_sddmm, attn.mask, stages["Q"], stages["K"],
                   min_time_s=stage_min),
        "Y": timed(bsr_spmm, s_bsr, stages["V"], min_time_s=stage_min),
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
