"""Single-run harness: build → time → gate → row.

Counterpart of ``run_spmm``, ``run_pipeline`` and ``run_sddmm`` in
``spgrid/bench/harness.py``. A row is a dict keyed by the JAX ``BenchRow``'s
field names, for the fields the port fills. ``device`` is 'cuda' for a
measurement on the card or 'cpu' for the port's CPU path; the row's
``device`` field names the hardware the time was taken on.

A kernel name is a format of ``ops.dispatch`` or one of the JAX harness's
dispatch kernels (``KERNELS``): ``bsr_xla`` (the ``bsr`` format),
``gemm_bound`` (``dense`` with the dense flop count), ``auto`` and
``auto_tol`` (the cost model's pick, without and with the value-compressed
candidates) and ``autotune`` (the fastest measured candidate). A row
writes ``kernel`` as given and ``fmt`` as the JAX package names the format
that ran (``dispatch.JAX_NAME``), so the CSV joins the JAX package's on
``fmt`` and the cost model can fit it; the gate's class is the format's,
whatever the kernel's name.

The gate (eps 1e-4 at f32, the config's ``epsilon`` at bf16, 3e-2, and at
f64, 1e-10: ``gate_eps``) holds a row to the f64 product of its gate class
(``gold_class``): the exact class on A and X; ``gell16`` and ``cv_gell`` on
the X they gather; ``cv_bf16`` and ``cv_int8`` on A's dequantized values;
``cv_panel`` on A's bf16 values and X rounded to bf16 (``gate_csr``,
``gate_x``). It runs where the config's ``oracle`` says (``gate_site``):
on the host (``core.metrics``, the definition) or on the result's device
(``core.device_oracle``, whose gold is the host's bit for bit), the device
by default on the card once the result passes ``DEVICE_GATE_BYTES``; an f64
row is gated on the host, as the JAX harness gates it.

A row at bf16 or f64 (``config.dtype``) casts A once (``_as_dtype``:
``CSRMatrix.astype``, bf16 held as the f32 numbers it is) and makes X in the
dtype (``make_x``: the same draw rounded, bit for bit the JAX package's),
so the gold multiplies the values the row's format multiplies. numpy has no
bf16 without ``ml_dtypes``, so a bf16 result comes to the host widened to
f32 (``to_host``), exactly.

On the card a call is timed by the config's ``timing_protocol``: 'graph'
(the default) replays calls captured in a CUDA graph, so the time is the
device's, as the JAX harness's fused chained loop measures it; 'eager'
times eager calls. Each captured call keeps its output in the graph's
memory pool, so a row captures ``graph_calls(output bytes)`` calls: at most
``GRAPH_CALLS``, fewer where their outputs would pass ``GRAPH_BYTES``, and
never fewer than 2. On the CPU calls are timed eagerly on the host clock.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from spgrid_torch.formats.csr import (
    CSRMatrix, cast_values, itemsize, value_dtype,
)
from spgrid_torch.gen.masks import create_mask
from spgrid_torch.core.config import BenchConfig, own_precision
from spgrid_torch.core.device_oracle import DeviceOracle
from spgrid_torch.core.metrics import error_metrics, gold_spmm_fast
from spgrid_torch.core.roofline import (
    chip_for_name, csr_bytes, gemm_flops, roofline_time, spmm_flops,
)
from spgrid_torch.core.timing import time_kernel, time_kernel_graph
from spgrid_torch.features import matrix_features, value_features
from spgrid_torch.formats.cv import csr_to_cv, cv_to_csr
from spgrid_torch.ops import costmodel, dispatch
from spgrid_torch.ops.gell import gathered_x
from spgrid_torch.ops.attention import (
    SparseAttention, attention_pipeline, gold_pipeline, make_pipeline_step,
    stage_ops,
)
from spgrid_torch.ops.kernels.sddmm import bsr_sddmm
from spgrid_torch.ops.layouts import DeviceBSR, DeviceCOO, torch_dtype
from spgrid_torch.ops.sddmm_plan import choose_sddmm_blocks
from spgrid_torch.ops.xla import sddmm_coo


GRAPH_CALLS = 20            # calls captured in one graph, at most
GRAPH_BYTES = 2 << 30       # their outputs' bytes, at most (2 calls apart)
ROOFLINE_FRAC_CAP = 9.99    # as the JAX harness writes roofline_frac
VALUE_SAMPLE = 1 << 20      # values the value features read, at most
GOLD_CACHE = 2              # f64 golds kept a matrix (m n 8 bytes each)
DEVICE_GATE_BYTES = 32 << 20  # an f32 result past this is gated on the card
SDDMM_GOLD_BYTES = 1 << 28  # a block of rows' f64 scores in the SDDMM gold

# kernel name -> the port's format it runs; None where dispatch picks it
KERNELS = {**{fmt: fmt for fmt in dispatch.FORMATS},
           "csr_xla_coo": "coo",      # the JAX harness's names of coo
           "ell_xla": "ell",          # and ell
           "bsr_xla": "bsr",          # the batched block product, torch ops
           "gemm_bound": "dense",     # dense GEMM bound (dense flop count)
           "auto": None,              # the cost model's pick
           "auto_tol": None,          # the same, cv_* formats offered
           "autotune": None}          # the fastest measured candidate


def make_x(k: int, n: int, dtype: str, seed: int) -> np.ndarray:
    """Deterministic dense operand in [0.5, 1.5) — the port's copy of
    ``spgrid.bench.harness.make_x``, so the same seed gives the same X in
    both packages (bf16 as the f32 numbers it is: ``cast_values``)."""
    rng = np.random.default_rng(seed ^ 0x5EED)
    x = rng.random((k, n)) + 0.5
    return cast_values(x, dtype)


def x_tensor(x: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A host operand of ``make_x`` (or the like) as a tensor of ``dtype``
    on ``device`` (bf16 from the f32 numbers it is: exact)."""
    return torch.from_numpy(x).to(device).to(torch_dtype(dtype))


def to_host(t: torch.Tensor) -> np.ndarray:
    """A result on the host as numpy, bf16 widened to f32 (exact)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def gate_eps(config: BenchConfig, f32_eps: float = 1e-4) -> float:
    """A row's gate epsilon: ``f32_eps`` at f32 (1e-4; the pipeline's 1e-3),
    the config's ``epsilon`` at bf16 (3e-2) and f64 (1e-10), as the JAX
    harness gates them."""
    return f32_eps if config.dtype == "float32" else config.epsilon


def formats_run_at(formats, dtype: str, precision) -> bool:
    """Whether a row over ``formats`` (``kernel_formats``) computes the
    JAX function at ``dtype`` and matmul ``precision``: some format has a
    form there (``dispatch.runs_at``), and so has every one that has a
    form at the dtype's own precision. A dispatch kernel (every format)
    runs only where all of them do: JAX's ``auto`` at f32 'default' may
    choose ``bsr`` or ``dense`` at one bf16 pass, which the port has no
    form of, and choosing among the rest would make neither JAX's choice
    nor compute its function."""
    return (any(dispatch.runs_at(f, dtype, precision) for f in formats)
            and all(dispatch.runs_at(f, dtype, precision) for f in formats
                    if dispatch.runs_at(f, dtype)))


def check_spmm_precision(config: BenchConfig, what: str, formats) -> None:
    """Raise unless ``formats`` run at ``config``'s dtype and matmul
    precision (``formats_run_at``): at f32 'high' every format (the TPU's
    three bf16 passes); at f32 'default' (the TPU's one bf16 pass) only
    those that contract through no ambient-precision dot, and no dispatch
    kernel; at bf16 and f64 only the dtype's own precision."""
    if not formats_run_at(formats, config.dtype, config.precision):
        raise ValueError(
            f"{what}: no form at matmul precision {config.precision!r} for "
            f"{config.dtype} (ROADMAP.md lists the forms still to port)")


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


def gold_class(fmt: str) -> str:
    """The row's gate class, as the JAX harness names it, for a format named
    as the port or the JAX package names it: ``gell16``, ``cv_gell`` and
    the ``cv_*`` formats are their own class; every other format is
    ``exact``."""
    name = dispatch.JAX_NAME.get(fmt, fmt)
    return name if name == "gell16" or name.startswith("cv_") else "exact"


def gate_csr(csr, fmt: str):
    """The matrix a row's gold multiplies: A's dequantized values for the
    ``cv_*`` classes but ``cv_gell`` (bf16 for ``cv_panel``), else A."""
    cls = gold_class(fmt)
    if not cls.startswith("cv_") or cls == "cv_gell":
        return csr
    mode = "bf16" if cls == "cv_panel" else cls.split("_")[1]
    return cv_to_csr(csr_to_cv(csr, mode))


# the gate classes whose gold multiplies another X than the row's
X_CLASSES = ("cv_panel", "gell16", "cv_gell")


def gate_x_tensor(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """The X a row's gold multiplies, formed by torch where ``x`` lies: X
    itself; for ``gell16`` and ``cv_gell`` the X they gather; for
    ``cv_panel`` X rounded to bf16 (all three from X in f32, as the JAX
    harness's ``_xg_device``)."""
    cls = gold_class(fmt)
    if cls not in X_CLASSES:
        return x
    mode = "bf16" if cls == "cv_panel" else dispatch.GELL_MODE[cls]
    return gathered_x(x.to(torch.float32), mode)


def gate_x(x: np.ndarray, fmt: str) -> np.ndarray:
    """``gate_x_tensor`` of a host X, formed by torch on the CPU (the JAX
    harness's ``_xg_host``, without ``ml_dtypes``)."""
    if gold_class(fmt) not in X_CLASSES:
        return x
    return gate_x_tensor(torch.from_numpy(np.ascontiguousarray(
        x, np.float32)), fmt).numpy()


def gate_site(m: int, n: int, config: BenchConfig,
              device: torch.device) -> str:
    """'device' or 'host': where a row's gate runs (the config's
    ``oracle``; 'auto' takes the device on the card once the (m, n) result
    passes ``DEVICE_GATE_BYTES``). An f64 row is gated on the host, as the
    JAX harness gates it."""
    if config.dtype == "float64":
        return "host"
    if config.oracle != "auto":
        return config.oracle
    big = m * n * itemsize(config.dtype) > DEVICE_GATE_BYTES
    return "device" if torch.device(device).type == "cuda" and big \
        else "host"


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
    if value_dtype(csr) == dtype:
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


def _cached_gold(csr, fmt: str, x: np.ndarray, key_base) -> np.ndarray:
    """The host f64 gold of ``fmt``'s gate class (``gate_csr`` times
    ``gate_x``), cached on the matrix object a (n, dtype, seed, class):
    every format of a class on one matrix and X has the same gold. At most
    ``GOLD_CACHE`` are kept, the oldest dropped first (the JAX harness's
    ``_cached_gold``)."""
    cache = getattr(csr, "_spgrid_torch_gold", None)
    if cache is None:
        cache = {}
        csr._spgrid_torch_gold = cache
    key = (*key_base, gold_class(fmt))
    gold = cache.get(key)
    if gold is None:
        g = gate_csr(csr, fmt)
        gold = gold_spmm_fast(g.row_ptr, g.col_idx, g.values, gate_x(x, fmt))
        if len(cache) >= GOLD_CACHE:
            cache.pop(next(iter(cache)))
        cache[key] = gold
    return gold


def _cached_device_oracle(csr, fmt: str, device) -> DeviceOracle:
    """The device gate of ``fmt``'s gate class on ``device``, kept on the
    matrix object: its f64 CSR and its last gold are paid once a class, not
    a row. At most ``GOLD_CACHE`` are kept, the oldest dropped first (the
    JAX harness's ``_cached_device_oracle``)."""
    cache = getattr(csr, "_spgrid_torch_dev_oracle", None)
    if cache is None:
        cache = {}
        csr._spgrid_torch_dev_oracle = cache
    key = (gold_class(fmt), str(device))
    orc = cache.get(key)
    if orc is None:
        if len(cache) >= GOLD_CACHE:
            cache.pop(next(iter(cache)))
        orc = DeviceOracle.from_csr(gate_csr(csr, fmt), device=device)
        cache[key] = orc
    return orc


def gate(csr, fmt: str, test: torch.Tensor, x: np.ndarray,
         xd: torch.Tensor, config: BenchConfig, device):
    """The error vector of ``test`` (the row's result, on ``device``) at
    ``gate_eps`` against its gate class's f64 gold, on the host or the
    device (``gate_site``)."""
    n = test.shape[1]
    key = (n, config.dtype, config.seed)
    eps = gate_eps(config)
    if gate_site(csr.m, n, config, device) == "device":
        orc = _cached_device_oracle(csr, fmt, device)
        return orc.check(test, gate_x_tensor(xd, fmt), eps, key=key)
    gold = _cached_gold(csr, fmt, x, key)
    return error_metrics(gold, to_host(test), epsilon=eps)


def _cached_x(csr, n: int, dtype: str, seed: int, device: torch.device):
    """(X on the host, X on ``device``), made once a matrix object for the
    last (n, dtype, seed, device) asked: a sweep runs every kernel on the
    same X (the JAX harness's one-entry ``_XD_CACHE``). No format writes
    into X."""
    key = (n, dtype, seed, str(device))
    hit = getattr(csr, "_spgrid_torch_x", None)
    if hit is None or hit[0] != key:
        x = make_x(csr.k, n, dtype, seed)
        hit = (key, x, x_tensor(x, dtype, device))
        csr._spgrid_torch_x = hit
    return hit[1], hit[2]


def kernel_formats(kernel: str) -> tuple:
    """The port's formats ``kernel`` may run: its own, or every format for
    the dispatch kernels."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; the port has "
                         f"{tuple(KERNELS)}")
    fmt = KERNELS[kernel]
    return dispatch.FORMATS if fmt is None else (fmt,)


def kernel_format(csr, kernel: str, n: int, xd: torch.Tensor,
                  precision: Optional[str] = None) -> str:
    """The port's format that ``kernel`` runs on ``csr`` at n columns and
    matmul ``precision`` (None: the dtype's own)."""
    fmt = kernel_formats(kernel)
    if len(fmt) == 1:
        return fmt[0]
    if kernel == "autotune":
        return dispatch.autotune_spmm(
            csr, xd, precision=precision,
            features=_cached_features(csr)).best
    tol = costmodel.CV_TOLERANCE if kernel == "auto_tol" else 0.0
    return dispatch.select_format(_cached_features(csr), n, tolerance=tol,
                                  dtype=value_dtype(csr),
                                  precision=precision)


def run_spmm(csr: CSRMatrix, kernel: str = "bsr_cuda",
             config: Optional[BenchConfig] = None, *, device,
             check_accuracy: bool = True) -> dict:
    """Time Y = A @ X for one kernel (``KERNELS``) and gate it against the
    f64 gold of the gate class of the format that ran (eps 1e-4 at f32, as
    the JAX harness, at every precision; ``gate``). A and X take
    ``config.dtype``; a format with no form at that dtype raises
    (``dispatch.build``), and so does one with no form at the matmul
    precision (``check_spmm_precision``); at f32 'high' the formats whose
    JAX dot takes the ambient precision run their 3-pass forms, and
    the dispatch kernels pick among every format, as JAX's do; they
    raise at f32 'default', where some formats have no form."""
    config = config or BenchConfig()
    check_spmm_precision(config, f"run_spmm {kernel}",
                         kernel_formats(kernel))
    device = torch.device(device)
    n = config.num_cols
    csr = _as_dtype(csr, config.dtype)
    x, xd = _cached_x(csr, n, config.dtype, config.seed, device)
    fmt = kernel_format(csr, kernel, n, xd, config.precision)
    a = dispatch.build(csr, fmt, device=device)
    fn = dispatch.spmm_fn(fmt, config.precision)

    flops = (gemm_flops(csr.m, csr.k, n) if kernel == "gemm_bound"
             else spmm_flops(csr.nnz, n))
    vb = itemsize(config.dtype)
    bytes_accessed = (float((csr.m * csr.k + (csr.k + csr.m) * n) * vb)
                      if fmt == "dense"
                      else csr_bytes(csr.nnz, csr.m, n, csr.k, val_bytes=vb))
    timed = time_call(fn, a, xd, config=config, device=device,
                      out_bytes=csr.m * n * vb, flops=flops,
                      bytes_accessed=bytes_accessed)
    name, chip = _device_fields(device)
    sol = (roofline_time(flops, bytes_accessed, chip, config.dtype)
           if chip else math.nan)
    fmt_bytes = (a.numel() * a.element_size() if fmt == "dense"
                 else a.nbytes)
    row = dict(
        matrix_name=csr.name, kernel=kernel, fmt=dispatch.JAX_NAME[fmt],
        dtype=config.dtype,
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
        m = gate(csr, fmt, fn(a, xd), x, xd, config, device)
        row.update(_gate_fields(m))
        if not m.passed:
            print(f"Test failed! {csr.name} {kernel} ({fmt}): "
                  f"max_rel_diff={m.max_rel_diff:.3e}")
    return row


def run_pipeline(wk: CSRMatrix, wq: CSRMatrix, wv: CSRMatrix,
                 mask: Optional[CSRMatrix] = None,
                 config: Optional[BenchConfig] = None, *, device,
                 xla_only: bool = False,
                 check_accuracy: bool = True) -> dict:
    """Time the 5-stage sparse-attention pipeline as one step and stage by
    stage (GFLOPS per stage), and gate the step against ``gold_pipeline``
    (eps 1e-3 at f32, as the JAX harness). Without ``mask`` the config's
    mask is made, as in the JAX harness. ``xla_only`` runs the JAX
    package's XLA baselines as torch ops in place of the kernels (kernel
    ``pipeline_xla``). At bf16 and f64 the weights, the mask and X take
    the dtype; the gold multiplies the weights and mask as given, as the
    JAX harness's does. At f32 'high' every stage runs its 3-pass form
    (``attention_pipeline``'s ``precision``); a matmul precision at which
    its SpMMs have no form raises (``check_spmm_precision``)."""
    config = config or BenchConfig()
    check_spmm_precision(config, "run_pipeline",
                         ("bsr" if xla_only else "bsr_cuda",))
    precision = config.precision
    device = torch.device(device)
    n = config.num_cols
    if mask is None:
        mask = create_mask(config.sparse_attention_type, wk.m,
                           config.sparsity, config.band_size, config.seed,
                           dtype=config.dtype)
    x = make_x(wk.k, n, config.dtype, config.seed)
    xd = x_tensor(x, config.dtype, device)
    attn = SparseAttention.from_csr(
        *(c.astype(config.dtype) for c in (wk, wq, wv, mask)), device=device)
    step = make_pipeline_step(attn, xla_only=xla_only, precision=precision)
    spmm, sddmm = stage_ops(xla_only, precision)

    _, stages = attention_pipeline(attn, xd, xla_only=xla_only,
                                   precision=precision)
    out_bytes = {s: t.numel() * t.element_size() for s, t in stages.items()}

    def timed(fn, *args, out, min_time_s=None, flops=None):
        return time_call(fn, *args, config=config, device=device,
                         out_bytes=out, min_time_s=min_time_s, flops=flops)

    whole = timed(step, xd, out=sum(out_bytes.values()),
                  flops=attn.flops_per_col * n)

    s_bsr = attn.mask.with_blocks(stages["S"].to(xd.dtype))
    stage_min = min(0.2, config.min_time_s)
    stage_time = {
        "K": timed(spmm, attn.wk, xd, out=out_bytes["K"],
                   min_time_s=stage_min),
        "Q": timed(spmm, attn.wq, xd, out=out_bytes["Q"],
                   min_time_s=stage_min),
        "V": timed(spmm, attn.wv, xd, out=out_bytes["V"],
                   min_time_s=stage_min),
        "S": timed(sddmm, attn.mask, stages["Q"], stages["K"],
                   out=out_bytes["S"], min_time_s=stage_min),
        "Y": timed(spmm, s_bsr, stages["V"], out=out_bytes["Y"],
                   min_time_s=stage_min),
    }
    stage_flops = {"K": spmm_flops(wk.nnz, n), "Q": spmm_flops(wq.nnz, n),
                   "V": spmm_flops(wv.nnz, n), "S": spmm_flops(mask.nnz, n),
                   "Y": spmm_flops(mask.nnz, n)}
    gf = {s: stage_flops[s] / stage_time[s].time_per_iter_s / 1e9
          for s in stage_flops}
    name, _ = _device_fields(device)
    row = dict(
        matrix_name=f"pipeline_{wk.name}",
        kernel="pipeline_xla" if xla_only else "pipeline_cuda", fmt="bsr",
        dtype=config.dtype, device=name, num_devices=1, input_columns=n,
        csr_m=wk.m, csr_k=wk.k, csr_nnz=wk.nnz + wq.nnz + wv.nnz + mask.nnz,
        time=whole.time_per_iter_s, iters=whole.iters, gflops=whole.gflops,
        gflops_spmm_K=gf["K"], gflops_spmm_Q=gf["Q"], gflops_spmm_V=gf["V"],
        gflops_sddmm=gf["S"], gflops_final_spmm=gf["Y"],
    )
    if check_accuracy:
        gold = gold_pipeline(wk, wq, wv, mask, x)
        m = error_metrics(gold, to_host(step(xd)),
                          epsilon=gate_eps(config, 1e-3))
        row.update(_gate_fields(m))
        if not m.passed:
            print(f"Test failed! pipeline: max_rel_diff={m.max_rel_diff:.3e}")
    return row


def sddmm_gold(mask: CSRMatrix, x: np.ndarray, z: np.ndarray) -> np.ndarray:
    """The f64 gold of mask ⊙ (X @ Zᵀ) at the mask's nnz, in CSR order: the
    JAX harness's numbers (each nnz's f64 dot of its X and Z rows, times
    its mask value), formed a block of rows at a time as one f64 product of
    the block's X rows with Zᵀ (at most ``SDDMM_GOLD_BYTES`` of scores),
    from which the block's nnz are read."""
    x64 = np.asarray(x, np.float64)
    zt = np.ascontiguousarray(np.asarray(z, np.float64).T)
    ptr = np.asarray(mask.row_ptr, np.int64)
    gold = np.empty(mask.nnz, dtype=np.float64)
    rows = max(1, SDDMM_GOLD_BYTES // (8 * max(mask.k, 1)))
    for r0 in range(0, mask.m, rows):
        r1 = min(r0 + rows, mask.m)
        s, e = ptr[r0], ptr[r1]
        if s == e:
            continue
        local = np.repeat(np.arange(r1 - r0), np.diff(ptr[r0:r1 + 1]))
        gold[s:e] = (x64[r0:r1] @ zt)[local, mask.col_idx[s:e]]
    return gold * mask.values.astype(np.float64)


def _cached_sddmm_gold(mask: CSRMatrix, x: np.ndarray, z: np.ndarray,
                       key) -> np.ndarray:
    """``sddmm_gold``, kept on the mask object for the last ``key`` asked:
    the arms of a study point share one mask and X and Z."""
    hit = getattr(mask, "_spgrid_torch_sddmm_gold", None)
    if hit is None or hit[0] != key:
        hit = (key, sddmm_gold(mask, x, z))
        mask._spgrid_torch_sddmm_gold = hit
    return hit[1]


def _bsr_blocks_to_nnz(dev, blocks_out: np.ndarray, mask: CSRMatrix,
                       rows_idx: np.ndarray) -> np.ndarray:
    """Gather per-nnz values out of mask-aligned BSR value blocks."""
    bm, bk = dev.bm, dev.bk
    cols_idx = mask.col_idx
    br = rows_idx.astype(np.int64) // bm
    bc = cols_idx.astype(np.int64) // bk
    # dense (block_row, block_col) -> block index lookup table
    block_rows = dev.block_rows[: dev.num_blocks].cpu().numpy().astype(
        np.int64)
    block_cols = dev.block_cols[: dev.num_blocks].cpu().numpy().astype(
        np.int64)
    kb = -(-mask.k // bk)
    lut = np.full((dev.mb + 1) * kb, -1, dtype=np.int64)
    lut[block_rows * kb + block_cols] = np.arange(dev.num_blocks)
    bi = lut[br * kb + bc]
    assert (bi >= 0).all()
    return blocks_out[bi, rows_idx % bm, cols_idx % bk]


def run_sddmm(length: int, config: Optional[BenchConfig] = None, *, device,
              xla_only: bool = False, check_accuracy: bool = True,
              mask: Optional[CSRMatrix] = None,
              blocks: Optional[tuple] = None) -> dict:
    """The standalone SDDMM bench: the config's attention mask (or
    ``mask``), dense X and Z filled with 0.1 as in the reference, values =
    mask ⊙ (X @ Zᵀ) timed, and the values gated at the mask's nnz against
    the f64 gold (eps 1e-4 at f32, as the JAX harness). The kernel runs at
    the blocking ``choose_sddmm_blocks`` picks, or at ``blocks`` (bm, bk),
    at ``config.precision`` (at f32 'high' is the 3-pass bf16 form,
    ``bsr_sddmm_bf16x3``; a precision without a form raises); ``xla_only``
    runs the COO baseline ``xla.sddmm_coo`` instead (kernel ``sddmm_xla``,
    fmt ``coo``), which sums elementwise products as JAX's does, through no
    dot, so its row is the same at every precision."""
    config = config or BenchConfig()
    device = torch.device(device)
    n = config.num_cols
    if mask is None:
        mask = create_mask(config.sparse_attention_type, length,
                           config.sparsity, config.band_size, config.seed,
                           dtype=config.dtype)
    mask = _as_dtype(mask, config.dtype)
    x = cast_values(np.full((mask.m, n), 0.1), config.dtype)
    z = cast_values(np.full((mask.k, n), 0.1), config.dtype)
    xd = x_tensor(x, config.dtype, device)
    zd = x_tensor(z, config.dtype, device)

    flops = spmm_flops(mask.nnz, n)
    vb = itemsize(config.dtype)
    bytes_accessed = float(mask.nnz * (vb + 4) + (mask.m + mask.k) * n * vb)
    if xla_only:
        dev = DeviceCOO.from_csr(mask, device=device)
        fn, kernel, fmt = sddmm_coo, "sddmm_xla", "coo"
        out_bytes = dev.values.numel() * vb
    else:
        if blocks is None:
            plan = choose_sddmm_blocks(mask, n)
            blocks = (plan.bm, plan.bk)
        bm, bk = blocks
        dev = DeviceBSR.from_csr(mask, bm=bm, bk=bk, device=device)
        fn = (bsr_sddmm if config.precision == own_precision(config.dtype)
              else functools.partial(bsr_sddmm, precision=config.precision))
        kernel, fmt = "sddmm_cuda", f"bsr_pallas_{bm}x{bk}"
        out_bytes = dev.blocks.numel() * vb
    timed = time_call(fn, dev, xd, zd, config=config, device=device,
                      out_bytes=out_bytes, flops=flops,
                      bytes_accessed=bytes_accessed)
    name, chip = _device_fields(device)
    sol = (roofline_time(flops, bytes_accessed, chip, config.dtype)
           if chip else math.nan)
    row = dict(
        matrix_name=mask.name or f"mask_{length}", kernel=kernel, fmt=fmt,
        dtype=config.dtype, device=name, num_devices=1, input_columns=n,
        csr_m=mask.m, csr_k=mask.k, csr_nnz=mask.nnz,
        csr_mem_footprint_mb=mask.mem_footprint / (1 << 20),
        fmt_mem_footprint_mb=dev.nbytes / (1 << 20),
        time=timed.time_per_iter_s, iters=timed.iters, gflops=timed.gflops,
        gbytes_per_s=timed.gbytes_per_s, sol_time=sol,
        roofline_frac=min(sol / timed.time_per_iter_s, ROOFLINE_FRAC_CAP),
    )
    if check_accuracy:
        gold = _cached_sddmm_gold(mask, x, z, (n, config.dtype))
        out = to_host(fn(dev, xd, zd))
        if xla_only:
            test = out[: mask.nnz]
        else:
            rows_idx = np.repeat(np.arange(mask.m), mask.degrees)
            test = _bsr_blocks_to_nnz(dev, out, mask, rows_idx)
        m = error_metrics(gold, test.astype(np.float64),
                          epsilon=gate_eps(config))
        row.update(_gate_fields(m))
        if not m.passed:
            print(f"Test failed! sddmm {mask.name}: "
                  f"max_rel_diff={m.max_rel_diff:.3e}")
    return row
