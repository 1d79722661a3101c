"""The 8-metric error vector and the f64 host oracle (numpy).

The port's own copies of ``ErrorMetrics``, ``error_metrics`` and
``gold_spmm_fast`` from ``spgrid/core/metrics.py``: the port imports nothing
of the JAX package. ``tests/test_torch_harness.py`` pins the copies to the
originals.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ErrorMetrics:
    """The 8-metric error vector of the reference's ``lib/array_metrics.c``."""

    mae: float        # mean |a - f|
    max_ae: float     # max  |a - f|
    mse: float        # mean (a - f)^2
    mape: float       # mean |a - f| / |a|          (a != 0)
    smape: float      # mean 2|a - f| / (|a| + |f|) (denominator != 0)
    lnQ_error: float  # mean log10(max(|f|,eps)) - log10(max(|a|,eps))
    mlare: float      # log10 |10^lnQ - 1|
    gmare: float      # 10^mlare

    # Gate fields
    max_rel_diff: float
    passed: bool

    def as_row(self) -> dict:
        return dataclasses.asdict(self)


def error_metrics(gold: np.ndarray, test: np.ndarray,
                  epsilon: float) -> ErrorMetrics:
    """Compute the full error vector of ``test`` against ``gold``.

    Pass/fail gate: max relative difference, computed only where
    ``|gold| > epsilon`` (absolute difference gates the rest), must stay
    below ``epsilon``.
    """
    a = np.asarray(gold, dtype=np.float64).ravel()
    f = np.asarray(test, dtype=np.float64).ravel()
    if a.shape != f.shape:
        raise ValueError(f"shape mismatch: gold {a.shape} vs test {f.shape}")

    diff = np.abs(a - f)
    mae = float(diff.mean()) if a.size else 0.0
    max_ae = float(diff.max()) if a.size else 0.0
    mse = float(np.mean((a - f) ** 2)) if a.size else 0.0

    nz = np.abs(a) > 0
    mape = float(np.mean(diff[nz] / np.abs(a[nz]))) if nz.any() else 0.0

    denom = np.abs(a) + np.abs(f)
    dz = denom > 0
    smape = float(np.mean(2.0 * diff[dz] / denom[dz])) if dz.any() else 0.0

    tiny = max(epsilon, np.finfo(np.float64).tiny)
    lnq = float(
        np.mean(
            np.log10(np.maximum(np.abs(f), tiny))
            - np.log10(np.maximum(np.abs(a), tiny))
        )
    ) if a.size else 0.0
    mlare = float(np.log10(np.abs(10.0 ** lnq - 1.0))) if lnq != 0.0 else -np.inf
    gmare = float(10.0 ** mlare)

    # Gate: relative where gold is significant, absolute elsewhere.
    sig = np.abs(a) > epsilon
    rel = np.zeros_like(diff)
    rel[sig] = diff[sig] / np.abs(a[sig])
    rel[~sig] = diff[~sig]
    max_rel = float(rel.max()) if rel.size else 0.0

    return ErrorMetrics(
        mae=mae,
        max_ae=max_ae,
        mse=mse,
        mape=mape,
        smape=smape,
        lnQ_error=lnq,
        mlare=mlare,
        gmare=gmare,
        max_rel_diff=max_rel,
        passed=bool(max_rel <= epsilon),
    )


def gold_spmm_fast(row_ptr: np.ndarray, col_idx: np.ndarray,
                   values: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Vectorized float64 oracle of CSR(m, k) @ x (np.add.reduceat over row
    segments)."""
    m = len(row_ptr) - 1
    x64 = np.asarray(x, dtype=np.float64)
    squeeze = x64.ndim == 1
    x2 = x64.reshape(x64.shape[0], -1)
    v = np.asarray(values, dtype=np.float64)
    prods = v[:, None] * x2[col_idx]                     # (nnz, n)
    starts = np.asarray(row_ptr[:-1], dtype=np.int64)
    nnz = len(v)
    out = np.zeros((m, x2.shape[1]), dtype=np.float64)
    nonempty = starts < row_ptr[1:]
    if nnz and nonempty.any():
        # reduceat needs strictly valid segment starts; empty rows repeat the
        # next start and must be zeroed after.
        red = np.add.reduceat(prods, starts[nonempty], axis=0)
        out[nonempty] = red
    return out[:, 0] if squeeze else out
