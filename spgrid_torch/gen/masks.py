"""Sparse-attention masks: band_and_random / band_and_decay.

The port's own copy of ``spgrid/gen/masks.py`` (same draws, same masks;
pinned by ``tests/test_torch_hostcopy.py``). ``sparsity`` is the fraction
of zeros: a mask holds a dense diagonal band of half-width ``band_size``
and a seeded random fill of the lower triangle up to
(1 - sparsity)·length² entries.
"""

from __future__ import annotations

import numpy as np

from spgrid_torch.formats.csr import (
    BF16, CSRMatrix, cast_values, dense_to_csr, dtype_name,
)


def _band_mask(length: int, band_size: int) -> np.ndarray:
    i = np.arange(length)[:, None]
    j = np.arange(length)[None, :]
    return np.abs(i - j) <= max(band_size - 1, 0)


def default_band_size(length: int, sparsity: float) -> int:
    """Band half-width table of sddmm_mask.h:28-34."""
    if abs(sparsity - 0.95) < 1e-9:
        return 16
    if abs(sparsity - 0.98) < 1e-9:
        return 8
    if abs(sparsity - 0.5) < 1e-9:
        return max(length - 100, 1)
    # Interpolate: denser masks get wider bands, consuming ~half the budget.
    nnz_target = (1.0 - sparsity) * length * length
    return max(1, min(length, int(nnz_target / (4 * length))))


def band_and_random(
    length: int,
    sparsity: float,
    band_size: int | None = None,
    seed: int = 14,
) -> np.ndarray:
    """Boolean (length, length) mask: diagonal band + uniform lower-tri fill."""
    if band_size is None:
        band_size = default_band_size(length, sparsity)
    rng = np.random.default_rng(seed)
    mask = _band_mask(length, band_size)
    target = int(round((1.0 - sparsity) * length * length))
    target = min(target, length * (length + 1) // 2 + int(mask.sum()))
    placed = int(mask.sum())
    if placed > target:
        # Reference prints an error row when placed != target
        # (sddmm_mask.h:77-78); the band cannot be shrunk, so actual density
        # exceeds the request.
        import warnings
        warnings.warn(
            f"band ({placed} nnz) exceeds density target ({target}); "
            f"mask density will be {placed / length**2:.4f}", stacklevel=2)
    while placed < target:
        batch = max(1024, (target - placed) * 2)
        r = rng.integers(0, length, size=batch)
        c = (rng.random(batch) * (r + 1)).astype(np.int64)  # uniform in [0, r]
        for row, col in zip(r, c):
            if not mask[row, col]:
                mask[row, col] = True
                placed += 1
                if placed >= target:
                    break
    return mask


def band_and_decay(
    length: int,
    sparsity: float,
    band_size: int | None = None,
    seed: int = 14,
) -> np.ndarray:
    """Band + distance-decay-weighted lower-triangular fill.

    Off-band lower-tri entries are sampled with probability proportional to
    w = 1/(dist + 1e-5), via cumulative-weight binary search
    (sddmm_mask.h:83-230), with rejection of already-set entries.
    """
    if band_size is None:
        band_size = default_band_size(length, sparsity)
    rng = np.random.default_rng(seed)
    mask = _band_mask(length, band_size)
    target = int(round((1.0 - sparsity) * length * length))

    # Candidate pool: lower-triangle entries outside the band.
    i, j = np.tril_indices(length)
    dist = (i - j).astype(np.float64)
    off_band = dist >= band_size
    i, j, dist = i[off_band], j[off_band], dist[off_band]
    target = min(target, int(mask.sum()) + len(i))
    if len(i):
        w = 1.0 / (dist + 1e-5)
        cumw = np.cumsum(w)
        cumw /= cumw[-1]
        placed = int(mask.sum())
        while placed < target:
            batch = max(1024, (target - placed) * 2)
            picks = np.searchsorted(cumw, rng.random(batch), side="left")
            for p in picks:
                if not mask[i[p], j[p]]:
                    mask[i[p], j[p]] = True
                    placed += 1
                    if placed >= target:
                        break
    return mask


def create_mask(
    attention_type: str,
    length: int,
    sparsity: float,
    band_size: int | None = None,
    seed: int = 14,
    dtype=np.float32,
) -> CSRMatrix:
    """Build the attention-mask CSR (values = 1.0), mirroring
    ``create_mask`` + ``dense_to_csr`` of sddmm_mask.h:272-308."""
    if attention_type == "band_and_random":
        mask = band_and_random(length, sparsity, band_size, seed)
    elif attention_type == "band_and_decay":
        mask = band_and_decay(length, sparsity, band_size, seed)
    else:
        raise ValueError(f"unknown attention type {attention_type!r}")
    csr = dense_to_csr(cast_values(mask, dtype), name=f"mask_{attention_type}_{length}_{sparsity:g}")
    csr.bf16 = dtype_name(dtype) == BF16
    return csr


def mask_mem_footprint(length: int, sparsity: float, val_bytes: int = 4,
                       idx_bytes: int = 4) -> float:
    """(1-sparsity)*m^2*(val+idx) + (m+1)*idx  (sddmm_mask.h:260)."""
    return ((1.0 - sparsity) * length * length * (val_bytes + idx_bytes)
            + (length + 1) * idx_bytes)
