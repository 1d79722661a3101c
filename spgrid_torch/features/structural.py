"""Structural features of a CSR matrix.

The port's own copy of ``matrix_features`` from
``spgrid/features/structural.py`` and the helpers it calls, with the same
numpy arithmetic, so that a feature here equals the JAX package's for the
same matrix (pinned by ``tests/test_torch_features.py``). The feature
taxonomy is the reference's ``csr_util_gen.c`` (SURVEY A.1):

- ``degree[i] = row_ptr[i+1] - row_ptr[i]``
- bandwidth ``bw[i] = col_max - col_min`` within the row; scatter
  ``sc[i] = degree / bw if bw > 0 else 0``
- num_neighbours: per nnz, the other nnz of its row within ``window``
  columns, counted on both elements
- cross_row_similarity: per non-empty row, the fraction of its nnz with an
  nnz of the next non-empty row within ``window`` columns, averaged over
  the non-empty rows that have a next one
- skew = (max - avg) / avg of the degrees; bandwidth and scatter scaled by
  the column count
"""

from __future__ import annotations

import dataclasses

import numpy as np

from spgrid_torch.formats.csr import CSRMatrix


def row_degrees(csr) -> np.ndarray:
    return np.diff(csr.row_ptr)


def row_bandwidths(csr) -> np.ndarray:
    """bw[i] = col_max - col_min per row (0 for rows with <= 1 nnz)."""
    d = row_degrees(csr)
    bw = np.zeros(csr.m, dtype=np.int64)
    nz = d > 0
    if nz.any():
        cmax = np.maximum.reduceat(csr.col_idx, csr.row_ptr[:-1][nz])
        cmin = np.minimum.reduceat(csr.col_idx, csr.row_ptr[:-1][nz])
        bw[nz] = cmax - cmin
    return bw


def row_scatters(csr) -> np.ndarray:
    """sc[i] = degree[i] / bw[i] if bw > 0 else 0."""
    d = row_degrees(csr).astype(np.float64)
    bw = row_bandwidths(csr).astype(np.float64)
    return np.divide(d, bw, out=np.zeros_like(d), where=bw > 0)


def _sorted_csr(csr):
    """``csr`` itself if its columns ascend within each row, else a copy
    with each row's columns (and values) sorted."""
    col = csr.col_idx
    rp = csr.row_ptr
    if len(col) > 1:
        rows = np.repeat(np.arange(csr.m), np.diff(rp))
        same_row = rows[1:] == rows[:-1]
        if (col[1:][same_row] <= col[:-1][same_row]).any():
            order = np.lexsort((col, rows))
            return CSRMatrix(rp, col[order], csr.values[order], csr.shape,
                             csr.name)
    return csr


def num_neighbours(csr, window: int = 1) -> np.ndarray:
    """Per-nnz count of the other nnz of its row within +-window columns.

    With window=1 and unique sorted columns the count per nnz is
    (next_col - col <= window) + (col - prev_col <= window), in {0, 1, 2}.
    """
    csr = _sorted_csr(csr)
    col = csr.col_idx.astype(np.int64)
    n = len(col)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    rows = np.repeat(np.arange(csr.m), np.diff(csr.row_ptr))
    counts = np.zeros(n, dtype=np.int64)
    if window == 1:
        fwd = np.zeros(n, dtype=bool)
        fwd[:-1] = (rows[1:] == rows[:-1]) & (col[1:] - col[:-1] <= window)
        counts += fwd
        counts[1:] += fwd[:-1]
    else:
        stride = np.int64(csr.k + 2 * window + 2)
        key = rows * stride + col
        lo = np.searchsorted(key, rows * stride + col - window)
        hi = np.searchsorted(key, rows * stride + col + window, side="right")
        counts = hi - lo - 1
    return counts


def avg_num_neighbours(csr, window: int = 1) -> float:
    c = num_neighbours(csr, window)
    return float(c.mean()) if len(c) else 0.0


def cross_row_stats(csr, window: int = 1):
    """(cross_row_similarity, cross_row_neighbours per nnz): for the nnz of
    each non-empty row, the matches within +-window columns in the next
    non-empty row."""
    csr = _sorted_csr(csr)
    d = row_degrees(csr)
    nonempty = np.flatnonzero(d > 0)
    if len(nonempty) < 2:
        return 0.0, 0.0
    col = csr.col_idx.astype(np.int64)
    rp = csr.row_ptr.astype(np.int64)

    src_rows = nonempty[:-1]
    dst_rows = nonempty[1:]

    # each nnz of a source row, keyed into its next row's segment
    stride = np.int64(csr.k + 2 * window + 2)
    key = np.repeat(np.arange(csr.m, dtype=np.int64), d) * stride + col

    src_deg = d[src_rows]
    nnz_dst_rows = np.repeat(dst_rows, src_deg)
    take = np.concatenate(
        [np.arange(rp[r], rp[r + 1]) for r in src_rows]
    ) if len(src_rows) else np.zeros(0, dtype=np.int64)
    c = col[take]

    q_lo = nnz_dst_rows * stride + c - window
    q_hi = nnz_dst_rows * stride + c + window
    lo = np.searchsorted(key, q_lo, side="left")
    hi = np.searchsorted(key, q_hi, side="right")
    matches = hi - lo
    matched = matches > 0

    seg_ends = np.cumsum(src_deg)
    seg_starts = seg_ends - src_deg
    frac = np.add.reduceat(matched.astype(np.float64), seg_starts) / src_deg
    similarity = float(frac.mean())
    neigh = float(matches.mean()) if len(matches) else 0.0
    return similarity, neigh


@dataclasses.dataclass
class MatrixFeatures:
    """The feature vector carried through benchmark CSVs (the reference's
    artificial-matrix schema)."""

    name: str
    m: int
    n: int
    nnz: int
    density: float
    mem_footprint: float          # MB
    mem_range: str
    avg_nnz_per_row: float
    std_nnz_per_row: float
    min_nnz_per_row: int
    max_nnz_per_row: int
    avg_bw: float                 # mean row bandwidth (columns)
    std_bw: float
    avg_bw_scaled: float          # divided by the column count
    std_bw_scaled: float
    avg_sc: float                 # scatter = degree / bw
    std_sc: float
    avg_sc_scaled: float
    std_sc_scaled: float
    skew: float                   # (max - avg) / avg
    avg_num_neighbours: float
    cross_row_similarity: float
    # mean |row's column centre - diagonal| over non-empty rows, divided by
    # the column count: where a band sits, which avg_bw does not say
    avg_dd_scaled: float = 0.0

    def as_row(self) -> dict:
        return dataclasses.asdict(self)


_MEM_RANGES = [
    (4, "[4-32]"), (32, "[32-128]"), (128, "[128-512]"),
    (512, "[512-2048]"), (2048, "[2048-inf]"),
]


def _mem_range(mb: float) -> str:
    label = "[0-4]"
    for lo, lab in _MEM_RANGES:
        if mb >= lo:
            label = lab
    return label


def matrix_features(csr, name: str | None = None) -> MatrixFeatures:
    """The full structural feature report of ``csr``."""
    d = row_degrees(csr).astype(np.float64)
    bw = row_bandwidths(csr).astype(np.float64)
    sc = row_scatters(csr)
    avg_d = float(d.mean()) if csr.m else 0.0
    mb = csr.mem_footprint / (1 << 20)
    crs, _ = cross_row_stats(csr)
    n = max(csr.k, 1)
    return MatrixFeatures(
        name=name or csr.name,
        m=csr.m,
        n=csr.k,
        nnz=csr.nnz,
        density=csr.nnz / max(csr.m * csr.k, 1),
        mem_footprint=mb,
        mem_range=_mem_range(mb),
        avg_nnz_per_row=avg_d,
        std_nnz_per_row=float(d.std()),
        min_nnz_per_row=int(d.min()) if csr.m else 0,
        max_nnz_per_row=int(d.max()) if csr.m else 0,
        avg_bw=float(bw.mean()),
        std_bw=float(bw.std()),
        avg_bw_scaled=float(bw.mean()) / n,
        std_bw_scaled=float(bw.std()) / n,
        avg_sc=float(sc.mean()),
        std_sc=float(sc.std()),
        avg_sc_scaled=float(sc.mean()) / n,
        std_sc_scaled=float(sc.std()) / n,
        skew=(float(d.max()) - avg_d) / avg_d if avg_d > 0 else 0.0,
        avg_num_neighbours=avg_num_neighbours(csr),
        cross_row_similarity=crs,
        avg_dd_scaled=_avg_diag_dev(csr) / n,
    )


def _avg_diag_dev(csr) -> float:
    """Mean |row col-centre - row * k/m| over non-empty rows."""
    if csr.m == 0 or csr.nnz == 0:
        return 0.0
    d = np.diff(csr.row_ptr).astype(np.float64)
    sums = np.add.reduceat(csr.col_idx.astype(np.float64),
                           np.minimum(csr.row_ptr[:-1], csr.nnz - 1))
    sums[d == 0] = 0.0
    nz = d > 0
    centers = sums[nz] / d[nz]
    diag = np.arange(csr.m, dtype=np.float64)[nz] * (csr.k / max(csr.m, 1))
    return float(np.abs(centers - diag).mean())


def twin_params(csr, name: str | None = None, seed: int = 14) -> str:
    """Emit the 11-field generator parameter line for this matrix's twin —
    exactly the ``csr_matrix_features_validation`` print format
    (csr_util_gen.c:963-980): bw normalized by n, skew=(max-avg)/avg."""
    f = matrix_features(csr, name)
    return (
        f"{f.m} {f.n} {f.avg_nnz_per_row:.4f} {f.std_nnz_per_row:.4f} "
        f"normal random {f.avg_bw_scaled:.4f} {f.skew:.4f} "
        f"{f.avg_num_neighbours:.4f} {f.cross_row_similarity:.4f} {seed}"
        + (f" {f.name}" if f.name else "")
    )
