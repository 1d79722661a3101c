"""Deterministic artificial sparse-matrix generator driven by structural
features: the port's own copy of ``spgrid/gen/artificial.py``.

Same parameters, same numpy draws in the same order, so a parameter line
gives the same CSR matrix in both packages (pinned by
``tests/test_torch_hostcopy.py``). The generation model is documented in
the original.
"""

from __future__ import annotations

import os

import numpy as np

from spgrid_torch.formats.csr import (
    BF16, CSRMatrix, IDX_DTYPE, cast_values, dtype_name,
)

# On-disk cache of generated matrices, keyed by the full parameter tuple
# without ``name``. It is the port's own, apart from the JAX package's, so a
# file written by one package never stands in for the other's output:
# ``<repo>/.gen_cache/spgrid_torch`` (git ignores ``.gen_cache/``), or the
# directory in SPGRID_TORCH_GEN_CACHE; "0" there turns it off.
_CACHE_MIN_NNZ = 1 << 19        # don't bother below ~0.5M nnz
_DEFAULT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".gen_cache", "spgrid_torch")


def _cache_dir():
    v = os.environ.get("SPGRID_TORCH_GEN_CACHE", _DEFAULT_CACHE)
    return None if v in ("0", "") else v


def artificial_matrix_generation(
    nr_rows: int,
    nr_cols: int,
    avg_nnz_per_row: float,
    std_nnz_per_row: float,
    distribution: str = "normal",
    seed: int = 14,
    placement: str = "random",
    bw: float = 0.05,
    skew: float = 0.0,
    avg_num_neighbours: float = 0.05,
    cross_row_similarity: float = 0.05,
    dtype=np.float32,
    name: str | None = None,
) -> CSRMatrix:
    """The CSR matrix of one 11-field parameter line (values uniform in
    [0.5, 1.5)). The original's opt-in ``calibrate_nnz`` trim is not
    carried: no caller of the port sets it."""
    m, n = int(nr_rows), int(nr_cols)
    rng = np.random.default_rng(np.random.PCG64(seed))
    avg = float(avg_nnz_per_row)
    std = float(std_nnz_per_row)

    cache = _cache_dir()
    cache_path = None
    if cache is not None and m * avg >= _CACHE_MIN_NNZ:
        key = (f"{m}_{n}_{avg:g}_{std:g}_{distribution}_{placement}_"
               f"{bw:g}_{skew:g}_{avg_num_neighbours:g}_"
               f"{cross_row_similarity:g}_{seed}_{dtype_name(dtype)}")
        cache_path = os.path.join(cache, key + ".npz")
        if os.path.exists(cache_path):
            try:
                z = np.load(cache_path)
                return CSRMatrix(z["row_ptr"], z["col_idx"], z["values"],
                                 (m, n), name if name is not None else key,
                                 bf16=dtype_name(dtype) == BF16)
            except Exception:           # corrupt/partial file: regenerate
                pass

    # --- 1. Row degrees -----------------------------------------------------
    if distribution == "normal":
        d = rng.normal(avg, std, size=m)
    elif distribution == "gamma":
        if std <= 0:
            d = np.full(m, avg)
        else:
            shape = (avg / std) ** 2
            scale = std * std / avg if avg > 0 else 1.0
            d = rng.gamma(shape, scale, size=m)
    else:
        raise ValueError(f"unknown distribution {distribution!r}")
    d = np.clip(np.rint(d), 0, n).astype(np.int64)

    # Window geometry: inflate so the *measured* bandwidth hits bw*n on
    # average.  Columns are placed as g groups of mean run length L; the row
    # range is E[max-min of g uniform starts] + (L-1) = w*(g-1)/(g+1) + L-1,
    # so the window is widened by the inverse factor.
    t_pre = float(np.clip(avg_num_neighbours, 0.0, 1.99))
    g_avg = max(avg * (1.0 - t_pre / 2.0), 1.0)
    run_avg = avg / g_avg
    base_w = max(bw * n - (run_avg - 1.0), 1.0)
    if g_avg > 1.05:
        base_w *= min((g_avg + 1.0) / (g_avg - 1.0), 10.0)
    w_row = min(n, int(round(base_w)))
    w_row = max(w_row, 2)

    # Degrees cannot exceed the window width.
    np.clip(d, 0, w_row, out=d)

    # Collision compensation: drawing t columns uniformly from a w-slot
    # window yields E[unique] = w(1-(1-1/w)^t); invert so the measured
    # degree lands on target after dedup (the reference generator achieves
    # the same with its ordered_set insert-until-full loop).
    if placement in ("random", "diagonal") and w_row < n:
        ratio = np.minimum(d / w_row, 0.95)
        denom = np.log1p(-1.0 / w_row)
        with np.errstate(divide="ignore", invalid="ignore"):
            d_draw = np.ceil(np.log1p(-ratio) / denom).astype(np.int64)
        d = np.where(d > 0, np.maximum(d, d_draw), 0)

    # Skew: boost one row toward avg*(1+skew) nnz (capped by row width n).
    if skew > 0 and m > 0:
        boost_row = int(rng.integers(0, m))
        d[boost_row] = min(int(round(avg * (1.0 + skew))), n)

    # --- 2. Group structure -------------------------------------------------
    t = float(np.clip(avg_num_neighbours, 0.0, 1.99))
    # groups per row: g = max(1, round(d * (1 - t/2)))
    g = np.maximum(1, np.rint(d * (1.0 - t / 2.0)).astype(np.int64))
    g[d == 0] = 0

    boosted = skew > 0 and d.max() > 4 * max(avg, 1)
    if boosted:
        # Handle the boosted row separately so the (m, G) slot matrix stays
        # small; G is set by the *typical* rows.
        mask_norm = np.ones(m, dtype=bool)
        mask_norm[boost_row] = False
        G = int(g[mask_norm].max()) if mask_norm.any() and g[mask_norm].size else 1
    else:
        G = int(g.max()) if m else 1
    G = max(G, 1)

    # --- 3+4. Persistent group-slot starts ----------------------------------
    q = float(np.clip(cross_row_similarity, 0.0, 1.0))
    # Window start per row (diagonal-centered, clipped to the matrix).
    centers = np.floor(np.arange(m, dtype=np.float64) * n / max(m, 1)).astype(np.int64)
    win_lo = np.clip(centers - w_row // 2, 0, max(n - w_row, 0))

    # Max start offset inside the window so a group fits.
    run_base = np.zeros(m, dtype=np.int64)
    nz = g > 0
    run_base[nz] = d[nz] // g[nz]           # base run length per row
    max_run = int(run_base.max()) + 1 if m else 1
    off_span = max(w_row - max_run, 1)

    if placement == "random":
        fresh = rng.integers(0, off_span, size=(m, G))
    elif placement == "diagonal":
        # Triangular distribution peaked at the window center.
        fresh = np.rint(
            rng.triangular(0, off_span / 2.0, off_span, size=(m, G))
        ).astype(np.int64)
    elif placement == "simple":
        # Consecutive packing from the window start; slot j starts after the
        # previous slot's run.
        fresh = np.tile(np.arange(G, dtype=np.int64), (m, 1)) * max_run
        fresh = np.minimum(fresh, off_span - 1)
    else:
        raise ValueError(f"unknown placement {placement!r}")
    fresh = fresh.astype(np.int64)

    if q > 0 and m > 1:
        # Calibration: row-to-row group-count/length variation breaks ~13% of
        # would-be matches (measured against spgrid.features extractor), so
        # the keep probability is inflated to land on the target similarity.
        q_eff = min(1.0, q * 1.15)
        keep = rng.random(size=(m, G)) < q_eff
        keep[0, :] = False
        # forward-fill: slot start = fresh value at the last non-kept row.
        row_ids = np.arange(m, dtype=np.int64)[:, None]
        src = np.where(keep, 0, row_ids)
        src = np.maximum.accumulate(src, axis=0)
        offs = np.take_along_axis(fresh, src, axis=0)
    else:
        offs = fresh

    starts = win_lo[:, None] + offs          # (m, G) absolute start columns

    # --- Expand groups to columns -------------------------------------------
    # Row r uses slots 0..g_r-1; slot j holds a run of length
    # base + (1 if j < rem else 0), where base = d // g, rem = d % g.
    rem = np.zeros(m, dtype=np.int64)
    rem[nz] = d[nz] % g[nz]

    rows_list = []
    cols_list = []

    norm_rows = np.arange(m)
    if boosted:
        norm_rows = norm_rows[mask_norm]

    gg = g[norm_rows]
    total_groups = int(gg.sum())
    if total_groups:
        grp_row = np.repeat(norm_rows, gg)
        # slot index of each group within its row
        grp_slot = _ranges(gg)
        grp_len = run_base[grp_row] + (grp_slot < rem[grp_row])
        grp_start = starts[grp_row, grp_slot]
        nnz_row = np.repeat(grp_row, grp_len)
        nnz_col = np.repeat(grp_start, grp_len) + _ranges(grp_len)
        rows_list.append(nnz_row)
        cols_list.append(np.minimum(nnz_col, n - 1))

    if boosted:
        # Boosted row: fill with d[boost_row] distinct columns.  The skewed
        # row ignores the bandwidth window when it cannot fit (a 8e6-nnz mawi
        # row has full-matrix extent; config.sh:329).
        db = int(d[boost_row])
        if db > w_row:
            wlo, span = 0, n
        else:
            wlo = int(win_lo[boost_row])
            span = min(w_row, n - wlo)
        if db >= span:
            cols_b = wlo + np.arange(span)
        else:
            cols_b = wlo + rng.choice(span, size=db, replace=False)
        rows_list.append(np.full(len(cols_b), boost_row, dtype=np.int64))
        cols_list.append(cols_b.astype(np.int64))

    if rows_list:
        rows = np.concatenate(rows_list)
        cols = np.concatenate(cols_list)
    else:
        rows = np.zeros(0, dtype=np.int64)
        cols = np.zeros(0, dtype=np.int64)

    # --- 5. Sort + dedup ------------------------------------------------------
    key = rows * np.int64(n) + cols
    key = np.unique(key)

    rows = (key // n).astype(IDX_DTYPE)
    cols = (key % n).astype(IDX_DTYPE)

    row_ptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(row_ptr, rows + 1, 1)
    row_ptr = np.cumsum(row_ptr)

    if dtype_name(dtype) == BF16:
        # bf16 arithmetic as numpy's with ml_dtypes: the draw rounded, the
        # sum formed exactly in f32 and rounded again
        values = cast_values(cast_values(rng.random(len(cols)), BF16)
                             + np.float32(0.5), BF16)
    else:
        values = (rng.random(len(cols)).astype(dtype)
                  + np.asarray(0.5, dtype=dtype))

    if name is None:
        name = (f"art_{m}_{n}_{avg:g}_{std:g}_{distribution}_{placement}_"
                f"{bw:g}_{skew:g}_{avg_num_neighbours:g}_"
                f"{cross_row_similarity:g}_{seed}")
    out = CSRMatrix(row_ptr.astype(IDX_DTYPE), cols, values, (m, n), name,
                    bf16=dtype_name(dtype) == BF16)
    if cache_path is not None:
        try:
            os.makedirs(cache, exist_ok=True)
            tmp = cache_path + f".tmp{os.getpid()}"
            with open(tmp, "wb") as fh:     # savez appends .npz to bare
                np.savez(fh, row_ptr=out.row_ptr,   # paths; a file object
                         col_idx=out.col_idx,       # keeps the name exact
                         values=out.values)
            os.replace(tmp, cache_path)
        except Exception:               # cache is best-effort only
            pass
    return out


def _ranges(lengths: np.ndarray) -> np.ndarray:
    """Concatenated aranges: [0..l0-1, 0..l1-1, ...], vectorized."""
    lengths = np.asarray(lengths, dtype=np.int64)
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(lengths)
    idx = np.arange(total, dtype=np.int64)
    offsets = np.repeat(ends - lengths, lengths)
    return idx - offsets
