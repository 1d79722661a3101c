"""Matrix reordering passes: RCM, degree sort, random shuffle — the port's
copy of ``spgrid/formats/reorder.py``, function for function (pinned by
``tests/test_torch_hostcopy.py``).

Reference counterparts: ``validation_matrices/matrix_features/mat_reorder``
(RCM etc.) and the row-shuffling effect study
(``results_visualization/epyc5_shuffling.ipynb``).  On TPU, reordering is a
first-class performance lever: RCM shrinks bandwidth, which directly raises
WCOO window locality and SELL slice density.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from spgrid_torch.formats.csr import CSRMatrix, coo_to_csr, csr_to_coo, COOMatrix


def permute(csr: CSRMatrix, row_perm: np.ndarray,
            col_perm: np.ndarray | None = None) -> CSRMatrix:
    """Return P_r A P_c^T: new_row = inv(row_perm)[old]. ``row_perm[i]`` is
    the OLD row placed at new position i."""
    if col_perm is None:
        col_perm = row_perm if csr.m == csr.k else np.arange(csr.k)
    inv_col = np.empty(csr.k, dtype=np.int64)
    inv_col[col_perm] = np.arange(csr.k)
    coo = csr_to_coo(csr)
    inv_row = np.empty(csr.m, dtype=np.int64)
    inv_row[row_perm] = np.arange(csr.m)
    return coo_to_csr(COOMatrix(
        inv_row[coo.rows], inv_col[coo.cols], coo.values, csr.shape,
        csr.name + "_perm"))


def rcm_order(csr: CSRMatrix) -> np.ndarray:
    """Reverse Cuthill-McKee ordering on the symmetrized pattern.

    Returns ``perm`` with perm[i] = old row at new position i."""
    m = csr.m
    if csr.m != csr.k:
        raise ValueError("RCM needs a square matrix")
    # symmetrized adjacency in CSR form
    rows = np.repeat(np.arange(m, dtype=np.int64), csr.degrees)
    cols = csr.col_idx.astype(np.int64)
    ar = np.concatenate([rows, cols])
    ac = np.concatenate([cols, rows])
    keep = ar != ac
    ar, ac = ar[keep], ac[keep]
    order = np.lexsort((ac, ar))
    ar, ac = ar[order], ac[order]
    dup = np.ones(len(ar), dtype=bool)
    if len(ar):
        dup[1:] = (ar[1:] != ar[:-1]) | (ac[1:] != ac[:-1])
    ar, ac = ar[dup], ac[dup]
    ptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(ptr, ar + 1, 1)
    ptr = np.cumsum(ptr)
    deg = np.diff(ptr)

    visited = np.zeros(m, dtype=bool)
    out = np.empty(m, dtype=np.int64)
    pos = 0
    for start_candidate in np.argsort(deg, kind="stable"):
        if visited[start_candidate]:
            continue
        q = deque([int(start_candidate)])
        visited[start_candidate] = True
        while q:
            u = q.popleft()
            out[pos] = u
            pos += 1
            nbrs = ac[ptr[u]:ptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if len(nbrs):
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
                visited[nbrs] = True
                q.extend(int(v) for v in nbrs)
    return out[::-1].copy()     # reverse CM


def rcm(csr: CSRMatrix) -> CSRMatrix:
    return permute(csr, rcm_order(csr))


def first_use_col_order(csr: CSRMatrix) -> np.ndarray:
    """Column permutation by first appearance in row-major nnz order.

    Scanning rows top-down, each new column is appended at the frontier;
    columns reused only by nearby rows (high cross_row_similarity — the
    scattered-hypersparse class) therefore land near all their users and
    the permuted matrix becomes near-banded.  Returns ``perm`` with
    perm[j] = OLD column placed at new position j (cf. ``permute``).

    Reference counterpart: the structure-inspection step of
    mkl_sparse_optimize (spmm_kernel_mkl_ie.cpp:75-104) and the
    mat_reorder pass family (validation_matrices/matrix_features)."""
    uniq, first_idx = np.unique(csr.col_idx, return_index=True)
    seen = uniq[np.argsort(first_idx, kind="stable")]
    if len(seen) == csr.k:
        return seen.astype(np.int64)
    unseen = np.setdiff1d(np.arange(csr.k, dtype=np.int64), uniq,
                          assume_unique=False)
    return np.concatenate([seen.astype(np.int64), unseen])


def centroid_col_order(csr: CSRMatrix) -> np.ndarray:
    """Column permutation by mean row index of each column's nnz.

    Places every column at the centroid of its users instead of the first
    (first_use_col_order) — better when a column's run of users starts
    late or spans a window.  Columns with no nnz sort last."""
    rows = np.repeat(np.arange(csr.m, dtype=np.int64), csr.degrees)
    sums = np.zeros(csr.k, dtype=np.float64)
    cnts = np.zeros(csr.k, dtype=np.int64)
    np.add.at(sums, csr.col_idx, rows)
    np.add.at(cnts, csr.col_idx, 1)
    centroid = np.where(cnts > 0, sums / np.maximum(cnts, 1), float(csr.m))
    return np.argsort(centroid, kind="stable").astype(np.int64)


def degree_sort_order(csr: CSRMatrix, descending: bool = True) -> np.ndarray:
    d = csr.degrees
    return np.argsort(-d if descending else d, kind="stable")


def shuffle_order(csr: CSRMatrix, seed: int = 14) -> np.ndarray:
    """Random row shuffle (the reference's shuffling-effect study)."""
    rng = np.random.default_rng(seed)
    return rng.permutation(csr.m)
