"""LDU (lower/diagonal/upper) format for FVM adjacency matrices.

The port's own copy of ``spgrid/formats/ldu.py`` (pinned to it by
``tests/test_torch_hostcopy.py``): one (owner, neighbour) id pair per
internal face plus three value arrays, ``diag`` (n_cells), ``lower`` (face
value at (neigh, owner)) and ``upper`` (face value at (owner, neigh)). The
SpMV is a face loop:

    y = diag * x
    y[owner[f]] += upper[f] * x[neigh[f]]     for each face f
    y[neigh[f]] += lower[f] * x[owner[f]]
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from spgrid_torch.formats.csr import CSRMatrix, COOMatrix, coo_to_csr, \
    IDX_DTYPE


@dataclasses.dataclass
class LDUMatrix:
    """Face-based LDU matrix (host, numpy). Square by construction."""

    owner: np.ndarray   # (n_faces,) int32, owner[f] < neigh[f]
    neigh: np.ndarray   # (n_faces,) int32
    lower: np.ndarray   # (n_faces,) value at (neigh[f], owner[f])
    upper: np.ndarray   # (n_faces,) value at (owner[f], neigh[f])
    diag: np.ndarray    # (n_cells,)
    name: str = "ldu"

    def __post_init__(self):
        self.owner = np.ascontiguousarray(self.owner, dtype=IDX_DTYPE)
        self.neigh = np.ascontiguousarray(self.neigh, dtype=IDX_DTYPE)
        self.lower = np.ascontiguousarray(self.lower)
        self.upper = np.ascontiguousarray(self.upper)
        self.diag = np.ascontiguousarray(self.diag)
        if not (len(self.owner) == len(self.neigh) == len(self.lower)
                == len(self.upper)):
            raise ValueError("owner, neigh, lower and upper differ in length")

    @property
    def n_cells(self) -> int:
        return len(self.diag)

    @property
    def n_faces(self) -> int:
        return len(self.owner)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_cells, self.n_cells)

    @property
    def nnz(self) -> int:
        return self.n_cells + 2 * self.n_faces

    @property
    def mem_footprint(self) -> int:
        vb = self.diag.dtype.itemsize
        ib = self.owner.dtype.itemsize
        return (self.n_cells + 2 * self.n_faces) * vb + 2 * self.n_faces * ib


def csr_to_ldu(csr: CSRMatrix) -> LDUMatrix:
    """CSR -> LDU for a square matrix with symmetric *pattern*.

    Off-diagonal entries must come in (i,j)/(j,i) pairs (values may differ);
    missing diagonal entries become zeros.  Raises if the pattern is not
    symmetric — LDU cannot represent one-sided adjacency."""
    if csr.m != csr.k:
        raise ValueError("LDU requires a square matrix")
    rows = np.repeat(np.arange(csr.m, dtype=np.int64), csr.degrees)
    cols = csr.col_idx.astype(np.int64)
    vals = csr.values
    diag_mask = rows == cols
    diag = np.zeros(csr.m, dtype=vals.dtype)
    diag[rows[diag_mask]] = vals[diag_mask]
    up_mask = rows < cols
    lo_mask = rows > cols
    if up_mask.sum() != lo_mask.sum():
        raise ValueError("pattern not symmetric: upper/lower nnz differ")
    # upper entries keyed by (owner=row, neigh=col); lower by (owner=col,...)
    up_key = rows[up_mask] * csr.k + cols[up_mask]
    lo_key = cols[lo_mask] * csr.k + rows[lo_mask]
    up_order = np.argsort(up_key)
    lo_order = np.argsort(lo_key)
    if not np.array_equal(up_key[up_order], lo_key[lo_order]):
        raise ValueError("pattern not symmetric: unmatched face pairs")
    key = up_key[up_order]
    owner = (key // csr.k).astype(IDX_DTYPE)
    neigh = (key % csr.k).astype(IDX_DTYPE)
    return LDUMatrix(owner, neigh,
                     lower=vals[lo_mask][lo_order].copy(),
                     upper=vals[up_mask][up_order].copy(),
                     diag=diag, name=csr.name)


def ldu_to_csr(ldu: LDUMatrix) -> CSRMatrix:
    n = ldu.n_cells
    cells = np.arange(n, dtype=IDX_DTYPE)
    rows = np.concatenate([cells, ldu.owner, ldu.neigh])
    cols = np.concatenate([cells, ldu.neigh, ldu.owner])
    vals = np.concatenate([ldu.diag, ldu.upper, ldu.lower])
    csr = coo_to_csr(COOMatrix(rows, cols, vals, (n, n), ldu.name),
                     sum_duplicates=False)
    # drop explicit zero diagonal fills so round-trips preserve nnz
    keep = csr.values != 0
    if keep.all():
        return csr
    deg = np.zeros(n + 1, dtype=np.int64)
    r = np.repeat(np.arange(n), csr.degrees)[keep]
    np.add.at(deg, r + 1, 1)
    return CSRMatrix(np.cumsum(deg).astype(IDX_DTYPE), csr.col_idx[keep],
                     csr.values[keep], (n, n), ldu.name)
