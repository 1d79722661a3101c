"""Compressed sparse column format.

The port's own copy of ``spgrid/formats/csc.py`` (pinned to it by
``tests/test_torch_hostcopy.py``). CSC of A is CSR of A^T, so conversion
is a transpose-sort.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from spgrid_torch.formats.csr import CSRMatrix, COOMatrix, coo_to_csr, \
    IDX_DTYPE


@dataclasses.dataclass
class CSCMatrix:
    """Compressed sparse column matrix (host, numpy)."""

    col_ptr: np.ndarray   # (k+1,) int32
    row_idx: np.ndarray   # (nnz,) int32
    values: np.ndarray    # (nnz,) float
    shape: Tuple[int, int]
    name: str = "csc"

    def __post_init__(self):
        self.col_ptr = np.ascontiguousarray(self.col_ptr, dtype=IDX_DTYPE)
        self.row_idx = np.ascontiguousarray(self.row_idx, dtype=IDX_DTYPE)
        self.values = np.ascontiguousarray(self.values)
        k = self.shape[1]
        if self.col_ptr.shape != (k + 1,):
            raise ValueError(f"col_ptr has shape {self.col_ptr.shape}, "
                             f"expected ({k + 1},)")
        if not self.col_ptr[-1] == len(self.row_idx) == len(self.values):
            raise ValueError(f"col_ptr[-1]={self.col_ptr[-1]}, "
                             f"{len(self.row_idx)} rows, "
                             f"{len(self.values)} values")

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def k(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.col_ptr[-1])

    @property
    def col_degrees(self) -> np.ndarray:
        return np.diff(self.col_ptr)

    @property
    def mem_footprint(self) -> int:
        vb = self.values.dtype.itemsize
        ib = self.row_idx.dtype.itemsize
        return self.nnz * (vb + ib) + (self.k + 1) * ib

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.values.dtype)
        cols = np.repeat(np.arange(self.k), self.col_degrees)
        out[self.row_idx, cols] = self.values
        return out


def csr_to_csc(csr: CSRMatrix) -> CSCMatrix:
    """CSR -> CSC: build CSR of A^T, reinterpret."""
    rows = np.repeat(np.arange(csr.m, dtype=IDX_DTYPE), csr.degrees)
    t = coo_to_csr(
        COOMatrix(csr.col_idx.copy(), rows, csr.values.copy(),
                  (csr.k, csr.m), csr.name),
        sum_duplicates=False)
    return CSCMatrix(t.row_ptr, t.col_idx, t.values, csr.shape, csr.name)


def csc_to_csr(csc: CSCMatrix) -> CSRMatrix:
    cols = np.repeat(np.arange(csc.k, dtype=IDX_DTYPE), csc.col_degrees)
    return coo_to_csr(
        COOMatrix(csc.row_idx.copy(), cols, csc.values.copy(),
                  csc.shape, csc.name),
        sum_duplicates=False)
