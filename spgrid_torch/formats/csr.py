"""Host CSR / COO containers and converters (numpy).

The port's own copy of ``spgrid/formats/csr.py``: the same classes and
functions with the same arithmetic, so that a matrix built here equals the
JAX package's element for element (pinned by
``tests/test_torch_hostcopy.py``). The port's functions read a matrix only
through its attributes (``row_ptr``, ``col_idx``, ``values``, ``shape``,
``name`` and the properties below), so they also take the JAX package's
``CSRMatrix``.

One difference: numpy has no bf16 type without ``ml_dtypes``, which the
machine with the card lacks, so a bf16 matrix (``astype("bfloat16")``)
holds its values as f32 numbers that bf16 represents exactly, rounded by
torch (to nearest, ties to even, through f32 from f64, as ``ml_dtypes``
rounds), and says so in ``bf16``; ``value_dtype`` names a matrix's value
type either way.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

IDX_DTYPE = np.int32
BF16 = "bfloat16"


def dtype_name(dtype) -> str:
    """The name of a value type given as a name or a numpy type: 'bfloat16'
    is known by its name alone."""
    if isinstance(dtype, str) and dtype == BF16:
        return BF16
    return np.dtype(dtype).name


def bf16_bits(values: np.ndarray) -> np.ndarray:
    """Values rounded to bf16 (to nearest, ties to even; f64 through f32):
    their bit patterns."""
    t = torch.from_numpy(np.ascontiguousarray(values, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def bf16_values(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns widened to f32 (exact)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


def cast_values(values: np.ndarray, dtype) -> np.ndarray:
    """``values`` in ``dtype``; bf16 as the f32 numbers that bf16 holds
    (``bf16_bits`` rounding)."""
    if dtype_name(dtype) == BF16:
        return bf16_values(bf16_bits(values))
    return np.asarray(values).astype(dtype)


def itemsize(dtype) -> int:
    """Bytes of one value of a type given as a name or a numpy type."""
    return 2 if dtype_name(dtype) == BF16 else np.dtype(dtype).itemsize


def value_dtype(csr) -> str:
    """The name of a matrix's value type: 'bfloat16' for a bf16 matrix of
    the port (f32 numbers, ``bf16``) or of the JAX package."""
    if getattr(csr, "bf16", False):
        return BF16
    return csr.values.dtype.name


@dataclasses.dataclass
class CSRMatrix:
    """Compressed sparse row matrix on the host.

    ``mem_footprint`` is ``nnz*(sizeof(val)+sizeof(idx)) + (m+1)*sizeof(idx)``.
    """

    row_ptr: np.ndarray   # (m+1,) int32
    col_idx: np.ndarray   # (nnz,)  int32
    values: np.ndarray    # (nnz,)  float
    shape: Tuple[int, int]
    name: str = "csr"
    bf16: bool = False    # values are bf16's, held as f32

    def __post_init__(self):
        self.row_ptr = np.ascontiguousarray(self.row_ptr, dtype=IDX_DTYPE)
        self.col_idx = np.ascontiguousarray(self.col_idx, dtype=IDX_DTYPE)
        self.values = np.ascontiguousarray(self.values)
        m = self.shape[0]
        if self.row_ptr.shape != (m + 1,):
            raise ValueError(f"row_ptr has shape {self.row_ptr.shape}, "
                             f"expected ({m + 1},)")
        if not self.row_ptr[-1] == len(self.col_idx) == len(self.values):
            raise ValueError(f"row_ptr[-1]={self.row_ptr[-1]}, "
                             f"{len(self.col_idx)} columns, "
                             f"{len(self.values)} values")

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def k(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.row_ptr[-1])

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    @property
    def mem_footprint(self) -> int:
        vb = 2 if self.bf16 else self.values.dtype.itemsize
        ib = self.col_idx.dtype.itemsize
        return self.nnz * (vb + ib) + (self.m + 1) * ib

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.values.dtype)
        rows = np.repeat(np.arange(self.m), self.degrees)
        out[rows, self.col_idx] = self.values
        return out

    def astype(self, dtype) -> "CSRMatrix":
        return CSRMatrix(self.row_ptr, self.col_idx,
                         cast_values(self.values, dtype), self.shape,
                         self.name, bf16=dtype_name(dtype) == BF16)


@dataclasses.dataclass
class COOMatrix:
    """Coordinate-format matrix on the host."""

    rows: np.ndarray
    cols: np.ndarray
    values: np.ndarray
    shape: Tuple[int, int]
    name: str = "coo"

    def __post_init__(self):
        self.rows = np.ascontiguousarray(self.rows, dtype=IDX_DTYPE)
        self.cols = np.ascontiguousarray(self.cols, dtype=IDX_DTYPE)
        self.values = np.ascontiguousarray(self.values)

    @property
    def nnz(self) -> int:
        return len(self.values)


def coo_to_csr(coo: COOMatrix, *, sum_duplicates: bool = True,
               sort_cols: bool = True) -> CSRMatrix:
    """COO → CSR: sort by (row, col), optionally fold duplicates (summed in
    f64), build the row pointer."""
    m, k = coo.shape
    if sort_cols:
        order = np.lexsort((coo.cols, coo.rows))
    else:
        order = np.argsort(coo.rows, kind="stable")
    rows = coo.rows[order]
    cols = coo.cols[order]
    vals = coo.values[order]
    if sum_duplicates and len(rows):
        key = rows.astype(np.int64) * k + cols
        uniq, inv = np.unique(key, return_inverse=True)
        if len(uniq) != len(rows):
            summed = np.zeros(len(uniq), dtype=np.float64)
            np.add.at(summed, inv, vals.astype(np.float64))
            vals = summed.astype(vals.dtype)
            rows = (uniq // k).astype(IDX_DTYPE)
            cols = (uniq % k).astype(IDX_DTYPE)
    row_ptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(row_ptr, rows + 1, 1)
    row_ptr = np.cumsum(row_ptr)
    return CSRMatrix(row_ptr.astype(IDX_DTYPE), cols, vals, coo.shape, coo.name)


def csr_to_coo(csr: CSRMatrix) -> COOMatrix:
    rows = np.repeat(np.arange(csr.m, dtype=IDX_DTYPE), csr.degrees)
    return COOMatrix(rows, csr.col_idx.copy(), csr.values.copy(), csr.shape, csr.name)


def dense_to_csr(a: np.ndarray, name: str = "dense") -> CSRMatrix:
    rows, cols = np.nonzero(a)
    return coo_to_csr(
        COOMatrix(rows, cols, a[rows, cols], a.shape, name), sum_duplicates=False
    )


def random_csr(m: int, k: int, density: float, seed: int = 0,
               dtype=np.float32) -> CSRMatrix:
    """Uniform-random test matrix with standard-normal values."""
    rng = np.random.default_rng(seed)
    nnz = max(1, int(round(m * k * density)))
    flat = rng.choice(m * k, size=min(nnz, m * k), replace=False)
    rows = (flat // k).astype(IDX_DTYPE)
    cols = (flat % k).astype(IDX_DTYPE)
    vals = rng.standard_normal(len(flat)).astype(dtype)
    return coo_to_csr(COOMatrix(rows, cols, vals, (m, k), "random"),
                      sum_duplicates=False)
