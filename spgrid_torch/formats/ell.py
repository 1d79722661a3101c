"""ELL format: rows padded to equal length.

The port's own copy of ``spgrid/formats/ell.py`` (pinned to it by
``tests/test_torch_hostcopy.py``). Padding slots use column 0 with value 0,
so they add nothing to a gathered sum.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from spgrid_torch.formats.csr import CSRMatrix, IDX_DTYPE


@dataclasses.dataclass
class ELLMatrix:
    cols: np.ndarray       # (m, w) int32, padded with 0
    values: np.ndarray     # (m, w) dtype, padded with 0
    shape: Tuple[int, int]
    nnz: int               # true nnz (flops are counted on this)
    name: str = "ell"

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def width(self) -> int:
        return self.cols.shape[1]

    @property
    def mem_footprint(self) -> int:
        return self.cols.nbytes + self.values.nbytes


def csr_to_ell(csr: CSRMatrix, *, width: int | None = None,
               pad_multiple: int = 1) -> ELLMatrix:
    d = csr.degrees
    w = int(d.max()) if width is None else width
    if pad_multiple > 1:
        w = -(-max(w, 1) // pad_multiple) * pad_multiple
    w = max(w, 1)
    if (d > w).any():
        raise ValueError(f"width {w} < max degree {int(d.max())}")
    cols = np.zeros((csr.m, w), dtype=IDX_DTYPE)
    vals = np.zeros((csr.m, w), dtype=csr.values.dtype)
    # Scatter nnz j of row i to slot j - row_ptr[i].
    rows = np.repeat(np.arange(csr.m), d)
    slots = np.arange(csr.nnz, dtype=np.int64) - np.repeat(csr.row_ptr[:-1].astype(np.int64), d)
    cols[rows, slots] = csr.col_idx
    vals[rows, slots] = csr.values
    return ELLMatrix(cols, vals, csr.shape, csr.nnz, csr.name)


def ell_to_csr(ell: ELLMatrix) -> CSRMatrix:
    mask = ell.values != 0
    # Column 0 entries with value 0 are padding; genuine zeros are dropped —
    # same as the reference ELL which stores explicit nnz only.
    rows, slots = np.nonzero(mask)
    row_ptr = np.zeros(ell.m + 1, dtype=np.int64)
    np.add.at(row_ptr, rows + 1, 1)
    return CSRMatrix(
        np.cumsum(row_ptr).astype(IDX_DTYPE),
        ell.cols[rows, slots],
        ell.values[rows, slots],
        ell.shape,
        ell.name,
    )
