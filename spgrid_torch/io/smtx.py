"""DLMC .smtx reader and writer: the port's own copy of the numpy path of
``spgrid/io/smtx.py``.

Line 1 is "m, k, nnz", line 2 the m+1 row pointers, line 3 the nnz column
indices. The files hold no values: they are filled with seeded uniform
values in [0.5, 1.5) by default, or with a constant.
"""

from __future__ import annotations

import gzip

import numpy as np

from spgrid_torch.formats.csr import (
    BF16, CSRMatrix, IDX_DTYPE, cast_values, dtype_name,
)
from spgrid_torch.io.mtx import _basename


def read_smtx(path: str, dtype=np.float32, value_fill: str = "random",
              seed: int = 14) -> CSRMatrix:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        head = f.readline().replace(",", " ").split()
        m, k, nnz = int(head[0]), int(head[1]), int(head[2])
        row_ptr = np.array(f.readline().split(), dtype=np.int64)
        col_idx = np.array(f.readline().split(), dtype=IDX_DTYPE) \
            if nnz else np.zeros(0, dtype=IDX_DTYPE)
    if len(row_ptr) != m + 1:
        raise ValueError(f"{path}: row_ptr length {len(row_ptr)} != m+1={m + 1}")
    if row_ptr[-1] != nnz or len(col_idx) != nnz:
        raise ValueError(f"{path}: nnz mismatch ({row_ptr[-1]} vs {nnz} vs "
                         f"{len(col_idx)})")
    if value_fill == "random":
        rng = np.random.default_rng(seed)
        vals = cast_values(rng.random(nnz) + 0.5, dtype)
    else:
        vals = cast_values(np.full(nnz, float(value_fill)), dtype)
    return CSRMatrix(row_ptr.astype(IDX_DTYPE), col_idx, vals, (m, k),
                     name=_basename(path), bf16=dtype_name(dtype) == BF16)


def write_smtx(path: str, csr: CSRMatrix) -> None:
    with open(path, "w") as f:
        f.write(f"{csr.m}, {csr.k}, {csr.nnz}\n")
        f.write(" ".join(str(int(v)) for v in csr.row_ptr) + "\n")
        f.write(" ".join(str(int(v)) for v in csr.col_idx) + "\n")
