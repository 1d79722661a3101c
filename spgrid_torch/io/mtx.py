"""MatrixMarket (.mtx) reader: the port's own copy of the numpy path of
``spgrid/io/mtx.py``, with the same semantics: real, integer, complex
(magnitude) and pattern fields; general, symmetric, skew-symmetric and
hermitian symmetry, expanded; coordinate and dense array bodies. A
``dtype`` of 'bfloat16' reads bf16 values (``formats.csr.cast_values``),
duplicates summed in f64 and rounded once, as the JAX package's reader
does.
"""

from __future__ import annotations

import gzip
import numpy as np

from spgrid_torch.formats.csr import (
    BF16, CSRMatrix, COOMatrix, cast_values, coo_to_csr, dtype_name,
)


def _open(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_mtx_coo(
    path: str,
    expand_symmetry: bool = True,
    pattern_dummy_value: float = 1.0,
    dtype=np.float32,
) -> COOMatrix:
    with _open(path) as f:
        header = f.readline().strip()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError(f"not a MatrixMarket file: {path}")
        parts = header.lower().split()
        if len(parts) < 5 or parts[1] != "matrix" \
                or parts[2] not in ("coordinate", "array"):
            raise ValueError(f"unsupported MatrixMarket header: {header}")
        fmt, field, symmetry = parts[2], parts[3], parts[4]
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        if fmt == "array":
            # dense array format (several SuiteSparse validation matrices
            # ship this way): values column-major, one per line
            m, n = (int(tok) for tok in line.split())
            body = np.loadtxt(f, dtype=np.float64, ndmin=2,
                              max_rows=m * n)
            vals = (np.hypot(body[:, 0], body[:, 1]) if field == "complex"
                    else body[:, 0] if body.ndim == 2 else body)
            if vals.size != m * n and symmetry == "general":
                raise ValueError(f"{path}: array body has {vals.size} "
                                 f"values, expected {m * n}")
            if symmetry == "general":
                dense = vals.reshape(n, m).T
            else:
                # MM spec: symmetric/hermitian array files store the lower
                # triangle including the diagonal; skew-symmetric files
                # store the STRICTLY lower triangle (diagonal omitted —
                # it is identically zero)
                dense = np.zeros((m, n))
                diag_off = -1 if symmetry == "skew-symmetric" else 0
                tri = np.tril_indices(m, diag_off)
                order = np.lexsort((tri[0], tri[1]))   # column-major walk
                dense[tri[0][order], tri[1][order]] = vals
                sign = -1.0 if symmetry == "skew-symmetric" else 1.0
                dense = dense + sign * np.tril(dense, -1).T
            rr, cc = np.nonzero(dense)
            return COOMatrix(rr, cc, cast_values(dense[rr, cc], dtype), (m, n),
                             name=_basename(path))
        m, n, nnz = (int(tok) for tok in line.split())

        # Bulk-parse the body.
        body = np.loadtxt(f, dtype=np.float64, ndmin=2, max_rows=nnz) \
            if nnz else np.zeros((0, 3))

    if nnz and body.shape[0] != nnz:
        raise ValueError(f"{path}: expected {nnz} entries, got {body.shape[0]}")
    rows = body[:, 0].astype(np.int64) - 1
    cols = body[:, 1].astype(np.int64) - 1
    if field == "pattern":
        vals = np.full(len(rows), pattern_dummy_value, dtype=np.float64)
    elif field == "complex":
        # magnitude, like typical real-benchmark treatment of complex inputs
        vals = np.hypot(body[:, 2], body[:, 3])
    else:
        vals = body[:, 2]

    if symmetry in ("symmetric", "skew-symmetric", "hermitian") and expand_symmetry:
        off = rows != cols
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        rows = np.concatenate([rows, cols[off]])
        cols2 = np.concatenate([cols, body[:, 0].astype(np.int64)[off] - 1])
        vals = np.concatenate([vals, sign * vals[off]])
        cols = cols2

    return COOMatrix(rows, cols, cast_values(vals, dtype), (m, n),
                     name=_basename(path))


def read_mtx(path: str, expand_symmetry: bool = True,
             pattern_dummy_value: float = 1.0,
             dtype=np.float32) -> CSRMatrix:
    csr = coo_to_csr(read_mtx_coo(path, expand_symmetry,
                                  pattern_dummy_value, dtype))
    return csr.astype(BF16) if dtype_name(dtype) == BF16 else csr


def _basename(path: str) -> str:
    import os
    b = os.path.basename(str(path))
    for suf in (".gz", ".mtx", ".smtx"):
        if b.endswith(suf):
            b = b[: -len(suf)]
    return b


def write_mtx(path: str, csr: CSRMatrix) -> None:
    """``csr`` as a general real coordinate MatrixMarket file (the JAX
    package's ``write_mtx``)."""
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{csr.m} {csr.k} {csr.nnz}\n")
        rows = np.repeat(np.arange(csr.m), csr.degrees)
        for r, c, v in zip(rows, csr.col_idx, csr.values):
            f.write(f"{r + 1} {c + 1} {v:.9g}\n")
