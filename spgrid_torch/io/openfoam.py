"""OpenFOAM LDU adjacency reader: the port's own copy of
``spgrid/io/openfoam.py`` (pinned to it by
``tests/test_torch_hostcopy.py``).

A mesh directory holds ``owner`` and ``neighbour`` files listing, per
internal face, the two adjacent cell ids. The matrix is the LDU pattern:
diagonal + one (lower, upper) pair per face; the values are synthetic (the
benchmark studies structure, not physics).
"""

from __future__ import annotations

import os

import numpy as np

from spgrid_torch.formats.csr import CSRMatrix, COOMatrix, coo_to_csr
from spgrid_torch.formats.ldu import LDUMatrix


def _read_openfoam_labels(path: str) -> np.ndarray:
    """Parse an OpenFOAM label list file: optional FoamFile header, then
    ``<count> ( v0 v1 ... )``."""
    with open(path) as f:
        text = f.read()
    lp = text.find("(")
    rp = text.rfind(")")
    if lp < 0 or rp < 0:
        raise ValueError(f"{path}: no label list found")
    return np.array(text[lp + 1:rp].split(), dtype=np.int64)


def read_openfoam_ldu(dirpath: str, dtype=np.float32,
                      value_fill: float = 1.0) -> LDUMatrix:
    """Read owner/neighbour directly into the LDU format, without CSR
    assembly."""
    owner = _read_openfoam_labels(os.path.join(dirpath, "owner"))
    neigh = _read_openfoam_labels(os.path.join(dirpath, "neighbour"))
    if len(owner) < len(neigh):
        raise ValueError("owner list shorter than neighbour list")
    owner = owner[: len(neigh)]
    n_cells = int(max(owner.max(initial=-1), neigh.max(initial=-1))) + 1
    # canonical face orientation: owner < neigh
    lo = np.minimum(owner, neigh)
    hi = np.maximum(owner, neigh)
    nf = len(lo)
    return LDUMatrix(
        owner=lo, neigh=hi,
        lower=np.full(nf, value_fill, dtype=dtype),
        upper=np.full(nf, value_fill, dtype=dtype),
        diag=np.full(n_cells, value_fill * 4, dtype=dtype),
        name=os.path.basename(os.path.normpath(dirpath)))


def read_openfoam_matrix_dir(dirpath: str, dtype=np.float32,
                             value_fill: float = 1.0) -> CSRMatrix:
    owner = _read_openfoam_labels(os.path.join(dirpath, "owner"))
    neigh = _read_openfoam_labels(os.path.join(dirpath, "neighbour"))
    if len(owner) < len(neigh):
        raise ValueError("owner list shorter than neighbour list")
    owner = owner[: len(neigh)]
    n_cells = int(max(owner.max(initial=-1), neigh.max(initial=-1))) + 1
    diag = np.arange(n_cells, dtype=np.int64)
    rows = np.concatenate([diag, owner, neigh])
    cols = np.concatenate([diag, neigh, owner])
    vals = np.full(len(rows), value_fill, dtype=dtype)
    # diagonal dominant-ish values for a meaningful oracle
    vals[:n_cells] = value_fill * 4
    return coo_to_csr(
        COOMatrix(rows, cols, vals, (n_cells, n_cells),
                  name=os.path.basename(os.path.normpath(dirpath))),
        sum_duplicates=True)
