"""Matrix files behind ``--matrix``: the port's own numpy readers of
``.mtx`` and ``.smtx`` (the JAX package's ``spgrid.io`` without its native
fast path), and their writers; ``io.openfoam`` reads OpenFOAM meshes as
LDU or CSR, as the JAX package's does."""

from __future__ import annotations

from spgrid_torch.io.mtx import read_mtx, write_mtx
from spgrid_torch.io.smtx import read_smtx, write_smtx


def read_matrix(path: str, dtype="float32"):
    """The CSR matrix of a ``.mtx`` or ``.smtx`` file, gzipped or not, its
    values in ``dtype`` ('float32', 'bfloat16' or 'float64')."""
    p = str(path)
    base = p[:-3] if p.endswith(".gz") else p
    if base.endswith(".smtx"):
        return read_smtx(path, dtype=dtype)
    if base.endswith(".mtx"):
        return read_mtx(path, dtype=dtype)
    raise ValueError(f"unrecognized matrix file type: {path}")


__all__ = ["read_matrix", "read_mtx", "read_smtx", "write_mtx", "write_smtx"]
