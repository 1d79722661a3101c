"""BSR: the dense (bm x bk) tiles of a CSR matrix that hold a nonzero.

The port's copy of ``csr_to_bsr`` from ``spgrid/formats/bsr.py`` (its numpy
path; the JAX package's optional native C++ path gives the same arrays).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from spgrid_torch.formats.csr import IDX_DTYPE


@dataclasses.dataclass
class BSRMatrix:
    block_row_ptr: np.ndarray   # (mb+1,) int32
    block_col_idx: np.ndarray   # (nb,)   int32 — block-column of each block
    blocks: np.ndarray          # (nb, bm, bk) dtype — dense block values
    shape: Tuple[int, int]      # logical (m, k), pre-padding
    nnz: int                    # true scalar nnz (flop accounting)
    name: str = "bsr"

    @property
    def mb(self) -> int:
        return len(self.block_row_ptr) - 1

    @property
    def num_blocks(self) -> int:
        return self.blocks.shape[0]


def csr_to_bsr(csr, bm: int = 8, bk: int = 128) -> BSRMatrix:
    """Densify every (bm x bk) tile of ``csr`` that contains a nonzero;
    blocks are sorted by (block row, block column)."""
    m, k = csr.shape
    mb = -(-m // bm)
    kb = -(-k // bk)
    rows = np.repeat(np.arange(m, dtype=np.int64), csr.degrees)
    cols = csr.col_idx.astype(np.int64)
    key = (rows // bm) * kb + cols // bk
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq = np.unique(key_s)

    blocks = np.zeros((len(uniq), bm, bk), dtype=csr.values.dtype)
    block_of = np.searchsorted(uniq, key_s)
    blocks[block_of, rows[order] % bm, cols[order] % bk] = csr.values[order]

    block_row_ptr = np.zeros(mb + 1, dtype=np.int64)
    np.add.at(block_row_ptr, uniq // kb + 1, 1)
    return BSRMatrix(
        block_row_ptr=np.cumsum(block_row_ptr).astype(IDX_DTYPE),
        block_col_idx=(uniq % kb).astype(IDX_DTYPE),
        blocks=blocks,
        shape=csr.shape,
        nnz=csr.nnz,
        name=csr.name,
    )
