"""Device layouts of the port built from host formats.

``DeviceBSR`` holds the same arrays as ``spgrid.ops.layouts.DeviceBSR``
element for element — the zero coverage block inserted for each empty block
row and the pad blocks at row ``mb`` included — plus ``row_ptr``, a
block-row pointer into ``blocks``.

``row_starts`` is ``csr_to_bsr``'s block-row pointer, which the JAX layout
stores as it is. It does not count the coverage blocks, so wherever a block
row is empty it no longer indexes ``blocks``; the JAX kernels never read it.
It is kept only as the counterpart of the JAX field. Kernels walk
``row_ptr``, which is rebuilt from ``block_rows``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from spgrid.formats.bsr import csr_to_bsr
from spgrid.formats.csr import CSRMatrix


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def block_row_ptr(block_rows: np.ndarray, mb: int) -> np.ndarray:
    """Pointer of length mb+1 into row-sorted blocks; pad blocks (row = mb)
    lie past its end."""
    rows = np.asarray(block_rows)
    counts = np.bincount(rows[rows < mb], minlength=mb)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def bsr_arrays(csr: CSRMatrix, bm: int, bk: int, pad_multiple: int = 1):
    """Host arrays of the BSR layout, as ``spgrid.ops.layouts.DeviceBSR.
    from_csr`` builds them: (block_rows, block_cols, row_starts, blocks,
    num_blocks)."""
    bsr = csr_to_bsr(csr, bm=bm, bk=bk)
    brows = np.repeat(np.arange(bsr.mb, dtype=np.int32),
                      np.diff(bsr.block_row_ptr))
    empty = np.setdiff1d(np.arange(bsr.mb, dtype=np.int32), brows)
    nb = bsr.num_blocks + len(empty)
    nb_pad = round_up(max(nb, 1), pad_multiple)
    rows = np.full(nb_pad, bsr.mb, dtype=np.int32)
    cols = np.zeros(nb_pad, dtype=np.int32)
    blocks = np.zeros((nb_pad, bm, bk), dtype=csr.values.dtype)
    # one zero block per empty block row, merged in row order
    allr = np.concatenate([brows, empty])
    order = np.argsort(allr, kind="stable")
    rows[:nb] = allr[order]
    cols[:nb] = np.concatenate(
        [bsr.block_col_idx, np.zeros(len(empty), np.int32)])[order]
    blocks[:nb] = np.concatenate(
        [bsr.blocks, np.zeros((len(empty), bm, bk), bsr.blocks.dtype)])[order]
    row_starts = np.asarray(bsr.block_row_ptr, dtype=np.int32)
    return rows, cols, row_starts, blocks, nb


@dataclasses.dataclass
class DeviceBSR:
    """Flattened block-sparse rows on a torch device, sorted by block row.

    ``block_rows[b]``/``block_cols[b]`` are the block-grid coordinates of the
    dense (bm, bk) block ``blocks[b]``; blocks of row r are
    ``row_ptr[r]:row_ptr[r+1]``. Pad blocks (to ``pad_multiple``) carry
    row = mb, col = 0 and zero values.
    """

    block_rows: torch.Tensor   # (nb_pad,) int32
    block_cols: torch.Tensor   # (nb_pad,) int32
    row_starts: torch.Tensor   # (mb+1,) int32, csr_to_bsr's pointer (JAX parity)
    row_ptr: torch.Tensor      # (mb+1,) int32, pointer into blocks
    blocks: torch.Tensor       # (nb_pad, bm, bk)
    shape: Tuple[int, int]     # logical (m, k)
    nnz: int
    num_blocks: int            # true block count, coverage blocks included

    @property
    def bm(self) -> int:
        return self.blocks.shape[1]

    @property
    def bk(self) -> int:
        return self.blocks.shape[2]

    @property
    def mb(self) -> int:
        return len(self.row_ptr) - 1

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.block_rows, self.block_cols, self.row_ptr, self.blocks))

    def with_blocks(self, blocks: torch.Tensor) -> "DeviceBSR":
        """The same sparsity with other block values (the SDDMM output)."""
        return dataclasses.replace(self, blocks=blocks)

    @classmethod
    def from_arrays(cls, block_rows, block_cols, row_starts, blocks,
                    shape, nnz: int, num_blocks: int, *,
                    device) -> "DeviceBSR":
        """Host arrays → device layout; ``row_ptr`` is rebuilt from
        ``block_rows``."""
        mb = len(row_starts) - 1
        ptr = block_row_ptr(block_rows, mb)

        def put(a, dtype=None):
            # np.array copies: leaves of JAX arrays are read-only views
            return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

        return cls(
            block_rows=put(block_rows, np.int32),
            block_cols=put(block_cols, np.int32),
            row_starts=put(row_starts, np.int32),
            row_ptr=put(ptr),
            blocks=put(blocks),
            shape=tuple(shape),
            nnz=int(nnz),
            num_blocks=int(num_blocks),
        )

    @classmethod
    def from_csr(cls, csr: CSRMatrix, bm: int = 8, bk: int = 128,
                 pad_multiple: int = 1, *, device) -> "DeviceBSR":
        rows, cols, row_starts, blocks, nb = bsr_arrays(
            csr, bm, bk, pad_multiple)
        return cls.from_arrays(rows, cols, row_starts, blocks, csr.shape,
                               csr.nnz, nb, device=device)
