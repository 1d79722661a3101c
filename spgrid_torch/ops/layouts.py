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

``DeviceCOO`` and ``DeviceSELL`` hold the same arrays as their counterparts
in ``spgrid/ops/layouts.py``, padding included; ``spgrid_torch/ops/xla.py``
multiplies with them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from spgrid_torch.formats.bsr import csr_to_bsr
from spgrid_torch.formats.csr import CSRMatrix
from spgrid_torch.formats.sell import csr_to_sell


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def to_device(a, device, dtype=None) -> torch.Tensor:
    """A host array as a tensor on ``device``. ``np.array`` copies: leaves
    of JAX arrays are read-only views."""
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def group_ptr(owner: np.ndarray, owners: int):
    """(ptr, members): the indices of the entries of ``owner`` that hold each
    value 0 .. owners-1, in index order, as ``members[ptr[o]:ptr[o + 1]]``.
    Entries whose owner lies outside that range belong to none."""
    owner = np.asarray(owner, np.int64)
    idx = np.flatnonzero((owner >= 0) & (owner < owners))
    members = idx[np.argsort(owner[idx], kind="stable")].astype(np.int32)
    counts = np.bincount(owner[idx], minlength=owners)
    return (np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
            members)


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
        return cls(
            block_rows=to_device(block_rows, device, np.int32),
            block_cols=to_device(block_cols, device, np.int32),
            row_starts=to_device(row_starts, device, np.int32),
            row_ptr=to_device(ptr, device),
            blocks=to_device(blocks, device),
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@dataclasses.dataclass
class DeviceCOO:
    """Row-sorted COO on a torch device, padded to a multiple of
    ``pad_multiple`` entries with row m, column 0 and value 0: a pad entry
    adds 0 to the sacrificial row m."""

    rows: torch.Tensor     # (nnz_pad,) int32
    cols: torch.Tensor     # (nnz_pad,) int32
    values: torch.Tensor   # (nnz_pad,)
    shape: Tuple[int, int]
    nnz: int

    @property
    def nbytes(self) -> int:
        return nbytes(self.rows, self.cols, self.values)

    @classmethod
    def from_csr(cls, csr: CSRMatrix, pad_multiple: int = 128, *,
                 device) -> "DeviceCOO":
        nnz_pad = round_up(max(csr.nnz, 1), pad_multiple)
        rows = np.full(nnz_pad, csr.m, dtype=np.int32)
        cols = np.zeros(nnz_pad, dtype=np.int32)
        vals = np.zeros(nnz_pad, dtype=csr.values.dtype)
        rows[: csr.nnz] = np.repeat(np.arange(csr.m, dtype=np.int32),
                                    csr.degrees)
        cols[: csr.nnz] = csr.col_idx
        vals[: csr.nnz] = csr.values
        return cls(to_device(rows, device), to_device(cols, device),
                   to_device(vals, device), tuple(csr.shape), csr.nnz)


@dataclasses.dataclass
class DeviceSELL:
    """SELL-C-sigma on a torch device: each width bucket's (s, C, w) columns
    and values and its slices' first slots, and ``perm`` (m_pad,): the
    original row of slot i. Pad slots m .. m_pad-1 hold the unique rows
    m .. m_pad-1, so the unpermute never collides with a real row. The
    buckets' slices cover every slot once."""

    perm: torch.Tensor              # (m_pad,) int32
    bucket_cols: tuple              # of (s, C, w) int32
    bucket_vals: tuple              # of (s, C, w)
    bucket_slice_rows: tuple        # of (s,) int32, a slice's first slot
    shape: Tuple[int, int]
    nnz: int
    C: int

    @property
    def nbytes(self) -> int:
        return nbytes(self.perm, *self.bucket_cols, *self.bucket_vals,
                      *self.bucket_slice_rows)

    @classmethod
    def from_csr(cls, csr: CSRMatrix, C: int = 8, sigma: int = 256, *,
                 device) -> "DeviceSELL":
        sell = csr_to_sell(csr, C=C, sigma=sigma)
        m_pad = round_up(csr.m, C)
        perm = np.arange(m_pad, dtype=np.int32)
        perm[: csr.m] = sell.perm
        return cls(
            perm=to_device(perm, device),
            bucket_cols=tuple(to_device(b.cols, device)
                              for b in sell.buckets),
            bucket_vals=tuple(to_device(b.values, device)
                              for b in sell.buckets),
            bucket_slice_rows=tuple(to_device(b.slice_rows, device)
                                    for b in sell.buckets),
            shape=tuple(csr.shape), nnz=csr.nnz, C=C)
