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

``DeviceCOO``, ``DeviceSELL``, ``DeviceELL``, ``DeviceCSC``, ``DeviceLDU``
and ``DeviceCV`` hold the same arrays as their counterparts in
``spgrid/ops/layouts.py``, padding included; ``spgrid_torch/ops/xla.py``
multiplies with them. Where the JAX op adds into rows with a segment sum or
a scatter, the port's layout also holds what its fixed-order row sums read:
COO keeps the row of each nnz as ``row_ptr``; CSC, LDU and CV add
``row_ptr`` (and CSC and LDU the permutation that takes their entries to
row order), so every row is summed in one fixed order and a call gives the
same bits every time.

A layout's values take the matrix's value type (``formats.csr.value_dtype``:
f32, f64, or bf16 for a bf16 matrix, whose f32 host values bf16 holds
exactly), as the JAX layouts keep the matrix's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from spgrid_torch.formats.bsr import csr_to_bsr
from spgrid_torch.formats.csc import CSCMatrix, csr_to_csc
from spgrid_torch.formats.csr import CSRMatrix, value_dtype
from spgrid_torch.formats.cv import CVMatrix, csr_to_cv
from spgrid_torch.formats.ell import csr_to_ell
from spgrid_torch.formats.ldu import LDUMatrix, csr_to_ldu
from spgrid_torch.formats.sell import csr_to_sell


class LayoutRefused(ValueError):
    """A layout does not take this matrix, by the same rule as the JAX
    package's layout (ELL past its padding limit, panels past their byte
    limit): the format does not apply to it."""


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def to_device(a, device, dtype=None) -> torch.Tensor:
    """A host array as a tensor on ``device``. ``np.array`` copies: leaves
    of JAX arrays are read-only views."""
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch type of a value type's name."""
    return TORCH_DTYPES[name]


def values_to_device(a, device, dtype: Optional[str]) -> torch.Tensor:
    """Host values as a tensor of the value type named ``dtype`` on
    ``device`` (bf16 from f32 numbers that bf16 holds: exact), or of their
    own type where ``dtype`` is None."""
    t = to_device(a, device)
    return t if dtype is None else t.to(torch_dtype(dtype))


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


# The bf16 BSR form's two routes (csrc/bsr_spmm.cu): a block row of (bm,
# bk) blocks holding at most ENTRY_ROUTE_MAX bm bk / 128^2 nonzero entries a
# block on average gives its entries to a row stream that a gather walk
# reads; the other block rows run the tensor-core tile over all their
# blocks. The same number stands as ENTRY_ROUTE_MAX in the .cu, with the
# sweep it came from.
ENTRY_ROUTE_MAX = 224
ROUTE_SLICE_ROWS = 128   # rows of a tile slice (ROWS of csrc/block_mma.cuh)
ROUTES = ("auto", "tile", "entry")


@dataclasses.dataclass
class BlockRoute:
    """The split of a bf16 ``DeviceBSR`` between the entry route and the
    tile route (``route_blocks``), by block row.

    Tile route: ``tile_slices`` lists the 128-row slices (block row r's
    s-th: ``r * ceil(bm / 128) + s``) of its block rows, which the tile
    kernel runs over all their blocks (``DeviceBSR.row_ptr``). Entry route:
    the nonzero entries of the other block rows' blocks (X row < k, output
    row < m), as a row stream (``slot_rows.stream_order``): ordered by
    output row, then block order, then column; row r's are
    ``row_slot[r]:row_slot[r + 1]``, each its value, its X row and its place
    in ``blocks`` (``slot_pos``, flat). ``walk_rows`` lists those rows (< m),
    which the entry kernel walks; ``long_rows`` those of them with more
    than ``slot_rows.LONG_ROW`` entries.
    """

    mode: str
    tile_slices: torch.Tensor   # (tile slices,) int32
    row_slot: torch.Tensor      # (m+1,) int32
    slot_vals: torch.Tensor     # (entries,) the blocks' type
    slot_xrows: torch.Tensor    # (entries,) int32
    slot_pos: torch.Tensor      # (entries,) int64
    walk_rows: torch.Tensor     # (walked rows,) int32
    long_rows: torch.Tensor     # (long rows,) int32
    tile_blocks: int            # blocks on the tile route
    entry_blocks: int           # blocks on the entry route

    @property
    def entries(self) -> int:
        return self.slot_vals.numel()

    def with_values(self, blocks: torch.Tensor) -> "BlockRoute":
        """The same split with the entries' values read from ``blocks``
        (the same sparsity), on the device: no host sync."""
        return dataclasses.replace(
            self, slot_vals=blocks.reshape(-1)[self.slot_pos])

    def __str__(self) -> str:
        return (f"route={self.mode} tile_blocks={self.tile_blocks} "
                f"tile_slices={self.tile_slices.numel()} "
                f"entry_blocks={self.entry_blocks} entries={self.entries} "
                f"walked_rows={self.walk_rows.numel()} "
                f"long_rows={self.long_rows.numel()}")


def entry_route_max(bm: int, bk: int) -> int:
    """The most nonzero entries a (bm, bk) block may hold on average in a
    block row on the entry route: ENTRY_ROUTE_MAX scaled to the block's
    area."""
    return ENTRY_ROUTE_MAX * bm * bk // (128 * 128)


def block_entries(csr: CSRMatrix, block_rows, block_cols, bm: int,
                  bk: int):
    """(b, i, j) of each nonzero of ``csr`` in the BSR layout whose (bm, bk)
    blocks sit at ``block_rows``, ``block_cols``: its block and its place
    there, in the order ``np.nonzero`` of the blocks gives (block, row,
    column), found from the CSR in O(nnz log nnz) rather than by a scan of
    every block's values."""
    rows = np.asarray(block_rows, np.int64)
    cols = np.asarray(block_cols, np.int64)
    kb = -(-csr.k // bk) + 1
    r = np.repeat(np.arange(csr.m, dtype=np.int64), csr.degrees)
    c = csr.col_idx.astype(np.int64)
    live = csr.values != 0
    r, c = r[live], c[live]
    keys = rows * kb + cols
    order = np.argsort(keys, kind="stable")
    b = order[np.searchsorted(keys[order], (r // bm) * kb + c // bk)]
    i, j = r % bm, c % bk
    sort = np.lexsort((j, i, b))
    return b[sort], i[sort], j[sort]


def route_blocks(block_rows, block_cols, blocks, mb: int, shape,
                 mode: str = "auto", *, device, dtype=None,
                 entries=None) -> BlockRoute:
    """The split of host blocks (nb, bm, bk) between the routes: ``mode``
    "auto" sends each block row whose real blocks (block row < mb) hold at
    most ``entry_route_max`` nonzero entries a block on average to the
    entry route, "tile" and "entry" send them all to one route (for tests
    and the A/B). Entries' values take the value type ``dtype`` on
    ``device``. ``entries``: the blocks' nonzeros as (b, i, j) in
    ``np.nonzero``'s order where the caller has them (``block_entries``),
    else found by a scan."""
    from spgrid_torch.ops.kernels.slot_rows import LONG_ROW, stream_order
    if mode not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {mode!r}")
    m, k = shape
    blocks = np.asarray(blocks)
    nb, bm, bk = blocks.shape
    rows = np.asarray(block_rows, np.int64)
    cols = np.asarray(block_cols, np.int64)
    real = rows < mb
    if mode == "tile":
        b = i = j = np.zeros(0, np.int64)
        entry_row = np.zeros(mb, bool)
    else:
        b, i, j = np.nonzero(blocks) if entries is None else entries
        if mode == "entry":
            entry_row = np.ones(mb, bool)
        else:
            counts = np.bincount(b, minlength=nb)[real]
            entry_row = (np.bincount(rows[real], counts, minlength=mb)
                         <= entry_route_max(bm, bk)
                         * np.bincount(rows[real], minlength=mb))
    entry = real & entry_row[np.minimum(rows, mb - 1)]
    slices = -(-bm // ROUTE_SLICE_ROWS)
    tile_slices = (np.flatnonzero(~entry_row)[:, None] * slices
                   + np.arange(slices)).reshape(-1)
    keep = entry[b]
    b, i, j = b[keep], i[keep], j[keep]
    out_row = rows[b] * bm + i
    xrow = cols[b] * bk + j
    inside = (out_row < m) & (xrow < k)
    b, i, j, out_row, xrow = (t[inside] for t in (b, i, j, out_row, xrow))
    vals = blocks[b, i, j]
    order, row_slot = stream_order(out_row, xrow, vals, m, k)
    walk_rows = np.flatnonzero(entry_row[np.arange(m) // bm])
    counts = np.diff(row_slot)
    return BlockRoute(
        mode=mode,
        tile_slices=to_device(tile_slices, device, np.int32),
        row_slot=to_device(row_slot, device, np.int32),
        slot_vals=values_to_device(vals[order], device, dtype),
        slot_xrows=to_device(xrow[order], device, np.int32),
        slot_pos=to_device(((b * bm + i) * bk + j)[order], device, np.int64),
        walk_rows=to_device(walk_rows, device, np.int32),
        long_rows=to_device(walk_rows[counts[walk_rows] > LONG_ROW], device,
                            np.int32),
        tile_blocks=int((real & ~entry).sum()),
        entry_blocks=int(entry.sum()))


def all_tile_route(a: "DeviceBSR") -> BlockRoute:
    """Every block row of ``a`` on the tile route, built on ``a``'s device
    (no host sync): the split of a layout that carries none."""
    dev = a.blocks.device
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    slices = -(-a.bm // ROUTE_SLICE_ROWS)
    return BlockRoute(
        mode="tile",
        tile_slices=torch.arange(a.mb * slices, dtype=torch.int32,
                                 device=dev),
        row_slot=torch.zeros(a.shape[0] + 1, dtype=torch.int32, device=dev),
        slot_vals=torch.zeros(0, dtype=a.blocks.dtype, device=dev),
        slot_xrows=none,
        slot_pos=torch.zeros(0, dtype=torch.int64, device=dev),
        walk_rows=none, long_rows=none, tile_blocks=a.num_blocks,
        entry_blocks=0)


@dataclasses.dataclass
class DeviceBSR:
    """Flattened block-sparse rows on a torch device, sorted by block row.

    ``block_rows[b]``/``block_cols[b]`` are the block-grid coordinates of the
    dense (bm, bk) block ``blocks[b]``; blocks of row r are
    ``row_ptr[r]:row_ptr[r+1]``. Pad blocks (to ``pad_multiple``) carry
    row = mb, col = 0 and zero values. A bf16 layout also carries
    ``route``, the split of its blocks between the bf16 kernel's two
    routes (``BlockRoute``; None at other types).
    """

    block_rows: torch.Tensor   # (nb_pad,) int32
    block_cols: torch.Tensor   # (nb_pad,) int32
    row_starts: torch.Tensor   # (mb+1,) int32, csr_to_bsr's pointer (JAX parity)
    row_ptr: torch.Tensor      # (mb+1,) int32, pointer into blocks
    blocks: torch.Tensor       # (nb_pad, bm, bk)
    shape: Tuple[int, int]     # logical (m, k)
    nnz: int
    num_blocks: int            # true block count, coverage blocks included
    route: Optional[BlockRoute] = None   # bf16 only

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
        """The same sparsity with other block values (the SDDMM output): a
        bf16 layout's route keeps its split and reads its entries' values
        from ``blocks`` (zero outside the sparsity, as the SDDMM's are)."""
        route = self.route
        if blocks.dtype == torch.bfloat16:
            route = (all_tile_route(self) if route is None
                     else route.with_values(blocks))
        return dataclasses.replace(self, blocks=blocks, route=route)

    @classmethod
    def from_arrays(cls, block_rows, block_cols, row_starts, blocks,
                    shape, nnz: int, num_blocks: int, *, device,
                    dtype: Optional[str] = None,
                    route: str = "auto", entries=None) -> "DeviceBSR":
        """Host arrays → device layout, the blocks of value type ``dtype``
        (their own where None); ``row_ptr`` is rebuilt from
        ``block_rows``. bf16 blocks are split between the bf16 kernel's
        routes (``route_blocks``, given the blocks' ``entries`` where the
        caller has them; ``route`` "tile" or "entry" forces one)."""
        mb = len(row_starts) - 1
        ptr = block_row_ptr(block_rows, mb)
        a = cls(
            block_rows=to_device(block_rows, device, np.int32),
            block_cols=to_device(block_cols, device, np.int32),
            row_starts=to_device(row_starts, device, np.int32),
            row_ptr=to_device(ptr, device),
            blocks=values_to_device(blocks, device, dtype),
            shape=tuple(shape),
            nnz=int(nnz),
            num_blocks=int(num_blocks),
        )
        if a.blocks.dtype == torch.bfloat16:
            a.route = route_blocks(block_rows, block_cols, blocks, mb, shape,
                                   route, device=device, dtype="bfloat16",
                                   entries=entries)
        return a

    @classmethod
    def from_csr(cls, csr: CSRMatrix, bm: int = 8, bk: int = 128,
                 pad_multiple: int = 1, *, device,
                 route: str = "auto") -> "DeviceBSR":
        rows, cols, row_starts, blocks, nb = bsr_arrays(
            csr, bm, bk, pad_multiple)
        entries = (block_entries(csr, rows, cols, bm, bk)
                   if value_dtype(csr) == "bfloat16" and route != "tile"
                   else None)
        return cls.from_arrays(rows, cols, row_starts, blocks, csr.shape,
                               csr.nnz, nb, device=device,
                               dtype=value_dtype(csr), route=route,
                               entries=entries)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@dataclasses.dataclass
class DeviceCOO:
    """Row-sorted COO on a torch device: columns and values padded to a
    multiple of ``pad_multiple`` entries with column 0 and value 0 (the JAX
    arrays, whose pad rows are the sacrificial row m), and the rows as
    ``row_ptr``, the CSR pointer of the nnz (the JAX ``rows`` are
    ``np.repeat(arange(m), diff(row_ptr))``, then m for each pad)."""

    row_ptr: torch.Tensor  # (m+1,) int64
    cols: torch.Tensor     # (nnz_pad,) int32
    values: torch.Tensor   # (nnz_pad,)
    shape: Tuple[int, int]
    nnz: int

    @property
    def nbytes(self) -> int:
        return nbytes(self.row_ptr, self.cols, self.values)

    @classmethod
    def from_csr(cls, csr: CSRMatrix, pad_multiple: int = 128, *,
                 device) -> "DeviceCOO":
        nnz_pad = round_up(max(csr.nnz, 1), pad_multiple)
        cols = np.zeros(nnz_pad, dtype=np.int32)
        vals = np.zeros(nnz_pad, dtype=csr.values.dtype)
        cols[: csr.nnz] = csr.col_idx
        vals[: csr.nnz] = csr.values
        return cls(to_device(csr.row_ptr, device, np.int64),
                   to_device(cols, device),
                   values_to_device(vals, device, value_dtype(csr)),
                   tuple(csr.shape), csr.nnz)


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
            bucket_vals=tuple(values_to_device(b.values, device,
                                               value_dtype(csr))
                              for b in sell.buckets),
            bucket_slice_rows=tuple(to_device(b.slice_rows, device)
                                    for b in sell.buckets),
            shape=tuple(csr.shape), nnz=csr.nnz, C=C)


def segment_ptr(owner: np.ndarray, segments: int) -> np.ndarray:
    """int64 pointer of length segments+1 over entries sorted by
    ``owner``."""
    counts = np.bincount(np.asarray(owner, np.int64), minlength=segments)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


@dataclasses.dataclass
class DeviceELL:
    """Padded ELL on a torch device: (m_pad, w) columns and values, rows
    padded to a multiple of ``row_multiple`` and the width to one of
    ``width_multiple``; a pad slot points at column 0 with value 0, so it
    adds nothing."""

    cols: torch.Tensor      # (m_pad, w) int32
    values: torch.Tensor    # (m_pad, w)
    shape: Tuple[int, int]
    nnz: int

    @property
    def nbytes(self) -> int:
        return nbytes(self.cols, self.values)

    @classmethod
    def from_csr(cls, csr: CSRMatrix, row_multiple: int = 8,
                 width_multiple: int = 8, max_bytes: int = 4 << 30, *,
                 device) -> "DeviceELL":
        """As ``spgrid.ops.layouts.DeviceELL.from_csr``: a matrix whose
        padding would pass ``max_bytes``, or waste 32x its nnz beyond 64 MB,
        raises (too skewed for ELL)."""
        width = int(np.diff(csr.row_ptr).max(initial=1))
        slots = csr.m * width
        est = slots * (4 + csr.values.dtype.itemsize)
        if est > max_bytes or (slots > 32 * max(csr.nnz, 1)
                               and est > 64 << 20):
            raise LayoutRefused(
                f"ELL padding would need {slots} slots for {csr.nnz} nnz "
                f"(~{est/2**30:.2f} GiB, width={width}); matrix too skewed "
                f"for ELL — use SELL-C-sigma or WCOO")
        ell = csr_to_ell(csr, pad_multiple=width_multiple)
        m_pad = round_up(csr.m, row_multiple)
        cols = np.zeros((m_pad, ell.width), dtype=np.int32)
        vals = np.zeros((m_pad, ell.width), dtype=csr.values.dtype)
        cols[: csr.m] = ell.cols
        vals[: csr.m] = ell.values
        return cls(to_device(cols, device),
                   values_to_device(vals, device, value_dtype(csr)),
                   tuple(csr.shape), csr.nnz)


@dataclasses.dataclass
class DeviceCSC:
    """Column-major COO on a torch device, the CSC traversal order: ``rows``
    and ``values`` in column order, ``cols`` non-decreasing, padded to a
    multiple of ``pad_multiple`` with row m, column 0, value 0 (the JAX
    arrays); and ``row_order``, the entries' indices in row order (a
    stable sort: columns ascending within a row), with ``row_ptr`` over
    them."""

    rows: torch.Tensor       # (nnz_pad,) int32, column-major order
    cols: torch.Tensor       # (nnz_pad,) int32, non-decreasing
    values: torch.Tensor     # (nnz_pad,)
    row_order: torch.Tensor  # (nnz,) int64
    row_ptr: torch.Tensor    # (m+1,) int64, into row_order
    shape: Tuple[int, int]
    nnz: int

    @property
    def nbytes(self) -> int:
        return nbytes(self.rows, self.cols, self.values, self.row_order,
                      self.row_ptr)

    @classmethod
    def from_csc(cls, csc: CSCMatrix, pad_multiple: int = 128, *,
                 device, dtype: Optional[str] = None) -> "DeviceCSC":
        nnz_pad = round_up(max(csc.nnz, 1), pad_multiple)
        rows = np.full(nnz_pad, csc.m, dtype=np.int32)
        cols = np.zeros(nnz_pad, dtype=np.int32)
        vals = np.zeros(nnz_pad, dtype=csc.values.dtype)
        rows[: csc.nnz] = csc.row_idx
        cols[: csc.nnz] = np.repeat(
            np.arange(csc.k, dtype=np.int32), csc.col_degrees)
        vals[: csc.nnz] = csc.values
        order = np.argsort(csc.row_idx, kind="stable")
        return cls(to_device(rows, device), to_device(cols, device),
                   values_to_device(vals, device, dtype),
                   to_device(order, device, np.int64),
                   to_device(segment_ptr(csc.row_idx, csc.m), device),
                   tuple(csc.shape), csc.nnz)

    @classmethod
    def from_csr(cls, csr: CSRMatrix, pad_multiple: int = 128, *,
                 device) -> "DeviceCSC":
        return cls.from_csc(csr_to_csc(csr), pad_multiple=pad_multiple,
                            device=device, dtype=value_dtype(csr))


@dataclasses.dataclass
class DeviceLDU:
    """LDU face lists on a torch device: pad faces carry owner = neigh =
    n_cells and zero values (the JAX arrays). ``owner_order`` and
    ``neigh_order`` list the real faces by owner and by neighbour (stable
    sorts: face order within a cell), with ``owner_ptr`` and ``neigh_ptr``
    over them."""

    owner: torch.Tensor        # (nf_pad,) int32
    neigh: torch.Tensor        # (nf_pad,) int32
    lower: torch.Tensor        # (nf_pad,)
    upper: torch.Tensor        # (nf_pad,)
    diag: torch.Tensor         # (n_cells,)
    owner_order: torch.Tensor  # (n_faces,) int64
    owner_ptr: torch.Tensor    # (n_cells+1,) int64, into owner_order
    neigh_order: torch.Tensor  # (n_faces,) int64
    neigh_ptr: torch.Tensor    # (n_cells+1,) int64, into neigh_order
    shape: Tuple[int, int]
    nnz: int
    n_faces: int

    @property
    def nbytes(self) -> int:
        return nbytes(self.owner, self.neigh, self.lower, self.upper,
                      self.diag, self.owner_order, self.owner_ptr,
                      self.neigh_order,
                      self.neigh_ptr)

    @classmethod
    def from_ldu(cls, ldu: LDUMatrix, pad_multiple: int = 128, *,
                 device, dtype: Optional[str] = None) -> "DeviceLDU":
        nf = ldu.n_faces
        nf_pad = round_up(max(nf, 1), pad_multiple)
        n = ldu.n_cells
        owner = np.full(nf_pad, n, dtype=np.int32)
        neigh = np.full(nf_pad, n, dtype=np.int32)
        lower = np.zeros(nf_pad, dtype=ldu.lower.dtype)
        upper = np.zeros(nf_pad, dtype=ldu.upper.dtype)
        owner[:nf] = ldu.owner
        neigh[:nf] = ldu.neigh
        lower[:nf] = ldu.lower
        upper[:nf] = ldu.upper
        return cls(to_device(owner, device), to_device(neigh, device),
                   values_to_device(lower, device, dtype),
                   values_to_device(upper, device, dtype),
                   values_to_device(ldu.diag, device, dtype),
                   to_device(np.argsort(ldu.owner, kind="stable"), device,
                             np.int64),
                   to_device(segment_ptr(ldu.owner, n), device),
                   to_device(np.argsort(ldu.neigh, kind="stable"), device,
                             np.int64),
                   to_device(segment_ptr(ldu.neigh, n), device),
                   ldu.shape, ldu.nnz, nf)

    @classmethod
    def from_csr(cls, csr: CSRMatrix, pad_multiple: int = 128, *,
                 device) -> "DeviceLDU":
        """Raises for a matrix that is not square or whose pattern is not
        symmetric (``csr_to_ldu``)."""
        return cls.from_ldu(csr_to_ldu(csr), pad_multiple=pad_multiple,
                            device=device, dtype=value_dtype(csr))


@dataclasses.dataclass
class DeviceCV:
    """Compressed-value COO on a torch device: int8 values with m+1 f32 row
    scales (the last 0, the pad entries' row m), or bf16 values with no
    scales; rows, columns and values padded to a multiple of
    ``pad_multiple`` with row m, column 0 and value 0 (the JAX arrays), and
    ``row_ptr``, the CSR pointer of the nnz, for the row sums."""

    rows: torch.Tensor      # (nnz_pad,) int32
    cols: torch.Tensor      # (nnz_pad,) int32
    qvalues: torch.Tensor   # (nnz_pad,) int8 | bfloat16
    scales: torch.Tensor    # (m+1,) f32 (int8) or (0,) (bf16)
    row_ptr: torch.Tensor   # (m+1,) int64
    shape: Tuple[int, int]
    nnz: int
    mode: str

    @property
    def nbytes(self) -> int:
        return nbytes(self.rows, self.cols, self.qvalues, self.scales,
                      self.row_ptr)

    @classmethod
    def from_cv(cls, cv: CVMatrix, pad_multiple: int = 128, *,
                device) -> "DeviceCV":
        nnz_pad = round_up(max(cv.nnz, 1), pad_multiple)
        rows = np.full(nnz_pad, cv.m, dtype=np.int32)
        cols = np.zeros(nnz_pad, dtype=np.int32)
        q = np.zeros(nnz_pad, dtype=cv.qvalues.dtype)
        rows[: cv.nnz] = np.repeat(np.arange(cv.m, dtype=np.int32),
                                   cv.degrees)
        cols[: cv.nnz] = cv.col_idx
        q[: cv.nnz] = cv.qvalues
        if cv.mode == "int8":
            scales = np.append(cv.scales, 0.0).astype(np.float32)
            qvalues = to_device(q, device)
        else:
            scales = np.zeros(0, dtype=np.float32)
            qvalues = to_device(q.view(np.int16), device).view(
                torch.bfloat16)
        return cls(to_device(rows, device), to_device(cols, device), qvalues,
                   to_device(scales, device),
                   to_device(cv.row_ptr, device, np.int64), tuple(cv.shape),
                   cv.nnz, cv.mode)

    @classmethod
    def from_csr(cls, csr: CSRMatrix, mode: str = "int8",
                 pad_multiple: int = 128, *, device) -> "DeviceCV":
        return cls.from_cv(csr_to_cv(csr, mode), pad_multiple=pad_multiple,
                           device=device)
