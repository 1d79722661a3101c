"""Multi-row packed SpMV: y = A @ x with A in DeviceWPACK layout.

Counterpart of ``spgrid/ops/pallas/wpack_spmv.py`` (format ``wpack_spmv``);
the CUDA kernels are in ``spgrid_torch/csrc/wpack_spmv.cu``. ``wpack_spmv``
takes x (k,) and returns y (m,), x unpadded. It launches a kernel for CUDA
tensors and takes ``wpack_spmv_plain`` only for CPU tensors.

The default kernel reads the layout's live-slot stream
(``DeviceWPACK.slot_*``, ``ops/kernels/slot_stream.py``): piece by piece,
the live lanes (value not 0, x index inside x), which are the piece's first
lanes in packing order, sorted by target row; each with its value, its x
index and its row in the block. ``wpack_stream_plain`` is the product over
it. The ablation kernels read the padded pieces up to each piece's last
live lane (``DeviceWPACK.piece_lanes``), a warp a piece, with W warps a CTA
(``launch_warps``; the rule, from the grid and the card's SMs, is held in
``csrc/wpack_spmv.cu``).

Its ``ablate``/``prefix`` knobs are the JAX wrapper's, for the timing
ablation of ``scripts/exp_wpack_ablate.py``. ``prefix="direct"``, the
default and the only form the dispatch format ``wpack_spmv_cuda`` uses, is
the card's own design: each row's segment summed directly. ``"pad"`` and
``"roll"`` are the TPU's: the lane prefix P of the products p and the
difference P[end] - (P - p)[start] (``wpack_ablate``, counted under its own
name). ``ablate="noseg"`` adds p and ``"nogather"`` adds P at every lane,
wrong by design.

A piece is up to 128 nnz of one (128-row target block, wsel·128-column
window), in lanes sorted by target row; ``starts``/``ends`` give, for each
row of the block, the piece's lanes that hold that row (an absent row has
start 1, end 0). ``sel`` picks the 128-column sub-window of each lane, so
slot t of piece p reads x[(piece_w[p] + sel[p, t]) · 128 + cols[p, t]]. A
group is 8 pieces of one target block, and a block's groups are
consecutive.

At bf16 (``wpack_spmv_bf16``: a layout built from a bf16 matrix, bf16
values, x and y; the default knobs only) the form computes what the Pallas
body computes at the layout's wsel. At wsel 2 or 4 the body's products
start from f32 zeros, so products and sums are f32 on the bf16 operands
and y is rounded once: the bf16 row walk (``slot_stream.launch_row_walk``)
over the layout's row-ordered stream (``DeviceWPACK.row_*``, built for a
bf16 layout only: the live slots by output row and, within a row, in piece
and lane order). At wsel 1 its product is a bf16 multiply, and the lane
prefix and P - p run in bf16, each operation rounded (an absent row then
adds p[0] - (P[1] - p[1]), which bf16 need not round to 0), the difference
of the two takes stays f32, and the f32 sum of a group's 8 pieces is
rounded to bf16 and added into the f32 row: ``wpack_spmv_bf16_prefix``, a
kernel of its own, a warp a piece and a CTA ``groups_per_cta`` groups in
turn (``prefix_groups_per_cta``: the rule), the blocks that cross CTAs
combined by a second kernel (``csrc/wpack_spmv.cu``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from spgrid_torch.formats.csr import value_dtype
from spgrid_torch.ops.kernels import (
    _build, check_form, check_operands, runs_plain)
from spgrid_torch.ops.kernels.slot_rows import (
    add_groups_in_order, bf16_rounded, stream_order)
from spgrid_torch.ops.kernels.slot_stream import (
    check_row_stream, check_stream, launch_row_walk, launch_stream,
    live_slot_stream, row_bytes, sm_count, stream_product)
from spgrid_torch.ops.layouts import group_ptr, to_device, torch_dtype

LANE = 128
GROUP_PIECES = 8


def pick_wsel(csr) -> int:
    """The window width in 128-column units (1, 2 or 4), as ``spgrid.ops.
    pallas.wpack_spmv.pick_wsel`` chooses it: the narrowest whose mean nnz
    per occupied (128-row block, 128-column window) run is >= ~64."""
    m, k = csr.shape
    if csr.nnz == 0:
        return 1
    rows = np.repeat(np.arange(m, dtype=np.int64), csr.degrees)
    key = (rows // LANE) * (-(-k // LANE)) + csr.col_idx // LANE
    c_mean = csr.nnz / max(len(np.unique(key)), 1)
    if c_mean >= 64:
        return 1
    if c_mean >= 32:
        return 2
    return 4


def csr_to_wpack(csr, wsel: int | None = None):
    """Pack a CSR matrix into WPACK pieces and groups, as ``spgrid.ops.
    pallas.wpack_spmv.csr_to_wpack`` does.

    Returns (cols int8 (P, 128), vals (P, 128), ends int8 (P, 128), starts
    int8 (P, 128), sel int8 (P, 128), piece_w (P,), group_sub (G,),
    num_groups, utilization, wsel); P == 8 G, pieces padded per target block
    to a multiple of 8 (window 0, zero values, absent-row maps). piece_w is
    the piece's first 128-column window (window · wsel)."""
    m, k = csr.shape
    nnz = csr.nnz
    dt = csr.values.dtype
    if wsel is None:
        wsel = pick_wsel(csr)
    if nnz == 0:
        return (np.zeros((8, LANE), np.int8), np.zeros((8, LANE), dt),
                np.zeros((8, LANE), np.int8), np.ones((8, LANE), np.int8),
                np.zeros((8, LANE), np.int8), np.zeros(8, np.int32),
                np.zeros(1, np.int32), 1, 0.0, 1)
    wl = LANE * wsel
    rows = np.repeat(np.arange(m, dtype=np.int64), csr.degrees)
    cols = csr.col_idx.astype(np.int64)
    b = rows // LANE
    w = cols // wl
    order = np.lexsort((cols, rows, w, b))
    b, w, rows, cols = b[order], w[order], rows[order], cols[order]
    vals_s = csr.values[order]
    tr = (rows % LANE).astype(np.int64)
    off = cols % wl
    cw = (off % LANE).astype(np.int8)
    sel = (off // LANE).astype(np.int8)

    # pieces: <=128-nnz chunks of each (b, w) run
    nwin = -(-k // wl)
    bw_key = b * nwin + w
    runs, run_id, run_cnt = np.unique(bw_key, return_inverse=True,
                                      return_counts=True)
    run_start = np.concatenate([[0], np.cumsum(run_cnt)])[:-1]
    rank = np.arange(nnz, dtype=np.int64) - run_start[run_id]
    pieces_per_run = -(-run_cnt // LANE)
    run_piece0 = np.concatenate([[0], np.cumsum(pieces_per_run)])[:-1]
    pid = run_piece0[run_id] + rank // LANE
    lane = (rank % LANE).astype(np.int64)
    P0 = int(pieces_per_run.sum())
    p_b = (runs // nwin)[np.repeat(np.arange(len(runs)), pieces_per_run)]
    p_w = (runs % nwin)[np.repeat(np.arange(len(runs)), pieces_per_run)]

    # pieces padded per target block to a multiple of 8
    counts = np.bincount(p_b, minlength=int(b.max()) + 1)
    tot = counts + (-counts) % GROUP_PIECES
    G = int(tot.sum()) // GROUP_PIECES
    starts_out = np.concatenate([[0], np.cumsum(tot)])
    starts_in = np.concatenate([[0], np.cumsum(counts)])
    dest = starts_out[p_b] + (np.arange(P0) - starts_in[p_b])

    P = G * GROUP_PIECES
    cols_p = np.zeros((P, LANE), np.int8)
    vals_p = np.zeros((P, LANE), dt)
    ends_p = np.zeros((P, LANE), np.int8)
    starts_p = np.ones((P, LANE), np.int8)
    sel_p = np.zeros((P, LANE), np.int8)
    piece_w = np.zeros(P, np.int32)
    piece_w[dest] = p_w * wsel
    dpid = dest[pid]
    cols_p[dpid, lane] = cw
    vals_p[dpid, lane] = vals_s
    sel_p[dpid, lane] = sel

    # per-piece row-segment lane maps (lanes sorted by target row)
    first = np.ones(nnz, dtype=bool)
    first[1:] = (dpid[1:] != dpid[:-1]) | (tr[1:] != tr[:-1])
    last = np.ones(nnz, dtype=bool)
    last[:-1] = first[1:]
    starts_p[dpid[first], tr[first]] = lane[first]
    ends_p[dpid[last], tr[last]] = lane[last]

    group_sub = np.repeat(np.arange(len(tot), dtype=np.int32),
                          tot // GROUP_PIECES)
    util = nnz / (P * LANE)
    return (cols_p, vals_p, ends_p, starts_p, sel_p, piece_w, group_sub, G,
            util, wsel)


@dataclasses.dataclass
class DeviceWPACK:
    """``csr_to_wpack``'s flat arrays on a torch device, plus ``block_ptr``:
    the groups of target block b are ``block_ptr[b]:block_ptr[b + 1]``,
    and the live-slot stream that the default kernel reads. (The JAX layout
    pads groups to 128 and reshapes the metadata into rows of 8 steps for
    the TPU's scalar memory; the port keeps neither.)"""

    cols: torch.Tensor        # (P, 128) int8, col % 128 of each slot
    values: torch.Tensor      # (P, 128) f32 or bf16, 0 in pad slots
    ends: torch.Tensor        # (P, 128) int8, last lane of each row
    starts: torch.Tensor      # (P, 128) int8, first lane of each row
    sel: torch.Tensor         # (P, 128) int8, sub-window of each slot
    piece_w: torch.Tensor     # (P,) int32, first window of each piece
    piece_lanes: torch.Tensor  # (P,) uint8, last live lane + 1 (0: none)
    group_sub: torch.Tensor   # (G,) int32, target block of each group, sorted
    block_ptr: torch.Tensor   # (ceil(m / 128) + 1,) int32
    # the live-slot stream: S live slots in piece, then lane order
    slot_ptr: torch.Tensor    # (P + 1,) int32, piece p's live slots
    block_slot: torch.Tensor  # (blocks + 1,) int32, block b's live slots
    slot_vals: torch.Tensor   # (S,) value of each live slot
    slot_cols: torch.Tensor   # (S,) int32, x index of each live slot
    slot_rows: torch.Tensor   # (S,) uint8, row in the block | PIECE_START
    # a bf16 layout's row-ordered stream: the same S slots by row, then
    # piece and lane (empty for an f32 layout)
    row_slot: torch.Tensor    # (m + 1,) int32, row r's live slots
    row_vals: torch.Tensor    # (S,) bf16, value of each live slot
    row_cols: torch.Tensor    # (S,) int32, x index of each live slot
    shape: Tuple[int, int]
    nnz: int
    utilization: float
    num_groups: int
    wsel: int
    name: str = ""

    @property
    def blocks(self) -> int:
        return len(self.block_ptr) - 1

    @property
    def num_slots(self) -> int:
        return len(self.slot_vals)

    @property
    def stream_nbytes(self) -> int:
        """Bytes of what the default kernel reads of the layout: the
        stream's values, x indices, rows and block pointer."""
        return sum(t.numel() * t.element_size() for t in (
            self.block_slot, self.slot_vals, self.slot_cols, self.slot_rows))

    @property
    def row_nbytes(self) -> int:
        """Bytes of what the bf16 row walk reads of the layout: the row
        stream's values, x indices and row pointer."""
        return sum(t.numel() * t.element_size() for t in (
            self.row_slot, self.row_vals, self.row_cols))

    @property
    def nbytes(self) -> int:
        return self.stream_nbytes + self.row_nbytes + sum(
            t.numel() * t.element_size() for t in (
                self.cols, self.values, self.ends, self.starts, self.sel,
                self.piece_w, self.piece_lanes, self.block_ptr,
                self.slot_ptr))

    @classmethod
    def from_arrays(cls, cols, values, ends, starts, sel, piece_w, group_sub,
                    shape, nnz: int, utilization: float, num_groups: int,
                    wsel: int, name: str = "", *, device,
                    dtype: torch.dtype = torch.float32) -> "DeviceWPACK":
        """Flat host arrays → device layout, its values in ``dtype`` (f32,
        or bf16 for a matrix whose values are bf16); groups past
        ``num_groups`` (the JAX layout's padding) are dropped. The live-slot
        stream is built here, on the host, from the padded pieces: a live
        lane's row is the last present row whose first lane is at or before
        it (rows rise with the lane); and from it ``piece_lanes``, each
        piece's last live lane + 1 (0 for a piece with none), which bounds
        what the ablation kernels read; for a bf16 layout also the
        row-ordered stream, the live-slot stream stably sorted by output
        row (``slot_rows.stream_order``), which the bf16 row walk reads."""
        G = int(num_groups)
        sub = np.asarray(group_sub, np.int64).reshape(-1)[:G]
        if np.any(np.diff(sub) < 0):
            raise ValueError("wpack: groups must be sorted by target block")
        ptr, _ = group_ptr(sub, max(-(-shape[0] // LANE), 1))
        P = G * GROUP_PIECES
        cols, values, ends, starts, sel = (
            np.asarray(t)[:P] for t in (cols, values, ends, starts, sel))
        piece_w = np.asarray(piece_w).reshape(-1)[:P]
        colsel = sel.astype(np.int16) * LANE + cols
        piece, lane, x_index, slot_ptr, block_slot = live_slot_stream(
            values, colsel, piece_w, ptr, shape[1], GROUP_PIECES)
        # each present row's first lane, keyed by piece: rows, and so their
        # first lanes, rise within a piece
        seg_piece, seg_row = np.nonzero(starts <= ends)
        seg_key = seg_piece * LANE + starts[seg_piece, seg_row]
        seg = np.searchsorted(seg_key, piece * LANE + lane, side="right") - 1
        rows = seg_row[np.maximum(seg, 0)]
        filled = np.diff(slot_ptr) > 0
        piece_lanes = np.zeros(P, np.uint8)
        piece_lanes[filled] = lane[slot_ptr[1:][filled] - 1] + 1

        slot_vals = values[piece, lane]
        if dtype == torch.bfloat16:
            order, row_slot = stream_order(
                sub[piece // GROUP_PIECES] * LANE + rows, x_index, slot_vals,
                shape[0], shape[1])
        else:
            order, row_slot = np.zeros(0, np.int64), np.zeros(0, np.int32)

        def slots(a):
            return to_device(a, device, np.int8)

        return cls(cols=slots(cols),
                   values=to_device(values, device).to(dtype),
                   ends=slots(ends), starts=slots(starts), sel=slots(sel),
                   piece_w=to_device(piece_w, device, np.int32),
                   piece_lanes=to_device(piece_lanes, device),
                   group_sub=to_device(sub, device, np.int32),
                   block_ptr=to_device(ptr, device),
                   slot_ptr=to_device(slot_ptr, device),
                   block_slot=to_device(block_slot, device),
                   slot_vals=to_device(slot_vals, device).to(dtype),
                   slot_cols=to_device(x_index, device, np.int32),
                   slot_rows=to_device(row_bytes(rows, slot_ptr), device),
                   row_slot=to_device(row_slot, device),
                   row_vals=to_device(slot_vals[order], device).to(dtype),
                   row_cols=to_device(x_index[order], device, np.int32),
                   shape=tuple(shape), nnz=int(nnz),
                   utilization=float(utilization), num_groups=G,
                   wsel=int(wsel), name=name)

    @classmethod
    def from_csr(cls, csr, wsel: int | None = None, *,
                 device) -> "DeviceWPACK":
        (cols, vals, ends, starts, sel, pw, gsub, G, util,
         wsel) = csr_to_wpack(csr, wsel)
        return cls.from_arrays(cols, vals, ends, starts, sel, pw, gsub,
                               csr.shape, csr.nnz, util, G, wsel, csr.name,
                               device=device,
                               dtype=torch_dtype(value_dtype(csr)))


ABLATE = ("", "noseg", "nogather")
PREFIX = ("direct", "pad", "roll")
# kernel variant of each (ablate, prefix) but the direct product
VARIANTS = {("noseg", "pad"): 0, ("noseg", "roll"): 0, ("noseg", "direct"): 0,
            ("nogather", "pad"): 1, ("nogather", "roll"): 2,
            ("", "pad"): 3, ("", "roll"): 4}


def _check_knobs(ablate: str, prefix: str) -> None:
    if ablate not in ABLATE:
        raise ValueError(f"wpack_spmv: ablate must be one of {ABLATE}, got "
                         f"{ablate!r}")
    if prefix not in PREFIX:
        raise ValueError(f"wpack_spmv: prefix must be one of {PREFIX}, got "
                         f"{prefix!r}")
    if ablate == "nogather" and prefix == "direct":
        raise ValueError("wpack_spmv: ablate='nogather' keeps the lane "
                         "prefix; give prefix='pad' or 'roll'")


def _check(a: DeviceWPACK, x: torch.Tensor,
           dtype: torch.dtype = torch.float32) -> None:
    if x.dim() != 1 or x.shape[0] != a.shape[1]:
        raise ValueError(f"x must be ({a.shape[1]},), got {tuple(x.shape)}")
    check_operands("wpack_spmv", x.device, x=(x, dtype),
                   values=(a.values, dtype), cols=(a.cols, torch.int8),
                   ends=(a.ends, torch.int8), starts=(a.starts, torch.int8),
                   sel=(a.sel, torch.int8), piece_w=(a.piece_w, torch.int32),
                   piece_lanes=(a.piece_lanes, torch.uint8),
                   block_ptr=(a.block_ptr, torch.int32))
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"wpack_spmv: no kernel for device {x.device}")


def wpack_spmv(a: DeviceWPACK, x: torch.Tensor, *, ablate: str = "",
               prefix: str = "direct",
               slots_per_cta: int | None = None) -> torch.Tensor:
    """y (m,) = A @ x in x's dtype: f32 x (k,), or bf16 x for a bf16 layout
    (``wpack_spmv_bf16``, the default knobs only); other ``ablate``/
    ``prefix`` knobs than the default as the module says (the JAX wrapper's
    default prefix, "roll", has "direct" in its place here). The default
    kernel gives each CTA ``slots_per_cta`` consecutive live slots (None:
    one wave of the card, ``slot_stream.default_slots_per_cta``); the
    ablation kernels do not read it."""
    _check_knobs(ablate, prefix)
    check_form("wpack_spmv", x.dtype)
    if x.dtype == torch.bfloat16:
        if (ablate, prefix) != ("", "direct"):
            raise TypeError("wpack_spmv: the ablation forms have no bfloat16 "
                            "form (the JAX probe runs them at f32)")
        return wpack_spmv_bf16(a, x, slots_per_cta)
    _check(a, x)
    check_stream("wpack_spmv", a, x, slots_per_cta)
    if x.device.type == "cpu":
        return wpack_spmv_plain(a, x, ablate=ablate, prefix=prefix)
    if (ablate, prefix) != ("", "direct"):
        return wpack_ablate(a, x, VARIANTS[ablate, prefix])
    return launch_stream(wpack_spmv, a, x, slots_per_cta)


wpack_spmv.launches = 0


def wpack_spmv_bf16(a: DeviceWPACK, x: torch.Tensor,
                    slots_per_cta: int | None = None) -> torch.Tensor:
    """y (m,) bf16 = A @ x for a bf16 layout and bf16 x (k,), rounded where
    the Pallas body rounds at the layout's wsel (the module says where):
    the row walk at wsel 2 and 4 (``slots_per_cta`` as for f32); at wsel 1
    ``wpack_spmv_bf16_prefix``, which takes no ``slots_per_cta``."""
    if a.wsel == 1:
        if slots_per_cta is not None:
            raise ValueError("wpack_spmv_bf16: the wsel-1 form takes no "
                             "slots_per_cta")
        return wpack_spmv_bf16_prefix(a, x)
    _check(a, x, torch.bfloat16)
    check_row_stream("wpack_spmv_bf16", a, x, slots_per_cta)
    if runs_plain("wpack_spmv_bf16", x.device):
        return wpack_spmv_plain(a, x)
    return launch_row_walk(wpack_spmv_bf16, a, x, slots_per_cta)


wpack_spmv_bf16.launches = 0


def wpack_spmv_bf16_prefix(a: DeviceWPACK, x: torch.Tensor) -> torch.Tensor:
    """y (m,) bf16 = A @ x for a bf16 layout at wsel 1 and bf16 x (k,): the
    TPU body's bf16 lane prefix, a warp a piece, ``prefix_groups_per_cta``
    groups a CTA."""
    if a.wsel != 1:
        raise ValueError(f"wpack_spmv_bf16_prefix: the layout packs at wsel "
                         f"{a.wsel}, not 1")
    _check(a, x, torch.bfloat16)
    check_operands("wpack_spmv_bf16_prefix", x.device,
                   group_sub=(a.group_sub, torch.int32))
    if runs_plain("wpack_spmv_bf16_prefix", x.device):
        return wpack_spmv_plain(a, x)
    y = torch.empty((a.shape[0],), dtype=torch.bfloat16, device=x.device)
    if a.shape[0]:
        launch_prefix_bf16(a, x, y)
        wpack_spmv_bf16_prefix.launches += 1
    return y


wpack_spmv_bf16_prefix.launches = 0

# groups a CTA of the wsel-1 form: 1 to MAX_GROUPS_PER_CTA, a power of 2
GROUPS_PER_CTA = (1, 2, 4, 8, 16)
# CTAs of 8 warps an SM that the rule's grid aims at
PREFIX_CTAS_PER_SM = 4


def prefix_groups_per_cta(groups: int, sms: int) -> int:
    """The wsel-1 form's rule: the fewest groups a CTA (``GROUPS_PER_CTA``)
    that keep its grid of ceil(groups / groups a CTA) CTAs within one wave
    of ``PREFIX_CTAS_PER_SM`` CTAs on each of ``sms`` SMs (the largest
    where none does): every group runs at once where the card holds them,
    so the time is one group's chain, and the blocks' partials the combine
    adds stay few where it does not (the 512^2 twin's 104 groups: 1)."""
    for g in GROUPS_PER_CTA:
        if -(-groups // g) <= PREFIX_CTAS_PER_SM * max(sms, 1):
            return g
    return GROUPS_PER_CTA[-1]


def launch_prefix_bf16(a: DeviceWPACK, x: torch.Tensor, y: torch.Tensor,
                       groups_per_cta: int = 0) -> None:
    """One launch of the bf16 wsel-1 kernel and its combine into ``y``,
    uncounted, at ``groups_per_cta`` groups a CTA (``GROUPS_PER_CTA``; 0:
    ``prefix_groups_per_cta``'s for x's card); ``wpack_spmv`` is the entry
    point."""
    m, k = a.shape
    groups = a.num_groups
    if groups_per_cta == 0:
        groups_per_cta = prefix_groups_per_cta(groups, sm_count(x.device))
    if groups_per_cta not in GROUPS_PER_CTA:
        raise ValueError(f"wpack_spmv_bf16_prefix: groups_per_cta must be "
                         f"one of {GROUPS_PER_CTA}, got {groups_per_cta}")
    ctas = -(-groups // groups_per_cta)
    carry = torch.empty((ctas, 2, LANE), dtype=torch.float32,
                        device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _build.library().spgrid_wpack_spmv_bf16_prefix(
            a.block_ptr.data_ptr(), a.group_sub.data_ptr(),
            a.piece_w.data_ptr(), a.cols.data_ptr(), a.starts.data_ptr(),
            a.ends.data_ptr(), a.values.data_ptr(), x.data_ptr(),
            y.data_ptr(), carry.data_ptr(), groups_per_cta, groups,
            a.blocks, m, k, stream)
    _build.check(code, "wpack_spmv_bf16_prefix")


def wpack_ablate(a: DeviceWPACK, x: torch.Tensor,
                 variant: int) -> torch.Tensor:
    """Ablation ``variant`` (``VARIANTS``) of the WPACK body, over the
    padded pieces' live extent, on CUDA operands that ``wpack_spmv`` has
    checked; its launches are counted apart from the product's."""
    y = torch.empty((a.shape[0],), dtype=torch.float32, device=x.device)
    if a.shape[0]:
        launch(a, x, y, variant)
        wpack_ablate.launches += 1
    return y


wpack_ablate.launches = 0


def launch(a: DeviceWPACK, x: torch.Tensor, y: torch.Tensor, variant: int,
           warps: int = 0) -> None:
    """One launch of the ablation kernel into ``y``, uncounted, at W =
    ``warps`` warps a CTA (4, 8 or 16; 0: the rule's), for sweeps and
    tests; ``wpack_spmv`` is the entry point."""
    m, k = a.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _build.library().spgrid_wpack_ablate(
            a.block_ptr.data_ptr(), a.piece_w.data_ptr(),
            a.piece_lanes.data_ptr(), a.cols.data_ptr(), a.sel.data_ptr(),
            a.starts.data_ptr(), a.ends.data_ptr(), a.values.data_ptr(),
            x.data_ptr(), y.data_ptr(), variant, warps, a.blocks, m, k,
            stream)
    _build.check(code, "wpack_ablate")


def launch_warps(a: DeviceWPACK, warps: int = 0) -> int:
    """W, the warps a CTA (a warp a piece) that the ablation kernel takes
    for ``a`` at ``warps`` on the current card (0: the rule's, held in
    ``csrc/wpack_spmv.cu``: the fewest that give each SM 16 warps); raises
    for a W it has no form for."""
    out = ctypes.c_int(0)
    _build.check(_build.library().spgrid_wpack_ablate_warps(
        warps, a.blocks, ctypes.addressof(out)), "wpack_ablate")
    return out.value


def wpack_stream_plain(a: DeviceWPACK, x: torch.Tensor) -> torch.Tensor:
    """The product in plain torch over the live-slot stream, which the
    default kernel reads, in x's dtype (bf16: f32 products and sums, y
    rounded once, as at wsel 2 and 4)."""
    return stream_product(a, x)


def _products(a: DeviceWPACK, x: torch.Tensor):
    """(p (P, 128): value · x at each slot, 0 where the value is 0 or the x
    index lies past k; each piece's target block (P,))."""
    k = a.shape[1]
    xi = (a.piece_w.long()[:, None] + a.sel.long()) * LANE + a.cols.long()
    live = (a.values != 0) & (xi < k)
    p = torch.zeros(a.cols.shape, dtype=x.dtype, device=x.device)
    p[live] = a.values[live].to(x.dtype) * x[xi[live]]
    return p, a.group_sub.long().repeat_interleave(GROUP_PIECES)


def wpack_spmv_plain(a: DeviceWPACK, x: torch.Tensor, *, ablate: str = "",
                     prefix: str = "direct") -> torch.Tensor:
    """The same function in plain torch, in x's dtype.

    p is value · x[index] at each slot, 0 where the value is 0 or the x
    index lies at or past k. With the default knobs, the product without
    the prefix difference: each lane's row is the last present row whose
    first lane is at or before it (rows rise with the lane), and each slot
    a row owns adds p to that row (``index_add_``). Otherwise, the TPU
    body: p, its lane prefix P (``torch.cumsum``), and per piece and lane j
    the term p[j] (noseg), P[j] (nogather) or P[ends[j]] - (P - p)[starts[j]]
    (``take_along_dim``), summed into row 128 b + j of the piece's block b;
    rows past m are dropped. bf16 (the default knobs): at wsel 2 and 4 the
    default product in f32 on the bf16 operands, y rounded once; at wsel 1
    the TPU body rounded as it rounds (``_prefix_bf16_plain``)."""
    _check_knobs(ablate, prefix)
    if x.dtype == torch.bfloat16:
        if (ablate, prefix) != ("", "direct"):
            raise TypeError("wpack_spmv_plain: the ablation forms have no "
                            "bfloat16 form")
        if a.wsel == 1:
            return _prefix_bf16_plain(a, x)
        return wpack_spmv_plain(a, x.float()).to(x.dtype)
    m = a.shape[0]
    y = torch.zeros((m,), dtype=x.dtype, device=x.device)
    p, sub = _products(a, x)
    if (ablate, prefix) == ("", "direct"):
        starts, ends = a.starts.long(), a.ends.long()
        piece, row = torch.nonzero(starts <= ends, as_tuple=True)
        mark = torch.full(p.shape, -1, dtype=torch.long, device=x.device)
        mark[piece, starts[piece, row]] = row
        owner = torch.cummax(mark, dim=1).values
        owned = owner >= 0
        y.index_add_(0, (sub[:, None] * LANE + owner)[owned], p[owned])
        return y
    if ablate == "noseg":
        term = p
    else:
        P = torch.cumsum(p, dim=1)
        term = P if ablate == "nogather" else (
            torch.take_along_dim(P, a.ends.long(), dim=1)
            - torch.take_along_dim(P - p, a.starts.long(), dim=1))
    row = sub[:, None] * LANE + torch.arange(LANE, device=x.device)
    keep = row < m
    y.index_add_(0, row[keep], term[keep])
    return y


def prefix_bf16_terms(a: DeviceWPACK, x: torch.Tensor) -> torch.Tensor:
    """(P, 128) f32: the Pallas body's row terms at wsel 1 and bf16, in
    plain torch: p, each product rounded to bf16; its lane prefix P by
    ``_lane_prefix``'s 7 shift-adds, each rounded to bf16; P - p rounded to
    bf16; and for row j of each piece P[ends[j]] - (P - p)[starts[j]],
    kept f32."""
    p, _ = _products(a, x.float())
    p = bf16_rounded(p)
    P = p
    for sh in (1, 2, 4, 8, 16, 32, 64):
        shifted = torch.zeros_like(P)
        shifted[:, sh:] = P[:, :-sh]
        P = bf16_rounded(P + shifted)
    pex = bf16_rounded(P - p)
    return (torch.take_along_dim(P, a.ends.long(), dim=1)
            - torch.take_along_dim(pex, a.starts.long(), dim=1))


def _prefix_bf16_plain(a: DeviceWPACK, x: torch.Tensor) -> torch.Tensor:
    """The Pallas body at wsel 1 and bf16, in plain torch: the f32 sum of
    each group's 8 pieces' ``prefix_bf16_terms``, in piece order, rounded
    to bf16; the groups of a block added into its f32 rows in group order;
    y rounded once."""
    y2 = add_groups_in_order(
        prefix_bf16_terms(a, x).view(-1, GROUP_PIECES, LANE), a.group_sub,
        a.blocks)
    return y2.reshape(-1)[:a.shape[0]].to(x.dtype)
