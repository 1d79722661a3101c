"""The bf16 SpMV forms' work splits on the card, emulated in numpy on the CPU.

- The bf16 row walk (``csrc/slot_stream.cuh``'s ``row_walk`` and
  ``row_combine``), which ``wrow_spmv_v2_bf16`` and ``wpack_spmv_bf16`` at
  wsel 2 and 4 launch over the layouts' row-ordered streams: equal ranges
  of live slots a CTA, a stretch of whole 32-slot passes a warp, each
  lane's row from the 32 row ends after the pass's first row (or its own
  bisection where more rows end in the pass), runs of one row summed by a
  segmented shuffle scan, partials carried across passes, warps and
  ranges. The emulation takes the kernel's steps lane by lane in f32 and
  writes each row of y once (a row written twice or never fails); its y is
  within 1 bf16 ulp of ``stream_product`` and of the form's plain version,
  whose bits ``tests/test_torch_spmv_bf16.py`` pins to the Pallas
  kernels' interpret outputs, and the same bits on two calls.
- WPACK's row-ordered stream: its slots, keyed by (block, row, piece,
  lane), are the padded pieces' live slots.
- The wsel-1 form's split (``csrc/wpack_spmv.cu``'s
  ``wpack_prefix_bf16_kernel`` and the combine): a warp a piece, lanes t +
  32q in register q of thread t, the prefix's shifts as the kernel takes
  them, each group's 8 row terms summed in piece order and rounded: bit for
  bit the plain version's group sums at every ``groups_per_cta``, and y
  within 1 bf16 ulp of it.

Tolerance: 1 bf16 ulp of the plain value (the f32 sums run in another
order; the matrices' values are positive, so no sum cancels); 1e-30
absolutely, so exact zeros compare exactly.
"""

import numpy as np
import pytest
import torch

from spgrid_torch.entry import hypersparse_edge
from spgrid_torch.formats.csr import CSRMatrix, dense_to_csr
from spgrid_torch.gen import artificial_matrix_generation
from spgrid_torch.ops.kernels.slot_rows import group_sums
from spgrid_torch.ops.kernels.slot_stream import (
    default_slots_per_cta, stream_product,
)
from spgrid_torch.ops.kernels.wpack_spmv import (
    GROUPS_PER_CTA, DeviceWPACK, prefix_bf16_terms, prefix_groups_per_cta,
    wpack_spmv, wpack_spmv_plain,
)
from spgrid_torch.ops.kernels.wrow_spmv import (
    DeviceWROW, wrow_spmv, wrow_spmv_plain,
)

torch.set_num_threads(1)

LANE = 128
WARPS = 8                # a CTA of the row walk: 256 threads
INT_MAX = 2 ** 31 - 1
X_INDEX = 0x7FFFFFFF     # WROW's row_cols carry v1's group mark in bit 31


def positive(csr):
    return CSRMatrix(csr.row_ptr, csr.col_idx,
                     (np.abs(csr.values) + 0.1).astype(np.float32),
                     csr.shape, csr.name)


def straddle():
    """1200 x 1000, ~1 % scattered, and target block 2 (rows 256-383) half
    dense: rows of ~500 slots, across many ranges and warps' stretches."""
    rng = np.random.default_rng(30)
    d = np.where(rng.random((1200, 1000)) < 0.01,
                 rng.random((1200, 1000)) + 0.5, 0.0)
    band = rng.random((128, 1000))
    d[256:384] = np.where(band < 0.5, band + 0.5, 0.0)
    return dense_to_csr(d.astype(np.float32), name="straddle")


def long_row():
    """1000 x 3200, ~0.3 % scattered; rows 100-499 empty and row 700 full in
    its last 3,000 columns: a row across many ranges."""
    return hypersparse_edge(1000, 3200, density=0.003, empty=slice(100, 500),
                            heavy_row=700, heavy_nnz=3000, seed=31)


def scattered():
    """LINE_S's generator at 4000^2: ~20 scattered nnz a row in 90 % of the
    columns, so a 32-slot pass holds one to three runs."""
    return artificial_matrix_generation(
        4000, 4000, 20, 6.6667, "normal", seed=14, placement="random",
        bw=0.9, name="scattered")


MATRICES = {"straddle": straddle, "edge": hypersparse_edge,
            "long_row": long_row, "scattered": scattered}


def bf16_csr(make):
    return positive(make()).astype("bfloat16")


def operand(k, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.random(k) + 0.5).astype(np.float32)).to(torch.bfloat16)


def assert_within_one_ulp(got, want):
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.double(), want.double()
    assert torch.isfinite(g).all()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    assert ((g - w).abs() <= torch.maximum(ulp, torch.full_like(ulp, 1e-30))
            ).all()


def f32(v):
    return np.float32(v)


# --- the row walk -----------------------------------------------------------

def last_at_or_below(a, lo, hi, v):
    """The largest j in [lo, hi) with a[j] <= v (a nondecreasing,
    a[lo] <= v): ``warp_search`` and ``lane_search``."""
    return lo + int(np.searchsorted(a[lo:hi], v, side="right")) - 1


class RowWalk:
    """``row_walk`` and ``row_combine`` on host arrays, step for step: a
    pass's lanes are numpy vectors, every sum an f32 add in the kernel's
    order. ``y`` starts NaN and each write is counted."""

    def __init__(self, row_slot, vals, cols, x, per_cta):
        self.row_slot = np.asarray(row_slot, np.int64)
        self.vals = np.asarray(vals, np.float32)
        self.cols = np.asarray(cols, np.int64) & X_INDEX
        self.x = np.asarray(x, np.float32)
        self.per_cta = per_cta
        self.m = len(self.row_slot) - 1
        self.num_slots = len(self.vals)
        self.y = np.full(self.m, np.nan, np.float32)
        self.writes = np.zeros(self.m, np.int64)
        self.fast_passes = self.slow_passes = 0

    def write(self, row, value):
        self.y[row] = value
        self.writes[row] += 1

    def zero_empty_rows(self, start, upto):
        rs = self.row_slot
        for j in range(start, self.m):
            if rs[j + 1] > upto:
                break
            if rs[j] == rs[j + 1]:
                self.write(j, f32(0))

    @staticmethod
    def scan(values, run0):
        """The segmented Hillis-Steele scan: lane j adds lane j - d's value
        from before the step where j - d lies in its run."""
        lanes = np.arange(32)
        total = values.copy()
        for d in (1, 2, 4, 8, 16):
            up = np.concatenate([total[:d], total[:-d]])
            total = np.where(lanes - d >= run0, total + up, total
                             ).astype(np.float32)
        return total

    def warp(self, c, w, ws0, ws1):
        """One warp's stretch [ws0, ws1) in passes of 32 slots: (head
        partial, its row) or None, and whether its last row goes on, that
        row's partial and whether it began before ws0."""
        rs, m = self.row_slot, self.m
        lanes = np.arange(32)
        r = last_at_or_below(rs, 0, m, ws0)
        if w == 0:
            self.carry_row[c] = r
        self.zero_empty_rows(0 if ws0 == 0 else r + 1, ws1)
        open_sum, before, goes_on, head = f32(0), rs[r] < ws0, False, None
        for b in range(ws0, ws1, 32):
            valid = min(32, ws1 - b)
            s = b + lanes
            ok = lanes < valid
            sc = np.minimum(s, self.num_slots - 1)
            prod = np.where(ok, self.vals[sc] * self.x[self.cols[sc]],
                            f32(0)).astype(np.float32)
            idx = r + 1 + lanes
            end = np.where(idx <= m, rs[np.minimum(idx, m)], INT_MAX)
            ends = np.zeros(32, bool)   # lane j's slot is its row's last
            if end[31] > b + 32:
                self.fast_passes += 1
                # lane l writes row r + l where it ends in the pass
                d = end - b
                end_before = np.concatenate([end[:1], end[:-1]])
                ends[d[d <= valid] - 1] = True
                nxt = r + int((end <= b + 32).sum())
                writer = (d <= valid) & ((lanes == 0) | (end_before != end))
                wrow, src, first = r + lanes, np.minimum(d, 32) - 1, lanes == 0
            else:
                self.slow_passes += 1
                row = np.array([last_at_or_below(rs, r, m, int(v)) if o
                                else r for v, o in zip(s, ok)])
                writer = ok & (rs[np.minimum(row + 1, m)] == s + 1)
                ends = writer.copy()
                nxt = (last_at_or_below(rs, r, m, b + 32)
                       if b + 32 < ws1 else r)
                wrow, src, first = row, lanes, row == r
            heads = np.concatenate([[True], ends[:-1]])
            run0 = np.maximum.accumulate(np.where(heads, lanes, 0))
            total = self.scan(prod, run0)
            got = total[src]
            value = np.where(first, open_sum + got, got).astype(np.float32)
            for lane in np.flatnonzero(writer):
                if first[lane] and before:
                    head = (value[lane], int(wrow[lane]))
                else:
                    self.write(int(wrow[lane]), value[lane])
            tail = valid - 1
            goes_on = not ends[tail]
            tail_in_r = not ends[:tail].any()
            before = goes_on and before and tail_in_r
            open_sum = (f32(open_sum + total[tail]) if tail_in_r
                        else total[tail]) if goes_on else f32(0)
            r = nxt
        return head, goes_on, open_sum, before

    def run(self):
        if self.num_slots == 0:
            for j in range(self.m):
                self.write(j, f32(0))
            return self.y
        per = self.per_cta
        ctas = -(-self.num_slots // per)
        stretch = -(-(-(-per // WARPS)) // 32) * 32
        self.carry = np.full((ctas, 2), np.nan, np.float32)
        self.carry_row = np.full(ctas, -1, np.int64)
        for c in range(ctas):
            s0, s1 = c * per, min(self.num_slots, (c + 1) * per)
            run, run_before, chain = f32(0), True, False
            for w in range(WARPS):
                ws0 = min(s1, s0 + w * stretch)
                ws1 = min(s1, ws0 + stretch)
                if ws0 >= ws1:
                    break
                head, has_tail, tail, tail_before = self.warp(c, w, ws0, ws1)
                if head is not None:
                    total = f32(run + head[0])
                    if run_before:
                        self.carry[c, 0] = total
                    else:
                        self.write(head[1], total)
                if has_tail:
                    if tail_before:
                        run = f32(run + tail)
                    else:
                        run, run_before = tail, False
                chain = has_tail
            if chain:
                self.carry[c, 1] = run
        rs = self.row_slot
        for c in range(1, ctas):
            r = self.carry_row[c]
            bound = c * per
            if rs[r] >= bound or rs[r] < bound - per:
                continue
            c1 = (rs[r + 1] - 1) // per
            acc = f32(0)
            for k in range(c - 1, c1):
                acc = f32(acc + self.carry[k, 1])
            self.write(r, f32(acc + self.carry[c1, 0]))
        return self.y


def emulated(a, x, per_cta):
    """(y bf16, the walk): the row walk over ``a``'s row-ordered stream."""
    walk = RowWalk(a.row_slot.numpy(), a.row_vals.float().numpy(),
                   a.row_cols.numpy(), x.float().numpy(), per_cta)
    y = walk.run()
    assert (walk.writes == 1).all(), "each row of y is written once"
    return torch.from_numpy(y).to(torch.bfloat16), walk


FORMS = {
    "wrow_v2": (lambda c: DeviceWROW.from_csr(c, device="cpu"),
                lambda a, x: wrow_spmv_plain(a, x, variant="v2"),
                lambda a, x: wrow_spmv(a, x, variant="v2")),
    "wpack_wsel2": (lambda c: DeviceWPACK.from_csr(c, 2, device="cpu"),
                    wpack_spmv_plain, wpack_spmv),
    "wpack_wsel4": (lambda c: DeviceWPACK.from_csr(c, 4, device="cpu"),
                    wpack_spmv_plain, wpack_spmv),
}


@pytest.fixture(scope="module")
def layouts():
    """Each matrix at bf16 in each form's layout, with its x, built once."""
    out = {}
    for name, make in MATRICES.items():
        csr = bf16_csr(make)
        x = operand(csr.k, 3)
        for form, (build, _, _) in FORMS.items():
            out[name, form] = (build(csr), x)
    return out


# ranges: 7 and 100 (rows cut mid-run, stretches cut mid-pass), 1,000
# (warps' stretches of 128) and the card's rule (None); one slot a range
# (every row cut at every slot) on the two matrices of few slots
RANGES = (7, 100, 1000, None)
CASES = ([(m, r) for m in sorted(MATRICES) for r in RANGES]
         + [("edge", 1), ("long_row", 1)])


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("matrix,per_cta", CASES)
def test_row_walk_emulation_within_one_ulp(layouts, matrix, per_cta, form):
    """The walk's order of sums: every row written once, within 1 ulp of
    ``stream_product`` and of the form's plain version, the same bits on a
    second call."""
    a, x = layouts[matrix, form]
    if per_cta is None:
        per_cta = default_slots_per_cta(a.num_slots, 132)
    y, walk = emulated(a, x, per_cta)
    _, plain, call = FORMS[form]
    assert_within_one_ulp(y, stream_product(a, x))
    assert_within_one_ulp(y, plain(a, x))
    assert torch.equal(call(a, x), plain(a, x))   # the CPU runs the plain
    again, _ = emulated(a, x, per_cta)
    assert torch.equal(again, y)


def test_row_walk_takes_both_row_finders(layouts):
    """The window of 32 row ends serves LINE_S-like passes; the edge
    matrix's 256 empty rows send passes to the lanes' bisection."""
    a, x = layouts["scattered", "wrow_v2"]
    _, walk = emulated(a, x, 2048)
    assert walk.slow_passes == 0 and walk.fast_passes > 0
    a, x = layouts["edge", "wpack_wsel4"]
    _, walk = emulated(a, x, 64)
    assert walk.slow_passes > 0


def test_row_walk_on_an_empty_stream():
    """No live slot: y is all zeros, written once a row."""
    csr = CSRMatrix(np.zeros(301, np.int64), np.zeros(0, np.int32),
                    np.zeros(0, np.float32), (300, 200), "empty"
                    ).astype("bfloat16")
    a = DeviceWROW.from_csr(csr, device="cpu")
    y, _ = emulated(a, operand(200, 1), 1024)
    assert torch.equal(y, torch.zeros(300, dtype=torch.bfloat16))


def test_wpack_row_stream_expands_to_the_pieces(layouts):
    """WPACK's row-ordered stream holds the padded pieces' live slots: by
    (row, piece, lane) in order, each with its value and x index, and no
    stream for an f32 layout."""
    for matrix in ("straddle", "edge"):
        for form in ("wpack_wsel2", "wpack_wsel4"):
            a, _ = layouts[matrix, form]
            m, k = a.shape
            vals = a.values.float().numpy()
            xi = ((a.piece_w.numpy().astype(np.int64)[:, None]
                   + a.sel.numpy()) * LANE + a.cols.numpy().astype(np.uint8))
            piece, lane = np.nonzero((vals != 0) & (xi < k))
            starts = a.starts.numpy().astype(np.int64)
            ends = a.ends.numpy().astype(np.int64)
            owner = np.full(vals.shape, -1)
            seg_p, seg_r = np.nonzero(starts <= ends)
            for p_, r_ in zip(seg_p, seg_r):
                owner[p_, starts[p_, r_]:ends[p_, r_] + 1] = r_
            block = a.group_sub.numpy().astype(np.int64).repeat(8)[piece]
            row = block * LANE + owner[piece, lane]
            order = np.lexsort((lane, piece, row))
            row_slot = a.row_slot.numpy()
            np.testing.assert_array_equal(
                row_slot, np.concatenate([[0], np.cumsum(
                    np.bincount(row, minlength=m))]))
            np.testing.assert_array_equal(a.row_vals.float().numpy(),
                                          vals[piece, lane][order])
            np.testing.assert_array_equal(a.row_cols.numpy(),
                                          xi[piece, lane][order])
    a32 = DeviceWPACK.from_csr(positive(straddle()), 4, device="cpu")
    assert a32.row_slot.numel() == a32.row_vals.numel() == 0


# --- the wsel-1 form's split ------------------------------------------------

def bf16r(v):
    return torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16).float().numpy()


def prefix_split(a, x, groups_per_cta):
    """(each group's rounded sums (G, 128), y bf16): the wsel-1 kernel and
    its combine, a warp a piece in registers, in numpy."""
    k = a.shape[1]
    vals = a.values.float().numpy()
    xi = a.piece_w.numpy().astype(np.int64)[:, None] * LANE + a.cols.numpy(
        ).astype(np.uint8)
    xv = x.float().numpy()
    live = (vals != 0) & (xi < k)
    p = np.where(live, bf16r(vals * xv[np.minimum(xi, k - 1)]), 0
                 ).astype(np.float32)
    # thread t's register q holds lane t + 32q
    P = p.reshape(-1, 4, 32).copy()
    t = np.arange(32)
    for sh in (1, 2, 4, 8, 16):
        s = P[:, :, (t - sh) & 31]
        below = np.concatenate([np.zeros_like(s[:, :1]), s[:, :-1]], axis=1)
        u = np.where(t >= sh, s, below)
        P = bf16r(P + u)
    for sh in (1, 2):
        for q in range(3, -1, -1):
            if q >= sh:
                P[:, q] = bf16r(P[:, q] + P[:, q - sh])
            else:
                P[:, q] = bf16r(P[:, q] + 0.0)
    P = P.reshape(-1, LANE)
    pex = bf16r(P - p)
    term = (np.take_along_axis(P, a.ends.numpy().astype(np.int64), 1)
            - np.take_along_axis(pex, a.starts.numpy().astype(np.int64), 1)
            ).astype(np.float32).reshape(-1, 8, LANE)
    gsum = term[:, 0].copy()
    for r in range(1, 8):
        gsum = (gsum + term[:, r]).astype(np.float32)
    gsum = bf16r(gsum)
    G, per = a.num_groups, groups_per_cta
    sub, ptr = a.group_sub.numpy(), a.block_ptr.numpy()
    m = a.shape[0]
    y2 = np.full((a.blocks, LANE), np.nan, np.float32)
    ctas = -(-G // per)
    carry = np.full((ctas, 2, LANE), np.nan, np.float32)
    for c in range(ctas):
        g0, g1 = c * per, min(G, (c + 1) * per)
        acc, open_b = np.zeros(LANE, np.float32), sub[g0]

        def flush(b):
            if ptr[b] >= g0 and ptr[b + 1] <= g1:
                y2[b] = acc
            else:
                carry[c, int(ptr[b + 1] > g1)] = acc

        for g in range(g0, g1):
            if sub[g] != open_b:
                flush(open_b)
                acc, open_b = np.zeros(LANE, np.float32), sub[g]
            acc = (acc + gsum[g]).astype(np.float32)
        flush(open_b)
    for b in range(a.blocks):
        first, last = ptr[b], ptr[b + 1]
        if first < last:
            c0, c1 = first // per, (last - 1) // per
            if c0 == c1:
                continue
            acc = np.zeros(LANE, np.float32)
            for c in range(c0, c1):
                acc = (acc + carry[c, 1]).astype(np.float32)
            y2[b] = (acc + carry[c1, 0]).astype(np.float32)
        else:
            y2[b] = 0.0
    assert not np.isnan(y2).any()
    return gsum, torch.from_numpy(y2.reshape(-1)[:m]).to(torch.bfloat16)


def dense_pieces():
    """384 x 1024 at 60 %: pieces of 128 live lanes at wsel 1."""
    rng = np.random.default_rng(40)
    d = np.where(rng.random((384, 1024)) < 0.6,
                 rng.random((384, 1024)) + 0.5, 0.0)
    return dense_to_csr(d.astype(np.float32), name="dense_pieces")


def twin():
    """The headline's 512^2 twin shape at a quarter of its density: ~64
    nnz a row, wsel 1 by ``pick_wsel``."""
    return artificial_matrix_generation(
        512, 512, 64, 8, "normal", seed=14, placement="random", bw=1.0,
        name="twin_quarter")


WSEL1 = {"dense_pieces": dense_pieces, "twin": twin,
         "straddle": straddle, "edge": hypersparse_edge}


@pytest.fixture(scope="module")
def wsel1_layouts():
    out = {}
    for name, make in WSEL1.items():
        csr = bf16_csr(make)
        out[name] = (DeviceWPACK.from_csr(csr, 1, device="cpu"),
                     operand(csr.k, 5))
    return out


@pytest.mark.parametrize("groups_per_cta", GROUPS_PER_CTA)
@pytest.mark.parametrize("matrix", sorted(WSEL1))
def test_prefix_split_emulation(wsel1_layouts, matrix, groups_per_cta):
    """The kernel's lanes and shifts give the plain version's group sums
    bit for bit; the split's y is within 1 ulp of the plain y, the same
    bits twice."""
    a, x = wsel1_layouts[matrix]
    gsum, y = prefix_split(a, x, groups_per_cta)
    want = group_sums(torch.from_numpy(
        prefix_bf16_terms(a, x).numpy()).view(-1, 8, LANE)).numpy()
    np.testing.assert_array_equal(gsum.view(np.uint32), want.view(np.uint32))
    assert_within_one_ulp(y, wpack_spmv_plain(a, x))
    assert torch.equal(prefix_split(a, x, groups_per_cta)[1], y)


def test_prefix_groups_per_cta_rule():
    """One group a CTA while the groups fit a wave of 4 CTAs on each SM
    (the twin's 104 on 132 SMs), more as they grow, 16 at most."""
    assert prefix_groups_per_cta(104, 132) == 1
    assert prefix_groups_per_cta(528, 132) == 1
    assert prefix_groups_per_cta(529, 132) == 2
    assert prefix_groups_per_cta(4 * 528, 132) == 4
    assert prefix_groups_per_cta(10 ** 6, 132) == 16
