"""The slot SpMMs' row walk (``spgrid_torch/csrc/slot_rows.cuh``) emulated in
numpy over the row-ordered live-slot stream, against the dense product.

The emulation follows the kernel's index arithmetic: CTA (bx, by) of 8
warps takes 8 rows and a slab of 128 C columns, warp w the row 8 bx + w;
lane l owns columns 128 c + 4 l .. + 3 (float4 form) or 32 j + l
(scalar form); a row's slots come 32 at a time and U at a time; a float4
is read and written only when its first column lies inside the slab. Rows
of more than ``long_row`` slots are left to the long-row walk: a CTA a
row, 16 warps that each sum an equal run of its slots, the runs' sums
added in warp order.
Y starts as NaN and every write is counted, so an element written never or
twice shows. Tolerance: rtol 1e-5, atol 1e-6 (f32 sums in slot order
against the f64 dense product).

The bands' 16-byte bf16 walk (``walk16``) is emulated the same way, at the
launch ``wcoo_spmm_aligned.launch_plan`` gives: each product rounded to
bf16, the f32 sums in slot order, bit for bit against the plain version.
"""

import numpy as np
import pytest
import torch

from spgrid_torch.entry import hypersparse_edge
from spgrid_torch.formats.csr import dense_to_csr
from spgrid_torch.gen import artificial_matrix_generation
from spgrid_torch.ops.kernels.slot_rows import (
    LONG_ROW, UNROLL_LOADS, WARPS, rows_product, walk_shape)
from spgrid_torch.ops.kernels.wcoo_spmm import DeviceWCOO
from spgrid_torch.ops.kernels.wcoo_spmm_aligned import (
    SETS, DeviceWCOOBands, launch_plan, wcoo_spmm_aligned_plain)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
LONG_WARPS = 16      # warps of the long-row walk (csrc/slot_rows.cuh)


def empty_tail():
    """300 x 260, ~5 % scattered; rows 10-39 and the last 100 rows empty."""
    rng = np.random.default_rng(32)
    d = np.where(rng.random((300, 260)) < 0.05, rng.random((300, 260)) + 0.5,
                 0.0)
    d[10:40] = 0.0
    d[200:] = 0.0
    return dense_to_csr(d.astype(np.float32), name="empty_tail")


MATRICES = {
    "edge": hypersparse_edge,     # a 200-nnz row, empty row blocks
    "hypersparse": lambda: artificial_matrix_generation(
        600, 2000, 5, 1.6667, "normal", seed=14, placement="random",
        bw=0.05, name="hyper"),
    "empty_tail": empty_tail,
    "empty": lambda: dense_to_csr(np.zeros((130, 70), np.float32)),
}
LAYOUTS = {
    "wcoo": lambda c: DeviceWCOO.from_csr(c, R=256, device="cpu"),
    "bands": lambda c: DeviceWCOOBands.from_csr(c, band_rows=256,
                                                device="cpu"),
}


def lane_columns(c, vec):
    """(32, 4 C) columns of a slab each lane owns, and (32, 4 C) whether
    each lies inside a slab of ``left`` columns by the kernel's test: the
    float4's first column in the vector form, the column itself in the
    scalar form."""
    lane = np.arange(32)[:, None]
    if vec:
        first = (128 * np.arange(c)[None, :] + 4 * lane)      # (32, C)
        cols = (first[:, :, None] + np.arange(4)).reshape(32, 4 * c)
        return cols, np.repeat(first, 4, axis=1)
    cols = 32 * np.arange(4 * c)[None, :] + lane
    return cols, cols


def emulate_walk(a, x, vec, long_row):
    m, n = a.shape[0], x.shape[1]
    gx, gy, c, u = walk_shape(m, n)
    assert u * c == UNROLL_LOADS
    row_slot = a.row_slot.numpy().astype(np.int64)
    vals, xrows = a.slot_vals.numpy(), a.slot_xrows.numpy()
    cols, test = lane_columns(c, vec)
    y = np.full((m, n), np.nan, np.float32)
    writes = np.zeros((m, n), np.int64)

    def add_slots(beg, end, inside, at):
        """One warp's acc over the slots [beg, end): 32 at a time, one a
        lane, U at a time."""
        acc = np.zeros((32, 4 * c), np.float32)
        for base in range(beg, end, 32):
            count = min(32, end - base)
            lv = np.zeros(32, np.float32)
            lx = np.zeros(32, np.int64)
            lv[:count] = vals[base:base + count]
            lx[:count] = xrows[base:base + count]
            for j in range(0, count, u):
                for s in range(j, min(j + u, count)):
                    xv = np.where(inside, x[lx[s & 31], at], 0)
                    acc = (acc + lv[s & 31] * xv).astype(np.float32)
        return acc

    def store(row, acc, n0, inside):
        y[row, n0 + cols[inside]] = acc[inside]
        writes[row, n0 + cols[inside]] += 1

    long_rows = np.flatnonzero(np.diff(row_slot) > long_row)
    for by in range(gy):
        n0 = by * 128 * c
        inside = test < n - n0
        at = n0 + np.where(inside, cols, 0)
        # the walk: CTA bx, warp w, row bx WARPS + w
        for bx in range(gx):
            for w in range(WARPS):
                row = bx * WARPS + w
                if row >= m:
                    break
                beg, end = row_slot[row], row_slot[row + 1]
                if end - beg > long_row:
                    continue
                store(row, add_slots(beg, end, inside, at), n0, inside)
        # the long-row walk: a CTA a long row, LONG_WARPS equal runs summed
        # by warp, the runs' sums added in warp order
        for row in long_rows:
            beg, end = row_slot[row], row_slot[row + 1]
            run = -(-(end - beg) // LONG_WARPS)
            parts = []
            for w in range(LONG_WARPS):
                lo = min(end, beg + w * run)
                parts.append(add_slots(lo, min(end, lo + run), inside, at))
            acc = parts[0]
            for p in parts[1:]:
                acc = (acc + p).astype(np.float32)
            store(row, acc, n0, inside)
    assert (writes == 1).all(), "an element of Y written never or twice"
    return y


@pytest.mark.parametrize("long_row", [LONG_ROW, 3])
@pytest.mark.parametrize("n,vec", [(1, False), (77, False), (200, True),
                                   (200, False), (512, True), (512, False),
                                   (600, True)])
@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("kind", sorted(LAYOUTS))
def test_walk_emulation_gives_the_dense_product(kind, name, n, vec,
                                                long_row):
    """``long_row`` 3 sends most rows through the long-row walk."""
    csr = MATRICES[name]()
    a = LAYOUTS[kind](csr)
    x = (np.random.default_rng(n).random((csr.k, n)) + 0.5).astype(
        np.float32)
    want = csr.to_dense().astype(np.float64) @ x.astype(np.float64)
    got = emulate_walk(a, x, vec, long_row)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got, rows_product(a, torch.from_numpy(x).double()).numpy(),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,shape", [(1, (7, 1, 1, 4)), (128, (7, 1, 1, 4)),
                                     (129, (7, 1, 2, 2)), (256, (7, 1, 2, 2)),
                                     (512, (7, 1, 4, 1)), (600, (7, 2, 4, 1)),
                                     (1100, (7, 3, 4, 1))])
def test_walk_shape(n, shape):
    """(CTAs, slabs, C, U) for 50 rows, 8 a CTA."""
    assert walk_shape(50, n) == shape


def bf16_round(v: np.ndarray) -> np.ndarray:
    """f32 ``v`` rounded to bf16 (to nearest, ties to even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
        torch.bfloat16).float().numpy()


def emulate_walk16(a, x, slab):
    """Y of the 16-byte walk at ``slab`` (0: the rule) as its launch takes
    the rows and columns: CTA (bx, by) of WARPS warps, warp w the SETS
    sets of R = 32 / L rows from (bx WARPS + w) SETS, a group of L lanes a
    row, lane j the columns (j + L e) 8 .. + 7 of the slab where the first
    lies inside it; long rows by runs, as the long-row walk sums them."""
    m, n = a.shape[0], x.shape[1]
    plan = launch_plan(n, 2, slab)
    lanes = plan.lanes
    per_lane = max(1, -(-plan.slab // 8) // lanes)
    rows_a_warp = 32 // lanes
    assert plan.rows == WARPS * SETS * rows_a_warp
    row_slot = a.row_slot.numpy().astype(np.int64)
    vals = a.slot_vals.float().numpy()
    xrows = a.slot_xrows.numpy().astype(np.int64)
    xf = x.float().numpy()
    y = np.full((m, n), np.nan, np.float32)
    writes = np.zeros((m, n), np.int64)

    def row_sum(beg, end, cols):
        acc = np.zeros(len(cols), np.float32)
        for s in range(beg, end):
            acc = (acc + bf16_round(vals[s] * xf[xrows[s], cols])).astype(
                np.float32)
        return acc

    counts = np.diff(row_slot)
    for by in range(plan.slabs):
        n0 = by * plan.slab
        left = min(plan.slab, n - n0)
        firsts = [(j + lanes * e) * 8 for j in range(lanes)
                  for e in range(per_lane) if (j + lanes * e) * 8 < left]
        cols = n0 + np.asarray([f + t for f in firsts for t in range(8)],
                               np.int64)
        for bx in range(-(-m // plan.rows)):
            for w in range(WARPS):
                set0 = (bx * WARPS + w) * SETS
                for i in range(SETS):
                    for g in range(rows_a_warp):
                        row = (set0 + i) * rows_a_warp + g
                        if row >= m or counts[row] > LONG_ROW:
                            continue
                        y[row, cols] = bf16_round(row_sum(
                            row_slot[row], row_slot[row + 1], cols))
                        writes[row, cols] += 1
        for row in np.flatnonzero(counts > LONG_ROW):
            beg, end = row_slot[row], row_slot[row + 1]
            run = -(-(end - beg) // LONG_WARPS)
            cols_all = np.arange(n0, n0 + left)
            parts = [row_sum(min(end, beg + w * run),
                             min(end, min(end, beg + w * run) + run),
                             cols_all) for w in range(LONG_WARPS)]
            acc = parts[0]
            for p in parts[1:]:
                acc = (acc + p).astype(np.float32)
            y[row, cols_all] = bf16_round(acc)
            writes[row, cols_all] += 1
    assert (writes == 1).all(), "an element of Y written never or twice"
    return y


@pytest.mark.parametrize("n,slab", [(8, 0), (64, 0), (96, 0), (200, 64),
                                    (512, 0), (512, 128), (1024, 0)])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_walk16_emulation_gives_the_plain_bits(name, n, slab):
    """The 16-byte bf16 walk, emulated, writes every element of Y once and
    gives the bits of ``wcoo_spmm_aligned_plain``, which sums as the walk
    does."""
    csr = MATRICES[name]().astype("bfloat16")
    a = DeviceWCOOBands.from_csr(csr, band_rows=256, device="cpu")
    x = torch.from_numpy((np.random.default_rng(n).random((csr.k, n))
                          + 0.5).astype(np.float32)).to(torch.bfloat16)
    got = emulate_walk16(a, x, slab)
    want = wcoo_spmm_aligned_plain(a, x).float().numpy()
    np.testing.assert_array_equal(got, want)
