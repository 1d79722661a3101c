"""The multi-row packed SpMV layout (DeviceWPACK) and WROW variant v2 against
the JAX package: host arrays element for element (through
``convert.wpack_from_jax``), the plain versions against the Pallas kernels
in interpret mode on one shape each (computed once in a module fixture:
the kernels' unrolled group loops compile for seconds), and edge cases
against the f64 dense product. The live-slot stream that the two CUDA
kernels read: against the padded pieces it was built from, its product
against the Pallas kernels, and a numpy emulation of the kernels' work
split (equal slot ranges, carry and combine) against the plain product.
WROW v1's row-ordered live-slot stream: against the padded pieces, and a
numpy emulation of its kernel's rounds against the padded kernel's sum,
bit for bit.

Tolerance: rtol 1e-5, atol 1e-6 (f32 sums in another order); the matrices
hold positive values, so no sum cancels below its terms' rounding.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgrid.formats import CSRMatrix, dense_to_csr
from spgrid.gen import artificial_matrix_generation
from spgrid.ops.pallas import wpack_spmv as jax_wpack
from spgrid.ops.pallas import wrow_spmv as jax_wrow
from spgrid_torch.entry import hypersparse_edge
from spgrid_torch.ops import convert, dispatch
from spgrid_torch.ops.kernels import launch_counts
from spgrid_torch.ops.kernels.slot_stream import (
    PIECE_START, default_slots_per_cta,
)
from spgrid_torch.ops.kernels.wpack_spmv import (
    DeviceWPACK, csr_to_wpack, pick_wsel, wpack_spmv, wpack_spmv_plain,
    wpack_stream_plain,
)
from spgrid_torch.ops.kernels.wrow_spmv import (
    DeviceWROW, wrow_rows_plain, wrow_spmv, wrow_spmv_plain, wrow_spmv_v2,
    wrow_stream_plain,
)

# The suite runs in parallel workers on shared cores: one intra-op thread
# a worker keeps these small CPU tensors from oversubscribing them.
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def positive(csr):
    """The same sparsity with values |v| + 0.1."""
    return CSRMatrix(csr.row_ptr, csr.col_idx,
                     (np.abs(csr.values) + 0.1).astype(np.float32),
                     csr.shape, csr.name)


def edge():
    e = hypersparse_edge()
    return CSRMatrix(e.row_ptr, e.col_idx, e.values, e.shape, "edge")


def full_piece():
    """Row 130 holds 200 nnz in columns 256-455 and is the only row of its
    128-row block in columns 256-383, so at wsel 1 it fills a whole piece
    of 128 lanes (start 0, end 127); the other rows are scattered; k = 1000
    is no multiple of 128."""
    rng = np.random.default_rng(4)
    d = np.where(rng.random((300, 1000)) < 0.01, rng.random((300, 1000)) + 0.5,
                 0.0)
    d[128:256, 256:384] = 0.0
    d[130, 256:456] = rng.random(200) + 0.5
    return dense_to_csr(d.astype(np.float32), name="full_piece")


MATRICES = {
    "edge": edge,
    "full_piece": full_piece,
    "scattered": lambda: positive(artificial_matrix_generation(
        1000, 1500, 20, 6.6667, "normal", seed=14, placement="random",
        bw=0.9, name="scattered")),
    "banded": lambda: positive(artificial_matrix_generation(
        1024, 1024, 20, 6, "normal", seed=14, placement="diagonal", bw=0.05,
        name="banded")),
    "empty": lambda: dense_to_csr(np.zeros((130, 70), np.float32)),
}
WSELS = (None, 1, 2, 4)
JAX_MATRIX = "edge"


def vector(k, seed=7):
    return (np.random.default_rng(seed).random(k) + 0.5).astype(np.float32)


def dense_product(csr, x):
    return csr.to_dense().astype(np.float64) @ x.astype(np.float64)


def leaves_of(jax_layout):
    children, aux = jax_layout.tree_flatten()
    return [np.asarray(c) for c in children], list(aux)


@pytest.fixture(scope="module")
def jax_outputs():
    """x and the interpret-mode outputs of the JAX WPACK kernel and of WROW
    v2 on JAX_MATRIX."""
    csr = MATRICES[JAX_MATRIX]()
    x = vector(csr.k)
    xj = jnp.asarray(x)
    return x, {
        "wpack": np.asarray(jax_wpack.wpack_spmv(
            jax_wpack.DeviceWPACK.from_csr(csr), xj, interpret=True)),
        "wrow_v2": np.asarray(jax_wrow.wrow_spmv(
            jax_wrow.DeviceWROW.from_csr(csr), xj, interpret=True,
            variant="v2")),
    }


def test_wpack_plain_matches_pallas(jax_outputs):
    x, want = jax_outputs
    a = DeviceWPACK.from_csr(MATRICES[JAX_MATRIX](), device="cpu")
    got = wpack_spmv_plain(a, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want["wpack"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(wpack_spmv(a, torch.from_numpy(x)).numpy(),
                                  got.numpy())


def test_wrow_v2_plain_matches_pallas(jax_outputs):
    x, want = jax_outputs
    a = DeviceWROW.from_csr(MATRICES[JAX_MATRIX](), device="cpu")
    got = wrow_spmv(a, torch.from_numpy(x), variant="v2")
    np.testing.assert_allclose(got.numpy(), want["wrow_v2"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(
        got.numpy(), wrow_spmv_plain(a, torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("wsel", WSELS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_wpack_on_cpu_matches_dense_product(name, wsel):
    csr = MATRICES[name]()
    a = DeviceWPACK.from_csr(csr, wsel, device="cpu")
    assert a.wsel == (wsel or pick_wsel(csr) if csr.nnz else 1)
    x = vector(csr.k, seed=3)
    np.testing.assert_allclose(wpack_spmv(a, torch.from_numpy(x)).numpy(),
                               dense_product(csr, x), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_wrow_v2_on_cpu_matches_dense_product(name):
    csr = MATRICES[name]()
    a = DeviceWROW.from_csr(csr, device="cpu")
    x = vector(csr.k, seed=3)
    want = dense_product(csr, x)
    for got in (wrow_spmv(a, torch.from_numpy(x), variant="v2"),
                wrow_spmv_v2(a, torch.from_numpy(x), slots_per_cta=1)):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("wsel", WSELS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_wpack_layout_equals_jax_arrays(name, wsel):
    csr = MATRICES[name]()
    j = jax_wpack.DeviceWPACK.from_csr(csr, wsel)
    leaves, aux = leaves_of(j)
    got = convert.wpack_from_jax(*leaves, *aux, device="cpu")
    want = DeviceWPACK.from_csr(csr, wsel, device="cpu")
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), f.name
        else:
            assert g == w, f.name
    # the JAX arrays pad the groups for the TPU grid: the port's are their
    # head
    cols, vals, ends, starts, sel, pw, gsub = leaves
    P = 8 * j.num_groups
    for t, arr in ((want.cols, cols), (want.values, vals), (want.ends, ends),
                   (want.starts, starts), (want.sel, sel)):
        np.testing.assert_array_equal(t.numpy(), arr[:P])
    np.testing.assert_array_equal(want.piece_w.numpy(), pw.reshape(-1)[:P])
    np.testing.assert_array_equal(want.group_sub.numpy(),
                                  gsub.reshape(-1)[:j.num_groups])
    assert want.wsel == j.wsel and want.num_groups == j.num_groups


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_host_packer_equals_jax(name):
    csr = MATRICES[name]()
    assert pick_wsel(csr) == jax_wpack.pick_wsel(csr)
    for wsel in WSELS:
        got, want = csr_to_wpack(csr, wsel), jax_wpack.csr_to_wpack(csr, wsel)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert np.asarray(g).dtype == np.asarray(w).dtype


def test_full_piece_and_wide_windows():
    csr = full_piece()
    a = DeviceWPACK.from_csr(csr, 1, device="cpu")
    lane = 130 % 128
    block = a.group_sub.repeat_interleave(8) == 130 // 128
    full = block & (a.starts[:, lane] == 0) & (a.ends[:, lane] == 127)
    assert int(full.sum()) == 1
    # at wsel 4, sel picks the source row inside a 512-column window
    a4 = DeviceWPACK.from_csr(csr, 4, device="cpu")
    assert set(a4.sel[a4.values != 0].unique().tolist()) == {0, 1, 2, 3}
    assert (a4.piece_w % 4 == 0).all()


def test_x_index_past_k_adds_nothing():
    # the JAX wrapper pads x to whole windows, so a slot whose x index lies
    # at or past k reads a zero; the port's x is unpadded and skips it
    csr = full_piece()
    a = DeviceWPACK.from_csr(csr, 4, device="cpu")
    x = vector(csr.k, seed=5)
    want = dense_product(csr, x)
    pad = (a.piece_w[:, None] == a.piece_w.max()) & (a.values == 0)
    last, t = torch.nonzero(pad)[0].tolist()
    cols, sel, values = a.cols.clone(), a.sel.clone(), a.values.clone()
    cols[last, t], sel[last, t], values[last, t] = 127, 3, 5.0
    assert (int(a.piece_w[last]) + 3) * 128 + 127 >= csr.k
    b = dataclasses.replace(a, cols=cols, sel=sel, values=values)
    np.testing.assert_allclose(wpack_spmv(b, torch.from_numpy(x)).numpy(),
                               want, rtol=RTOL, atol=ATOL)


def test_block_ptr_comes_from_the_padded_groups():
    # pieces are padded per block to a multiple of 8, so block_ptr counts
    # groups after the padding
    for name in ("edge", "scattered"):
        a = DeviceWPACK.from_csr(MATRICES[name](), device="cpu")
        assert a.block_ptr[-1] == a.num_groups == len(a.group_sub)
        assert a.cols.shape[0] == 8 * a.num_groups
        assert torch.equal(torch.repeat_interleave(
            torch.arange(a.blocks, dtype=torch.int32),
            torch.diff(a.block_ptr).long()), a.group_sub)


def test_dispatch_format_takes_one_column_only():
    csr = edge()
    a = dispatch.build(csr, "wpack_spmv_cuda", device="cpu")
    assert isinstance(a, DeviceWPACK)
    assert dispatch.JAX_NAME["wpack_spmv_cuda"] == "wpack_spmv"
    fn = dispatch.spmm_fn("wpack_spmv_cuda")
    x = torch.from_numpy(np.stack([vector(csr.k), vector(csr.k, 2)], 1))
    np.testing.assert_allclose(fn(a, x[:, :1]).numpy()[:, 0],
                               dense_product(csr, x[:, 0].numpy()),
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="n must be 1"):
        fn(a, x)
    assert a.nbytes == (4 * a.cols.numel() + a.values.numel() * 4
                        + 4 * a.piece_w.numel() + a.piece_lanes.numel()
                        + 4 * a.block_ptr.numel()
                        + 4 * a.slot_ptr.numel() + 4 * a.block_slot.numel()
                        + 9 * a.num_slots)
    assert a.stream_nbytes == 4 * a.block_slot.numel() + 9 * a.num_slots


def test_cpu_path_counts_no_launch():
    csr = edge()
    x = torch.from_numpy(vector(csr.k))
    a, w = (DeviceWPACK.from_csr(csr, device="cpu"),
            DeviceWROW.from_csr(csr, device="cpu"))
    before = launch_counts()
    wpack_spmv(a, x)
    wrow_spmv(w, x, variant="v2")
    assert launch_counts() == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "ndim"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    csr = edge()
    x = torch.from_numpy(vector(csr.k))
    x, err = {"dtype": (x.double(), TypeError),
              "shape": (x[:-1], ValueError),
              "device": (x.to("meta"), ValueError),
              "ndim": (x[:, None], ValueError)}[bad]
    with pytest.raises(err):
        wpack_spmv(DeviceWPACK.from_csr(csr, device="cpu"), x)
    with pytest.raises(err):
        wrow_spmv_v2(DeviceWROW.from_csr(csr, device="cpu"), x)


def test_wrow_variant_is_v1_or_v2():
    csr = edge()
    a = DeviceWROW.from_csr(csr, device="cpu")
    x = torch.from_numpy(vector(csr.k))
    with pytest.raises(ValueError, match="variant"):
        wrow_spmv(a, x, variant="v3")
    with pytest.raises(ValueError, match="slots_per_cta"):
        wrow_spmv_v2(a, x, slots_per_cta=0)
    assert torch.equal(wrow_spmv(a, x), wrow_spmv(a, x, variant="v1"))


# --- the live-slot stream (``ops/kernels/slot_stream.py``) -----------------

def explicit_zeros():
    """A scattered CSR in which every third stored value is 0.0: the packers
    give those nnz lanes, the stream drops them."""
    csr = MATRICES["scattered"]()
    values = csr.values.copy()
    values[::3] = 0.0
    return CSRMatrix(csr.row_ptr, csr.col_idx, values, csr.shape,
                     "explicit_zeros")


def straddle():
    """700 x 600, ~1 % scattered, and target block 1 (rows 128-255) dense
    over columns 0-79: 10,240 slots in one block, which spans many ranges
    of a few slots or 128."""
    rng = np.random.default_rng(5)
    d = np.where(rng.random((700, 600)) < 0.01, rng.random((700, 600)) + 0.5,
                 0.0)
    d[128:256, :80] = rng.random((128, 80)) + 0.5
    return dense_to_csr(d.astype(np.float32), name="straddle")


def empty_blocks():
    """1000 x 1000 banded; target blocks 1 and 2 (rows 128-383) and the
    ragged last block (rows 896-999) hold no nnz."""
    i, j = np.ogrid[:1000, :1000]
    rng = np.random.default_rng(6)
    d = np.where(np.abs(i - j) <= 40, rng.random((1000, 1000)) + 0.5, 0.0)
    d[128:384] = 0.0
    d[896:] = 0.0
    return dense_to_csr(d.astype(np.float32), name="empty_blocks")


STREAM_MATRICES = {**MATRICES, "explicit_zeros": explicit_zeros}
SPLIT_MATRICES = {"edge": edge, "straddle": straddle,
                  "empty_blocks": empty_blocks}


def live_mask(values, xoff, piece_w, k):
    return (values != 0) & (piece_w[:, None].astype(np.int64) * 128
                            + xoff.astype(np.int64) < k)


def check_pointers(a, live):
    np.testing.assert_array_equal(
        a.slot_ptr.numpy(), np.concatenate([[0], np.cumsum(live.sum(1))]))
    np.testing.assert_array_equal(a.block_slot.numpy(),
                                  a.slot_ptr.numpy()[8 * a.block_ptr.numpy()])
    assert a.num_slots == int(live.sum())
    # the row byte flags each piece's first live slot
    counts = live.sum(1)
    first = np.zeros(a.num_slots, bool)
    first[a.slot_ptr.numpy()[:-1][counts > 0]] = True
    np.testing.assert_array_equal(a.slot_rows.numpy() >= PIECE_START, first)
    assert a.slot_cols.dtype == torch.int32
    assert a.slot_rows.dtype == torch.uint8


@pytest.mark.parametrize("name", sorted(STREAM_MATRICES))
def test_wrow_stream_expands_to_the_padded_pieces(name):
    csr = STREAM_MATRICES[name]()
    a = DeviceWROW.from_csr(csr, device="cpu")
    values, cols = a.values.numpy(), a.cols.numpy()
    piece_w = a.piece_w.numpy()
    live = live_mask(values, cols, piece_w, csr.k)
    check_pointers(a, live)
    # lane = row: put each slot back at its piece and row
    piece = np.repeat(np.arange(len(a.piece_w)), np.diff(a.slot_ptr.numpy()))
    rows = a.slot_rows.numpy().astype(np.int64) & 127
    got_v, got_c = np.zeros_like(values), np.zeros_like(cols)
    got_v[piece, rows] = a.slot_vals.numpy()
    got_c[piece, rows] = a.slot_cols.numpy() - 128 * piece_w[piece]
    np.testing.assert_array_equal(got_v, np.where(live, values, 0))
    np.testing.assert_array_equal(got_c, np.where(live, cols, 0))
    x = vector(csr.k, seed=3)
    np.testing.assert_allclose(
        wrow_stream_plain(a, torch.from_numpy(x)).numpy(),
        dense_product(csr, x), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("wsel", (1, 2, 4))
@pytest.mark.parametrize("name", sorted(STREAM_MATRICES))
def test_wpack_stream_expands_to_the_padded_pieces(name, wsel):
    csr = STREAM_MATRICES[name]()
    a = DeviceWPACK.from_csr(csr, wsel, device="cpu")
    values = a.values.numpy()
    colsel = a.sel.numpy().astype(np.int64) * 128 + a.cols.numpy()
    piece_w = a.piece_w.numpy()
    live = live_mask(values, colsel, piece_w, csr.k)
    check_pointers(a, live)
    # each lane's row from the start/end maps
    starts, ends = (t.numpy().astype(np.int64) for t in (a.starts, a.ends))
    owner = np.full(values.shape, -1)
    for p, r in zip(*np.nonzero(starts <= ends)):
        owner[p, starts[p, r]:ends[p, r] + 1] = r
    # the stream is the live lanes, in piece and lane order
    x_index = piece_w[:, None].astype(np.int64) * 128 + colsel
    np.testing.assert_array_equal(a.slot_vals.numpy(), values[live])
    np.testing.assert_array_equal(a.slot_cols.numpy(), x_index[live])
    np.testing.assert_array_equal(a.slot_rows.numpy() & 127, owner[live])
    if name != "explicit_zeros":   # no dropped nnz: live lanes are 0 .. c-1
        c = live.sum(1)
        np.testing.assert_array_equal(live, np.arange(128) < c[:, None])
    x = vector(csr.k, seed=3)
    np.testing.assert_allclose(
        wpack_stream_plain(a, torch.from_numpy(x)).numpy(),
        dense_product(csr, x), rtol=RTOL, atol=ATOL)


def test_stream_product_matches_pallas(jax_outputs):
    x, want = jax_outputs
    csr = MATRICES[JAX_MATRIX]()
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(
        wpack_stream_plain(DeviceWPACK.from_csr(csr, device="cpu"),
                           xt).numpy(), want["wpack"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        wrow_stream_plain(DeviceWROW.from_csr(csr, device="cpu"), xt).numpy(),
        want["wrow_v2"], rtol=RTOL, atol=ATOL)


def emulate_stream_walk(a, x, per_cta, segment):
    """numpy emulation of ``csrc/slot_stream.cuh``: CTA c takes the slots
    [c S, (c + 1) S); with ``segment`` each run of one row within a piece
    (a piece starts at a slot flagged ``PIECE_START``) inside a 32-slot run
    aligned to the range start is summed first; each block the
    CTA opens is summed into a 128-row accumulator and flushed to y when all
    its slots lie in the range, else to carry slot 1 (it continues past the
    range) or 0 (it ends in it); then the combine adds each straddling
    block's partials in range order and writes 0 for a block with no slot.
    y and carry start as NaN, so a row or a carry never written shows."""
    m = a.shape[0]
    n = a.num_slots
    block_slot = a.block_slot.numpy()
    starts_piece = a.slot_rows.numpy() >= PIECE_START
    prod = a.slot_vals.numpy() * x[a.slot_cols.numpy()]
    rows = a.slot_rows.numpy().astype(np.int64) & 127
    y = np.full(m, np.nan, np.float32)
    ctas = -(-n // per_cta)
    carry = np.full((max(ctas, 1), 2, 128), np.nan, np.float32)

    def put(b, acc):
        r = np.arange(b * 128, min(m, b * 128 + 128))
        y[r] = acc[:len(r)]

    for c in range(ctas):
        s0, s1 = c * per_cta, min(n, (c + 1) * per_cta)
        idx = np.arange(s0, s1)
        r, v = rows[idx], prod[idx]
        if segment:
            head = ((idx - s0) % 32 == 0) | starts_piece[idx]
            head[1:] |= r[1:] != r[:-1]
            run = np.cumsum(head) - 1
            v = np.bincount(run, weights=v).astype(np.float32)
            tail = np.flatnonzero(np.append(head[1:], True))
            idx, r = idx[tail], r[tail]
        b_first = np.searchsorted(block_slot, s0, side="right") - 1
        b_last = np.searchsorted(block_slot, s1 - 1, side="right") - 1
        for b in range(b_first, b_last + 1):
            lo, hi = block_slot[b], block_slot[b + 1]
            if lo == hi:
                continue
            mine = (idx >= lo) & (idx < hi)
            acc = np.zeros(128, np.float32)
            np.add.at(acc, r[mine], v[mine])
            if lo >= s0 and hi <= s1:
                put(b, acc)
            else:
                carry[c, int(hi > s1)] = acc
    for b in range(a.blocks):
        lo, hi = block_slot[b], block_slot[b + 1]
        if lo == hi:
            put(b, np.zeros(128, np.float32))
            continue
        c0, c1 = lo // per_cta, (hi - 1) // per_cta
        if c0 != c1:
            acc = np.zeros(128, np.float32)
            for c in range(c0, c1):
                acc += carry[c, 1]
            put(b, acc + carry[c1, 0])
    return y


@pytest.mark.parametrize("per_cta", [1, 7, 128, None])
@pytest.mark.parametrize("name", sorted(SPLIT_MATRICES))
@pytest.mark.parametrize("layout", ["wrow", "wpack"])
def test_range_split_with_carry_gives_the_plain_product(layout, name,
                                                        per_cta):
    csr = SPLIT_MATRICES[name]()
    a = (DeviceWROW if layout == "wrow" else DeviceWPACK).from_csr(
        csr, device="cpu")
    per_cta = per_cta or a.num_slots
    x = vector(csr.k, seed=8)
    b = a.block_slot.numpy()
    if name == "straddle":     # block 1 spans ranges, whole and partial
        assert b[2] - b[1] > 2 * per_cta or per_cta == a.num_slots
    if name == "empty_blocks":
        assert b[1] == b[3] and b[-2] == b[-1]
    got = emulate_stream_walk(a, x, per_cta, segment=layout == "wpack")
    assert np.isfinite(got).all()
    plain = (wrow_spmv_plain if layout == "wrow" else wpack_spmv_plain)
    np.testing.assert_allclose(got, plain(a, torch.from_numpy(x)).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_default_range_is_one_wave_of_whole_tiles():
    # the H100's 132 SMs: LINE_S's and MAIN_LINE's live slots
    assert default_slots_per_cta(2_099_796, 132) == 2048
    assert default_slots_per_cta(392_149, 132) == 1024
    for n in (0, 1, 10 ** 5, 3 * 10 ** 6, 10 ** 8):
        per_cta = default_slots_per_cta(n, 132)
        assert per_cta >= 1024 and per_cta % 512 == 0
        assert -(-n // per_cta) <= 8 * 132


# --- WROW v1's row-ordered live-slot stream (``DeviceWROW.row_*``) --------

WROW_CU = (Path(__file__).resolve().parents[1] / "spgrid_torch" / "csrc"
           / "wrow_rows.cuh").read_text()
# slots of each row a round of the kernel stages (one a lane)
DEPTH = int(re.search(r"constexpr int DEPTH = (\d+);", WROW_CU).group(1))
ROW_MATRICES = {**STREAM_MATRICES, "straddle": straddle,
                "empty_blocks": empty_blocks}


def padded_slots(a, k):
    """(row, piece, x index, value) of each live slot of the padded pieces,
    in piece and lane order."""
    values, cols = a.values.numpy(), a.cols.numpy()
    piece_w = a.piece_w.numpy()
    live = live_mask(values, cols, piece_w, k)
    piece, lane = np.nonzero(live)
    sub = a.group_sub.numpy().astype(np.int64)[piece // 8]
    return (sub * 128 + lane, piece,
            piece_w[piece].astype(np.int64) * 128 + cols[piece, lane],
            values[piece, lane])


def fma32(a, b, c):
    """f32 a * b + c, the exact product rounded once (in f64, then f32)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def padded_v1_sum(a, x):
    """y as the padded kernel summed it: thread t of target block b walks
    the block's pieces in order, an fma a live slot from 0.0."""
    row, piece, xi, vals = padded_slots(a, len(x))
    y = np.zeros(a.shape[0], np.float32)
    bounds = np.flatnonzero(np.diff(piece)) + 1
    for rows, xs, vs in zip(*(np.split(v, bounds) for v in (row, xi, vals))):
        y[rows] = fma32(vs, x[xs], y[rows])  # one piece: distinct rows
    return y


def emulate_row_walk(a, x):
    """numpy emulation of ``csrc/wrow_rows.cuh``: a CTA a 128-row target
    block, a warp 32 of its rows; round i of a warp (as many as its longest
    row needs) stages slot i DEPTH + j of each row whose length exceeds it,
    lane j, value and x side by side in a (32, DEPTH) buffer that starts as
    NaN each round (a slot read but not staged shows); then lane l sums
    min(DEPTH, len - i DEPTH) of its row's, an fma each from 0.0. Returns y
    (NaN where never written) and the write count of each row."""
    m = a.shape[0]
    row_slot = a.row_slot.numpy().astype(np.int64)
    vals, cols = a.row_vals.numpy(), a.row_cols.numpy()
    y = np.full(m, np.nan, np.float32)
    writes = np.zeros(m, np.int64)
    for b in range(a.blocks):
        for w in range(4):
            rows = b * 128 + w * 32 + np.arange(32)
            inside = rows < m
            r = np.minimum(rows, m)
            begin = np.where(inside, row_slot[r], 0)
            length = np.where(inside, row_slot[np.minimum(r + 1, m)] - begin,
                              0)
            acc = np.zeros(32, np.float32)
            for i in range(-(-length.max() // DEPTH)):
                sv = np.full((32, DEPTH), np.nan, np.float32)
                sx = np.full((32, DEPTH), np.nan, np.float32)
                at = i * DEPTH + np.arange(DEPTH)
                for q in range(32):
                    live = at < length[q]
                    s = begin[q] + at[live]
                    sv[q, live] = vals[s]
                    sx[q, live] = x[cols[s]]
                here = np.minimum(DEPTH, length - i * DEPTH)
                for j in range(DEPTH):
                    on = j < here
                    acc[on] = fma32(sv[on, j], sx[on, j], acc[on])
            y[rows[inside]] = acc[inside]
            writes[rows[inside]] += 1
    return y, writes


@pytest.mark.parametrize("name", sorted(ROW_MATRICES))
def test_wrow_row_stream_is_the_live_slots_by_row_then_piece(name):
    csr = ROW_MATRICES[name]()
    a = DeviceWROW.from_csr(csr, device="cpu")
    row, piece, xi, vals = padded_slots(a, csr.k)
    order = np.lexsort((piece, row))       # by row, then piece order
    row_slot = a.row_slot.numpy()
    np.testing.assert_array_equal(
        row_slot, np.concatenate([[0], np.cumsum(np.bincount(
            row, minlength=csr.m))]))
    np.testing.assert_array_equal(a.row_cols.numpy(), xi[order])
    np.testing.assert_array_equal(a.row_vals.numpy(), vals[order])
    assert a.row_slot.dtype == a.row_cols.dtype == torch.int32
    assert a.row_vals.dtype == torch.float32
    assert len(a.row_vals) == a.num_slots
    assert a.row_nbytes == 4 * (csr.m + 1) + 8 * a.num_slots
    # each block's row-stream slots are its piece-ordered stream's
    bs = a.block_slot.numpy()
    np.testing.assert_array_equal(row_slot[np.minimum(128 * np.arange(
        a.blocks + 1), csr.m)], bs)
    x = vector(csr.k, seed=3)
    np.testing.assert_allclose(
        wrow_rows_plain(a, torch.from_numpy(x)).numpy(),
        dense_product(csr, x), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(ROW_MATRICES))
def test_wrow_v1_walk_gives_the_padded_sum_bit_for_bit(name):
    """The row stream keeps each row's slots in piece order, so the new
    kernel's rounds sum each row as the padded kernel did: the same bits;
    every row written once (straddle: rows of 80 slots, three rounds)."""
    csr = ROW_MATRICES[name]()
    a = DeviceWROW.from_csr(csr, device="cpu")
    x = vector(csr.k, seed=9)
    got, writes = emulate_row_walk(a, x)
    np.testing.assert_array_equal(writes, 1)
    np.testing.assert_array_equal(got, padded_v1_sum(a, x))
    np.testing.assert_allclose(got, dense_product(csr, x), rtol=RTOL,
                               atol=ATOL)
