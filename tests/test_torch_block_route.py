"""The bf16 BSR form's two routes (``DeviceBSR.route``, ``BlockRoute``):
the host split of a bf16 layout's block rows between the entry route (a row
stream that ``csrc/slot_rows.cuh``'s walk reads) and the tensor-core tile
(``csrc/bf16_mma.cuh``), and a numpy emulation of the two kernels' f32
sums, held to the f64 product and, rounded once to bf16, to
``bsr_spmm_plain`` within 1 bf16 ulp.

The emulation follows ``csrc/bsr_spmm.cu``: a tile slice's steps (its block
row's blocks times 64 of each block's bk columns) split across a cluster of
1, 2, 4 or 8 ranks, each step's products summed exactly into a fresh
accumulator and truncated to f32 (the tensor cores), added to the rank's
sums in f32, the ranks' sums added in rank order; a walked row's entries
(the stream's, in stream order) added from zero one by one with an f32
fma. Every element of Y is written by exactly one of the two.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from spgrid_torch.bench.headline import headline_matrix
from spgrid_torch.formats.csr import dense_to_csr, random_csr
from spgrid_torch.gen import artificial_matrix_generation
from spgrid_torch.ops.kernels import (
    launch_counts, reset_launch_counts)
from spgrid_torch.ops.kernels.bsr_spmm import (
    bsr_spmm, bsr_spmm_bf16, bsr_spmm_plain, route_of)
from spgrid_torch.ops.kernels.slot_rows import LONG_ROW
from spgrid_torch.ops.layouts import (
    ENTRY_ROUTE_MAX, DeviceBSR, all_tile_route, block_entries, bsr_arrays,
    entry_route_max)

CSRC = Path(__file__).resolve().parents[1] / "spgrid_torch" / "csrc"
STEP = 64         # BF_TK of csrc/bf16_mma.cuh
SLICE = 128       # ROWS of csrc/block_mma.cuh
CLUSTERS = (1, 2, 4, 8)


def positive(csr):
    csr.values = np.abs(csr.values) + 0.5
    return csr


def banded():
    """A band_98k-like pattern at 2048^2: ~8 nnz a row spread over a wide
    band, ~70 a 128^2 block (band_98k's hold 22.6 on average)."""
    return artificial_matrix_generation(
        2048, 2048, 8, 2.6667, "normal", seed=14, placement="random",
        bw=0.9, skew=0, avg_num_neighbours=0.05, cross_row_similarity=0.5,
        name="band_2k")


def mixed():
    """512 x 384: block (0, 0) dense, block (0, 2) and block row 2 sparse,
    block row 1 empty, block row 3 one dense block beside sparse ones."""
    rng = np.random.default_rng(3)
    d = np.zeros((512, 384), np.float32)
    d[:128, :128] = rng.random((128, 128)) + 0.5
    d[:128, 256:] = (rng.random((128, 128)) < 0.004) * (rng.random() + 0.5)
    d[256:384] = (rng.random((128, 384)) < 0.003) * 1.25
    d[384:, 128:256] = rng.random((128, 128)) + 0.5
    d[384:, :128] = (rng.random((128, 128)) < 0.002) * 0.75
    return dense_to_csr(d, name="mixed")


MATRICES = {
    "banded": banded,
    "twin": headline_matrix,
    "mixed": mixed,
    "ragged": lambda: positive(random_csr(500, 300, 0.02, seed=6)),
}


def bf16(make):
    return make().astype("bfloat16")


def test_entry_route_max_is_the_kernels():
    """The host's threshold is the one the .cu states with its sweep."""
    found = re.search(r"constexpr int ENTRY_ROUTE_MAX = (\d+);",
                      (CSRC / "bsr_spmm.cu").read_text())
    assert int(found.group(1)) == ENTRY_ROUTE_MAX
    assert entry_route_max(128, 128) == ENTRY_ROUTE_MAX
    assert entry_route_max(64, 128) == ENTRY_ROUTE_MAX // 2


@pytest.mark.parametrize("name,want", [("banded", "entry"), ("twin", "tile"),
                                       ("mixed", "both")])
def test_route_split(name, want):
    """All entry on a band_98k-like pattern, all tile on the twin, both on
    the crafted matrix: each block row where its blocks' mean count of
    nonzeros puts it."""
    csr = bf16(MATRICES[name])
    a = DeviceBSR.from_csr(csr, bm=128, bk=128, device="cpu")
    r = a.route
    counts = (a.blocks != 0).reshape(a.blocks.shape[0], -1).sum(1)
    real = a.block_rows < a.mb
    rows = a.block_rows[real].long()
    row_nnz = torch.bincount(rows, counts[real], minlength=a.mb)
    row_blocks = torch.bincount(rows, minlength=a.mb)
    entry_row = row_nnz <= ENTRY_ROUTE_MAX * row_blocks
    assert r.entry_blocks == int(entry_row[rows].sum())
    assert r.tile_blocks == int((~entry_row[rows]).sum())
    assert r.tile_slices.tolist() == torch.nonzero(~entry_row).reshape(
        -1).tolist()
    if want == "entry":
        assert r.tile_blocks == 0 and r.tile_slices.numel() == 0
        assert r.walk_rows.numel() == csr.m and r.entries == csr.nnz
    elif want == "tile":
        assert r.entry_blocks == 0 and r.entries == 0
        assert r.tile_slices.tolist() == list(range(a.mb))
    else:
        # block rows 0 and 3 run the tile (a dense block each, beside
        # sparse ones); the empty row 1 and the sparse row 2 are walked
        assert r.tile_slices.tolist() == [0, 3]
        assert r.walk_rows.tolist() == list(range(128, 384))
        assert r.entries == int(counts[(a.block_rows == 1)
                                       | (a.block_rows == 2)].sum())


def test_forced_routes():
    csr = bf16(MATRICES["mixed"])
    tile = DeviceBSR.from_csr(csr, bm=128, bk=128, device="cpu",
                              route="tile").route
    entry = DeviceBSR.from_csr(csr, bm=128, bk=128, device="cpu",
                               route="entry").route
    a = DeviceBSR.from_csr(csr, bm=128, bk=128, device="cpu")
    assert tile.entries == 0 and tile.walk_rows.numel() == 0
    assert tile.tile_slices.tolist() == list(range(a.mb))
    assert tile.tile_blocks == a.num_blocks
    assert entry.tile_slices.numel() == 0 and entry.entries == csr.nnz
    assert entry.walk_rows.tolist() == list(range(csr.m))
    assert entry.entry_blocks == a.num_blocks
    fallback = all_tile_route(a)
    assert torch.equal(fallback.tile_slices, tile.tile_slices)
    assert fallback.tile_blocks == tile.tile_blocks
    with pytest.raises(ValueError):
        DeviceBSR.from_csr(csr, bm=128, bk=128, device="cpu", route="dense")


def test_entry_stream_holds_the_routed_entries():
    """Exactly the entry-route blocks' nonzeros, by output row, then block
    order, then column; pad blocks (block row mb) and X rows >= k skipped
    even where their values are not zero."""
    csr = bf16(lambda: positive(random_csr(300, 200, 0.01, seed=2)))
    rows, cols, starts, blocks, nb = bsr_arrays(csr, 128, 128, 4)
    blocks = blocks.copy()
    mb = len(starts) - 1
    pad = np.flatnonzero(rows == mb)
    assert len(pad)
    blocks[pad[0], 5, 7] = 3.0             # a pad block's stray value
    last = np.flatnonzero((rows < mb) & (cols == 1))[0]
    blocks[last, 9, 100] = 2.0             # X row 228 >= k = 200
    a = DeviceBSR.from_arrays(rows, cols, starts, blocks, csr.shape, csr.nnz,
                              nb, device="cpu", dtype="bfloat16",
                              route="entry")
    r = a.route
    dense = csr.to_dense()
    want = [(i, j, dense[i, j]) for i in range(csr.m)
            for j in sorted(np.flatnonzero(dense[i]),
                            key=lambda c: (c // 128, c))]
    ptr = r.row_slot.numpy()
    got = [(i, int(r.slot_xrows[e]), float(r.slot_vals[e]))
           for i in range(csr.m) for e in range(ptr[i], ptr[i + 1])]
    assert got == [(i, int(j), float(v)) for i, j, v in want]
    flat = a.blocks.reshape(-1)
    assert torch.equal(flat[r.slot_pos], r.slot_vals)


@pytest.mark.parametrize("name,bm,pad", [("mixed", 128, 1), ("ragged", 200, 3),
                                         ("banded", 64, 4), ("zeros", 8, 2)])
def test_block_entries_from_the_csr_are_the_blocks_nonzeros(name, bm, pad):
    """``from_csr``'s entry lookup gives what a scan of the blocks gives,
    explicit zeros of the CSR left out."""
    if name == "zeros":
        csr = positive(random_csr(70, 300, 0.1, seed=4))
        csr.values[::7] = 0.0
    else:
        csr = MATRICES[name]()
    rows, cols, _, blocks, _ = bsr_arrays(csr, bm, 128, pad)
    got = block_entries(csr, rows, cols, bm, 128)
    for g, w in zip(got, np.nonzero(blocks)):
        np.testing.assert_array_equal(g, w)


def test_walk_rows_and_long_rows():
    """A walked row of more than LONG_ROW entries is a long row."""
    d = np.zeros((256, 1024), np.float32)
    d[5, :LONG_ROW + 10] = 1.0
    d[6, :LONG_ROW] = 1.0
    d[200, 3] = 2.0
    csr = dense_to_csr(d).astype("bfloat16")
    r = DeviceBSR.from_csr(csr, bm=128, bk=128, device="cpu",
                           route="entry").route
    assert r.long_rows.tolist() == [5]
    assert r.walk_rows.tolist() == list(range(256))


def test_with_blocks_reads_the_entries_again():
    csr = bf16(MATRICES["mixed"])
    a = DeviceBSR.from_csr(csr, bm=128, bk=128, device="cpu")
    b = a.with_blocks(a.blocks * 2)
    assert torch.equal(b.route.slot_vals, a.route.slot_vals * 2)
    assert torch.equal(b.route.tile_slices, a.route.tile_slices)
    f32 = DeviceBSR.from_csr(MATRICES["mixed"](), bm=128, bk=128,
                             device="cpu")
    assert f32.route is None
    assert f32.with_blocks(f32.blocks.bfloat16()).route.mode == "tile"


def to_f32_toward_zero(v):
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def emulate(a: DeviceBSR, x: np.ndarray, cluster: int) -> np.ndarray:
    """Y (m, n) f32 as the two kernels sum it (module docstring)."""
    r = route_of(a)
    m, k = a.shape
    n = x.shape[1]
    bm, bk = a.bm, a.bk
    blocks = a.blocks.float().numpy().astype(np.float64)
    cols = a.block_cols.numpy()
    xp = np.zeros((-(-k // bk) * bk + bk, n))
    xp[:k] = x
    y = np.full((m, n), np.nan, np.float32)
    written = np.zeros((m, n), int)
    row_ptr = a.row_ptr.numpy()
    slices = -(-bm // SLICE)
    nq = -(-bk // STEP)
    for s in r.tile_slices.numpy():
        row, i0 = divmod(int(s), slices)
        i0 *= SLICE
        rows = min(SLICE, bm - i0)
        steps = [(b, q * STEP) for b in range(row_ptr[row], row_ptr[row + 1])
                 for q in range(nq)]
        total = len(steps)
        part = np.zeros((cluster, rows, n), np.float32)
        for rank in range(cluster):
            for b, k0 in steps[total * rank // cluster:
                               total * (rank + 1) // cluster]:
                blk = blocks[b, i0:i0 + rows, k0:k0 + STEP]
                xs = xp[cols[b] * bk + k0:cols[b] * bk + k0 + blk.shape[1]]
                part[rank] += to_f32_toward_zero(blk @ xs)
        tile = part[0].copy()
        for rank in range(1, cluster):
            tile += part[rank]
        out = range(row * bm + i0, min(row * bm + i0 + rows, m))
        y[out.start:out.stop] = tile[:len(out)]
        written[out.start:out.stop] += 1
    walked = r.walk_rows.numpy()
    y[walked] = 0.0
    written[walked] += 1
    assert (written == 1).all(), "every element of Y written once"
    ptr = r.row_slot.numpy()
    assert ptr[-1] == sum(ptr[i + 1] - ptr[i] for i in walked), \
        "the stream holds the walked rows' entries alone"
    vals = r.slot_vals.float().numpy().astype(np.float64)
    xrows = r.slot_xrows.numpy()
    for i in walked:
        for e in range(ptr[i], ptr[i + 1]):
            # one fmaf: the bf16 x bf16 product is exact
            y[i] = (y[i].astype(np.float64)
                    + vals[e] * x[xrows[e]]).astype(np.float32)
    return y


def bf16_values(t):
    return t.to(torch.bfloat16).float().numpy().astype(np.float64)


@pytest.mark.parametrize("route", ["auto", "tile", "entry"])
@pytest.mark.parametrize("name,bm,n", [("mixed", 128, 24), ("ragged", 200, 16),
                                       ("banded", 128, 8), ("twin", 64, 8)])
def test_emulated_sums_give_the_product(name, bm, n, route):
    """At every cluster size: within f32 rounding of the f64 product of the
    bf16 values, and, rounded once to bf16, within 1 bf16 ulp of
    ``bsr_spmm_plain`` (what the card tests hold the kernels to); forced
    tile and forced entry give the same function."""
    csr = bf16(MATRICES[name])
    a = DeviceBSR.from_csr(csr, bm=bm, bk=128, pad_multiple=3,
                           device="cpu", route=route)
    x = bf16_values(torch.from_numpy(
        np.random.default_rng(7).random((csr.k, n)) + 0.5))
    dense = csr.to_dense().astype(np.float64)
    exact = dense @ x
    scale = np.abs(dense) @ np.abs(x)
    plain = bsr_spmm_plain(a, torch.from_numpy(x).to(torch.bfloat16))
    plain = plain.float().numpy().astype(np.float64)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(plain), 1e-30))) - 7)
    for cluster in CLUSTERS:
        y = emulate(a, x, cluster).astype(np.float64)
        adds = 2 * (csr.k // STEP + cluster) + int(np.diff(csr.row_ptr).max())
        assert (np.abs(y - exact) <= adds * 2.0 ** -24 * scale + 1e-30).all()
        rounded = bf16_values(torch.from_numpy(y))
        assert (np.abs(rounded - plain) <= np.maximum(ulp, 1e-30)).all()


def test_plain_version_and_counts_on_the_cpu():
    """On the CPU the wrapper takes the plain version under every route, and
    a reset clears the counts of the kernels a call starts."""
    csr = bf16(MATRICES["mixed"])
    x = torch.from_numpy(np.random.default_rng(1).random(
        (csr.k, 16)).astype(np.float32)).to(torch.bfloat16)
    outs = [bsr_spmm(DeviceBSR.from_csr(csr, bm=128, bk=128, device="cpu",
                                        route=route), x)
            for route in ("auto", "tile", "entry")]
    assert all(torch.equal(o, outs[0]) for o in outs)
    bsr_spmm_bf16.tile_launches = bsr_spmm_bf16.entry_launches = 3
    reset_launch_counts()
    assert bsr_spmm_bf16.tile_launches == bsr_spmm_bf16.entry_launches == 0
    assert launch_counts()["bsr_spmm_bf16"] == 0
