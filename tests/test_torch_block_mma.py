"""A numpy emulation of the block kernels' tensor-core tile
(``spgrid_torch/csrc/block_mma.cuh``, run by ``bsr_spmm``, ``panel_spmm``
and ``bsr_sddmm`` on the card alone), against the f64 product.

The emulation follows the kernels' work split, with the tile's geometry
read from the headers: the grid of 128 x 64 tiles and a cluster of 1, 2, 4
or 8 CTAs (the sizes the C launch rule picks from), each rank's range of
the tile's steps of 32, each step's 3xTF32 products (A_lo B_hi, A_hi
B_lo, A_hi B_hi for each 8 of the contraction, every product summed exactly
and truncated to f32 into the step's fresh accumulators, as the tensor
cores do), the step's sum added to the rank's accumulators in f32, the
ranks' partial tiles summed in rank order, and the SDDMM's mask multiplied
once in the epilogue. Each output element's owner (tile, rank, unit of 4
columns) is counted, so every element must be written exactly once.

Tolerance: 1e-5 of |A| @ |X| (the scale each output's rounding error is
bound by) where that exceeds 1e-4: the split keeps f32's accuracy.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from spgrid_torch.bench.headline import headline_matrix
from spgrid_torch.entry import flagship_csrs
from spgrid_torch.formats.csr import CSRMatrix, dense_to_csr, random_csr
from spgrid_torch.gen import create_mask
from spgrid_torch.ops.kernels.panel_spmm import DevicePanels
from spgrid_torch.ops.layouts import DeviceBSR

CSRC = Path(__file__).resolve().parents[1] / "spgrid_torch" / "csrc"


def header_int(name):
    """A ``constexpr int`` of the tile's headers."""
    for header in ("block_mma.cuh", "tf32x3.cuh"):
        found = re.search(rf"constexpr int {name} = (\d+);",
                          (CSRC / header).read_text())
        if found:
            return int(found.group(1))
    raise LookupError(name)


# the tile's rows and columns, a step's depth, a CTA's threads (each
# storing 4 columns at a time) and the largest cluster
ROWS, NT, TK, THREADS, CLUSTER_MAX = map(
    header_int, ("ROWS", "NT", "TK", "THREADS", "CLUSTER_MAX"))
CLUSTERS = [2 ** i for i in range(CLUSTER_MAX.bit_length())]
MAIN_CLUSTER = 4   # the flagship's on an H100's 132 SMs


def cdiv(a, b):
    return -(-a // b)


def tf32(v):
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, by bits: what ``cvt.rna.tf32.f32`` gives (the rule
    ``tests/test_torch_bsrc.py`` pins)."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def to_f32_toward_zero(v):
    """f64 to f32, rounded toward zero: the tensor cores' f32 accumulate."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def rank_partial(a_steps, b_steps):
    """One rank's accumulators: for each of its steps (an A slice of
    (rows, <= 32) and a B slice of (<= 32, cols)), the step's products in
    fresh accumulators, then added in f32."""
    acc = None
    for a, b in zip(a_steps, b_steps):
        a_hi, b_hi = tf32(a), tf32(b)
        a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
        part = np.zeros((a.shape[0], b.shape[1]), np.float32)
        for kk in range(0, a.shape[1], 8):
            for p, q in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
                part = to_f32_toward_zero(
                    part + p[:, kk:kk + 8].astype(np.float64)
                    @ q[kk:kk + 8].astype(np.float64))
        acc = part if acc is None else acc + part
    return acc


def cluster_sum(steps, cluster, a_step, b_step, shape):
    """The tile's steps split across the cluster's ranks, each rank's
    partial tile, and their sum in rank order. ``a_step(s)``/``b_step(s)``
    give step s's slices; all of a row's columns at once (the column tiles
    of one row slice split their steps alike)."""
    total = None
    for rank in range(cluster):
        own = range(steps * rank // cluster, steps * (rank + 1) // cluster)
        part = rank_partial([a_step(s) for s in own], [b_step(s) for s in own])
        if part is None:
            part = np.zeros(shape, np.float32)
        total = part if total is None else total + part
    return total


def store_units(rows, ncols, cluster):
    """(row, column) of every element the tile's ranks store: rank r takes
    the units of 4 columns e with (e // THREADS) % cluster == r."""
    units = np.arange(rows * (NT // 4))
    out = []
    for rank in range(cluster):
        e = units[units // THREADS % cluster == rank]
        i, j = e // (NT // 4), e % (NT // 4) * 4
        for c in range(4):
            keep = j + c < ncols
            out.append((i[keep], (j + c)[keep]))
    return (np.concatenate([i for i, _ in out]),
            np.concatenate([j for _, j in out]))


def emulate_row_tiles(blocks, cols, ranges, m, x, cluster):
    """(Y, write counts) of a row-tiled launch (``row_tile_spmm``) as the
    kernel computes them: row of blocks r is made of the (bm, bk) blocks
    ``ranges[r][0] .. ranges[r][1] - 1`` of ``blocks``, block b at block
    column ``cols[b]``; X rows past k read as zeros."""
    k, n = x.shape
    _, bm, bk = blocks.shape
    slices, col_tiles, nq = cdiv(bm, ROWS), cdiv(n, NT), cdiv(bk, TK)
    xp = np.zeros((max(k, (cols.max(initial=0) + 1) * bk), n), np.float32)
    xp[:k] = x
    y = np.full((m, n), np.nan, np.float32)
    writes = np.zeros((m, n), np.int64)
    sums = {}
    for tile in range(len(ranges) * slices * col_tiles):
        n0 = tile % col_tiles * NT
        i0 = tile // col_tiles % slices * ROWS
        r = tile // col_tiles // slices
        rows = min(ROWS, bm - i0)
        if (r, i0) not in sums:
            begin, end = ranges[r]

            def a_step(s, begin=begin, i0=i0, rows=rows):
                b, k0 = begin + s // nq, s % nq * TK
                return blocks[b, i0:i0 + rows, k0:k0 + TK]

            def b_step(s, begin=begin):
                b, k0 = begin + s // nq, s % nq * TK
                x0 = cols[b] * bk + k0
                return xp[x0:x0 + min(TK, bk - k0)]

            sums[r, i0] = cluster_sum((end - begin) * nq, cluster, a_step,
                                      b_step, (rows, n))
        row0 = r * bm + i0
        i, j = store_units(min(rows, m - row0), min(NT, n - n0), cluster)
        writes[row0 + i, n0 + j] += 1
        y[row0 + i, n0 + j] = sums[r, i0][i, n0 + j]
    return y, writes


def emulate_bsr_spmm(a: DeviceBSR, x: np.ndarray, cluster: int):
    """(Y, write counts) as ``bsr_spmm``'s kernel computes them: block row
    r's blocks are ``row_ptr[r] .. row_ptr[r + 1] - 1``."""
    row_ptr = a.row_ptr.numpy()
    return emulate_row_tiles(a.blocks.numpy(), a.block_cols.numpy(),
                             list(zip(row_ptr[:-1], row_ptr[1:])),
                             a.shape[0], x, cluster)


def emulate_panel_spmm(a: DevicePanels, x: np.ndarray, cluster: int):
    """(Y, write counts) as ``panel_spmm``'s kernel computes them: band b's
    blocks are its real panels, slots ``b max_p .. b max_p + counts[b] -
    1``; its pad slots are never read."""
    starts = np.arange(a.bands) * a.max_p
    return emulate_row_tiles(a.panels.numpy(), a.block_cols.numpy(),
                             list(zip(starts, starts + a.counts.numpy())),
                             a.shape[0], x, cluster)


def emulate_bsr_sddmm(mask: DeviceBSR, q: np.ndarray, kmat: np.ndarray,
                      cluster: int):
    """(S blocks, write counts) as the kernel computes them."""
    nb, bm, bk = mask.blocks.shape
    d = q.shape[1]
    brows, bcols = mask.block_rows.numpy(), mask.block_cols.numpy()
    mvals = mask.blocks.numpy()
    slices, col_tiles = cdiv(bm, ROWS), cdiv(bk, NT)

    def rows_of(mat, r0, count):   # rows past the operand read as zeros
        out = np.zeros((count, d), np.float32)
        have = mat[r0:r0 + count]
        out[:len(have)] = have
        return out

    out = np.full((nb, bm, bk), np.nan, np.float32)
    writes = np.zeros((nb, bm, bk), np.int64)
    sums = {}
    for tile in range(nb * slices * col_tiles):
        j0 = tile % col_tiles * NT
        i0 = tile // col_tiles % slices * ROWS
        b = tile // col_tiles // slices
        rows = min(ROWS, bm - i0)
        if (b, i0) not in sums:
            qa = rows_of(q, brows[b] * bm + i0, rows)
            kb = rows_of(kmat, bcols[b] * bk, bk)
            sums[b, i0] = cluster_sum(
                cdiv(d, TK), cluster,
                lambda s, qa=qa: qa[:, s * TK:(s + 1) * TK],
                lambda s, kb=kb: kb[:, s * TK:(s + 1) * TK].T, (rows, bk))
        i, j = store_units(rows, min(NT, bk - j0), cluster)
        writes[b, i0 + i, j0 + j] += 1
        out[b, i0 + i, j0 + j] = (sums[b, i0][i, j0 + j]
                                  * mvals[b, i0 + i, j0 + j])
    return out, writes


def relative_to_scale(got, ref, scale):
    sig = scale > 1e-4
    diff = np.abs(got.astype(np.float64) - ref)
    return float(np.where(sig, diff / np.where(sig, scale, 1.0), diff).max())


def positive(csr):
    return CSRMatrix(csr.row_ptr, csr.col_idx,
                     (np.abs(csr.values) + 0.1).astype(np.float32),
                     csr.shape, csr.name)


def signed(csr, seed):
    flip = np.random.default_rng(seed).choice([-1, 1], csr.nnz)
    return CSRMatrix(csr.row_ptr, csr.col_idx,
                     (csr.values * flip).astype(np.float32), csr.shape,
                     csr.name)


def empty_rows_matrix():
    """300 x 260, 10 % dense; rows 8-23 and 150-199 empty (empty block rows
    at bm = 8 and 16, a part-empty one above); neither m nor k is a
    multiple of any bm or of 128."""
    d = positive(random_csr(300, 260, 0.1, seed=3)).to_dense()
    d[8:24] = 0.0
    d[150:200] = 0.0
    return dense_to_csr(d.astype(np.float32), name="empty_rows")


def operand(shape, seed, values="positive"):
    rng = np.random.default_rng(seed)
    if values == "signed":
        return rng.standard_normal(shape).astype(np.float32)
    return (rng.random(shape) + 0.5).astype(np.float32)


def check_spmm(csr, bm, n, pad=1, values="positive", cluster=MAIN_CLUSTER):
    a = DeviceBSR.from_csr(csr, bm=bm, bk=128, pad_multiple=pad,
                           device="cpu")
    x = operand((csr.k, n), 5, values)
    y, writes = emulate_bsr_spmm(a, x, cluster)
    np.testing.assert_array_equal(writes, 1)
    d = csr.to_dense().astype(np.float64)
    ref = d @ x.astype(np.float64)
    scale = np.abs(d) @ np.abs(x.astype(np.float64))
    assert relative_to_scale(y, ref, scale) <= 1e-5


def check_sddmm(mask_csr, bm, d, mq, mk, pad=1, values="positive",
                cluster=MAIN_CLUSTER):
    mask = DeviceBSR.from_csr(mask_csr, bm=bm, bk=128, pad_multiple=pad,
                              device="cpu")
    q, kmat = operand((mq, d), 7, values), operand((mk, d), 8, values)
    got, writes = emulate_bsr_sddmm(mask, q, kmat, cluster)
    np.testing.assert_array_equal(writes, 1)
    q64, k64 = q.astype(np.float64), kmat.astype(np.float64)
    ref = bsr_sddmm_f64(mask, q64, k64)
    scale = bsr_sddmm_f64(mask.with_blocks(mask.blocks.abs()), np.abs(q64),
                          np.abs(k64))
    assert relative_to_scale(got, ref, scale) <= 1e-5


def bsr_sddmm_f64(mask, q, kmat):
    """mask ⊙ (Q Kᵀ) on the mask's blocks, in f64 (pad blocks and rows past
    Q or K give zeros)."""
    nb, bm, bk = mask.blocks.shape
    rows = (mask.block_rows.numpy().max(initial=0) + 1) * bm
    cols = (mask.block_cols.numpy().max(initial=0) + 1) * bk
    qp = np.zeros((max(rows, len(q)), q.shape[1]))
    qp[:len(q)] = q
    kp = np.zeros((max(cols, len(kmat)), q.shape[1]))
    kp[:len(kmat)] = kmat
    out = np.empty((nb, bm, bk))
    for b, (r, c) in enumerate(zip(mask.block_rows.numpy(),
                                   mask.block_cols.numpy())):
        out[b] = qp[r * bm:(r + 1) * bm] @ kp[c * bk:(c + 1) * bk].T
    return out * mask.blocks.double().numpy()


@pytest.mark.parametrize("n", [1, 70, 200, 512])
@pytest.mark.parametrize("bm", [8, 16, 128, 200])
def test_bsr_spmm_emulation_gives_the_f64_product(bm, n):
    # empty block rows, pad blocks (pad_multiple 3), ragged m and k
    check_spmm(empty_rows_matrix(), bm, n, pad=3)


@pytest.mark.parametrize("d", [1, 70, 200, 512])
@pytest.mark.parametrize("bm", [8, 16, 128, 200])
def test_bsr_sddmm_emulation_gives_the_masked_f64_product(bm, d):
    # a 200^2 mask: mq = mk = 200 is ragged against every bm and bk = 128;
    # pad blocks at block row mb give zero blocks
    mask = create_mask("band_and_random", 200, 0.8, band_size=4, seed=14)
    check_sddmm(mask, bm, d, 200, 200, pad=4)


def test_sddmm_reads_rows_past_q_and_k_as_zeros():
    # Q and K shorter than the mask's block grid covers
    mask = create_mask("band_and_random", 300, 0.7, band_size=8, seed=3)
    check_sddmm(mask, 128, 70, 260, 230)


@pytest.mark.parametrize("values", ["positive", "signed"])
def test_flagship_shapes(values):
    """The headline's and the pipeline's SpMM (512^2, bm = 128, n = 512) and
    the pipeline mask's SDDMM (d = 512): the card's grid of few tiles (32
    and 26), split across clusters of 4."""
    wk, _, _, mask = flagship_csrs()
    # the headline's and the weights' layouts have the same shape
    csr = signed(headline_matrix(), 1) if values == "signed" else wk
    check_spmm(csr, 128, 512, values=values)
    check_sddmm(mask, 128, 512, 512, 512, values=values)


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("kernel", ["bsr_spmm", "bsr_sddmm"])
def test_every_cluster_size_gives_the_product(kernel, cluster):
    """Each cluster size the launch rule may pick (or a caller force): the
    ranks' step ranges cover the tile's steps once, ranks left without a
    step add zeros, and the rank-order sum gives the product; bm = 200 runs
    as row slices of 128 and 72."""
    if kernel == "bsr_spmm":
        check_spmm(positive(random_csr(500, 300, 0.2, seed=6)), 200, 77,
                   pad=3, cluster=cluster)
    else:
        mask = create_mask("band_and_random", 200, 0.8, band_size=4, seed=14)
        check_sddmm(mask, 200, 70, 200, 200, pad=4, cluster=cluster)


def panel_matrix():
    """2500 x 300, 5 % dense: bands of 2048 rows (the layout's default R)
    are two, the second ragged; rows 208-311 are empty (an empty band at R =
    104, a part-empty one at R = 8), and the second band holds no nnz in
    block column 2, so it has a pad slot (k = 300: three block columns, the
    last ragged)."""
    d = positive(random_csr(2500, 300, 0.05, seed=11)).to_dense()
    d[208:312] = 0.0
    d[2048:, 256:] = 0.0
    return dense_to_csr(d.astype(np.float32), name="panel_matrix")


# band rows R -> (matrix, band_rows asked of the layout)
PANELS = {
    8: (empty_rows_matrix, 8),          # bands of one 8-row slice
    40: (lambda: positive(random_csr(40, 300, 0.2, seed=12)), 2048),
    104: (panel_matrix, 104),           # R not a multiple of 64
    1000: (lambda: positive(random_csr(1000, 300, 0.05, seed=13)), 2048),
    2048: (panel_matrix, 2048),         # 16 slices of 128
}


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("R", sorted(PANELS))
def test_panel_spmm_emulation_gives_the_f64_product(R, cluster):
    """The panel launch: a band is a row of blocks whose blocks are its
    real panels; bands of R rows run as slices of 128 (R = 1000: the last
    of 104 rows; R = 40 and 8: one warpgroup); pad slots, filled with NaN
    here, are never read; each output element is written once, an empty
    band's as zeros."""
    make, band_rows = PANELS[R]
    csr = make()
    a = DevicePanels.from_csr(csr, bk=128, band_rows=band_rows, device="cpu")
    assert a.band_rows == R
    counts = a.counts.numpy()
    pad = np.arange(a.max_p)[None, :] >= counts[:, None]
    if R in (104, 2048):
        assert pad.any()
    a.panels.view(a.bands, a.max_p, R, -1)[torch.from_numpy(pad)] = np.nan
    x = operand((csr.k, 70), 5)
    y, writes = emulate_panel_spmm(a, x, cluster)
    np.testing.assert_array_equal(writes, 1)
    d = csr.to_dense().astype(np.float64)
    ref = d @ x.astype(np.float64)
    scale = np.abs(d) @ np.abs(x.astype(np.float64))
    assert relative_to_scale(y, ref, scale) <= 1e-5
