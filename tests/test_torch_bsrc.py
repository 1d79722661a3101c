"""The C-stationary block layout (DeviceBSRCol) and its kernel's plain
version against the JAX package: host arrays element for element, the
output against the Pallas kernel in interpret mode on one shape (computed
once in a module fixture: interpret mode runs every grid step on the host),
and edge cases against the f64 dense product; and a numpy emulation of the
CUDA kernel's 3xTF32 tensor-core arithmetic, which the card alone runs.

Tolerance: rtol 1e-5, atol 1e-6 (f32 sums in another order); the matrices
hold positive values, so no sum cancels below its terms' rounding.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgrid.formats import CSRMatrix, dense_to_csr, random_csr
from spgrid.gen import artificial_matrix_generation
from spgrid.ops.pallas import bsr_spmm_cstat as jax_bsrc
from spgrid_torch.ops import convert, dispatch
from spgrid_torch.ops.kernels import launch_counts
from spgrid_torch.ops.kernels.bsr_spmm_cstat import (
    DeviceBSRCol, bsr_spmm_cstat, bsr_spmm_cstat_plain,
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


def bands_with_gaps():
    """300 x 260 at bm=8, band_rows=64: five bands, the last one short (44
    rows, m not a multiple of bm), band 1 (rows 64-127) empty, and block
    column 2 (k = 260) ragged."""
    d = positive(random_csr(300, 260, 0.1, seed=2)).to_dense()
    d[64:128] = 0.0
    return dense_to_csr(d.astype(np.float32), name="bands_with_gaps")


def padded_bands():
    """Bands with very different block counts, so most bands have pad
    slots that repeat their last column."""
    d = np.zeros((256, 300), np.float32)
    d[:8, :] = 1.0
    d[200, 5] = 3.0
    d[130:140, 250:] = 2.0
    return dense_to_csr(d, name="padded_bands")


# name: (matrix, bm, band_rows)
CASES = {
    "bands_with_gaps": (bands_with_gaps, 8, 64),
    "padded_bands": (padded_bands, 8, 64),
    "one_short_band_bm128": (
        lambda: positive(random_csr(200, 150, 0.3, seed=4)), 128, 2048),
    "banded_bm128": (lambda: positive(artificial_matrix_generation(
        1000, 700, 20, 5, "normal", seed=14, placement="random", bw=0.05,
        name="banded")), 128, 256),
    "empty": (lambda: dense_to_csr(np.zeros((130, 70), np.float32)), 8, 64),
}
JAX_CASE, JAX_N = "bands_with_gaps", 20


def operand(k, n, seed=7):
    return (np.random.default_rng(seed).random((k, n)) + 0.5).astype(
        np.float32)


def port_layout(case):
    make, bm, band_rows = CASES[case]
    return DeviceBSRCol.from_csr(make(), bm=bm, bk=128, band_rows=band_rows,
                                 device="cpu")


def jax_layout(case):
    make, bm, band_rows = CASES[case]
    return jax_bsrc.DeviceBSRCol.from_csr(make(), bm=bm, bk=128,
                                          band_rows=band_rows)


def leaves_of(jax_layout):
    children, aux = jax_layout.tree_flatten()
    return [np.asarray(c) for c in children], list(aux)


@pytest.fixture(scope="module")
def jax_output():
    """(x, the Pallas kernel's output in interpret mode) for JAX_CASE."""
    make, _, _ = CASES[JAX_CASE]
    x = operand(make().k, JAX_N)
    y = jax_bsrc.bsr_spmm_cstat(jax_layout(JAX_CASE), jnp.asarray(x),
                                interpret=True)
    return x, np.asarray(y)


def test_plain_matches_pallas(jax_output):
    x, want = jax_output
    a = port_layout(JAX_CASE)
    got = bsr_spmm_cstat_plain(a, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        bsr_spmm_cstat(a, torch.from_numpy(x)).numpy(), got.numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrapper_on_cpu_matches_dense_product(case):
    csr = CASES[case][0]()
    a = port_layout(case)
    for n in (1, 13, 40):
        x = operand(csr.k, n, seed=n)
        want = csr.to_dense().astype(np.float64) @ x.astype(np.float64)
        got = bsr_spmm_cstat(a, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_equals_jax_arrays(case):
    a, j = port_layout(case), jax_layout(case)
    (lrows, cols, blocks), aux = leaves_of(j)
    np.testing.assert_array_equal(a.local_rows.numpy(), lrows)
    np.testing.assert_array_equal(a.block_cols.numpy(), cols)
    np.testing.assert_array_equal(a.blocks.numpy(), blocks)
    assert (a.shape, a.nnz, a.num_blocks, a.band_rows, a.bands,
            a.max_nb) == tuple(aux)
    # counts: the real slots, which lead each band
    rows_per_band = a.band_rows // a.bm
    real = lrows.reshape(a.bands, a.max_nb) < rows_per_band
    np.testing.assert_array_equal(a.counts.numpy(), real.sum(axis=1))
    for b, c in enumerate(a.counts.tolist()):
        assert real[b, :c].all() and not real[b, c:].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_from_jax_equals_from_csr(case):
    leaves, aux = leaves_of(jax_layout(case))
    got = convert.bsrc_from_jax(*leaves, *aux, device="cpu")
    want = port_layout(case)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, torch.Tensor):
            assert torch.equal(g, w), f.name
        else:
            assert g == w, f.name


def test_bands_with_gaps_has_the_edges_it_names():
    a = port_layout("bands_with_gaps")
    assert a.bands == 5 and a.band_rows == 64 and a.shape[0] % 8 != 0
    assert a.counts[1] == 0 and a.counts.min() == 0
    assert (a.counts[[0, 2, 3, 4]] > 0).all()
    assert a.counts.max() == a.max_nb > a.counts[4]


def test_band_rows_follow_the_jax_rule():
    # R = min(band_rows, round_up(max(m, bm), bm)): a short matrix is one
    # band of fewer rows; a band's first output row is band * R
    a = DeviceBSRCol.from_csr(random_csr(200, 150, 0.3, seed=4), bm=128,
                              device="cpu")
    assert (a.band_rows, a.bands) == (256, 1)
    a = DeviceBSRCol.from_csr(random_csr(5000, 150, 0.01, seed=4), bm=128,
                              device="cpu")
    assert (a.band_rows, a.bands) == (2048, 3)


def test_dispatch_format():
    csr = CASES["banded_bm128"][0]()
    a = dispatch.build(csr, "bsrc_cuda", device="cpu")
    assert isinstance(a, DeviceBSRCol) and a.bm == 128
    assert dispatch.JAX_NAME["bsrc_cuda"] == "bsrc_pallas"
    x = torch.from_numpy(operand(csr.k, 8))
    want = csr.to_dense().astype(np.float64) @ x.numpy().astype(np.float64)
    np.testing.assert_allclose(dispatch.spmm_fn("bsrc_cuda")(a, x).numpy(),
                               want, rtol=RTOL, atol=ATOL)
    assert a.nbytes == sum(t.numel() * t.element_size() for t in (
        a.local_rows, a.block_cols, a.blocks, a.counts))


def test_cpu_path_counts_no_launch():
    a = port_layout("bands_with_gaps")
    before = launch_counts()
    bsr_spmm_cstat(a, torch.from_numpy(operand(a.shape[1], 8)))
    assert launch_counts() == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "ndim"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    a = port_layout("bands_with_gaps")
    x = torch.from_numpy(operand(a.shape[1], 8))
    x, err = {"dtype": (x.double(), TypeError),
              "shape": (x[:-1], ValueError),
              "device": (x.to("meta"), ValueError),
              "ndim": (x[:, 0], ValueError)}[bad]
    with pytest.raises(err):
        bsr_spmm_cstat(a, x)


def tf32(v):
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, by bits: what ``cvt.rna.tf32.f32`` gives."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def to_f32_toward_zero(v):
    """f64 to f32, rounded toward zero: an mma's f32 accumulate."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def tensor_core_product(a, x, split=True):
    """The CUDA kernel's arithmetic in numpy, at bm = 128 (a row slice is
    one block row), in slot order. For each 8 columns of a block, the
    products A_lo X_hi, A_hi X_lo and A_hi X_hi (A_hi X_hi alone without
    ``split``), each summed exactly and truncated to f32 into a step's
    accumulators; after each 32 columns (a step) these are added to the
    slice's accumulators in f32, rounding to nearest."""
    assert a.bm == 128
    lrows, cols = a.local_rows.numpy(), a.block_cols.numpy()
    blocks, counts = a.blocks.numpy(), a.counts.numpy()
    (m, k), n, bk, R = a.shape, x.shape[1], a.bk, a.band_rows
    xp = np.zeros((-(-k // bk) * bk, n), np.float32)
    xp[:k] = x
    y = np.zeros((a.bands * R, n), np.float32)
    for band in range(a.bands):
        slots = range(band * a.max_nb, band * a.max_nb + counts[band])
        for r in range(R // 128):
            acc = np.zeros((128, n), np.float32)
            for s in (s for s in slots if lrows[s] == r):
                blk, xs = blocks[s], xp[cols[s] * bk:(cols[s] + 1) * bk]
                a_hi, x_hi = tf32(blk), tf32(xs)
                a_lo, x_lo = tf32(blk - a_hi), tf32(xs - x_hi)
                terms = ([(a_lo, x_hi), (a_hi, x_lo), (a_hi, x_hi)] if split
                         else [(a_hi, x_hi)])
                for k0 in range(0, bk, 32):
                    part = np.zeros((128, n), np.float32)
                    for kk in range(k0, min(k0 + 32, bk), 8):
                        for p, q in terms:
                            part = to_f32_toward_zero(
                                part + p[:, kk:kk + 8].astype(np.float64)
                                @ q[kk:kk + 8].astype(np.float64))
                    acc = acc + part
            y[band * R + r * 128:band * R + (r + 1) * 128] = acc
    return y[:m]


def test_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)   # TF32's unit in the last place at 1
    got = tf32(np.array([one + ulp / 4, one + ulp / 2, -(one + ulp / 2),
                         one + 3 * ulp / 4], np.float32))
    np.testing.assert_array_equal(got, [one, one + ulp, -(one + ulp),
                                        one + ulp])


@pytest.mark.parametrize("values", ["positive", "signed"])
def test_3xtf32_keeps_f32_accuracy_where_tf32_does_not(values):
    """The split's error, |y - ref| over |A| @ |X| (the scale each output's
    rounding error is bound by; for positive operands it is |ref|, the
    check of the card tests and phase 1), where that exceeds 1e-4: within
    1e-5 with the split, above 1e-4 with one TF32 product."""
    csr = CASES["banded_bm128"][0]()
    rng = np.random.default_rng(11)
    x = operand(csr.k, 40)
    if values == "signed":
        csr = CSRMatrix(csr.row_ptr, csr.col_idx, (csr.values * rng.choice(
            [-1, 1], csr.nnz)).astype(np.float32), csr.shape, csr.name)
        x = rng.standard_normal((csr.k, 40)).astype(np.float32)
    a = DeviceBSRCol.from_csr(csr, bm=128, bk=128, band_rows=256,
                              device="cpu")
    d = csr.to_dense().astype(np.float64)
    ref = d @ x.astype(np.float64)
    scale = np.abs(d) @ np.abs(x.astype(np.float64))
    sig = scale > 1e-4

    def err(y):
        diff = np.abs(y - ref)
        return float(np.where(sig, diff / np.where(sig, scale, 1.0),
                              diff).max())

    assert err(tensor_core_product(a, x)) <= 1e-5
    assert err(tensor_core_product(a, x, split=False)) > 1e-4


def test_takes_the_jax_csr():
    csr = positive(random_csr(64, 40, 0.2, seed=9))
    assert isinstance(csr, CSRMatrix)
    a = DeviceBSRCol.from_csr(csr, bm=8, band_rows=32, device="cpu")
    x = operand(40, 3)
    np.testing.assert_allclose(
        bsr_spmm_cstat(a, torch.from_numpy(x)).numpy(),
        csr.to_dense().astype(np.float64) @ x, rtol=RTOL, atol=ATOL)
