"""The COO and SELL-C-sigma formats of the port (``spgrid_torch.ops.xla``,
``DeviceCOO``, ``DeviceSELL``) against the JAX package's: the layouts array
for array, and ``spmm_coo``, ``spmv_coo``, ``spmm_sell`` and ``spmv_sell``
against the JAX functions (XLA on the CPU) and the f64 product; and
``xla.segment_sum``, the run sum of COO, GELL's tail, merge's fix-up and
the softmax, against the f64 and the in-order f32 sums.

Tolerance: 1e-5 relative (f32 sums in another order); the matrices hold
positive values and X lies in [0.5, 1.5), so no sum cancels below its
terms' rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgrid.formats.csr import CSRMatrix, dense_to_csr
from spgrid.gen.artificial import artificial_matrix_generation
from spgrid.ops import xla as jax_xla
from spgrid.ops.layouts import DeviceCOO as JaxCOO
from spgrid.ops.layouts import DeviceSELL as JaxSELL
from spgrid_torch.core.metrics import gold_spmm_fast
from spgrid_torch.ops import xla
from spgrid_torch.ops.layouts import DeviceCOO, DeviceSELL

# The suite runs in parallel workers on shared cores: one intra-op thread
# a worker keeps these small CPU tensors from oversubscribing them.
torch.set_num_threads(1)

RTOL = 1e-5
N = 16


def positive(csr):
    return CSRMatrix(csr.row_ptr, csr.col_idx,
                     (np.abs(csr.values) + 0.1).astype(np.float32),
                     csr.shape, csr.name)


def monster():
    """One 4,000-nnz row among 499 singletons (the JAX merge test's)."""
    m = 500
    deg = np.ones(m, np.int64)
    deg[7] = 4000
    rng = np.random.default_rng(0)
    nnz = int(deg.sum())
    return CSRMatrix(np.concatenate([[0], np.cumsum(deg)]),
                     rng.integers(0, m, nnz),
                     (rng.random(nnz) + 0.1).astype(np.float32), (m, m),
                     "monster")


def empty_and_dense_rows():
    """13 x 40 (m not a multiple of 8): rows 0, 5 and 6 empty, row 3 full,
    the rest 1-3 nnz."""
    rng = np.random.default_rng(4)
    d = np.zeros((13, 40), np.float32)
    for i in range(13):
        d[i, rng.choice(40, size=1 + i % 3, replace=False)] = rng.random() + 1
    d[[0, 5, 6]] = 0.0
    d[3] = rng.random(40) + 0.5
    return dense_to_csr(d, name="empty_dense")


MATRICES = {
    "generated": lambda: positive(artificial_matrix_generation(
        700, 650, 6, 2.0, "normal", seed=3, placement="random", bw=0.3)),
    "skewed": lambda: positive(artificial_matrix_generation(
        999, 999, 8, 40.0, "gamma", seed=5, placement="random", bw=0.9)),
    "monster": monster,
    "empty_dense": empty_and_dense_rows,
}


@pytest.fixture(scope="module")
def cases():
    """Each matrix with X (k, N) and x (k,), and the JAX functions' outputs
    on them, computed once."""
    out = {}
    for name, make in MATRICES.items():
        csr = make()
        rng = np.random.default_rng(7)
        x = (rng.random((csr.k, N)) + 0.5).astype(np.float32)
        coo, sell = JaxCOO.from_csr(csr), JaxSELL.from_csr(csr)
        out[name] = dict(
            csr=csr, x=x, coo=coo, sell=sell,
            coo_mm=np.asarray(jax_xla.spmm_coo(coo, jnp.asarray(x))),
            coo_mv=np.asarray(jax_xla.spmv_coo(coo, jnp.asarray(x[:, 0]))),
            sell_mm=np.asarray(jax_xla.spmm_sell(sell, jnp.asarray(x))),
            sell_mv=np.asarray(jax_xla.spmv_sell(sell,
                                                 jnp.asarray(x[:, 0]))))
    return out


@pytest.mark.parametrize("name", MATRICES)
def test_coo_layout_is_the_jax_one(cases, name):
    c = cases[name]
    a = DeviceCOO.from_csr(c["csr"], device="cpu")
    for field in ("cols", "values"):
        want = np.asarray(getattr(c["coo"], field))
        got = getattr(a, field).numpy()
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    assert a.shape == c["coo"].shape and a.nnz == c["coo"].nnz
    # padding: to a multiple of 128 with row m, column 0 and value 0
    nnz, m = c["csr"].nnz, c["csr"].m
    ptr = a.row_ptr.numpy()
    rows = np.full(len(a.cols), m, np.int32)
    rows[:nnz] = np.repeat(np.arange(m, dtype=np.int32), np.diff(ptr))
    np.testing.assert_array_equal(rows, np.asarray(c["coo"].rows))
    assert len(a.cols) % 128 == 0 and len(a.cols) - nnz < 128
    assert ptr[-1] == nnz and (a.cols[nnz:] == 0).all()
    assert (a.values[nnz:] == 0).all()


@pytest.mark.parametrize("name", MATRICES)
def test_sell_layout_is_the_jax_one(cases, name):
    c = cases[name]
    a = DeviceSELL.from_csr(c["csr"], device="cpu")
    j = c["sell"]
    np.testing.assert_array_equal(a.perm.numpy(), np.asarray(j.perm))
    assert a.C == j.C and a.shape == j.shape and a.nnz == j.nnz
    for field in ("bucket_cols", "bucket_vals", "bucket_slice_rows"):
        got, want = getattr(a, field), getattr(j, field)
        assert len(got) == len(want), field
        for g, w in zip(got, want):
            assert g.numpy().dtype == np.asarray(w).dtype, field
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=field)
    # pad slots hold the unique rows m .. m_pad-1; the buckets' slices
    # cover every slot once
    m = c["csr"].m
    perm = a.perm.numpy()
    np.testing.assert_array_equal(perm[m:], np.arange(m, len(perm)))
    assert sorted(perm) == list(range(len(perm)))
    slots = np.concatenate([(s[:, None] + np.arange(a.C)).reshape(-1)
                            for s in (b.numpy() for b in a.bucket_slice_rows)])
    assert sorted(slots) == list(range(len(perm)))


def gold(c, x):
    csr = c["csr"]
    return gold_spmm_fast(csr.row_ptr, csr.col_idx, csr.values, x)


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("fmt", ["coo", "sell"])
def test_spmm_matches_jax_and_the_f64_product(cases, name, fmt):
    c = cases[name]
    layout = {"coo": DeviceCOO, "sell": DeviceSELL}[fmt]
    spmm = {"coo": xla.spmm_coo, "sell": xla.spmm_sell}[fmt]
    got = spmm(layout.from_csr(c["csr"], device="cpu"),
               torch.from_numpy(c["x"]))
    assert got.dtype == torch.float32 and got.shape == (c["csr"].m, N)
    np.testing.assert_allclose(got.numpy(), c[f"{fmt}_mm"], rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), gold(c, c["x"]), rtol=RTOL)


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("fmt", ["coo", "sell"])
def test_spmv_matches_jax_and_the_f64_product(cases, name, fmt):
    c = cases[name]
    layout = {"coo": DeviceCOO, "sell": DeviceSELL}[fmt]
    spmv = {"coo": xla.spmv_coo, "sell": xla.spmv_sell}[fmt]
    x = np.ascontiguousarray(c["x"][:, 0])
    got = spmv(layout.from_csr(c["csr"], device="cpu"), torch.from_numpy(x))
    assert got.shape == (c["csr"].m,)
    np.testing.assert_allclose(got.numpy(), c[f"{fmt}_mv"], rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), gold(c, x), rtol=RTOL)


def test_sums_run_in_f64_for_an_f64_operand(cases):
    c = cases["generated"]
    x = torch.from_numpy(c["x"]).double()
    for layout, spmm in ((DeviceCOO, xla.spmm_coo),
                         (DeviceSELL, xla.spmm_sell)):
        got = spmm(layout.from_csr(c["csr"], device="cpu"), x)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), gold(c, c["x"]), rtol=1e-12)


# run lengths: empty runs among them, as COO's empty rows give
RUNS = {
    "singletons": [1] * 50,
    "mixed": [1, 0, 2, 3, 0, 0, 4, 5, 7, 8, 9, 16, 17, 1, 31],
    "one_long": [1000],
    "skewed": [3] * 40 + [4097] + [0, 2] * 15,
}


@pytest.mark.parametrize("name", RUNS)
def test_segment_sum_adds_each_run_in_order(name):
    """``xla.segment_sum``: each run's sum (an empty run 0) against the f64
    sum, and in f32 the left-to-right sum of its entries bit for bit."""
    lengths = np.asarray(RUNS[name])
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    vals = (np.random.default_rng(1).random((offsets[-1], 3)) + 0.5).astype(
        np.float32)
    got = xla.segment_sum(torch.from_numpy(vals), torch.from_numpy(offsets))
    assert got.shape == (len(lengths), 3)
    want = np.stack([vals[a:b].astype(np.float64).sum(0)
                     for a, b in zip(offsets[:-1], offsets[1:])])
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    ordered = np.zeros((len(lengths), 3), np.float32)
    for i, (a, b) in enumerate(zip(offsets[:-1], offsets[1:])):
        for row in vals[a:b]:
            ordered[i] += row
    np.testing.assert_array_equal(got.numpy(), ordered)
