"""The reorder-block hybrid of the port (``spgrid_torch/ops/rbh.py``, with
its copy of ``formats/reorder.py``) against the JAX package's, under the JAX
package's constants: the column orders element for element, the inspect
step's split, residual format, permutation and block part array for array,
and ``rbh_spmm`` on the CPU against the JAX ``rbh_spmm`` (the Pallas block
kernel in interpret mode) within 1e-5 relative, on positive values. Also
traps 1 and 5 on a block part whose empty block rows outnumber its full
ones."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spgrid.formats.reorder as jax_reorder
import spgrid.ops.costmodel as jax_costmodel
import spgrid.ops.rbh as jax_rbh
from spgrid.gen import artificial_matrix_generation
from spgrid.formats import random_csr
from spgrid_torch.core.metrics import gold_spmm_fast
from spgrid_torch.formats import reorder
from spgrid_torch.formats.csr import CSRMatrix, dense_to_csr
from spgrid_torch.ops import costmodel
from spgrid_torch.ops import rbh
from spgrid_torch.ops.rbh import DeviceRBH, rbh_spmm

torch.set_num_threads(1)

N = 16
RTOL = 1e-5


def positive(csr):
    csr.values = (np.abs(csr.values) + 0.1).astype(np.float32)
    return csr


def port_csr(csr) -> CSRMatrix:
    return CSRMatrix(csr.row_ptr, csr.col_idx, csr.values, csr.shape,
                     csr.name)


def clustered(m=2048, crs=0.9):
    """``tests/test_rbh.py``'s clustered-scattered matrix."""
    return positive(artificial_matrix_generation(
        m, m, 8, 2.5, "normal", seed=14, placement="random", bw=0.9,
        skew=0, avg_num_neighbours=0.9, cross_row_similarity=crs))


def banded():
    return positive(artificial_matrix_generation(
        1024, 1024, 20, 5, "normal", seed=14, placement="diagonal", bw=0.05,
        skew=0, avg_num_neighbours=0.9, cross_row_similarity=0.9))


# name -> (matrix, rbh thresholds: None is auto_threshold). The JAX
# tests' thresholds keep every block of these matrices; the second one of
# each splits them near their mean block fill (~1,017, 164 and 892 nnz)
CASES = {
    "clustered": (clustered, (None, 1000)),
    "random": (lambda: positive(random_csr(512, 512, density=0.01, seed=7)),
               (8, 170)),
    "banded": (banded, (16, 900)),
}


def jax_constants():
    return costmodel.H100Constants(
        **dataclasses.asdict(jax_costmodel.C), residual_nnz=29e-9)


@pytest.fixture
def jax_c(monkeypatch):
    monkeypatch.setattr(costmodel, "C", jax_constants())


@pytest.fixture(scope="module")
def cases():
    """Each matrix, X and, at each threshold, the JAX layout and product,
    computed once."""
    out = {}
    for name, (make, thresholds) in CASES.items():
        csr = make()
        x = (np.random.default_rng(3).random((csr.k, N)) + 0.5).astype(
            np.float32)
        layouts = {t: jax_rbh.DeviceRBH.from_csr(csr, threshold=t)
                   for t in thresholds}
        ys = {t: np.asarray(jax_rbh.rbh_spmm(a, jnp.asarray(x)))
              for t, a in layouts.items()}
        out[name] = dict(csr=csr, x=x, layouts=layouts, ys=ys)
    return out


@pytest.mark.parametrize("name", CASES)
def test_column_orders_equal_jax(cases, name):
    csr = cases[name]["csr"]
    for port_order, jax_order in (
            (reorder.first_use_col_order, jax_reorder.first_use_col_order),
            (reorder.centroid_col_order, jax_reorder.centroid_col_order)):
        got, want = port_order(port_csr(csr)), jax_order(csr)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_other_reorder_passes_equal_jax():
    csr = banded()
    for fn in ("rcm_order", "degree_sort_order", "shuffle_order"):
        np.testing.assert_array_equal(getattr(reorder, fn)(port_csr(csr)),
                                      getattr(jax_reorder, fn)(csr))
    got, want = reorder.rcm(port_csr(csr)), jax_reorder.rcm(csr)
    for field in ("row_ptr", "col_idx", "values"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


def test_auto_threshold_equals_jax(jax_c):
    for n in (1, 64, 512):
        assert rbh.auto_threshold(n) == jax_rbh.auto_threshold(n)


@pytest.mark.parametrize("name", CASES)
def test_split_equals_jax(cases, name, jax_c):
    c = cases[name]
    for t, want in c["layouts"].items():
        got = DeviceRBH.from_csr(port_csr(c["csr"]), threshold=t,
                                 device="cpu")
        assert got.stats.as_dict() == want.stats.as_dict(), t
        if want.res is not None:
            assert got.res_fmt == want.res_fmt
        assert (got.perm is None) == (want.perm is None)
        if want.perm is not None:
            np.testing.assert_array_equal(got.perm.numpy(),
                                          np.asarray(want.perm))
        assert (got.bsr is None) == (want.bsr is None)
        if want.bsr is not None:
            for field in ("block_rows", "block_cols", "blocks"):
                np.testing.assert_array_equal(
                    getattr(got.bsr, field).numpy(),
                    np.asarray(getattr(want.bsr, field)), err_msg=field)


def test_the_cases_split_both_ways(cases, jax_c):
    """The second thresholds reach both parts on every matrix: a
    reordering on the clustered one, identity on the banded one."""
    st = {name: c["layouts"][CASES[name][1][1]].stats
          for name, c in cases.items()}
    assert st["clustered"].method in ("first_use", "centroid")
    assert st["banded"].method == "identity"
    for s in st.values():
        assert s.hi_blocks and s.lo_nnz, s


@pytest.mark.parametrize("name", CASES)
def test_rbh_spmm_matches_jax(cases, name, jax_c):
    c = cases[name]
    for t, want in c["ys"].items():
        a = DeviceRBH.from_csr(port_csr(c["csr"]), threshold=t,
                               device="cpu")
        got = rbh_spmm(a, torch.from_numpy(c["x"]))
        assert got.shape == (c["csr"].m, N) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
        gold = gold_spmm_fast(c["csr"].row_ptr, c["csr"].col_idx,
                              c["csr"].values, c["x"])
        np.testing.assert_allclose(got.numpy(), gold, rtol=RTOL)


@pytest.mark.parametrize("residual", ["sell", "merge", "coo"])
def test_every_residual_format(cases, residual, jax_c):
    c = cases["clustered"]
    a = DeviceRBH.from_csr(port_csr(c["csr"]), threshold=1000,
                           residual=residual, device="cpu")
    assert a.res_fmt == residual
    np.testing.assert_allclose(rbh_spmm(a, torch.from_numpy(c["x"])).numpy(),
                               c["ys"][1000], rtol=RTOL)


def sparse_block_rows(m=2048, full=(3, 9), seed=51):
    """m x m, ~0.1 % scattered, block rows ``full`` half dense in one
    128-column window: a block part of 2 full block rows and 14 empty
    ones."""
    rng = np.random.default_rng(seed)
    d = np.where(rng.random((m, m)) < 0.001, rng.random((m, m)) + 0.5, 0.0)
    for b in full:
        win = rng.random((128, 128))
        d[b * 128:(b + 1) * 128, 512:640] = np.where(win < 0.5, win + 0.5,
                                                    0.0)
    return dense_to_csr(d.astype(np.float32), name="sparse_block_rows")


def test_block_part_with_more_empty_block_rows_than_full_ones():
    """Trap 1: a zero coverage block for each empty block row (14, against
    2 kept blocks); trap 5: ``row_ptr`` rebuilt from the blocks, where
    ``row_starts`` goes stale past the first empty block row; the product
    is the f64 one."""
    csr = sparse_block_rows()
    a = DeviceRBH.from_csr(csr, threshold=64, device="cpu")
    assert a.stats.hi_blocks == 2 and a.bsr.mb == 16
    assert a.coverage_blocks == 14 > a.stats.hi_blocks
    ptr = a.bsr.row_ptr.numpy()
    assert (np.diff(ptr) == 1).all()           # a block every block row
    assert not np.array_equal(ptr, a.bsr.row_starts.numpy())
    cover = a.bsr.blocks.numpy()[np.diff(ptr) == 1]
    assert (np.abs(cover).sum(axis=(1, 2)) == 0).sum() == 14
    x = (np.random.default_rng(5).random((csr.k, N)) + 0.5).astype(
        np.float32)
    got = rbh_spmm(a, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, gold_spmm_fast(csr.row_ptr, csr.col_idx, csr.values, x),
        rtol=RTOL)


def test_rbh_with_no_kept_block_and_empty_matrix():
    """A split that keeps nothing runs the residual alone; an empty matrix
    gives zeros."""
    csr = sparse_block_rows()
    a = DeviceRBH.from_csr(csr, threshold=10 ** 6, device="cpu")
    assert a.bsr is None and a.perm is None and a.coverage_blocks == 0
    x = torch.ones((csr.k, 3))
    np.testing.assert_allclose(
        rbh_spmm(a, x).numpy(),
        gold_spmm_fast(csr.row_ptr, csr.col_idx, csr.values, x.numpy()),
        rtol=RTOL)
    empty = dense_to_csr(np.zeros((40, 30), np.float32))
    e = DeviceRBH.from_csr(empty, device="cpu")
    assert e.bsr is None and e.res is None
    assert torch.equal(rbh_spmm(e, torch.ones((30, 2))), torch.zeros(40, 2))
