"""The gather-ELL layout (DeviceDGELL) and its kernel's plain version against
the JAX package: host arrays element for element (through
``convert.dgell_from_jax``, which undoes the TPU's slot-major steps and lane
padding), the output against the Pallas kernel in interpret mode on one
shape (computed once in a module fixture), and edge cases against the f64
dense product.

Tolerance: rtol 1e-5, atol 1e-6 (f32 sums in another order); the matrices
hold positive values, so no sum cancels below its terms' rounding.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgrid.formats import CSRMatrix, dense_to_csr, random_csr
from spgrid.ops.pallas import dgell as jax_dgell
from spgrid_torch.entry import hypersparse_edge
from spgrid_torch.ops import convert, dispatch
from spgrid_torch.ops.kernels import launch_counts
from spgrid_torch.ops.kernels.dgell import (
    DeviceDGELL, dgell_arrays, dgell_spmm, dgell_spmm_plain, pick_slots,
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


def tail_spill():
    """Rows of 3 nnz, row 7 with 64 and row 100 with 40: both spill to the
    tail at their positions >= slots; rows 20-29 empty; k = 161."""
    rng = np.random.default_rng(3)
    d = np.zeros((160, 161), np.float32)
    for i in range(160):
        d[i, rng.choice(161, size=3, replace=False)] = rng.random(3) + 0.5
    d[7, :64] = rng.random(64) + 0.5
    d[100, 90:130] = rng.random(40) + 0.5
    d[20:30] = 0.0
    return dense_to_csr(d, name="tail_spill")


def even_degrees():
    """4 or 5 nnz in every row: the slot count is the largest degree."""
    d = np.zeros((96, 111), np.float32)
    for i in range(96):
        d[i, (7 * i + 3 * np.arange(4 + i % 2)) % 111] = 1.0 + i / 96
    return dense_to_csr(d, name="even_degrees")


def edge():
    e = hypersparse_edge()
    return CSRMatrix(e.row_ptr, e.col_idx, e.values, e.shape, "edge")


MATRICES = {
    "tail_spill": tail_spill,
    "edge": edge,
    # avg degree ~40: slots 50, so the JAX layout caps rb at 8
    "fanout_cap": lambda: positive(random_csr(203, 400, 0.1, seed=14)),
    "even_degrees": even_degrees,
    "empty": lambda: dense_to_csr(np.zeros((37, 70), np.float32)),
    "one_heavy_row": lambda: dense_to_csr(np.pad(
        np.ones((1, 300), np.float32), ((0, 4), (0, 0)))),
}
JAX_MATRIX, JAX_N = "tail_spill", 20


def operand(k, n, seed=7):
    return (np.random.default_rng(seed).random((k, n)) + 0.5).astype(
        np.float32)


def leaves_of(jax_layout):
    children, aux = jax_layout.tree_flatten()
    return [np.asarray(c) for c in children], list(aux)


@pytest.fixture(scope="module")
def jax_output():
    """(x, the Pallas kernel's output in interpret mode) for JAX_MATRIX."""
    csr = MATRICES[JAX_MATRIX]()
    x = operand(csr.k, JAX_N)
    y = jax_dgell.dgell_spmm(jax_dgell.DeviceDGELL.from_csr(csr),
                             jnp.asarray(x), interpret=True)
    return x, np.asarray(y)


def test_plain_matches_pallas(jax_output):
    x, want = jax_output
    a = DeviceDGELL.from_csr(MATRICES[JAX_MATRIX](), device="cpu")
    assert a.tail_rows.numel() > 0
    got = dgell_spmm_plain(a, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(dgell_spmm(a, torch.from_numpy(x)).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_wrapper_on_cpu_matches_dense_product(name):
    csr = MATRICES[name]()
    a = DeviceDGELL.from_csr(csr, device="cpu")
    for n in (1, 13, 40):
        x = operand(csr.k, n, seed=n)
        want = csr.to_dense().astype(np.float64) @ x.astype(np.float64)
        got = dgell_spmm(a, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        # small chunks of rows give the same result
        np.testing.assert_allclose(
            dgell_spmm_plain(a, torch.from_numpy(x), chunk_elems=64).numpy(),
            want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_from_jax_equals_from_csr(name):
    csr = MATRICES[name]()
    j = jax_dgell.DeviceDGELL.from_csr(csr)
    leaves, aux = leaves_of(j)
    got = convert.dgell_from_jax(*leaves, *aux, device="cpu")
    want = DeviceDGELL.from_csr(csr, device="cpu")
    assert want.slots == j.slots
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), f.name
        else:
            assert g == w, f.name
    # the ELL part and the tail hold exactly the JAX layout's nnz
    assert (int((want.values != 0).sum()) + want.tail_rows.numel()
            == int((np.asarray(j.values) != 0).sum()) + j.tail_rows.shape[0])


def test_tail_holds_the_positions_past_slots():
    csr = tail_spill()
    cols, vals, t_rows, t_cols, _, slots = dgell_arrays(csr)
    assert slots == pick_slots(csr) < 40
    # the tail: each row's nnz at positions >= slots, in CSR order
    deg = csr.degrees
    want = np.concatenate([np.arange(csr.row_ptr[r] + slots,
                                     csr.row_ptr[r + 1])
                           for r in range(csr.m) if deg[r] > slots])
    np.testing.assert_array_equal(t_rows, np.repeat(
        np.arange(csr.m), np.maximum(deg - slots, 0)))
    np.testing.assert_array_equal(t_cols, csr.col_idx[want])
    # the slots: each row's first nnz, empty slots column 0 and value 0
    np.testing.assert_array_equal(cols[7],
                                  csr.col_idx[csr.row_ptr[7]:][:slots])
    assert not vals[20:30].any() and not cols[20:30].any()


def test_slot_rule_follows_the_jax_package():
    # the largest degree when it is at most ceil(1.25 avg) + 2, else
    # ceil(1.25 avg); capped at 128
    assert pick_slots(even_degrees()) == 5
    spill = tail_spill()
    assert pick_slots(spill) == int(np.ceil(1.25 * spill.nnz / spill.m))
    heavy = dense_to_csr(np.ones((2, 600), np.float32))
    assert pick_slots(heavy) == 128
    for name, make in MATRICES.items():
        assert pick_slots(make()) == jax_dgell.DeviceDGELL.from_csr(
            make()).slots, name


def test_dispatch_format():
    csr = edge()
    a = dispatch.build(csr, "dgell_cuda", device="cpu")
    assert isinstance(a, DeviceDGELL)
    assert dispatch.JAX_NAME["dgell_cuda"] == "dgell"
    x = torch.from_numpy(operand(csr.k, 8))
    want = csr.to_dense().astype(np.float64) @ x.numpy().astype(np.float64)
    np.testing.assert_allclose(dispatch.spmm_fn("dgell_cuda")(a, x).numpy(),
                               want, rtol=RTOL, atol=ATOL)
    assert a.nbytes == 8 * a.cols.numel() + 12 * a.tail_rows.numel()


def test_cpu_path_counts_no_launch():
    a = DeviceDGELL.from_csr(edge(), device="cpu")
    before = launch_counts()
    dgell_spmm(a, torch.from_numpy(operand(a.shape[1], 8)))
    assert launch_counts() == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "ndim"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    a = DeviceDGELL.from_csr(edge(), device="cpu")
    x = torch.from_numpy(operand(a.shape[1], 8))
    x, err = {"dtype": (x.double(), TypeError),
              "shape": (x[:-1], ValueError),
              "device": (x.to("meta"), ValueError),
              "ndim": (x[:, 0], ValueError)}[bad]
    with pytest.raises(err):
        dgell_spmm(a, x)
