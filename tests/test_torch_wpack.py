"""The multi-row packed SpMV layout (DeviceWPACK) and WROW variant v2 against
the JAX package: host arrays element for element (through
``convert.wpack_from_jax``), the plain versions against the Pallas kernels
in interpret mode on one shape each (computed once in a module fixture:
the kernels' unrolled group loops compile for seconds), and edge cases
against the f64 dense product.

Tolerance: rtol 1e-5, atol 1e-6 (f32 sums in another order); the matrices
hold positive values, so no sum cancels below its terms' rounding.
"""

import dataclasses

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
from spgrid_torch.ops.kernels.wpack_spmv import (
    DeviceWPACK, csr_to_wpack, pick_wsel, wpack_spmv, wpack_spmv_plain,
)
from spgrid_torch.ops.kernels.wrow_spmv import (
    DeviceWROW, wrow_spmv, wrow_spmv_plain, wrow_spmv_v2,
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
                wrow_spmv_v2(a, torch.from_numpy(x), groups_per_cta=1)):
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
                        + 4 * a.piece_w.numel() + 4 * a.block_ptr.numel())


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
    with pytest.raises(ValueError, match="groups_per_cta"):
        wrow_spmv_v2(a, x, groups_per_cta=0)
    assert torch.equal(wrow_spmv(a, x), wrow_spmv(a, x, variant="v1"))
