"""The four hypersparse slot layouts and their kernels' plain versions against
the JAX package: host arrays element for element, outputs against the Pallas
kernels in interpret mode, and edge cases against the f64 dense product.

Interpret mode compiles each new shape anew (seconds, on several cores, for
the unrolled SpMV loops), so one shape a kernel goes through JAX, the edge
matrix, computed once in a module-scoped fixture; every other case is held
to the dense product.
Tolerance: rtol 1e-5, atol 1e-6 (f32 sums in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgrid.formats.csr import CSRMatrix, dense_to_csr
from spgrid.formats.wcoo import csr_to_wcoo as jax_csr_to_wcoo
from spgrid.formats.wcoo import csr_to_wcoo_aligned as jax_csr_to_aligned
from spgrid.gen import artificial_matrix_generation
from spgrid.ops.pallas import wcoo_spmm as jax_wcoo
from spgrid.ops.pallas import wcoo_spmm_aligned as jax_bands
from spgrid.ops.pallas import wcoo_spmv as jax_wcoo_spmv
from spgrid.ops.pallas import wrow_spmv as jax_wrow
from spgrid_torch.entry import hypersparse_edge
from spgrid_torch.formats import wcoo as port_wcoo
from spgrid_torch.ops import convert, dispatch
from spgrid_torch.ops.kernels import launch_counts
from spgrid_torch.ops.kernels.wcoo_spmm import (
    DeviceWCOO, wcoo_spmm, wcoo_spmm_plain,
)
from spgrid_torch.ops.kernels.wcoo_spmm_aligned import (
    DeviceWCOOBands, wcoo_spmm_aligned, wcoo_spmm_aligned_plain,
)
from spgrid_torch.ops.kernels.wcoo_spmv import (
    DeviceWCOOAligned, wcoo_spmv, wcoo_spmv_plain,
)
from spgrid_torch.ops.kernels.wrow_spmv import (
    DeviceWROW, csr_to_wrow, wrow_spmv, wrow_spmv_plain,
)

# The suite runs in parallel workers on shared cores: one intra-op thread
# a worker keeps these small CPU tensors from oversubscribing them.
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def edge_matrix():
    """The port's edge matrix (700 x 1100, ~5 scattered nnz a row; rows
    256-511 empty, an empty row block at R=256 and two empty 128-row blocks;
    row 3 holds 200 nnz in the last 200 columns, colliding in the last two
    128-column windows), as the JAX package's CSRMatrix."""
    e = hypersparse_edge()
    return CSRMatrix(e.row_ptr, e.col_idx, e.values, e.shape, "edge")


MATRICES = {
    "edge": edge_matrix,
    "hypersparse": lambda: artificial_matrix_generation(
        600, 2000, 5, 1.6667, "normal", seed=14, placement="random",
        bw=0.05, name="hyper"),
    "tiny": lambda: dense_to_csr(np.array([[0, 2.0, 0], [1.0, 0, 3.0]],
                                          np.float32)),
    "empty": lambda: dense_to_csr(np.zeros((130, 70), np.float32)),
    "one_row_k_lt_128": lambda: dense_to_csr(
        (np.random.default_rng(1).random((1, 90)) + 0.5).astype(np.float32)),
    "banded_1000": lambda: artificial_matrix_generation(
        1000, 1000, 20, 5, "normal", seed=3, placement="diagonal", bw=0.1,
        name="banded"),
}
# the shapes that go through JAX: matrix -> n
JAX_SHAPES = {"edge": 20}


def operand(k, n, seed=7):
    return (np.random.default_rng(seed).random((k, n)) + 0.5).astype(
        np.float32)


def dense_product(csr, x):
    return csr.to_dense().astype(np.float64) @ x.astype(np.float64)


def port_layouts(csr):
    """The four port layouts of ``csr`` on the CPU, with the row-block
    options of the JAX layouts in ``jax_layouts``."""
    return {
        "wcoo": DeviceWCOO.from_csr(csr, R=256, device="cpu"),
        "bands": DeviceWCOOBands.from_csr(csr, band_rows=256, device="cpu"),
        "wcoo_spmv": DeviceWCOOAligned.from_csr(csr, device="cpu"),
        "wrow": DeviceWROW.from_csr(csr, device="cpu"),
    }


def jax_layouts(csr):
    return {
        "wcoo": jax_wcoo.DeviceWCOO.from_csr(csr, R=256, W=128),
        "bands": jax_bands.DeviceWCOOBands.from_csr(csr, band_rows=256),
        "wcoo_spmv": jax_wcoo_spmv.DeviceWCOOAligned.from_csr(csr),
        "wrow": jax_wrow.DeviceWROW.from_csr(csr),
    }


PLAIN = {"wcoo": wcoo_spmm_plain, "bands": wcoo_spmm_aligned_plain,
         "wcoo_spmv": wcoo_spmv_plain, "wrow": wrow_spmv_plain}
WRAPPER = {"wcoo": wcoo_spmm, "bands": wcoo_spmm_aligned,
           "wcoo_spmv": wcoo_spmv, "wrow": wrow_spmv}
JAX_KERNEL = {"wcoo": jax_wcoo.wcoo_spmm, "bands": jax_bands.wcoo_spmm_aligned,
              "wcoo_spmv": jax_wcoo_spmv.wcoo_spmv, "wrow": jax_wrow.wrow_spmv}
SPMV = ("wcoo_spmv", "wrow")
FROM_JAX = {"wcoo": convert.wcoo_from_jax, "bands": convert.bands_from_jax,
            "wcoo_spmv": convert.wcoo_aligned_from_jax,
            "wrow": convert.wrow_from_jax}


def run_port(kind, a, x):
    fn = PLAIN[kind]
    if kind in SPMV:
        return fn(a, torch.from_numpy(x[:, 0].copy())).numpy()[:, None]
    return fn(a, torch.from_numpy(x)).numpy()


@pytest.fixture(scope="module")
def jax_outputs():
    """{(kind, matrix): (x, the JAX kernel's output in interpret mode)}, for
    the shapes of JAX_SHAPES, computed once."""
    out = {}
    for name, n in JAX_SHAPES.items():
        csr = MATRICES[name]()
        layouts = jax_layouts(csr)
        x = operand(csr.k, n)
        for kind, layout in layouts.items():
            xk = x[:, :1] if kind in SPMV else x
            arg = jnp.asarray(xk[:, 0] if kind in SPMV else xk)
            y = np.asarray(JAX_KERNEL[kind](layout, arg, interpret=True))
            out[kind, name] = (xk, y.reshape(csr.m, -1))
    return out


@pytest.mark.parametrize("name", sorted(JAX_SHAPES))
@pytest.mark.parametrize("kind", sorted(PLAIN))
def test_plain_matches_pallas(jax_outputs, kind, name):
    x, want = jax_outputs[kind, name]
    a = port_layouts(MATRICES[name]())[kind]
    np.testing.assert_allclose(run_port(kind, a, x), want, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("kind", sorted(PLAIN))
def test_wrapper_on_cpu_matches_dense_product(kind, name):
    csr = MATRICES[name]()
    a = port_layouts(csr)[kind]
    for n in ((1,) if kind in SPMV else (1, 13, 64)):
        x = operand(csr.k, n, seed=n)
        want = dense_product(csr, x)
        if kind in SPMV:
            got = WRAPPER[kind](a, torch.from_numpy(x[:, 0].copy()))[:, None]
        else:
            got = WRAPPER[kind](a, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def leaves_of(jax_layout):
    children, aux = jax_layout.tree_flatten()
    return [np.asarray(c) for c in children], list(aux)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_layouts_equal_jax_arrays(name):
    csr = MATRICES[name]()
    port, jaxl = port_layouts(csr), jax_layouts(csr)

    w_cols, w_rows, w_vals, w_win, w_rb, w_sub, _ = leaves_of(
        jaxl["wcoo"])[0]
    p = port["wcoo"]
    for got, want in zip((p.cols, p.rows, p.values, p.chunk_window,
                          p.chunk_tile()),
                         (w_cols, w_rows, w_vals, w_win,
                          w_rb * (p.R // 128) + w_sub)):
        np.testing.assert_array_equal(got.numpy(), want)

    b_cols, b_vals, b_sw, b_lb = leaves_of(jaxl["bands"])[0]
    p = port["bands"]
    for got, want in zip((p.cols, p.values, p.g_sw, p.g_lb),
                         (b_cols, b_vals, b_sw, b_lb)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert (p.bands, p.mbb, p.steps_per_band) == (
        jaxl["bands"].bands, jaxl["bands"].mbb, jaxl["bands"].steps_per_band)

    # the JAX SpMV layouts pad their groups for the TPU grid: the port keeps
    # the real ones, which are the JAX arrays' head
    for kind in SPMV:
        (cols, vals, meta, sub), _ = leaves_of(jaxl[kind])
        p = port[kind]
        G = jaxl[kind].num_groups
        rows = 8 * G
        np.testing.assert_array_equal(p.cols.numpy(), cols[:rows])
        np.testing.assert_array_equal(p.values.numpy(), vals[:rows])
        np.testing.assert_array_equal(
            (p.g_sw if kind == "wcoo_spmv" else p.piece_w).numpy(),
            meta.reshape(-1)[:G if kind == "wcoo_spmv" else rows])
        np.testing.assert_array_equal(
            (p.g_sub if kind == "wcoo_spmv" else p.group_sub).numpy(),
            sub.reshape(-1)[:G])
        assert p.num_groups == G


@pytest.mark.parametrize("name", ["edge", "hypersparse", "empty"])
def test_host_packers_equal_jax(name):
    csr = MATRICES[name]()
    for R, W in ((1024, 128), (256, 64)):
        got = dataclasses.asdict(port_wcoo.csr_to_wcoo(csr, R=R, W=W))
        want = dataclasses.asdict(jax_csr_to_wcoo(csr, R=R, W=W))
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for got, want in ((port_wcoo.csr_to_wcoo_aligned(csr),
                       jax_csr_to_aligned(csr)),
                      (csr_to_wrow(csr), jax_wrow.csr_to_wrow(csr))):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert np.asarray(g).dtype == np.asarray(w).dtype


@pytest.mark.parametrize("name", ["edge", "hypersparse"])
def test_from_jax_equals_from_csr(name):
    csr = MATRICES[name]()
    port, jaxl = port_layouts(csr), jax_layouts(csr)
    for kind, conv in FROM_JAX.items():
        leaves, aux = leaves_of(jaxl[kind])
        got = conv(*leaves, *aux, device="cpu")
        want = port[kind]
        for f in dataclasses.fields(want):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if isinstance(w, torch.Tensor):
                assert torch.equal(g, w), (kind, f.name)
            else:
                assert g == w, (kind, f.name)


def test_tile_and_block_pointers_cover_every_slot_once():
    csr = edge_matrix()
    p = port_layouts(csr)
    w = p["wcoo"]
    assert torch.equal(torch.sort(w.tile_chunks).values,
                       torch.arange(len(w.chunk_window), dtype=torch.int32))
    host = port_wcoo.csr_to_wcoo(csr, R=w.R)
    tiles = torch.from_numpy(host.chunk_rowblock.astype(np.int64)
                             * (w.R // 128) + host.chunk_sub)
    owner = torch.repeat_interleave(torch.arange(w.tiles),
                                    torch.diff(w.tile_ptr).long())
    assert torch.equal(tiles[w.tile_chunks.long()], owner)
    assert torch.equal(w.chunk_tile(), tiles)
    b = p["bands"]
    lb = b.g_lb.reshape(-1)[:b.bands * b.steps_per_band * 16]
    assert len(b.block_groups) == int((lb < b.mbb).sum())
    for kind in SPMV:
        a = p[kind]
        sub = a.g_sub if kind == "wcoo_spmv" else a.group_sub
        assert a.block_ptr[-1] == len(sub)
        assert torch.equal(torch.repeat_interleave(
            torch.arange(a.blocks, dtype=torch.int32),
            torch.diff(a.block_ptr).long()), sub)


def test_cpu_path_counts_no_launch():
    csr = edge_matrix()
    p = port_layouts(csr)
    x = torch.from_numpy(operand(csr.k, 8))
    before = launch_counts()
    for kind, a in p.items():
        WRAPPER[kind](a, x[:, 0].contiguous() if kind in SPMV else x)
    assert launch_counts() == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    csr = edge_matrix()
    x = torch.from_numpy(operand(csr.k, 8))
    for kind, a in port_layouts(csr).items():
        xk = x[:, 0].contiguous() if kind in SPMV else x
        if bad == "dtype":
            xk, err = xk.double(), TypeError
        elif bad == "shape":
            xk, err = xk[:-1], ValueError
        else:
            xk, err = xk.to("meta"), ValueError
        with pytest.raises(err):
            WRAPPER[kind](a, xk)


def test_spmv_formats_take_one_column_only():
    csr = edge_matrix()
    x = torch.from_numpy(operand(csr.k, 3))
    want = dense_product(csr, x[:, :1].numpy())
    for fmt in ("wcoo_spmv_cuda", "wrow_spmv_cuda"):
        a = dispatch.build(csr, fmt, device="cpu")
        fn = dispatch.spmm_fn(fmt)
        np.testing.assert_allclose(fn(a, x[:, :1]).numpy(), want, rtol=RTOL,
                                   atol=ATOL)
        with pytest.raises(ValueError, match="n must be 1"):
            fn(a, x)
