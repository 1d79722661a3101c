"""The port's layouts against the JAX package's, element for element."""

import numpy as np
import pytest
import torch

from spgrid.formats import random_csr
from spgrid.formats.csr import dense_to_csr
from spgrid.gen import create_mask
from spgrid.ops.attention import SparseAttention as JaxAttention
from spgrid.ops.layouts import DeviceBSR as JaxBSR
from spgrid.ops.pallas.panel_spmm import DevicePanels as JaxPanels
from spgrid_torch.ops.attention import SparseAttention
from spgrid_torch.ops.convert import (
    attention_from_jax, bsr_from_jax, panels_from_jax,
)
from spgrid_torch.ops.kernels.panel_spmm import DevicePanels
from spgrid_torch.ops.layouts import DeviceBSR

# The suite runs in parallel workers on shared cores: one intra-op thread
# a worker keeps these small CPU tensors from oversubscribing them.
torch.set_num_threads(1)


def empty_block_rows_csr():
    """32 x 256 whose block rows 1 and 2 are empty at bm=8: csr_to_bsr's
    pointer is [0 1 1 1 2] while the layout holds blocks for rows 0..3."""
    rng = np.random.default_rng(5)
    d = np.zeros((32, 256), np.float32)
    d[0:8, 0:128] = rng.random((8, 128)) * (rng.random((8, 128)) < 0.3)
    d[24:32, 0:128] = rng.random((8, 128)) * (rng.random((8, 128)) < 0.3)
    d[0, 0] = d[24, 0] = 1.0
    return dense_to_csr(d, name="empty_block_rows")


def empty_band_csr():
    """300 x 200 whose rows 64..127 (band 1 at band_rows=64) are empty."""
    d = random_csr(300, 200, 0.05, seed=9).to_dense()
    d[64:128] = 0.0
    return dense_to_csr(d.astype(np.float32), name="empty_band")


BSR_CASES = {
    "empty_block_rows_bm8": (empty_block_rows_csr, 8, 128, 1),
    "random_bm8_pad4": (lambda: random_csr(128, 96, 0.1, seed=1), 8, 128, 4),
    "random_bm128": (lambda: random_csr(300, 200, 0.2, seed=2), 128, 128, 1),
    "mask_bm128_pad2": (lambda: create_mask("band_and_random", 200, 0.8,
                                            band_size=4, seed=14), 128, 128, 2),
}


def jax_bsr_args(j):
    """bsr_from_jax's arguments from a JAX DeviceBSR (tree_flatten order)."""
    leaves, aux = j.tree_flatten()
    return (*(np.asarray(leaf) for leaf in leaves), *aux)


def assert_bsr_equal(t: DeviceBSR, j: JaxBSR):
    for name in ("block_rows", "block_cols", "row_starts", "blocks"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    assert t.shape == tuple(j.shape)
    assert (t.nnz, t.num_blocks, t.mb, t.bm, t.bk) == (
        j.nnz, j.num_blocks, j.mb, j.bm, j.bk)


@pytest.mark.parametrize("case", sorted(BSR_CASES))
def test_bsr_matches_jax_layout(case):
    make, bm, bk, pad = BSR_CASES[case]
    csr = make()
    t = DeviceBSR.from_csr(csr, bm=bm, bk=bk, pad_multiple=pad, device="cpu")
    assert_bsr_equal(t, JaxBSR.from_csr(csr, bm=bm, bk=bk, pad_multiple=pad))
    assert t.blocks.dtype == torch.float32
    assert t.row_ptr.dtype == torch.int32 and len(t.row_ptr) == t.mb + 1


@pytest.mark.parametrize("case", sorted(BSR_CASES))
def test_row_ptr_indexes_blocks(case):
    make, bm, bk, pad = BSR_CASES[case]
    t = DeviceBSR.from_csr(make(), bm=bm, bk=bk, pad_multiple=pad,
                           device="cpu")
    rows, ptr = t.block_rows.numpy(), t.row_ptr.numpy()
    for r in range(t.mb):
        assert ptr[r] < ptr[r + 1], "every block row holds a block"
        assert (rows[ptr[r]:ptr[r + 1]] == r).all()
    assert (rows[ptr[-1]:] == t.mb).all(), "only pad blocks past the end"


def test_row_starts_is_stale_where_block_rows_are_empty():
    t = DeviceBSR.from_csr(empty_block_rows_csr(), bm=8, bk=128,
                           device="cpu")
    np.testing.assert_array_equal(t.block_rows.numpy(), [0, 1, 2, 3])
    np.testing.assert_array_equal(t.row_starts.numpy(), [0, 1, 1, 1, 2])
    np.testing.assert_array_equal(t.row_ptr.numpy(), [0, 1, 2, 3, 4])


PANEL_CASES = {
    "random_one_band": (lambda: random_csr(128, 96, 0.1, seed=1), 2048),
    "random_bands64": (lambda: random_csr(300, 200, 0.2, seed=2), 64),
    "empty_band": (empty_band_csr, 64),
    "ragged_rows": (lambda: random_csr(100, 260, 0.05, seed=3), 72),
}


@pytest.mark.parametrize("case", sorted(PANEL_CASES))
def test_panels_match_jax_layout(case):
    make, band_rows = PANEL_CASES[case]
    csr = make()
    t = DevicePanels.from_csr(csr, bk=128, band_rows=band_rows, device="cpu")
    j = JaxPanels.from_csr(csr, bk=128, band_rows=band_rows)
    np.testing.assert_array_equal(t.block_cols.numpy(),
                                  np.asarray(j.block_cols))
    np.testing.assert_array_equal(t.panels.numpy(), np.asarray(j.panels))
    assert (t.shape, t.nnz, t.num_panels, t.band_rows, t.bands, t.max_p) == (
        tuple(j.shape), j.nnz, j.num_panels, j.band_rows, j.bands, j.max_p)
    # counts: the band's real panels; every slot past them is a zero pad
    counts = t.counts.numpy()
    assert counts.sum() == t.num_panels
    slots = t.panels.numpy().reshape(t.bands, t.max_p, -1)
    for b, c in enumerate(counts):
        assert not slots[b, c:].any()
        assert all(slots[b, p].any() for p in range(c))
    if case == "empty_band":
        assert counts[1] == 0


@pytest.mark.parametrize("case", sorted(BSR_CASES))
def test_bsr_from_jax_round_trip(case):
    make, bm, bk, pad = BSR_CASES[case]
    csr = make()
    j = JaxBSR.from_csr(csr, bm=bm, bk=bk, pad_multiple=pad)
    t = bsr_from_jax(*jax_bsr_args(j), device="cpu")
    assert_bsr_equal(t, j)
    native = DeviceBSR.from_csr(csr, bm=bm, bk=bk, pad_multiple=pad,
                                device="cpu")
    np.testing.assert_array_equal(t.row_ptr.numpy(), native.row_ptr.numpy())


@pytest.mark.parametrize("case", sorted(PANEL_CASES))
def test_panels_from_jax_round_trip(case):
    make, band_rows = PANEL_CASES[case]
    csr = make()
    j = JaxPanels.from_csr(csr, bk=128, band_rows=band_rows)
    leaves, aux = j.tree_flatten()
    t = panels_from_jax(*(np.asarray(leaf) for leaf in leaves), *aux,
                        device="cpu")
    native = DevicePanels.from_csr(csr, bk=128, band_rows=band_rows,
                                   device="cpu")
    for name in ("block_cols", "panels", "counts"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      getattr(native, name).numpy(), name)
    assert (t.shape, t.nnz, t.num_panels, t.band_rows, t.bands, t.max_p) == (
        native.shape, native.nnz, native.num_panels, native.band_rows,
        native.bands, native.max_p)


def test_attention_from_jax_round_trip():
    wk, wq, wv = (random_csr(128, 96, 0.5, seed=s) for s in (1, 2, 3))
    mask = create_mask("band_and_random", 128, 0.8, band_size=4, seed=14)
    j = JaxAttention.from_csr(wk, wq, wv, mask, bm=8, bk=128, mask_bm=8,
                              mask_bk=128)
    t = attention_from_jax(*(jax_bsr_args(b) for b in (j.wk, j.wq, j.wv,
                                                       j.mask)), device="cpu")
    native = SparseAttention.from_csr(wk, wq, wv, mask, bm=8, bk=128,
                                      mask_bm=8, mask_bk=128, device="cpu")
    for name in ("wk", "wq", "wv", "mask"):
        assert_bsr_equal(getattr(t, name), getattr(j, name))
        np.testing.assert_array_equal(getattr(t, name).row_ptr.numpy(),
                                      getattr(native, name).row_ptr.numpy())
