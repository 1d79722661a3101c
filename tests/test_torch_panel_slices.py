"""The bf16 panel kernel's live-slice walk on the CPU.

``DevicePanels.slice_ptr``/``slice_slots`` (``panel_spmm.live_slices``)
against a direct numpy recount from the JAX package's dense panels of the
CSR's pattern; the fields the JAX layout has stay equal to its arrays; a
plain-torch product over the live (slot, slice) pairs only against
``panel_spmm_plain``; and the port's bf16 form against the JAX Pallas kernel
in interpret mode on the JAX panels cast to bf16.

Tolerances: the live walk and the plain version run in f64 on the same
products and differ in the order of the sums only (1e-6 relative holds with
room). Against the Pallas kernel both sides take X rounded to bf16 first
(the TPU's default precision rounds X in the MXU; XLA on the CPU does not)
and multiply bf16 panels exactly in f32, summing in another order: 1e-5
relative. The matrices hold positive values and X lies in [0.5, 1.5), so no
sum cancels below its terms' rounding.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgrid.formats.csr import CSRMatrix, dense_to_csr
from spgrid.formats import random_csr
from spgrid.ops.pallas.panel_spmm import DevicePanels as JaxPanels
from spgrid.ops.pallas.panel_spmm import panel_spmm as jax_panel_spmm
from spgrid_torch.ops.convert import panels_from_jax
from spgrid_torch.ops.kernels.panel_spmm import (
    SLICE_ROWS, DevicePanels, panel_arrays, panel_spmm, panel_spmm_plain,
)

# The suite runs in parallel workers on shared cores: one intra-op thread
# a worker keeps these small CPU tensors from oversubscribing them.
torch.set_num_threads(1)

RTOL_WALK = 1e-6
RTOL_PALLAS = 1e-5


def positive(csr):
    return CSRMatrix(csr.row_ptr, csr.col_idx,
                     (np.abs(csr.values) + 0.1).astype(np.float32),
                     csr.shape, csr.name)


def sparse_rows(m, k, density, seed, keep):
    """A positive random matrix whose rows outside ``keep`` (a boolean mask
    of m) are empty."""
    d = positive(random_csr(m, k, density, seed=seed)).to_dense()
    d[~keep] = 0.0
    return dense_to_csr(d.astype(np.float32), name="sparse_rows")


def ragged_band():
    """2500 x 700 at R = 1000: three bands of 8 slices, the last of 104
    rows; the third band ends at m after 500 rows, so its slices 4-7 lie
    past m; rows 300-555 empty, so slice 3 of the first band (rows 384-511)
    has no live slot."""
    keep = np.ones(2500, dtype=bool)
    keep[300:556] = False
    return sparse_rows(2500, 700, 0.004, 21, keep)


def empty_bands():
    """600 x 500 at R = 200: the middle band (rows 200-399) is empty, and
    the last one holds entries in its first slice only."""
    keep = np.zeros(600, dtype=bool)
    keep[:200] = True
    keep[400:500] = True
    return sparse_rows(600, 500, 0.05, 22, keep)


def explicit_zeros():
    """300 x 300, one band; in rows 128-255 only explicit zeros, at columns
    0-9, so the middle slice is live in the CSR's pattern but holds no
    nonzero value."""
    d = positive(random_csr(300, 300, 0.05, seed=23)).to_dense()
    d[128:256] = 0.0
    csr = dense_to_csr(d.astype(np.float32), name="explicit_zeros")
    rows = np.repeat(np.arange(csr.m), csr.degrees)
    cols, vals = csr.col_idx.copy(), csr.values.copy()
    zr = np.arange(128, 138)
    rows = np.concatenate([rows, zr])
    cols = np.concatenate([cols, np.arange(10)])
    vals = np.concatenate([vals, np.zeros(10, dtype=np.float32)])
    order = np.lexsort((cols, rows))
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(rows,
                                                         minlength=csr.m))])
    return CSRMatrix(row_ptr.astype(np.int64), cols[order].astype(np.int32),
                     vals[order], csr.shape, "explicit_zeros")


MATRICES = {
    # name: (matrix, band_rows)
    "one_band": (lambda: positive(random_csr(700, 900, 0.02, seed=24)), 2048),
    "bands256": (lambda: positive(random_csr(900, 600, 0.01, seed=25)), 256),
    "ragged_r1000": (ragged_band, 1000),
    "empty_bands": (empty_bands, 200),
    "explicit_zeros": (explicit_zeros, 2048),
}


def pattern(csr):
    """The CSR with every stored entry, explicit zeros too, set to 1."""
    return CSRMatrix(csr.row_ptr, csr.col_idx,
                     np.ones_like(csr.values), csr.shape, csr.name)


def recount(jp):
    """(slice_ptr, slice_slots) counted from dense JAX panels: for each band
    and 128-row slice in order, the band's slots whose rows of that slice
    hold a nonzero, in slot order."""
    panels = np.asarray(jp.panels)
    slices = -(-jp.band_rows // SLICE_ROWS)
    ptr, slots = [0], []
    for band in range(jp.bands):
        for sl in range(slices):
            rows = slice(sl * SLICE_ROWS, (sl + 1) * SLICE_ROWS)
            for p in range(jp.max_p):
                slot = band * jp.max_p + p
                if panels[slot, rows].any():
                    slots.append(slot)
            ptr.append(len(slots))
    return np.array(ptr), np.array(slots, dtype=np.int64)


@pytest.fixture(scope="module")
def layouts():
    """Each matrix's port layout beside the JAX layout of its values and of
    its pattern."""
    out = {}
    for name, (make, band_rows) in MATRICES.items():
        csr = make()
        out[name] = (
            csr, band_rows,
            DevicePanels.from_csr(csr, bk=128, band_rows=band_rows,
                                  device="cpu"),
            JaxPanels.from_csr(csr, bk=128, band_rows=band_rows),
            JaxPanels.from_csr(pattern(csr), bk=128, band_rows=band_rows))
    return out


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_live_slices_equal_a_recount_from_the_jax_panels(layouts, name):
    _, _, a, _, jp_pattern = layouts[name]
    ptr, slots = recount(jp_pattern)
    np.testing.assert_array_equal(a.slice_ptr.numpy(), ptr)
    np.testing.assert_array_equal(a.slice_slots.numpy(), slots)
    assert a.slice_ptr.dtype == a.slice_slots.dtype == torch.int32


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_jax_fields_stay_the_jax_layouts(layouts, name):
    csr, band_rows, a, jp, _ = layouts[name]
    np.testing.assert_array_equal(a.block_cols.numpy(),
                                  np.asarray(jp.block_cols))
    np.testing.assert_array_equal(a.panels.numpy(), np.asarray(jp.panels))
    cols, panels, counts, num_panels, R, bands, max_p = panel_arrays(
        csr, 128, band_rows)
    np.testing.assert_array_equal(a.counts.numpy(), counts)
    assert (a.num_panels, a.band_rows, a.bands, a.max_p) == (
        jp.num_panels, jp.band_rows, jp.bands, jp.max_p) == (
        num_panels, R, bands, max_p)
    assert a.nbytes == sum(t.numel() * t.element_size() for t in (
        a.block_cols, a.panels, a.counts, a.slice_ptr, a.slice_slots))


def test_the_index_marks_dead_slices(layouts):
    """The layouts' own edges: a ragged band's empty slices, an empty band,
    and a slice live by an explicit zero alone."""
    a = layouts["ragged_r1000"][2]
    live = torch.diff(a.slice_ptr).view(a.bands, -1)
    assert live.shape == (3, 8)
    assert live[0, 3].item() == 0 and live[2, 4:].sum().item() == 0
    assert (live[0, :3] > 0).all() and (live[:2, 4:] > 0).all()
    e = layouts["empty_bands"][2]
    live = torch.diff(e.slice_ptr).view(e.bands, -1)
    assert live[1].sum().item() == 0 and e.counts[1].item() == 0
    z, zj = layouts["explicit_zeros"][2], layouts["explicit_zeros"][3]
    assert torch.diff(z.slice_ptr).tolist()[1] > 0
    assert not np.asarray(zj.panels)[:, 128:256].any()


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_from_jax_index_follows_the_nonzero_values(layouts, name):
    """``panels_from_jax`` sees no CSR: its index is the recount from the
    panels' values, the CSR's pattern less the slices of explicit zeros
    alone."""
    _, _, _, jp, _ = layouts[name]
    leaves, aux = jp.tree_flatten()
    t = panels_from_jax(*(np.asarray(leaf) for leaf in leaves), *aux,
                        device="cpu")
    ptr, slots = recount(jp)
    np.testing.assert_array_equal(t.slice_ptr.numpy(), ptr)
    np.testing.assert_array_equal(t.slice_slots.numpy(), slots)


def live_walk(a, x):
    """Y = A @ X over the live (slot, slice) pairs only, in x's dtype, the
    kernel's walk: each slice's rows summed over its live slots."""
    m, k = a.shape
    n = x.shape[1]
    bk, R = a.bk, a.band_rows
    slices = -(-R // SLICE_ROWS)
    xp = torch.zeros((-(-k // bk) * bk, n), dtype=x.dtype)
    xp[:k] = (x.to(torch.bfloat16).to(x.dtype)
              if a.panels.dtype == torch.bfloat16 else x)
    y = torch.zeros((a.bands * R, n), dtype=x.dtype)
    ptr = a.slice_ptr.tolist()
    for band in range(a.bands):
        for sl in range(slices):
            i = band * slices + sl
            r0, r1 = sl * SLICE_ROWS, min((sl + 1) * SLICE_ROWS, R)
            for slot in a.slice_slots[ptr[i]:ptr[i + 1]].tolist():
                c = int(a.block_cols[slot])
                y[band * R + r0: band * R + r1] += (
                    a.panels[slot, r0:r1].to(x.dtype)
                    @ xp[c * bk:(c + 1) * bk])
    return y[:m]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_live_walk_equals_the_plain_version(layouts, name, bf16):
    a = layouts[name][2]
    if bf16:
        a = a.as_bf16()
    x = torch.from_numpy(np.random.default_rng(26).random(
        (a.shape[1], 33)) + 0.5)
    want = panel_spmm_plain(a, x)
    torch.testing.assert_close(live_walk(a, x), want, rtol=RTOL_WALK, atol=0)


def test_slices_are_the_kernels_tile_rows():
    """The index's slices are the rows of the tile the kernel walks them
    in (``ROWS`` of ``csrc/block_mma.cuh``)."""
    header = (Path(__file__).resolve().parents[1] / "spgrid_torch" / "csrc"
              / "block_mma.cuh").read_text()
    rows = re.search(r"constexpr int ROWS = (\d+);", header)
    assert rows and int(rows.group(1)) == SLICE_ROWS


def test_as_bf16_keeps_the_index(layouts):
    a = layouts["ragged_r1000"][2]
    b = a.as_bf16()
    assert b.slice_ptr is a.slice_ptr and b.slice_slots is a.slice_slots
    assert b.nbytes == a.nbytes - a.panels.numel() * 2


# The JAX kernel runs one Pallas grid step a (band, 512-column tile, slot):
# small n, few bands
PALLAS_CASES = {
    # name: (matrix, band_rows, n)
    "one_band": ("one_band", 2048, 70),
    "ragged_r1000": ("ragged_r1000", 1000, 33),
    "empty_bands": ("empty_bands", 200, 16),
}


@pytest.fixture(scope="module")
def pallas_outputs(layouts):
    """Each case's JAX output, once: the Pallas kernel in interpret mode on
    the JAX panels cast to bf16, X rounded to bf16 first."""
    out = {}
    for case, (name, band_rows, n) in PALLAS_CASES.items():
        jp = layouts[name][3]
        x = np.random.default_rng(27).random(
            (jp.shape[1], n)).astype(np.float32) + np.float32(0.5)
        xq = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()
        jb = dataclasses.replace(jp, panels=jp.panels.astype(jnp.bfloat16))
        out[case] = (xq, np.asarray(jax_panel_spmm(jb, jnp.asarray(xq),
                                                   interpret=True)))
    return out


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_bf16_form_equals_the_pallas_kernel(layouts, pallas_outputs, case):
    name = PALLAS_CASES[case][0]
    a = layouts[name][2].as_bf16()
    xq, want = pallas_outputs[case]
    got = panel_spmm(a, torch.from_numpy(xq))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_PALLAS, atol=0)
    # the bf16 layout's panels are the JAX bf16 panels, bit for bit
    np.testing.assert_array_equal(
        a.panels.view(torch.int16).numpy(),
        np.asarray(layouts[name][3].panels.astype(jnp.bfloat16)).view(
            np.int16))
