"""The rest of the JAX CLI's SpMM formats in the port, on the CPU: the host
copies (``formats/ell.py``, ``csc.py``, ``ldu.py``, ``cv.py``,
``io/openfoam.py``) element for element against the JAX package's; the
layouts ``DeviceELL``, ``DeviceCSC``, ``DeviceLDU``, ``DeviceCV``,
``DeviceSCOO`` and ``DevicePanels`` in bf16 array for array against the JAX
layouts; and ``spmm_ell``, ``spmm_csc``, ``spmm_ldu``, ``spmm_cv``,
``scoo_spmm`` (and their SpMV forms) against the JAX functions (XLA on the
CPU), each giving the same bits twice; and ``cv_panel``'s plain version
against the JAX harness's gold of its class (bf16 values, bf16 X).

Tolerance: 1e-5 relative (f32 sums in another order); the matrices hold
positive values and X lies in [0.5, 1.5), so no sum cancels below its
terms' rounding.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spgrid.formats.csc as jax_csc
import spgrid.formats.cv as jax_cv
import spgrid.formats.ell as jax_ell
import spgrid.formats.ldu as jax_ldu
import spgrid.io.openfoam as jax_openfoam
from spgrid.bench.harness import _xg_host
from spgrid.core.metrics import gold_spmm_fast
from spgrid.formats.csr import CSRMatrix, dense_to_csr
from spgrid.gen.artificial import artificial_matrix_generation
from spgrid.ops import layouts as jax_layouts
from spgrid.ops import xla as jax_xla
from spgrid.ops.pallas.panel_spmm import DevicePanels as JaxPanels
from spgrid.ops.scoo import DeviceSCOO as JaxSCOO
from spgrid.ops.scoo import scoo_spmm as jax_scoo_spmm
from spgrid_torch.formats import csc, cv, ell, ldu
from spgrid_torch.io import openfoam
from spgrid_torch.ops import xla
from spgrid_torch.ops.kernels.panel_spmm import (
    DevicePanels, panel_spmm, panel_spmm_plain,
)
from spgrid_torch.ops.layouts import DeviceCSC, DeviceCV, DeviceELL, \
    DeviceLDU
from spgrid_torch.ops.scoo import DeviceSCOO, scoo_spmm

# The suite runs in parallel workers on shared cores: one intra-op thread
# a worker keeps these small CPU tensors from oversubscribing them.
torch.set_num_threads(1)

RTOL = 1e-5
N = 16


def positive(csr):
    return CSRMatrix(csr.row_ptr, csr.col_idx,
                     (np.abs(csr.values) + 0.1).astype(np.float32),
                     csr.shape, csr.name)


def symmetric_pattern(m=300, seed=2, drop_diag=(3, 17)):
    """m x m, a symmetric pattern with unequal values ((i, j) and (j, i)
    differ), diagonal entries missing at ``drop_diag``, rows 40-49 empty
    but for their diagonal."""
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((m, m)) < 0.02, 1)
    upper[40:50] = False
    upper[:, 40:50] = False
    pat = upper | upper.T
    d = np.where(pat, rng.random((m, m)) + 0.5, 0.0)
    np.fill_diagonal(d, rng.random(m) + 1.0)
    d[drop_diag, drop_diag] = 0.0
    return dense_to_csr(d.astype(np.float32), name="symmetric")


def empty_and_dense_rows():
    """13 x 40: rows 0, 5 and 6 empty, row 3 full, the rest 1-3 nnz."""
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
    "empty_dense": empty_and_dense_rows,
    "symmetric": symmetric_pattern,
}


@pytest.fixture(scope="module")
def mats():
    return {name: make() for name, make in MATRICES.items()}


def operand(k, n, seed=7):
    return (np.random.default_rng(seed).random((k, n)) + 0.5).astype(
        np.float32)


def assert_fields_equal(got, want, names):
    for name in names:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        if w.dtype.name == "bfloat16":
            w = w.view(np.uint16)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def tensor_array(t: torch.Tensor) -> np.ndarray:
    """A layout tensor as numpy, bf16 as its 16-bit patterns."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def assert_layout_equal(got, want, names):
    for name in names:
        w = np.asarray(getattr(want, name))
        if w.dtype.name == "bfloat16":
            w = w.view(np.uint16)
        g = tensor_array(getattr(got, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


# ---------------------------------------------------------------- host copies

@pytest.mark.parametrize("name", sorted(MATRICES))
def test_ell_host_copy_equals_jax(mats, name):
    a = mats[name]
    for kw in ({}, {"pad_multiple": 8}):
        got, want = ell.csr_to_ell(a, **kw), jax_ell.csr_to_ell(a, **kw)
        assert_fields_equal(got, want, ("cols", "values"))
        assert (got.shape, got.nnz, got.width, got.mem_footprint) == (
            want.shape, want.nnz, want.width, want.mem_footprint)
        back, jback = ell.ell_to_csr(got), jax_ell.ell_to_csr(want)
        assert_fields_equal(back, jback, ("row_ptr", "col_idx", "values"))
    with pytest.raises(ValueError):
        ell.csr_to_ell(a, width=0 if a.nnz else -1)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_csc_host_copy_equals_jax(mats, name):
    a = mats[name]
    got, want = csc.csr_to_csc(a), jax_csc.csr_to_csc(a)
    assert_fields_equal(got, want, ("col_ptr", "row_idx", "values"))
    assert got.mem_footprint == want.mem_footprint
    np.testing.assert_array_equal(got.to_dense(), a.to_dense())
    assert_fields_equal(csc.csc_to_csr(got), jax_csc.csc_to_csr(want),
                        ("row_ptr", "col_idx", "values"))


def test_ldu_host_copy_equals_jax(mats):
    a = mats["symmetric"]
    got, want = ldu.csr_to_ldu(a), jax_ldu.csr_to_ldu(a)
    assert_fields_equal(got, want, ("owner", "neigh", "lower", "upper",
                                    "diag"))
    assert (got.nnz, got.mem_footprint) == (want.nnz, want.mem_footprint)
    back = ldu.ldu_to_csr(got)
    assert_fields_equal(back, jax_ldu.ldu_to_csr(want),
                        ("row_ptr", "col_idx", "values"))
    np.testing.assert_array_equal(back.to_dense(), a.to_dense())


@pytest.mark.parametrize("name", ["generated", "empty_dense"])
def test_ldu_refuses_what_jax_refuses(mats, name):
    """Not square, or a one-sided pattern: both raise."""
    a = mats[name]
    if a.m == a.k:
        d = a.to_dense()
        d[np.tril_indices(a.m, -1)] = 0.0
        np.fill_diagonal(d, 0.0)
        d[0, 1] = 1.0
        a = dense_to_csr(d)
    for fn in (ldu.csr_to_ldu, jax_ldu.csr_to_ldu):
        with pytest.raises(ValueError):
            fn(a)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_cv_host_copy_equals_jax(mats, name, mode):
    """bf16 values by torch's rounding equal ``ml_dtypes``' bit for bit."""
    a = mats[name]
    got, want = cv.csr_to_cv(a, mode), jax_cv.csr_to_cv(a, mode)
    assert_fields_equal(got, want, ("row_ptr", "col_idx", "qvalues",
                                    "scales"))
    assert (got.mode, got.mem_footprint) == (want.mode, want.mem_footprint)
    assert_fields_equal(cv.cv_to_csr(got), jax_cv.cv_to_csr(want),
                        ("row_ptr", "col_idx", "values"))


def test_bf16_rounding_ties_to_even():
    import ml_dtypes
    v = np.array([1.0, 1.00390625, 1.01171875, -3.5e-39, 3.4e38, np.inf,
                  1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8], np.float32)
    rng = np.random.default_rng(0)
    v = np.concatenate([v, rng.standard_normal(10000).astype(np.float32)])
    np.testing.assert_array_equal(
        cv.bf16_bits(v), v.astype(ml_dtypes.bfloat16).view(np.uint16))
    np.testing.assert_array_equal(
        cv.bf16_values(cv.bf16_bits(v)),
        v.astype(ml_dtypes.bfloat16).astype(np.float32))


def openfoam_dir(tmp_path):
    """A 6-cell mesh: 7 faces, owner > neighbour on two of them, a
    FoamFile header, the owner list longer than the neighbour list."""
    header = "FoamFile\n{\n    version 2.0;\n}\n"
    owner = [0, 0, 1, 2, 4, 3, 5, 5, 1]
    neigh = [1, 2, 3, 3, 2, 4, 4]
    for name, labels in (("owner", owner), ("neighbour", neigh)):
        (tmp_path / name).write_text(
            header + f"{len(labels)}\n(\n" + "\n".join(map(str, labels))
            + "\n)\n")
    return str(tmp_path)


def test_openfoam_readers_equal_jax(tmp_path):
    path = openfoam_dir(tmp_path)
    got, want = (openfoam.read_openfoam_ldu(path),
                 jax_openfoam.read_openfoam_ldu(path))
    assert_fields_equal(got, want, ("owner", "neigh", "lower", "upper",
                                    "diag"))
    assert got.name == want.name
    got, want = (openfoam.read_openfoam_matrix_dir(path),
                 jax_openfoam.read_openfoam_matrix_dir(path))
    assert_fields_equal(got, want, ("row_ptr", "col_idx", "values"))
    (tmp_path / "owner").write_text("no list")
    with pytest.raises(ValueError):
        openfoam.read_openfoam_ldu(path)


# ------------------------------------------------------------------ layouts

@pytest.mark.parametrize("name", sorted(MATRICES))
def test_device_ell_equals_jax(mats, name):
    a = mats[name]
    got = DeviceELL.from_csr(a, device="cpu")
    want = jax_layouts.DeviceELL.from_csr(a)
    assert_layout_equal(got, want, ("cols", "values"))
    assert (got.shape, got.nnz) == (want.shape, want.nnz)


def test_device_ell_refuses_a_skewed_matrix():
    d = np.zeros((4000, 5000), np.float32)
    d[np.arange(4000), np.arange(4000)] = 1.0
    d[7] = 1.0
    a = dense_to_csr(d)
    for build in (lambda: DeviceELL.from_csr(a, device="cpu"),
                  lambda: jax_layouts.DeviceELL.from_csr(a)):
        with pytest.raises(ValueError):
            build()


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_device_csc_equals_jax(mats, name):
    a = mats[name]
    got = DeviceCSC.from_csr(a, device="cpu")
    want = jax_layouts.DeviceCSC.from_csr(a)
    assert_layout_equal(got, want, ("rows", "cols", "values"))
    # row_order takes the column-major entries to CSR order
    rows = got.rows[:a.nnz].numpy()
    order = got.row_order.numpy()
    np.testing.assert_array_equal(rows[order], np.repeat(
        np.arange(a.m), a.degrees))
    np.testing.assert_array_equal(got.cols[:a.nnz].numpy()[order],
                                  a.col_idx)
    np.testing.assert_array_equal(got.row_ptr.numpy(), a.row_ptr)


def test_device_ldu_equals_jax(mats, tmp_path):
    a = mats["symmetric"]
    for got, want in (
            (DeviceLDU.from_csr(a, device="cpu"),
             jax_layouts.DeviceLDU.from_ldu(jax_ldu.csr_to_ldu(a))),
            (DeviceLDU.from_ldu(openfoam.read_openfoam_ldu(
                openfoam_dir(tmp_path)), device="cpu"),
             jax_layouts.DeviceLDU.from_ldu(jax_openfoam.read_openfoam_ldu(
                 openfoam_dir(tmp_path))))):
        assert_layout_equal(got, want, ("owner", "neigh", "lower", "upper",
                                        "diag"))
        assert (got.shape, got.nnz) == (want.shape, want.nnz)
        nf = got.n_faces
        for ids, order, ptr in ((got.owner, got.owner_order, got.owner_ptr),
                                (got.neigh, got.neigh_order, got.neigh_ptr)):
            cells = ids[:nf].numpy()[order.numpy()]
            assert (np.diff(cells) >= 0).all()
            np.testing.assert_array_equal(
                ptr.numpy(), np.searchsorted(cells, np.arange(
                    got.shape[0] + 1)))


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_device_cv_equals_jax(mats, name, mode):
    a = mats[name]
    got = DeviceCV.from_csr(a, mode, device="cpu")
    want = jax_layouts.DeviceCV.from_csr(a, mode)
    assert_layout_equal(got, want, ("rows", "cols", "qvalues", "scales"))
    assert (got.shape, got.nnz, got.mode) == (want.shape, want.nnz,
                                              want.mode)
    np.testing.assert_array_equal(got.row_ptr.numpy(), a.row_ptr)


SCOO_PLANS = {"default": {}, "windows": dict(chunk_rows=64, window_cols=96)}


@pytest.mark.parametrize("plan", sorted(SCOO_PLANS))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_device_scoo_equals_jax(mats, name, plan):
    a = mats[name]
    kw = SCOO_PLANS[plan]
    got = DeviceSCOO.from_csr(a, device="cpu", **kw)
    want = JaxSCOO.from_csr(a, **kw)
    assert_layout_equal(got, want, ("rows", "cols", "values", "srows",
                                    "scols", "svalues"))
    assert (got.shape, got.nnz, got.plan) == (want.shape, want.nnz,
                                              want.plan)
    assert got.mem_footprint == want.mem_footprint


def test_scoo_windows_plan_spills(mats):
    """The small plan on the skewed matrix spills: the tail path runs."""
    assert DeviceSCOO.from_csr(mats["skewed"], device="cpu",
                               **SCOO_PLANS["windows"]).num_spill > 0


@pytest.mark.parametrize("name", ["generated", "skewed", "symmetric"])
def test_device_panels_bf16_equal_jax(mats, name):
    a = mats[name]
    got = DevicePanels.from_csr(a, bk=128, band_rows=256,
                                device="cpu").as_bf16()
    want = JaxPanels.from_csr(a, bk=128, band_rows=256)
    assert got.panels.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tensor_array(got.panels),
        np.asarray(want.panels.astype(jnp.bfloat16)).view(np.uint16))
    np.testing.assert_array_equal(got.block_cols.numpy(),
                                  np.asarray(want.block_cols))


# ---------------------------------------------------------------------- ops

def jax_ops(mats):
    """(port layout, port op, JAX layout, JAX op) of each format."""
    out = {}
    for name, a in mats.items():
        out[("ell", name)] = (DeviceELL.from_csr(a, device="cpu"),
                              xla.spmm_ell, xla.spmv_ell,
                              jax_layouts.DeviceELL.from_csr(a),
                              jax_xla.spmm_ell, jax_xla.spmv_ell)
        out[("csc", name)] = (DeviceCSC.from_csr(a, device="cpu"),
                              xla.spmm_csc, xla.spmv_csc,
                              jax_layouts.DeviceCSC.from_csr(a),
                              jax_xla.spmm_csc, jax_xla.spmv_csc)
        for mode in ("bf16", "int8"):
            out[(f"cv_{mode}", name)] = (
                DeviceCV.from_csr(a, mode, device="cpu"), xla.spmm_cv,
                xla.spmv_cv, jax_layouts.DeviceCV.from_csr(a, mode),
                jax_xla.spmm_cv, jax_xla.spmv_cv)
        for plan, kw in SCOO_PLANS.items():
            out[(f"scoo_{plan}", name)] = (
                DeviceSCOO.from_csr(a, device="cpu", **kw), scoo_spmm,
                scoo_spmm, JaxSCOO.from_csr(a, **kw), jax_scoo_spmm,
                jax_scoo_spmm)
    a = mats["symmetric"]
    out[("ldu", "symmetric")] = (
        DeviceLDU.from_csr(a, device="cpu"), xla.spmm_ldu, xla.spmv_ldu,
        jax_layouts.DeviceLDU.from_ldu(jax_ldu.csr_to_ldu(a)),
        jax_xla.spmm_ldu, jax_xla.spmv_ldu)
    return out


@pytest.fixture(scope="module")
def cases(mats):
    """Each format on each matrix with X (k, N) and x (k,), and the JAX
    functions' outputs on them, computed once."""
    out = {}
    for key, (pa, pf, pv, ja, jf, jv) in jax_ops(mats).items():
        a = mats[key[1]]
        x = operand(a.k, N)
        out[key] = (pa, pf, pv, x, np.asarray(jf(ja, jnp.asarray(x))),
                    np.asarray(jv(ja, jnp.asarray(x[:, 0]))))
    return out


CASE_KEYS = sorted(
    [(f, m) for f in ("ell", "csc", "cv_bf16", "cv_int8", "scoo_default",
                      "scoo_windows") for m in MATRICES]
    + [("ldu", "symmetric")])


@pytest.mark.parametrize("fmt,name", CASE_KEYS)
def test_op_equals_jax_and_gives_the_same_bits_twice(cases, fmt, name):
    pa, pf, pv, x, want, want_v = cases[(fmt, name)]
    xt = torch.from_numpy(x)
    got = pf(pa, xt)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)
    assert torch.equal(pf(pa, xt), got)
    got_v = pv(pa, xt[:, 0].contiguous())
    assert got_v.shape == want_v.shape
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_cv_panel_plain_equals_its_gate_gold(mats, name):
    """The bf16 panels times X rounded to bf16, summed in f32, against the
    JAX harness's gold of the ``cv_panel`` class: f64 of the bf16 values
    times ``_xg_host(x, "cv_panel")``."""
    a = mats[name]
    x = operand(a.k, N)
    p = DevicePanels.from_csr(a, bk=128, band_rows=256,
                              device="cpu").as_bf16()
    got = panel_spmm(p, torch.from_numpy(x)).numpy()
    g = jax_cv.cv_to_csr(jax_cv.csr_to_cv(a, "bf16"))
    gold = gold_spmm_fast(g.row_ptr, g.col_idx, g.values,
                          _xg_host(x, "cv_panel"))
    np.testing.assert_allclose(got, gold, rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(
        got, panel_spmm_plain(p, torch.from_numpy(x)).numpy())


def test_panels_refuse_another_dtype(mats):
    p = DevicePanels.from_csr(mats["generated"], device="cpu")
    p = dataclasses.replace(p, panels=p.panels.double())
    with pytest.raises(TypeError):
        panel_spmm(p, torch.ones(p.shape[1], 2))
