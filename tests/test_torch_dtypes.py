"""The dtype axis of the port (``--dtype bfloat16|float64``) against the JAX
package, on the CPU.

- The host layer: ``make_x``, ``CSRMatrix.astype``, the generator, the masks
  and the readers at bf16 and f64, bit for bit against the JAX package's
  (its bf16 numpy arrays, from ``ml_dtypes``, against the port's f32
  numbers that bf16 holds).
- The plain versions of the kernels' four bf16 forms (``bsr_spmm``,
  ``panel_spmm``, ``bsr_sddmm``, ``wcoo_spmm_aligned``) against the Pallas
  kernels in interpret mode at bf16, on grids of 2-3 blocks at n = 24.
- Every torch-op format and ``dense`` at bf16 against the JAX function at
  bf16, and at f64 against numpy's f64 product.
- The harness's rows (``run_spmm`` at both dtypes, ``run_pipeline``,
  ``run_sddmm``), the two legs' drivers and the CLI at bf16 in a process
  where neither JAX nor ``ml_dtypes`` can be imported: numpy there has no
  bf16 type, as on the machine with the card.

Tolerances. bf16 results are compared in units of the last place (ulp) of
the reference's bf16 value, 2^(e - 7) for a value in [2^e, 2^(e + 1)). Two
results that round the same f32 sum, formed in different orders, to bf16
differ by at most 1 ulp (the orders' f32 difference is ~2^-17 of a value,
far below half a bf16 ulp, except at a rounding boundary): ``ULPS = 1``.
The JAX package's ``coo`` and ``csc`` multiply and sum in bf16 (their
segment sum runs in X's type; the port widens first and rounds once, as
``_acc_dtype`` does elsewhere), so against them the port is held to 1 ulp of
the same function on the inputs widened to f32 and rounded once, and the JAX
result to ``JAX_BF16_SUM_ULPS`` of the f64 product (a sum of at most ~20
bf16 roundings of values of one sign). f64 results: 1e-12 relative to
numpy's f64 product (an f64 sum of at most a few hundred terms in another
order). The operands are positive, so no sum cancels.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import spgrid.bench.harness as jax_harness
import spgrid.formats.csr as jax_csr
import spgrid.gen as jax_gen
import spgrid.io.mtx as jax_mtx
import spgrid.io.smtx as jax_smtx
from spgrid.core.config import BenchConfig as JaxConfig
from spgrid.ops import dispatch as jax_dispatch
from spgrid.ops.layouts import DeviceBSR as JaxBSR
from spgrid.ops.pallas.bsr_spmm import bsr_spmm as jax_bsr_spmm
from spgrid.ops.pallas.panel_spmm import DevicePanels as JaxPanels
from spgrid.ops.pallas.panel_spmm import panel_spmm as jax_panel_spmm
from spgrid.ops.pallas.sddmm import bsr_sddmm as jax_bsr_sddmm
from spgrid.ops.pallas.wcoo_spmm_aligned import (
    DeviceWCOOBands as JaxBands,
)
from spgrid.ops.pallas.wcoo_spmm_aligned import (
    wcoo_spmm_aligned as jax_wcoo_bands,
)
from spgrid_torch.bench import cli, harness
from spgrid_torch.core import roofline
from spgrid_torch.core.config import BenchConfig
from spgrid_torch.formats.csr import CSRMatrix, cast_values, value_dtype
from spgrid_torch.gen import artificial, masks
from spgrid_torch.io import read_matrix
from spgrid_torch.ops import dispatch
from spgrid_torch.ops.convert import bands_from_jax, bsr_from_jax
from spgrid_torch.ops.kernels.bsr_spmm import bsr_spmm
from spgrid_torch.ops.kernels.panel_spmm import DevicePanels, panel_spmm
from spgrid_torch.ops.kernels.sddmm import bsr_sddmm
from spgrid_torch.ops.kernels.wcoo_spmm_aligned import (
    DeviceWCOOBands, wcoo_spmm_aligned,
)
from spgrid_torch.ops.layouts import DeviceBSR
from spgrid_torch.scripts import run_bf16_leg, run_f64_sweep

# The suite runs in parallel workers on shared cores: one intra-op thread
# a worker keeps these small CPU tensors from oversubscribing them.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
BF16 = ml_dtypes.bfloat16
ULPS = 1
JAX_BF16_SUM_ULPS = 8
F64_RTOL = 1e-12
N = 24
LINE = "300 280 9 3.0 normal random 0.3 0 0.05 0.05 3"


def bits(a) -> np.ndarray:
    """bf16 bit patterns of a JAX bf16 array or of the port's f32 numbers
    that bf16 holds (the low 16 bits of which must be 0)."""
    a = np.asarray(a)
    if a.dtype == BF16:
        return a.view(np.uint16)
    f = np.ascontiguousarray(a, np.float32).view(np.uint32)
    assert not (f & 0xFFFF).any(), "not a bf16 number"
    return (f >> 16).astype(np.uint16)


def ulps(got, want) -> float:
    """The largest |got - want| in ulps of want's bf16 value."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ulp = np.exp2(np.floor(np.log2(np.abs(want))) - 7)
    return float(np.max(np.abs(got - want) / ulp))


def as_port(c) -> CSRMatrix:
    """A JAX package's f32/f64 CSR as the port's."""
    return CSRMatrix(c.row_ptr, c.col_idx, c.values, c.shape, c.name)


def jax_matrix():
    return jax_gen.artificial_matrix_generation(
        **jax_gen.GenParams.from_line(LINE).kwargs())


@pytest.fixture(scope="module")
def bf16_case():
    """(JAX bf16 CSR, port bf16 CSR, JAX bf16 X, port bf16 X, f64 gold)."""
    jc = jax_matrix()
    jb = jc.astype(BF16)
    pb = as_port(jc).astype("bfloat16")
    x = harness.make_x(jc.k, N, "bfloat16", 5)
    jx = jax_harness.make_x(jc.k, N, "bfloat16", 5)
    gold = (jb.astype(np.float64).to_dense()
            @ np.asarray(jx, np.float64))
    return jb, pb, jx, harness.x_tensor(x, "bfloat16", "cpu"), gold


# --- the host layer -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float64"])
@pytest.mark.parametrize("k,n,seed", [(37, 5, 14), (300, 24, 3)])
def test_make_x_equals_jax(dtype, k, n, seed):
    got = harness.make_x(k, n, dtype, seed)
    want = jax_harness.make_x(k, n, dtype, seed)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(bits(got), bits(want))
    else:
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("source", ["float32", "float64"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float64", "float32"])
def test_csr_astype_equals_jax(source, dtype):
    jc = jax_matrix().astype(source)
    got = as_port(jc).astype(dtype)
    want = jc.astype(BF16 if dtype == "bfloat16" else dtype)
    assert value_dtype(got) == dtype and got.bf16 == (dtype == "bfloat16")
    assert got.mem_footprint == want.mem_footprint
    if dtype == "bfloat16":
        assert got.values.dtype == np.float32
        np.testing.assert_array_equal(bits(got.values), bits(want.values))
    else:
        np.testing.assert_array_equal(got.values, want.values)


def test_f64_to_bf16_rounds_through_f32_as_ml_dtypes():
    """1 + 2^-8 + 2^-30 lies above the midpoint of two bf16 numbers, so it
    rounds up directly; through f32 it becomes the midpoint and rounds to
    even (down). ml_dtypes and the port both go through f32."""
    v = np.array([1 + 2**-8 + 2**-30, 1 + 2**-8 - 2**-30, 3 + 2**-7,
                  0.1, -2.5e-39, 3e38], np.float64)
    np.testing.assert_array_equal(bits(cast_values(v, "bfloat16")),
                                  bits(v.astype(BF16)))
    assert cast_values(v[:1], "bfloat16")[0] == 1.0


def test_generator_at_bf16_equals_jax(monkeypatch):
    monkeypatch.setenv("SPGRID_TORCH_GEN_CACHE", "0")
    monkeypatch.setenv("SPGRID_GEN_CACHE", "0")
    kw = jax_gen.GenParams.from_line(LINE).kwargs()
    got = artificial.artificial_matrix_generation(**kw, dtype="bfloat16")
    want = jax_gen.artificial_matrix_generation(**kw, dtype=BF16)
    assert got.bf16 and got.name == want.name
    np.testing.assert_array_equal(got.col_idx, want.col_idx)
    np.testing.assert_array_equal(bits(got.values), bits(want.values))


@pytest.mark.parametrize("kind", ["band_and_random", "band_and_decay"])
def test_masks_at_bf16_equal_jax(kind):
    got = masks.create_mask(kind, 200, 0.8, band_size=4, seed=3,
                            dtype="bfloat16")
    want = jax_gen.create_mask(kind, 200, 0.8, band_size=4, seed=3,
                               dtype=BF16)
    assert got.bf16
    np.testing.assert_array_equal(got.col_idx, want.col_idx)
    np.testing.assert_array_equal(bits(got.values), bits(want.values))


def test_readers_at_bf16_equal_jax(tmp_path):
    """.smtx random fill, and .mtx with duplicate entries (summed in f64,
    rounded once) and values bf16 does not hold."""
    a = jax_csr.random_csr(50, 40, 0.1, seed=6)
    jax_smtx.write_smtx(str(tmp_path / "a.smtx"), a)
    (tmp_path / "d.mtx").write_text(
        "%%MatrixMarket matrix coordinate real general\n3 3 4\n"
        "1 1 0.1\n1 1 0.30000001\n2 3 1.00390625\n3 2 -7.123456\n")
    for name, read_jax in (("a.smtx", jax_smtx.read_smtx),
                           ("d.mtx", jax_mtx.read_mtx)):
        path = str(tmp_path / name)
        got = read_matrix(path, dtype="bfloat16")
        want = read_jax(path, dtype=BF16, use_native=False)
        assert got.bf16
        np.testing.assert_array_equal(got.col_idx, want.col_idx)
        np.testing.assert_array_equal(bits(got.values), bits(want.values))


@pytest.mark.parametrize("fmt", ["cv_gell", "gell16", "cv_panel_cuda"])
def test_gate_x_of_a_bf16_x_equals_jax(fmt):
    """The X the gate classes multiply, from a bf16 X, is the JAX harness's
    ``_xg_host`` (X itself: bf16 numbers are their own bf16 rounding and
    split)."""
    x = harness.make_x(40, 7, "bfloat16", 2)
    want = jax_harness._xg_host(jax_harness.make_x(40, 7, "bfloat16", 2),
                                dispatch.JAX_NAME[fmt])
    np.testing.assert_array_equal(harness.gate_x(x, fmt), want)
    np.testing.assert_array_equal(harness.gate_x(x, fmt), x)


def test_roofline_prices_f64_at_the_fp64_tensor_rate():
    for chip, rate in ((roofline.H100_SXM, 67e12), (roofline.H100_PCIE,
                                                    51e12)):
        assert roofline.roofline_time(1e12, 0.0, chip, "float64") == \
            pytest.approx(1e12 / rate, rel=1e-12)
        assert roofline.roofline_time(1e12, 0.0, chip, "bfloat16") == \
            pytest.approx(1e12 / (chip.peak_bf16_tflops * 1e12), rel=1e-12)


# --- the kernels' bf16 forms, plain versions against the Pallas kernels ---

@pytest.fixture(scope="module")
def pallas_outputs(bf16_case):
    """The four Pallas kernels in interpret mode at bf16 on the bf16 matrix
    (300 x 280: 3 x 3 blocks of 128^2, one band of panels, 3 row blocks of
    the banded layout) and on a 3-block mask, computed once."""
    jb, pb, jx, x, _ = bf16_case
    xj = jnp.asarray(jx)
    jbsr = JaxBSR.from_csr(jb, bm=128, bk=128)
    jpan = JaxPanels.from_csr(jb, bk=128)
    jband = JaxBands.from_csr(jb)
    mask = jax_gen.create_mask("band_and_decay", 256, 0.6, band_size=16,
                               seed=3, dtype=BF16)
    jmask = JaxBSR.from_csr(mask, bm=128, bk=128)
    q = jax_harness.make_x(256, N, "bfloat16", 6)
    k = jax_harness.make_x(256, N, "bfloat16", 7)
    return dict(
        jbsr=jbsr, jband=jband, mask=mask, q=q, k=k,
        bsr=np.asarray(jax_bsr_spmm(jbsr, xj, interpret=True)),
        panel=np.asarray(jax_panel_spmm(jpan, xj, interpret=True)),
        bands=np.asarray(jax_wcoo_bands(jband, xj, interpret=True)),
        sddmm=np.asarray(jax_bsr_sddmm(jmask, jnp.asarray(q),
                                       jnp.asarray(k), interpret=True)))


def test_bsr_spmm_bf16_plain_equals_pallas(bf16_case, pallas_outputs):
    _, pb, _, x, _ = bf16_case
    a = DeviceBSR.from_csr(pb, bm=128, bk=128, device="cpu")
    assert a.blocks.dtype == torch.bfloat16 and a.num_blocks >= 2
    y = bsr_spmm(a, x)
    assert y.dtype == torch.bfloat16
    assert ulps(y.float(), pallas_outputs["bsr"].astype(np.float32)) <= ULPS
    # the JAX layout carried over gives the same blocks and the same Y
    jbsr = pallas_outputs["jbsr"]
    c = bsr_from_jax(*(np.asarray(t) for t in (
        jbsr.block_rows, jbsr.block_cols, jbsr.row_starts, jbsr.blocks)),
        jbsr.shape, jbsr.nnz, jbsr.num_blocks, device="cpu")
    assert torch.equal(c.blocks, a.blocks)
    assert torch.equal(bsr_spmm(c, x), y)


def test_panel_spmm_bf16_plain_equals_pallas(bf16_case, pallas_outputs):
    _, pb, _, x, _ = bf16_case
    a = DevicePanels.from_csr(pb, device="cpu")
    assert a.panels.dtype == torch.bfloat16
    y = panel_spmm(a, x)
    assert y.dtype == torch.bfloat16
    assert ulps(y.float(), pallas_outputs["panel"].astype(np.float32)) \
        <= ULPS


def test_bsr_sddmm_bf16_plain_equals_pallas(pallas_outputs):
    mask = as_port(pallas_outputs["mask"].astype(np.float32)).astype(
        "bfloat16")
    a = DeviceBSR.from_csr(mask, bm=128, bk=128, device="cpu")
    q = torch.from_numpy(pallas_outputs["q"].astype(np.float32)).to(
        torch.bfloat16)
    k = torch.from_numpy(pallas_outputs["k"].astype(np.float32)).to(
        torch.bfloat16)
    s = bsr_sddmm(a, q, k)
    assert s.dtype == torch.bfloat16 and s.shape[0] >= 2
    want = pallas_outputs["sddmm"].astype(np.float32)
    live = want != 0
    assert ulps(s.float().numpy()[live], want[live]) <= ULPS
    np.testing.assert_array_equal(s.float().numpy()[~live], 0.0)


def test_wcoo_bands_bf16_plain_equals_pallas(bf16_case, pallas_outputs):
    """Each product rounded to bf16 before the f32 sum, as the Pallas body's
    bf16 multiply rounds it."""
    _, pb, _, x, _ = bf16_case
    a = DeviceWCOOBands.from_csr(pb, device="cpu")
    assert a.values.dtype == a.slot_vals.dtype == torch.bfloat16
    y = wcoo_spmm_aligned(a, x)
    assert y.dtype == torch.bfloat16
    want = pallas_outputs["bands"].astype(np.float32)
    assert ulps(y.float(), want) <= ULPS
    jb = pallas_outputs["jband"]
    c = bands_from_jax(*(np.asarray(t) for t in (jb.cols, jb.values, jb.g_sw,
                                                 jb.g_lb)),
                       jb.shape, jb.nnz, jb.utilization, jb.bands, jb.mbb,
                       jb.steps_per_band, jb.name, device="cpu")
    assert torch.equal(wcoo_spmm_aligned(c, x), y)


def test_wcoo_bands_bf16_rounds_each_product():
    """A row of two products whose bf16-rounded sum differs as the products
    are rounded to bf16 first (the Pallas body) or not: the port's form
    rounds them. Both sums are exact in f32 here (two bf16 x bf16 products
    near 1), so only the products' rounding tells them apart."""
    rng = np.random.default_rng(0)
    v = cast_values(rng.random((4000, 4)) + 0.5, "bfloat16")

    def r(t):
        return cast_values(t, "bfloat16")

    rounded = r(r(v[:, 0] * v[:, 1]) + r(v[:, 2] * v[:, 3]))
    exact = r(v[:, 0] * v[:, 1] + v[:, 2] * v[:, 3])
    i = int(np.flatnonzero(rounded != exact)[0])
    csr = CSRMatrix(np.array([0, 2]), np.array([0, 1]),
                    v[i, [0, 2]], (1, 2)).astype("bfloat16")
    x = torch.from_numpy(v[i, [1, 3]][:, None].copy()).to(torch.bfloat16)
    a = DeviceWCOOBands.from_csr(csr, device="cpu")
    assert wcoo_spmm_aligned(a, x).float().item() == rounded[i]


# --- every torch-op format and dense, at bf16 and f64 ---------------------

TORCH_OPS = ("dense", "coo", "sell", "merge", "gell", "cv_gell", "bsr",
             "ell", "csc", "cv_bf16", "cv_int8", "scoo", "rbh")
# the JAX ops whose products and sums run in bf16 at a bf16 X
JAX_BF16_SUMS = ("coo", "csc")


@pytest.fixture(scope="module")
def jax_bf16_outputs(bf16_case):
    jb, _, jx, _, _ = bf16_case
    out = {}
    for fmt in TORCH_OPS:
        name = dispatch.JAX_NAME[fmt]
        a = jax_dispatch.build(jb, name)
        out[fmt] = np.asarray(jax_dispatch.spmm_fn(name)(a, jnp.asarray(jx)))
        if fmt in JAX_BF16_SUMS:
            # the same function on the inputs widened to f32, rounded once
            a32 = jax_dispatch.build(jb.astype(np.float32), name)
            out[fmt + "_f32"] = np.asarray(jax_dispatch.spmm_fn(name)(
                a32, jnp.asarray(jx.astype(np.float32)))).astype(BF16)
    return out


@pytest.mark.parametrize("fmt", TORCH_OPS)
def test_torch_op_at_bf16_equals_jax(fmt, bf16_case, jax_bf16_outputs):
    _, pb, _, x, gold = bf16_case
    a = dispatch.build(pb, fmt, device="cpu")
    y = dispatch.spmm_fn(fmt)(a, x)
    assert y.dtype == torch.bfloat16
    want = jax_bf16_outputs[fmt].astype(np.float32)
    if fmt in JAX_BF16_SUMS:
        assert ulps(y.float(), jax_bf16_outputs[fmt + "_f32"].astype(
            np.float32)) <= ULPS
        assert ulps(want, gold) <= JAX_BF16_SUM_ULPS
    else:
        assert ulps(y.float(), want) <= ULPS
    assert ulps(y.float(), gold) <= ULPS + 1


def test_gell16_at_bf16_gathers_x_itself(bf16_case):
    """The JAX ``gell16`` takes no bf16 X (it bit-casts X to 32 bits); the
    port's splits a bf16 X into itself, so gell16 at bf16 is gell's
    product."""
    _, pb, _, x, _ = bf16_case
    y16 = dispatch.spmm_fn("gell16")(dispatch.build(pb, "gell16",
                                                    device="cpu"), x)
    y = dispatch.spmm_fn("gell")(dispatch.build(pb, "gell", device="cpu"), x)
    assert torch.equal(y16, y)


F64_FORMATS = ("dense", "coo", "sell", "merge", "bsr", "ell", "csc")


@pytest.mark.parametrize("fmt", F64_FORMATS)
def test_torch_op_at_f64_equals_numpy(fmt):
    c = as_port(jax_matrix()).astype("float64")
    x = harness.make_x(c.k, N, "float64", 5)
    gold = c.to_dense() @ x
    a = dispatch.build(c, fmt, device="cpu")
    y = dispatch.spmm_fn(fmt)(a, torch.from_numpy(x))
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), gold, rtol=F64_RTOL, atol=0)


def test_ldu_at_bf16_and_f64():
    rng = np.random.default_rng(2)
    d = np.triu((rng.random((60, 60)) < 0.1) * (rng.random((60, 60)) + 0.5))
    d = d + d.T + np.diag(rng.random(60) + 1)
    c = jax_csr.dense_to_csr(d.astype(np.float32), name="sym")
    for dtype in ("bfloat16", "float64"):
        pc = as_port(c).astype(dtype)
        x = harness.make_x(60, 5, dtype, 1)
        y = dispatch.spmm_fn("ldu")(dispatch.build(pc, "ldu", device="cpu"),
                                    harness.x_tensor(x, dtype, "cpu"))
        gold = pc.to_dense().astype(np.float64) @ x.astype(np.float64)
        if dtype == "bfloat16":
            assert ulps(y.float(), gold) <= ULPS
        else:
            np.testing.assert_allclose(y.numpy(), gold, rtol=F64_RTOL)


@pytest.mark.parametrize("fmt,dtype", [
    ("wcoo_cuda", "float64"), ("dgell_cuda", "float64"),
    ("bsrc_cuda", "float64"), ("wcoo_spmv_cuda", "float64"),
    ("bsr_cuda", "float64"), ("rbh", "float64"), ("gell", "float64"),
    ("cv_int8", "float64"), ("scoo", "float64")])
def test_formats_without_a_form_at_the_dtype_raise(fmt, dtype):
    c = as_port(jax_matrix()).astype(dtype)
    with pytest.raises(ValueError, match="ROADMAP"):
        dispatch.build(c, fmt, device="cpu")


def test_kernels_refuse_f64_naming_it():
    c = as_port(jax_matrix()).astype("float64")
    x = torch.from_numpy(harness.make_x(c.k, 4, "float64", 1))
    a = DeviceBSR.from_csr(c, bm=128, bk=128, device="cpu")
    with pytest.raises(TypeError, match="float64"):
        bsr_spmm(a, x)
    with pytest.raises(TypeError, match="float64"):
        bsr_sddmm(a, x[:a.shape[0]], x)


@pytest.mark.parametrize("dtype", ["bfloat16", "float64"])
def test_auto_and_autotune_pick_formats_with_a_form(dtype):
    c = as_port(jax_matrix()).astype(dtype)
    f = harness._cached_features(c)
    for n in (1, 512):
        for tol in (0.0, 1.0):
            assert dispatch.runs_at(dispatch.select_format(
                f, n, tolerance=tol, dtype=dtype), dtype)
    x = harness.x_tensor(harness.make_x(c.k, 4, dtype, 1), dtype, "cpu")
    res = dispatch.autotune_spmm(c, x, min_time_s=0.0, min_iters=1,
                                 warmup_iters=0)
    assert all(dispatch.runs_at(fmt, dtype) for fmt in res.times)
    assert dispatch.runs_at(res.best, dtype)


# --- the harness's rows ---------------------------------------------------

def small_config(dtype, **kw) -> BenchConfig:
    return BenchConfig(num_cols=N, dtype=dtype, min_time_s=0.0, min_iters=1,
                       warmup_iters=0, **kw)


FEATURES = ("density", "avg_nnz_per_row", "std_nnz_per_row",
            "avg_bw_scaled", "std_bw_scaled", "avg_sc_scaled", "skew",
            "avg_num_neighbours", "cross_row_similarity",
            "val_unique_fraction", "val_exp_unique",
            "val_kmeans_rel_error_8")


@pytest.fixture(scope="module")
def jax_bf16_row():
    """The JAX harness's bf16 row of csr_xla_coo on the matrix (ungated)."""
    cfg = JaxConfig(num_cols=N, dtype="bfloat16", min_time_s=0.001)
    return jax_harness.run_spmm(jax_matrix(), kernel="csr_xla_coo",
                                config=cfg, check_accuracy=False)


@pytest.mark.parametrize("kernel", ["csr_xla_coo", "bsr_cuda", "panel_cuda",
                                    "wcoo_bands_cuda", "gell", "rbh",
                                    "dense", "auto"])
def test_run_spmm_at_bf16_passes_with_the_jax_features(kernel,
                                                       jax_bf16_row):
    row = harness.run_spmm(as_port(jax_matrix()), kernel,
                           small_config("bfloat16"), device="cpu")
    assert row["dtype"] == "bfloat16" and row["errors_passed"] == 1
    assert row["mape"] < 3e-2
    for f in FEATURES:
        assert row[f] == pytest.approx(getattr(jax_bf16_row, f), rel=1e-12)
    assert row["csr_mem_footprint_mb"] == pytest.approx(
        jax_bf16_row.csr_mem_footprint_mb, rel=1e-12)


@pytest.mark.parametrize("kernel", run_f64_sweep.KERNELS)
def test_run_spmm_at_f64_passes_at_1e_10(kernel):
    c = as_port(jax_matrix()).astype("float64")
    row = harness.run_spmm(c, kernel, small_config("float64"), device="cpu")
    assert row["dtype"] == "float64" and row["errors_passed"] == 1
    assert row["max_ae"] < 1e-12
    want = jax_harness._cached_features(jax_matrix().astype(np.float64))
    for f in FEATURES[:9]:
        assert row[f] == pytest.approx(getattr(want, f), rel=1e-12)


def test_device_gate_at_bf16_equals_the_host_gate():
    """The device oracle (run here on the CPU) gates a bf16 row as the host
    does."""
    c = as_port(jax_matrix())
    rows = [harness.run_spmm(c, "bsr_cuda", small_config(
        "bfloat16", oracle=site), device="cpu") for site in ("host",
                                                            "device")]
    for f in ("mae", "max_ae", "mse", "mape", "smape"):
        assert rows[1][f] == pytest.approx(rows[0][f], rel=1e-12)
    assert rows[0]["errors_passed"] == rows[1]["errors_passed"] == 1


def test_f64_rows_are_gated_on_the_host():
    cfg = small_config("float64", oracle="device")
    assert harness.gate_site(10**6, 512, cfg, torch.device("cuda")) == "host"
    cfg = small_config("bfloat16")
    assert harness.gate_site(10**6, 512, cfg, torch.device("cuda")) == \
        "device"


@pytest.mark.parametrize("xla_only", [False, True])
def test_run_pipeline_and_sddmm_at_bf16_pass(xla_only):
    w = [jax_gen.artificial_matrix_generation(
        128, 128, 40, 8, "normal", s, "random", 1.0, 0, 0.05, 0.05)
        for s in (1, 2, 3)]
    cfg = small_config("bfloat16", sparsity=0.9, band_size=None)
    row = harness.run_pipeline(*map(as_port, w), config=cfg, device="cpu",
                               xla_only=xla_only)
    assert row["dtype"] == "bfloat16" and row["errors_passed"] == 1
    row = harness.run_sddmm(256, cfg, device="cpu", xla_only=xla_only)
    assert row["dtype"] == "bfloat16" and row["errors_passed"] == 1
    assert row["fmt"] == ("coo" if xla_only else "bsr_pallas_128x128")


def test_pipeline_stages_follow_the_jax_types():
    from spgrid_torch.ops.attention import SparseAttention, \
        attention_pipeline
    w = [as_port(jax_gen.artificial_matrix_generation(
        128, 128, 40, 8, "normal", s, "random", 1.0, 0, 0.05, 0.05)
    ).astype("bfloat16") for s in (1, 2, 3)]
    mask = masks.create_mask("band_and_random", 128, 0.9, seed=1,
                             dtype="bfloat16")
    attn = SparseAttention.from_csr(*w, mask, device="cpu")
    x = harness.x_tensor(harness.make_x(128, 8, "bfloat16", 1), "bfloat16",
                         "cpu")
    for xla_only, s_type in ((False, torch.bfloat16),
                             (True, torch.float32)):
        y, st = attention_pipeline(attn, x, xla_only=xla_only)
        assert y.dtype == st["K"].dtype == torch.bfloat16
        assert st["S"].dtype == s_type


# --- the drivers and the CLI ----------------------------------------------

def test_bf16_leg_at_a_small_size(monkeypatch, tmp_path):
    monkeypatch.setenv("SPGRID_MIN_ITERS", "1")
    monkeypatch.setenv("SPGRID_WARMUP_ITERS", "0")
    monkeypatch.setattr(run_bf16_leg, "N", 16)
    monkeypatch.setattr(run_bf16_leg, "MIN_TIME_S", 0.0)
    monkeypatch.setattr(run_bf16_leg, "PIPELINE_MIN_TIME_S", 0.0)
    monkeypatch.setattr(run_bf16_leg, "JOBS", [
        ("tiny", dict(m=400, avg=8, std=2, placement="diagonal", bw=0.3,
                      skew=0, neigh=0.3, crs=0.5),
         ["dense", "bsr_cuda", "panel_cuda", "gell", "merge", "sell",
          "rbh", "wcoo_bands_cuda"])])
    monkeypatch.setattr(run_bf16_leg, "weight", lambda seed: as_port(
        jax_gen.artificial_matrix_generation(
            128, 128, 40, 8, "normal", seed, "random", 1.0, 0, 0.05, 0.05,
            name=f"bf16_w{seed}")))
    out = tmp_path / "bf16_leg.csv"
    assert run_bf16_leg.main(["--out", str(out), "--platform", "cpu"]) == 0
    lines = out.read_text().splitlines()
    assert len(lines) == 1 + 8 + 1
    assert run_bf16_leg.PIPELINE in lines[-1]
    # resumes past the rows written
    assert run_bf16_leg.main(["--out", str(out), "--platform", "cpu"]) == 0
    assert len(out.read_text().splitlines()) == len(lines)


def test_f64_sweep_at_a_small_size(monkeypatch, tmp_path):
    monkeypatch.setenv("SPGRID_MIN_ITERS", "1")
    monkeypatch.setenv("SPGRID_WARMUP_ITERS", "0")
    monkeypatch.setattr(run_f64_sweep, "MIN_TIME_S", 0.0)
    monkeypatch.setattr(run_f64_sweep, "CASES",
                        [(300, 6, 2.0, "normal", 0.1, 0)])
    out = tmp_path / "f64.csv"
    assert run_f64_sweep.main(["--out", str(out), "--platform", "cpu"]) == 0
    assert len(out.read_text().splitlines()) == 1 + len(
        run_f64_sweep.KERNELS)


def test_cli_exits_nonzero_for_a_kernel_without_the_form(capsys):
    for args in (["--generate", LINE, "--kernel", "wcoo_cuda",
                  "--dtype", "float64"],
                 ["--generate", LINE, "--kernel", "bsr_cuda",
                  "--dtype", "float64"],
                 ["--sddmm", "128", "--dtype", "float64"]):
        with pytest.raises(SystemExit) as e:
            cli.main(args + ["--platform", "cpu"])
        assert e.value.code != 0
        assert "ROADMAP" in capsys.readouterr().err


def test_cli_at_bf16_without_jax_or_ml_dtypes(tmp_path):
    """The CLI's bf16 rows and SDDMM, and an f64 row, in a process where
    ``jax`` and ``ml_dtypes`` cannot be imported: numpy there has no bf16
    type, as on the machine with the card."""
    out = tmp_path / "rows.csv"
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "ml_dtypes"):
            sys.modules[name] = None
        import numpy as np
        try:
            np.dtype("bfloat16")
        except TypeError:
            pass
        else:
            sys.exit("numpy knows bfloat16 here")
        from spgrid_torch.bench.cli import main
        out, line = sys.argv[1], sys.argv[2]
        common = ["--platform", "cpu", "--num-cols", "8", "--out", out]
        rc = main(["--generate", line, "--dtype", "bfloat16", "--kernels",
                   "dense,bsr_cuda,panel_cuda,wcoo_bands_cuda,coo,gell"]
                  + common)
        rc |= main(["--sddmm", "128", "--dtype", "bfloat16"] + common)
        rc |= main(["--generate", line, "--dtype", "float64", "--kernels",
                    "csr_xla_coo"] + common)
        assert "jax" not in sys.modules or sys.modules["jax"] is None
        sys.exit(rc)
    """)
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "SPGRID_MIN_ITERS": "1", "SPGRID_WARMUP_ITERS": "0",
           "SPGRID_MIN_TIME_S": "0"}
    proc = subprocess.run([sys.executable, "-c", code, str(out), LINE],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rows = out.read_text().splitlines()
    assert len(rows) == 1 + 6 + 1 + 1
    assert all(",bfloat16," in r for r in rows[1:8])
    assert ",float64," in rows[-1]


def test_f64_sweep_writes_no_row_where_a_layout_refuses(monkeypatch,
                                                        tmp_path):
    """A format whose layout refuses the matrix (the JAX layouts' rule, as
    ELL refuses the JAX sweep's skewed matrix) writes no row and fails
    nothing; any other error fails the sweep."""
    from spgrid_torch.ops.layouts import LayoutRefused
    monkeypatch.setenv("SPGRID_MIN_ITERS", "1")
    monkeypatch.setenv("SPGRID_WARMUP_ITERS", "0")
    monkeypatch.setattr(run_f64_sweep, "MIN_TIME_S", 0.0)
    monkeypatch.setattr(run_f64_sweep, "CASES",
                        [(200, 5, 2.0, "normal", 0.1, 0)])
    real = run_f64_sweep.run_spmm

    def refusing(csr, kernel, *a, **k):
        if kernel == "ell_xla":
            raise LayoutRefused("too skewed")
        return real(csr, kernel, *a, **k)

    monkeypatch.setattr(run_f64_sweep, "run_spmm", refusing)
    out = tmp_path / "f64.csv"
    assert run_f64_sweep.main(["--out", str(out), "--platform", "cpu"]) == 0
    rows = out.read_text().splitlines()[1:]
    assert len(rows) == len(run_f64_sweep.KERNELS) - 1
    assert not any(",ell_xla," in r for r in rows)

    def failing(csr, kernel, *a, **k):
        raise RuntimeError("a fault")

    monkeypatch.setattr(run_f64_sweep, "run_spmm", failing)
    assert run_f64_sweep.main(["--out", str(tmp_path / "b.csv"),
                               "--platform", "cpu"]) == 1
