"""The bf16 forms of the last three SpMM kernels against the JAX package, on
the CPU: ``bsr_spmm_cstat`` (format ``bsrc_cuda``), ``wcoo_spmm``
(``wcoo_cuda``) and ``dgell_spmm`` (``dgell_cuda``).

Their plain versions are held to ``spgrid``'s Pallas kernels in interpret
mode at bf16 (each computed once, in a module fixture, on a 300 x 280 matrix
at n = 24):

- ``wcoo_spmm`` and ``dgell_spmm`` bit for bit. The Pallas wcoo body's bf16
  product ``g * vals`` is rounded to bf16 by XLA on the CPU before the
  one-hot dot sums it in f32 (found by trying both roundings against the
  interpret output; the port's form rounds it), and the plain version adds
  the rounded products in the stream's order, as the one-hot dots and the
  chunk adds do. dgell's products of a value bf16 holds and a bf16 X
  element are exact in f32, and the slots are summed in slot order, then
  the tail, as the JAX function does.
- ``bsr_spmm_cstat`` within 1 bf16 ulp: each block's dot sums its products
  in f32 in XLA's order, the plain version's batched product in torch's;
  the two f32 sums differ by ~2^-17 of a value, which moves the one
  rounding to bf16 by at most 1 ulp.

Also trap 9's pad slots (bands of unequal slot counts), trap 10's dgell
tail, the layouts carried over from JAX (same values, same Y), ``run_spmm``
rows at bf16 for the three formats, and ``select_format``/``autotune`` at
bf16: none of the three is an AUTO candidate, so the picks are the JAX
package's, as before.
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import spgrid.bench.harness as jax_harness
import spgrid.gen as jax_gen
import spgrid.ops.costmodel as jax_costmodel
import spgrid.ops.dispatch as jax_dispatch
from spgrid.features.structural import matrix_features as jax_features
from spgrid.ops.pallas.bsr_spmm_cstat import DeviceBSRCol as JaxBSRCol
from spgrid.ops.pallas.bsr_spmm_cstat import (
    bsr_spmm_cstat as jax_bsr_spmm_cstat,
)
from spgrid.ops.pallas.dgell import DeviceDGELL as JaxDGELL
from spgrid.ops.pallas.dgell import dgell_spmm as jax_dgell_spmm
from spgrid.ops.pallas.wcoo_spmm import DeviceWCOO as JaxWCOO
from spgrid.ops.pallas.wcoo_spmm import wcoo_spmm as jax_wcoo_spmm
from spgrid_torch.bench import harness
from spgrid_torch.core.config import BenchConfig
from spgrid_torch.features import matrix_features
from spgrid_torch.formats.csr import CSRMatrix, cast_values
from spgrid_torch.gen import GenParams, artificial_matrix_generation
from spgrid_torch.ops import convert, costmodel, dispatch
from spgrid_torch.ops.kernels import launch_counts
from spgrid_torch.ops.kernels.bsr_spmm_cstat import (
    DeviceBSRCol, bsr_spmm_cstat,
)
from spgrid_torch.ops.kernels.dgell import (
    DeviceDGELL, dgell_rows_plain, dgell_spmm,
)
from spgrid_torch.ops.kernels.wcoo_spmm import DeviceWCOO, wcoo_spmm

# The suite runs in parallel workers on shared cores: one intra-op thread
# a worker keeps these small CPU tensors from oversubscribing them.
torch.set_num_threads(1)

BF16 = ml_dtypes.bfloat16
ULPS = 1
N = 24
LINE = "300 280 9 3.0 normal random 0.3 0 0.05 0.05 3"
BAND_ROWS = 128    # bsrc: three bands of 128 rows, padded to the longest
WCOO_R = 256       # wcoo: two row blocks of 256 rows


def bits(a) -> np.ndarray:
    """bf16 bit patterns of a JAX bf16 array or of f32 numbers bf16 holds."""
    a = np.asarray(a)
    if a.dtype == BF16:
        return a.view(np.uint16)
    f = np.ascontiguousarray(a, np.float32).view(np.uint32)
    assert not (f & 0xFFFF).any(), "not a bf16 number"
    return (f >> 16).astype(np.uint16)


def ulps(got, want) -> float:
    """The largest |got - want| in ulps of want's bf16 value (0 where both
    are 0)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return float(np.max(np.abs(got - want) / ulp))


@pytest.fixture(scope="module")
def case():
    """The bf16 matrix and X on both sides and the three Pallas kernels'
    interpret outputs at bf16, computed once."""
    jc = jax_gen.artificial_matrix_generation(
        **jax_gen.GenParams.from_line(LINE).kwargs())
    jb = jc.astype(BF16)
    pb = CSRMatrix(jc.row_ptr, jc.col_idx, jc.values, jc.shape,
                   jc.name).astype("bfloat16")
    jx = jax_harness.make_x(jc.k, N, "bfloat16", 5)
    x = harness.x_tensor(harness.make_x(jc.k, N, "bfloat16", 5), "bfloat16",
                         "cpu")
    xj = jnp.asarray(jx)
    jbsrc = JaxBSRCol.from_csr(jb, bm=128, bk=128, band_rows=BAND_ROWS)
    jwcoo = JaxWCOO.from_csr(jb, R=WCOO_R)
    jdgell = JaxDGELL.from_csr(jb)
    return dict(
        jb=jb, pb=pb, x=x, jbsrc=jbsrc, jwcoo=jwcoo, jdgell=jdgell,
        bsrc=np.asarray(jax_bsr_spmm_cstat(jbsrc, xj, interpret=True)),
        wcoo=np.asarray(jax_wcoo_spmm(jwcoo, xj, interpret=True)),
        dgell=np.asarray(jax_dgell_spmm(jdgell, xj, interpret=True)))


# --- the plain versions against the Pallas kernels -------------------------

def test_bsrc_bf16_plain_within_one_ulp_of_pallas(case):
    a = DeviceBSRCol.from_csr(case["pb"], bm=128, bk=128,
                              band_rows=BAND_ROWS, device="cpu")
    assert a.blocks.dtype == torch.bfloat16
    # trap 9: bands of unequal slot counts, so pad slots past counts
    assert int(a.counts.min()) < a.max_nb
    y = bsr_spmm_cstat(a, case["x"])
    assert y.dtype == torch.bfloat16
    want = case["bsrc"]
    assert want.dtype == BF16
    assert ulps(y.float(), want.astype(np.float32)) <= ULPS


def test_wcoo_spmm_bf16_plain_equals_pallas(case):
    a = DeviceWCOO.from_csr(case["pb"], R=WCOO_R, device="cpu")
    assert a.values.dtype == a.slot_vals.dtype == torch.bfloat16
    y = wcoo_spmm(a, case["x"])
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(y.float().numpy()), bits(case["wcoo"]))


def test_dgell_bf16_plain_equals_pallas(case):
    a = DeviceDGELL.from_csr(case["pb"], device="cpu")
    assert a.values.dtype == torch.float32
    # trap 10: rows longer than the slots keep the rest in the tail
    assert a.tail_rows.numel() > 0
    y = dgell_spmm(a, case["x"])
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(y.float().numpy()),
                                  bits(case["dgell"]))
    # the kernel's order (slots, then the row's tail) gives the same bits
    assert torch.equal(dgell_rows_plain(a, case["x"]), y)


def test_layouts_from_jax_give_the_same_y(case):
    """The JAX layouts' bf16 leaves carried over (``convert``): the same
    values, the same Y."""
    x = case["x"]
    jb = case["jbsrc"]
    c = convert.bsrc_from_jax(*(np.asarray(t) for t in (
        jb.local_rows, jb.block_cols, jb.blocks)), jb.shape, jb.nnz,
        jb.num_blocks, jb.band_rows, jb.bands, jb.max_nb, device="cpu")
    a = DeviceBSRCol.from_csr(case["pb"], bm=128, bk=128,
                              band_rows=BAND_ROWS, device="cpu")
    assert c.blocks.dtype == torch.bfloat16
    assert torch.equal(c.blocks, a.blocks)
    assert torch.equal(bsr_spmm_cstat(c, x), bsr_spmm_cstat(a, x))
    jw = case["jwcoo"]
    w = convert.wcoo_from_jax(*(np.asarray(t) for t in (
        jw.cols, jw.rows, jw.values, jw.chunk_window, jw.chunk_rowblock,
        jw.chunk_sub, jw.chunk_first)), jw.shape, jw.nnz, jw.W, jw.R,
        jw.num_rowblocks, jw.utilization, jw.name, device="cpu")
    assert w.slot_vals.dtype == torch.bfloat16
    assert torch.equal(wcoo_spmm(w, x), wcoo_spmm(
        DeviceWCOO.from_csr(case["pb"], R=WCOO_R, device="cpu"), x))
    jd = case["jdgell"]
    d = convert.dgell_from_jax(*(np.asarray(t) for t in (
        jd.cols, jd.values, jd.tail_rows, jd.tail_cols, jd.tail_vals)),
        jd.shape, jd.nnz, jd.slots, jd.rb, jd.name, device="cpu")
    assert d.values.dtype == torch.float32
    np.testing.assert_array_equal(bits(dgell_spmm(d, x).float().numpy()),
                                  bits(case["dgell"]))


def test_wcoo_spmm_bf16_rounds_each_product():
    """A row of two products whose bf16-rounded sum differs as the products
    are rounded to bf16 first (the Pallas body, as XLA computes it on the
    CPU) or not: the port's form rounds them. Both sums are exact in f32
    here (two bf16 x bf16 products near 1), so only the products' rounding
    tells them apart."""
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
    a = DeviceWCOO.from_csr(csr, device="cpu")
    assert wcoo_spmm(a, x).float().item() == rounded[i]
    # and so does the JAX kernel
    jx = np.asarray(x.float().numpy(), BF16)
    jw = JaxWCOO.from_csr(_jax_csr(csr))
    got = np.asarray(jax_wcoo_spmm(jw, jnp.asarray(jx), interpret=True))
    assert float(got[0, 0]) == rounded[i]


def _jax_csr(csr):
    """The port's bf16 CSR as the JAX package's bf16 CSR."""
    from spgrid.formats.csr import CSRMatrix as JaxCSR
    return JaxCSR(csr.row_ptr, csr.col_idx, csr.values.astype(BF16),
                  csr.shape, csr.name)


def test_forms_refuse_what_they_do_not_take(case):
    """A bf16 X against an f32 layout, and an f64 X, raise; the CPU runs
    the plain versions and counts no launch."""
    pb, x = case["pb"], case["x"]
    f32 = pb.astype("float32")
    with pytest.raises(TypeError):
        bsr_spmm_cstat(DeviceBSRCol.from_csr(f32, device="cpu"), x)
    with pytest.raises(TypeError):
        wcoo_spmm(DeviceWCOO.from_csr(f32, device="cpu"), x)
    with pytest.raises(TypeError, match="float64"):
        dgell_spmm(DeviceDGELL.from_csr(pb, device="cpu"), x.double())
    before = launch_counts()
    dgell_spmm(DeviceDGELL.from_csr(pb, device="cpu"), x)
    assert launch_counts() == before


# --- the harness's rows and dispatch ---------------------------------------

@pytest.mark.parametrize("kernel", ["bsrc_cuda", "wcoo_cuda", "dgell_cuda"])
def test_run_spmm_rows_at_bf16_pass(kernel):
    csr = artificial_matrix_generation(**GenParams.from_line(LINE).kwargs())
    cfg = BenchConfig(num_cols=N, dtype="bfloat16", min_time_s=0.0,
                      min_iters=1, warmup_iters=0)
    row = harness.run_spmm(csr, kernel, cfg, device="cpu")
    assert row["dtype"] == "bfloat16" and row["errors_passed"] == 1
    assert row["fmt"] == dispatch.JAX_NAME[kernel]
    assert row["mape"] < 3e-2


LINES = (
    "512 512 256 32 normal random 1.0 0 0.05 0.05 14",
    "2048 2048 200 20 normal random 0.3 0 0.5 0.5 14",
    "8192 8192 50 10 normal random 0.05 0 0.05 0.05 14",
)


@pytest.fixture
def jax_c(monkeypatch):
    monkeypatch.setattr(costmodel, "C", costmodel.H100Constants(
        **dataclasses.asdict(jax_costmodel.C), residual_nnz=29e-9))


def test_select_format_and_autotune_at_bf16_unchanged(jax_c, monkeypatch):
    """None of the three formats is an AUTO candidate, so ``select_format``
    at bf16 picks as at f32 and as the JAX package (which has no dtype
    argument) does, and ``autotune`` times the same candidates at both
    dtypes."""
    three = {dispatch.JAX_NAME[f] for f in ("bsrc_cuda", "wcoo_cuda",
                                            "dgell_cuda")}
    assert not three & set(costmodel.AUTO_CANDIDATES)
    for line in LINES:
        kw = GenParams.from_line(line).kwargs()
        f = matrix_features(artificial_matrix_generation(**kw))
        got = dispatch.select_format(f, 512, dtype="bfloat16")
        assert got == dispatch.select_format(f, 512, dtype="float32")
        want = jax_dispatch.select_format(jax_features(
            jax_gen.artificial_matrix_generation(**kw)), 512)
        assert got == dispatch.PORT_NAME[want], (line, got, want)

    monkeypatch.setattr(harness, "time_call", lambda *a, **kw: _Timed())
    monkeypatch.setattr(dispatch, "build", lambda csr, fmt, device: None)
    csr = artificial_matrix_generation(**GenParams.from_line(
        LINES[0]).kwargs())
    picks = {}
    for dtype in ("float32", "bfloat16"):
        c = csr.astype(dtype)
        x = harness.x_tensor(harness.make_x(c.k, 8, dtype, 1), dtype, "cpu")
        picks[dtype] = dispatch.autotune_spmm(c, x).times
    assert list(picks["bfloat16"]) == list(picks["float32"])
    assert not {dispatch.PORT_NAME[f] for f in three} & set(picks["float32"])


class _Timed:
    time_per_iter_s = 1e-3
