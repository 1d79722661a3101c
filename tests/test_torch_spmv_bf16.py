"""The SpMV path at bf16 (``wrow_spmv`` v1 and v2, ``wcoo_spmv``,
``wpack_spmv``) against the JAX package, on the CPU.

- Each bf16 form's plain version against its Pallas kernel run in interpret
  mode on the same bf16 matrix and x (values in [0.5, 1.5), x from
  ``make_x``), bit for bit: each rounds where XLA rounds the Pallas body on
  the CPU, and the f32 sums the two take in other orders are exact here
  (products of bf16 numbers in [0.25, 2.25) and at most a few dozen of
  them), so no order shows. WROW v1 and ``wcoo_spmv`` round each group's
  sum for a row, WROW v2 and WPACK at wsel 2 and 4 round y once, WPACK at
  wsel 1 rounds its products, its lane prefix and P - p; the test also
  holds v1 against v2 (they differ) and the wsel-1 form against a rounding
  of y alone (they differ).
- ``select_format`` at bf16 and n = 1 against the JAX pick; the harness's
  rows of the three formats and ``auto`` at bf16 and n = 1; the WPACK row
  of a wsel-1 matrix against the JAX harness's (both miss the 3e-2 gate).
- The marks of each row's groups in the bf16 row streams, the layouts
  carried over from the JAX package, and the refusals.

The interpret runs are few (six kernels, computed once in a module fixture:
each compiles an unrolled group loop for 5-25 seconds).
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import spgrid.bench.harness as jax_harness
import spgrid.ops.costmodel as jax_costmodel
import spgrid.ops.dispatch as jax_dispatch
from spgrid.core.config import BenchConfig as JaxConfig
from spgrid.core.timing import TimedResult as JaxTimed
from spgrid.features.structural import matrix_features as jax_features
from spgrid.formats.csr import dense_to_csr as jax_dense_to_csr
from spgrid.gen import GenParams as JaxParams
from spgrid.gen import artificial_matrix_generation as jax_generate
from spgrid.ops.pallas import wcoo_spmv as jax_wcoo
from spgrid.ops.pallas import wpack_spmv as jax_wpack
from spgrid.ops.pallas import wrow_spmv as jax_wrow
from spgrid_torch.bench import cli, harness
from spgrid_torch.core.config import BenchConfig
from spgrid_torch.features import matrix_features
from spgrid_torch.formats.csr import CSRMatrix
from spgrid_torch.gen import GenParams, artificial_matrix_generation
from spgrid_torch.ops import convert, costmodel, dispatch
from spgrid_torch.ops.kernels import launch_counts
from spgrid_torch.ops.kernels.slot_rows import (
    GROUP_START, X_INDEX, add_groups_in_order, mark_groups,
)
from spgrid_torch.ops.kernels.wcoo_spmv import (
    GROUP_ROWS, DeviceWCOOAligned, wcoo_spmv, wcoo_spmv_plain,
)
from spgrid_torch.ops.kernels.wpack_spmv import (
    DeviceWPACK, pick_wsel, wpack_spmv, wpack_spmv_bf16_prefix,
    wpack_stream_plain,
)
from spgrid_torch.ops.kernels.wrow_spmv import (
    GROUP_PIECES, DeviceWROW, wrow_rows_plain, wrow_spmv, wrow_spmv_plain,
    wrow_spmv_v2, wrow_stream_plain,
)

torch.set_num_threads(1)

BF16 = ml_dtypes.bfloat16
# 600 x 3000 at 1 %: 5 row blocks, ~23 windows a block row, rows of ~30
# nnz with collisions in a window (several wcoo groups of one superwindow)
SCATTERED = (600, 3000, 0.01, 1)
# 256 x 2048 at 5 %: ~650 nnz a (block, window) run, so WPACK packs it at
# wsel 1, where the JAX row misses its 3e-2 gate
WSEL1 = (256, 2048, 0.05, 3)


def jax_matrix(m, k, density, seed):
    """A JAX f32 CSR of values in [0.5, 1.5) at ``density``."""
    rng = np.random.default_rng(seed)
    d = np.where(rng.random((m, k)) < density, rng.random((m, k)) + 0.5, 0)
    return jax_dense_to_csr(d.astype(np.float32), name=f"bf16_spmv_{seed}")


def as_port(c) -> CSRMatrix:
    return CSRMatrix(c.row_ptr, c.col_idx, c.values, c.shape, c.name)


def bits(y) -> np.ndarray:
    """bf16 bit patterns of a port result or of a JAX bf16 array."""
    if isinstance(y, torch.Tensor):
        return y.view(torch.int16).numpy().view(np.uint16)
    y = np.asarray(y)
    assert y.dtype == BF16
    return y.view(np.uint16)


def xs(k, seed):
    """(JAX bf16 x, the port's bf16 x): ``make_x`` of both packages."""
    jx = jax_harness.make_x(k, 1, "bfloat16", seed)[:, 0]
    x = harness.x_tensor(harness.make_x(k, 1, "bfloat16", seed)[:, 0],
                         "bfloat16", "cpu")
    return jx, x


@pytest.fixture(scope="module")
def case():
    """The scattered matrix in both packages, its x, and the Pallas kernels'
    bf16 outputs on it, computed once; and the wsel-1 matrix with the JAX
    harness's WPACK row and the kernel's output on it (the row compiles the
    kernel, the direct call reuses it)."""
    jc = jax_matrix(*SCATTERED)
    jb = jc.astype(BF16)
    jx, x = xs(jc.k, 5)
    xj = jnp.asarray(jx)
    wrow = jax_wrow.DeviceWROW(jb)
    out = dict(jb=jb, pb=as_port(jc).astype("bfloat16"), x=x, wrow=wrow,
               v1=np.asarray(jax_wrow.wrow_spmv(wrow, xj, interpret=True)),
               v2=np.asarray(jax_wrow.wrow_spmv(wrow, xj, interpret=True,
                                                variant="v2")))
    wcoo = jax_wcoo.DeviceWCOOAligned(jb)
    out["wcoo_layout"] = wcoo
    out["wcoo"] = np.asarray(jax_wcoo.wcoo_spmv(wcoo, xj, interpret=True))
    for wsel in (2, 4):
        a = jax_wpack.DeviceWPACK(jb, wsel)
        out[f"wpack{wsel}"] = np.asarray(jax_wpack.wpack_spmv(
            a, xj, interpret=True))
    w1 = jax_matrix(*WSEL1)
    w1b = w1.astype(BF16)
    jx1, x1 = xs(w1.k, 7)
    out.update(pw1=as_port(w1).astype("bfloat16"), x1=x1,
               wpack1_layout=jax_wpack.DeviceWPACK(w1b))
    out["wpack1"] = np.asarray(jax_wpack.wpack_spmv(
        out["wpack1_layout"], jnp.asarray(jx1), interpret=True))
    # the JAX harness's row, its kernel compiled above; its timing loop
    # (a jit of its own that compiles the kernel again) is left out: the
    # row's gate is what the test reads
    cfg = JaxConfig(num_cols=1, dtype="bfloat16", min_time_s=0.0,
                    min_iters=1, warmup_iters=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_harness, "time_kernel_chained",
                   lambda *a, **k: JaxTimed(1.0, 1, 1.0))
        out["w1_row"] = jax_harness.run_spmm(w1, kernel="wpack_spmv",
                                             config=cfg)
    return out


# --- the plain versions against the Pallas kernels -------------------------

def test_wrow_v1_bf16_plain_equals_pallas(case):
    """Each group's sum for a row rounded to bf16, bit for bit."""
    a = DeviceWROW.from_csr(case["pb"], device="cpu")
    assert a.values.dtype == a.row_vals.dtype == torch.bfloat16
    y = wrow_spmv(a, case["x"])
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(y), bits(case["v1"]))
    assert torch.equal(wrow_spmv_plain(a, case["x"]), y)


def test_wrow_v2_bf16_plain_equals_pallas(case):
    """Products and sums in f32, y rounded once, bit for bit; the stream's
    product is the same function."""
    a = DeviceWROW.from_csr(case["pb"], device="cpu")
    y = wrow_spmv(a, case["x"], variant="v2")
    np.testing.assert_array_equal(bits(y), bits(case["v2"]))
    assert torch.equal(wrow_spmv_v2(a, case["x"]), y)
    assert torch.equal(wrow_stream_plain(a, case["x"]), y)


def test_wrow_v1_and_v2_differ_at_bf16(case):
    """The group rounding is real: the two JAX variants give other bits on
    some rows, and so do the port's, on the same rows; the row stream's
    product without the group rounding is v2's."""
    a = DeviceWROW.from_csr(case["pb"], device="cpu")
    jax_differ = bits(case["v1"]) != bits(case["v2"])
    assert jax_differ.sum() >= 10
    v1, v2 = wrow_spmv(a, case["x"]), wrow_spmv(a, case["x"], variant="v2")
    np.testing.assert_array_equal(bits(v1) != bits(v2), jax_differ)
    assert torch.equal(wrow_rows_plain(a, case["x"]), v2)


def test_wcoo_spmv_bf16_plain_equals_pallas(case):
    """Each group's sum for a row rounded to bf16, bit for bit, on a matrix
    whose rows hold several groups of one superwindow."""
    a = DeviceWCOOAligned.from_csr(case["pb"], device="cpu")
    key = a.g_sub.long() * 1_000_000 + a.g_sw.long()
    assert int(torch.unique(key, return_counts=True)[1].max()) >= 2
    y = wcoo_spmv(a, case["x"])
    assert y.dtype == a.slot_vals.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(y), bits(case["wcoo"]))
    assert torch.equal(wcoo_spmv_plain(a, case["x"]), y)


@pytest.mark.parametrize("wsel", [1, 2, 4])
def test_wpack_bf16_plain_equals_pallas(case, wsel):
    """At wsel 2 and 4 f32 products and sums, y rounded once; at wsel 1 the
    body's bf16 products, lane prefix and P - p, the f32 sum of a group's
    8 pieces rounded to bf16: bit for bit."""
    if wsel == 1:
        a = DeviceWPACK.from_csr(case["pw1"], device="cpu")
        x, want = case["x1"], case["wpack1"]
    else:
        a = DeviceWPACK.from_csr(case["pb"], wsel, device="cpu")
        x, want = case["x"], case[f"wpack{wsel}"]
    assert a.wsel == wsel and a.values.dtype == torch.bfloat16
    y = wpack_spmv(a, x)
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(y), bits(want))
    once = wpack_stream_plain(a, x)
    if wsel == 1:
        # the prefix's roundings move y far from one rounding of it
        assert (bits(once) != bits(y)).mean() > 0.5
    else:
        assert torch.equal(once, y)


def test_layouts_from_jax_give_the_same_y(case):
    """The JAX package's bf16 layouts carried over are the port's: the same
    values (bf16), marks and y."""
    w = case["wrow"]
    a = convert.wrow_from_jax(*(np.asarray(t) for t in (
        w.cols, w.values, w.piece_w, w.group_sub)), w.shape, w.nnz,
        w.utilization, w.num_groups, w.name, device="cpu")
    b = DeviceWROW.from_csr(case["pb"], device="cpu")
    assert a.row_vals.dtype == torch.bfloat16
    assert torch.equal(a.row_cols, b.row_cols)
    assert torch.equal(wrow_spmv(a, case["x"]), wrow_spmv(b, case["x"]))
    c = case["wcoo_layout"]
    a = convert.wcoo_aligned_from_jax(*(np.asarray(t) for t in (
        c.cols, c.values, c.g_sw, c.g_sub)), c.shape, c.nnz, c.utilization,
        c.num_groups, c.name, device="cpu")
    np.testing.assert_array_equal(bits(wcoo_spmv(a, case["x"])),
                                  bits(case["wcoo"]))
    p = case["wpack1_layout"]
    a = convert.wpack_from_jax(*(np.asarray(t) for t in (
        p.cols, p.values, p.ends, p.starts, p.sel, p.piece_w, p.group_sub)),
        p.shape, p.nnz, p.utilization, p.num_groups, p.wsel, p.name,
        device="cpu")
    np.testing.assert_array_equal(bits(wpack_spmv(a, case["x1"])),
                                  bits(case["wpack1"]))


# --- the group marks -------------------------------------------------------

def test_row_streams_mark_each_group_start(case):
    """Bit 31 of a bf16 row stream's x index is set exactly on each row's
    first slot of each group (recounted from the padded layout); the f32
    layouts carry no mark."""
    pb = case["pb"]
    for layout, per_group in ((DeviceWROW, GROUP_PIECES * 128),
                              (DeviceWCOOAligned, GROUP_ROWS * 128)):
        a = layout.from_csr(pb, device="cpu")
        f = layout.from_csr(pb.astype("float32"), device="cpu")
        marked = a.row_cols if layout is DeviceWROW else a.slot_xrows
        plain = f.row_cols if layout is DeviceWROW else f.slot_xrows
        assert bool((plain >= 0).all())
        assert torch.equal(marked & X_INDEX, plain)
        # each slot's group, from its place in the padded layout
        vals = f.values.reshape(-1)
        if layout is DeviceWROW:
            xi = (f.piece_w.long()[:, None] * 128 + f.cols.long()).reshape(-1)
        else:
            w = torch.arange(GROUP_ROWS)[:, None]
            xi = (f.g_sw.long()[:, None, None] * (GROUP_ROWS * 128)
                  + w * 128 + f.cols.view(-1, GROUP_ROWS, 128).long()
                  ).reshape(-1)
        live = torch.nonzero((vals != 0) & (xi < pb.k)).reshape(-1)
        group = live // per_group
        lane = live % 128
        sub = (f.group_sub if layout is DeviceWROW else f.g_sub).long()
        row = sub[group] * 128 + lane
        order = torch.argsort(row, stable=True)
        g, r = group[order], row[order]
        want = torch.ones(len(g), dtype=torch.bool)
        want[1:] = (g[1:] != g[:-1]) | (r[1:] != r[:-1])
        assert torch.equal(marked < 0, want)
        assert int(want.sum()) < len(want)   # some groups hold 2+ slots


def test_mark_groups_and_group_order_sums():
    xidx = np.array([5, 6, 7, 8, 9], np.int32)
    got = mark_groups(xidx, [0, 0, 1, 1, 1], np.array([0, 3, 3, 5]))
    assert list(got < 0) == [True, False, True, True, False]
    np.testing.assert_array_equal(got & X_INDEX, xidx)
    assert GROUP_START == np.int32(-2 ** 31)
    # groups of one part: in group order (1 + 2^30) - 2^30 is 0 in f32
    parts = torch.tensor([1.0, 2.0 ** 30, -2.0 ** 30, 1.0])[:, None, None]
    y = add_groups_in_order(parts, torch.tensor([0, 0, 0, 1]), 3)
    assert y[:, 0].tolist() == [0.0, 1.0, 0.0]
    # a group's parts summed in f32, in order, then rounded to bf16:
    # (2^30 + 1) - 2^30 is 0, and 1 + 2^-8 rounds to 1 (ties to even)
    parts = torch.tensor([[2.0 ** 30, 1.0, -2.0 ** 30],
                          [1.0, 2.0 ** -8, 0.0]])[:, :, None]
    y = add_groups_in_order(parts, torch.tensor([0, 1]), 2)
    assert y[:, 0].tolist() == [0.0, 1.0]


# --- dispatch, the harness's rows and the CLI ------------------------------

LINES = (
    "65535 65535 5 1.6667 normal random 0.05 0 0.05 0.05 14",
    "20000 20000 20 6.6667 normal random 0.9 0 0.05 0.05 14",
    "512 512 256 32 normal random 1.0 0 0.05 0.05 14",
    "2048 2048 200 20 normal random 0.3 0 0.5 0.5 14",
)


@pytest.fixture
def jax_c(monkeypatch):
    monkeypatch.setattr(costmodel, "C", costmodel.H100Constants(
        **dataclasses.asdict(jax_costmodel.C), residual_nnz=29e-9))


def test_select_format_at_bf16_spmv_equals_jax(jax_c):
    """At n = 1 the port's bf16 pick is the JAX package's (which has no
    dtype argument): the WROW SpMV below 5 % density, the cost model's
    argmin above it."""
    picks = []
    for line in LINES:
        got = dispatch.select_format(matrix_features(
            artificial_matrix_generation(**GenParams.from_line(line)
                                         .kwargs())), 1, dtype="bfloat16")
        want = jax_dispatch.select_format(jax_features(
            jax_generate(**JaxParams.from_line(line).kwargs())), 1)
        assert got == dispatch.PORT_NAME[want], (line, got, want)
        assert dispatch.runs_at(got, "bfloat16")
        picks.append(got)
    assert picks[:2] == ["wrow_spmv_cuda"] * 2
    assert "wrow_spmv_cuda" not in picks[2:]


@pytest.mark.parametrize("kernel", ["wrow_spmv_cuda", "wcoo_spmv_cuda",
                                    "wpack_spmv_cuda", "auto"])
def test_run_spmm_spmv_rows_at_bf16_pass(kernel):
    """On a scattered matrix, which WPACK packs at wsel 4 (its wsel-1 form
    misses the gate as the JAX one does: ``test_wsel1_row_gates_as_the_jax_
    row``)."""
    csr = artificial_matrix_generation(**GenParams.from_line(
        "4000 4000 8 2 normal random 0.9 0 0.05 0.05 14").kwargs())
    assert pick_wsel(csr) != 1
    cfg = BenchConfig(num_cols=1, dtype="bfloat16", min_time_s=0.0,
                      min_iters=1, warmup_iters=0)
    row = harness.run_spmm(csr, kernel, cfg, device="cpu")
    assert row["dtype"] == "bfloat16" and row["errors_passed"] == 1
    assert row["mape"] < 3e-2
    assert row["fmt"] == ("wrow_spmv" if kernel == "auto"
                          else dispatch.JAX_NAME[kernel])


def test_wsel1_row_gates_as_the_jax_row(case):
    """On the wsel-1 matrix the JAX harness's WPACK row misses the 3e-2 gate
    (its bf16 prefix rounds with the piece's whole prefix); the port's
    computes the same function and misses it the same way, while WROW
    passes."""
    cfg = BenchConfig(num_cols=1, dtype="bfloat16", min_time_s=0.0,
                      min_iters=1, warmup_iters=0)
    csr = as_port(jax_matrix(*WSEL1))
    row = harness.run_spmm(csr, "wpack_spmv_cuda", cfg, device="cpu")
    want = case["w1_row"]
    assert row["errors_passed"] == want.errors_passed == 0
    assert row["mape"] == pytest.approx(want.mape, rel=1e-12)
    assert harness.run_spmm(csr, "wrow_spmv_cuda", cfg,
                            device="cpu")["errors_passed"] == 1


def test_cli_runs_the_bf16_spmv_path(tmp_path):
    out = tmp_path / "rows.csv"
    assert cli.main(["--generate", LINES[0].replace("65535", "4000"),
                     "--kernels", "wrow_spmv_cuda,wcoo_spmv_cuda,auto",
                     "--num-cols", "1", "--dtype", "bfloat16",
                     "--platform", "cpu", "--out", str(out)]) == 0
    import csv
    rows = list(csv.DictReader(out.open()))
    assert [r["kernel"] for r in rows] == ["wrow_spmv_cuda",
                                           "wcoo_spmv_cuda", "auto"]
    assert [r["fmt"] for r in rows] == ["wrow_spmv", "wcoo_spmv",
                                        "wrow_spmv"]
    assert all(r["dtype"] == "bfloat16" and r["errors_passed"] == "1"
               for r in rows)


# --- what the bf16 forms refuse --------------------------------------------

def test_bf16_forms_refuse_what_they_do_not_take(case):
    pb, x = case["pb"], case["x"]
    a = DeviceWPACK.from_csr(pb, 2, device="cpu")
    with pytest.raises(TypeError, match="ablation"):
        wpack_spmv(a, x, ablate="noseg", prefix="pad")
    with pytest.raises(TypeError):   # an f32 layout with a bf16 x
        wrow_spmv(DeviceWROW.from_csr(pb.astype("float32"), device="cpu"), x)
    with pytest.raises(TypeError, match="float64"):
        wcoo_spmv(DeviceWCOOAligned.from_csr(pb, device="cpu"), x.double())
    before = launch_counts()
    wpack_spmv(a, x)   # the CPU runs the plain version: no launch
    assert launch_counts() == before


def test_wpack_bf16_wsel_1_form_takes_no_slots_per_cta(case):
    """The wsel-1 form walks the padded pieces, not the live-slot stream:
    it refuses a ``slots_per_cta``, and refuses a layout of another wsel."""
    pb, x = case["pb"], case["x"]
    a = DeviceWPACK.from_csr(pb, 1, device="cpu")
    with pytest.raises(ValueError, match="slots_per_cta"):
        wpack_spmv(a, x, slots_per_cta=128)
    with pytest.raises(ValueError, match="wsel"):
        wpack_spmv_bf16_prefix(DeviceWPACK.from_csr(pb, 2, device="cpu"), x)
    torch.testing.assert_close(wpack_spmv_bf16_prefix(a, x),
                               wpack_spmv(a, x), rtol=0, atol=0)
