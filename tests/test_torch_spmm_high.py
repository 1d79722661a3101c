"""The SpMMs at matmul precision 'high' in the port, on the CPU: the 3-pass
bf16 forms of the block kernels (1c ``bsr_spmm_bf16x3``, 2c
``panel_spmm_bf16x3``, 4c ``bsr_spmm_cstat_bf16x3``), the torch ops'
``dense.at_high``, and the harness, the CLI and the pipeline at 'high'.

- Each form's plain version bit for bit against a numpy emulation of the
  three passes (the block and its X tile split into bf16 hi and lo parts
  with ``ml_dtypes``, each pass's sum in f64 rounded once to f32, the cross
  passes added, then the hi pass, then added into the block row, band or
  slab in block order, in f32), on a matrix with an empty block row and
  values and X of both signs.
- The same plain versions against the Pallas kernels in interpret mode
  under ``jax.default_matmul_precision("high")``. XLA on the CPU ignores
  'high' and computes in f32, so that output is a reference within a
  tolerance only: per entry ``2^-14 * sum_j |a_ij x_jc|`` (the dropped lo x
  lo term and the split's remainders are at most ~2^-16 + 2^-17 of each
  |a x|, the f32 sums far below); and the two must differ somewhere: the
  form is not f32 under another name.
- The torch ops at 'high' (``dense``, ``bsr``, ``ell``, ``merge`` and the
  pipeline's XLA SDDMM) against their JAX functions under 'high' the same
  way. Their three products are torch's f32 matmuls, whose order of sums
  is the library's, so no numpy emulation holds them bit for bit;
  ``at_high`` is held to its three products instead.
- Every format whose JAX dot does not take the ambient precision gives the
  same bits at 'high' and 'highest', and its row the same gate numbers.
- ``run_spmm`` at 'high' for every format that has a 3-pass form, and
  ``run_pipeline`` with and without ``xla_only``, each passing its gate;
  the pipeline at 'high' within 1e-4 of the output's largest magnitude of
  the JAX ``attention_pipeline`` (interpret mode, 'high').
- The CLI's SpMM rows and ``--pipeline`` at 'high' exit 0.
"""

import csv
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from spgrid.formats import dense_to_csr as jax_dense_to_csr
from spgrid.formats import random_csr as jax_random_csr
from spgrid.ops import attention as jax_attention
from spgrid.ops import merge as jax_merge
from spgrid.ops import xla as jax_xla
from spgrid.ops.layouts import DeviceBSR as JaxBSR
from spgrid.ops.layouts import DeviceELL as JaxELL
from spgrid.ops.pallas import bsr_spmm as jax_bsr
from spgrid.ops.pallas import bsr_spmm_cstat as jax_bsrc
from spgrid.ops.pallas import panel_spmm as jax_panel
from spgrid_torch.bench import cli, harness
from spgrid_torch.core.config import BenchConfig
from spgrid_torch.formats.csr import dense_to_csr, random_csr
from spgrid_torch.gen import GenParams, artificial_matrix_generation
from spgrid_torch.gen.masks import create_mask
from spgrid_torch.ops import dispatch
from spgrid_torch.ops.attention import (
    SparseAttention, attention_pipeline, sddmm_bsr_xla,
)
from spgrid_torch.ops.dense import at_high, spmm_dense
from spgrid_torch.ops.kernels import launch_counts
from spgrid_torch.ops.kernels.bf16x3 import split_bf16
from spgrid_torch.ops.kernels.bsr_spmm import (
    bsr_spmm, bsr_spmm_bf16x3_plain, bsr_spmm_plain,
)
from spgrid_torch.ops.kernels.bsr_spmm_cstat import (
    DeviceBSRCol, bsr_spmm_cstat, bsr_spmm_cstat_bf16x3_plain,
)
from spgrid_torch.ops.kernels.panel_spmm import (
    DevicePanels, panel_spmm, panel_spmm_bf16x3_plain,
)
from spgrid_torch.ops.layouts import DeviceBSR, DeviceELL
from spgrid_torch.ops.merge import DeviceMerge, merge_spmm
from spgrid_torch.ops.xla import spmm_bsr, spmm_ell
from spgrid_torch.scripts.sddmm_study import weight

# The suite runs in parallel workers on shared cores: one intra-op thread
# a worker keeps these small CPU tensors from oversubscribing them.
torch.set_num_threads(1)

BF16 = ml_dtypes.bfloat16
N = 40
FAST = BenchConfig(min_time_s=0.005, min_iters=2, warmup_iters=1)
HIGH = dataclasses.replace(FAST, num_cols=16, matmul_precision="high")
LINE = "300 280 9 3.0 normal random 0.3 0 0.05 0.05 3"


def matrix():
    """300 x 280, values of both signs, block row 1 (rows 128-255 at bm
    128) empty, block column 2 ragged (k = 280)."""
    d = jax_random_csr(300, 280, 0.3, seed=21).to_dense()
    d[128:256] = 0.0
    return jax_dense_to_csr(d.astype(np.float32), name="high_case")


def operand(k, n=N, seed=23):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32)


def line_matrix():
    """The generator's matrix of LINE: positive values, as the harness's
    rows take them (a relative gate on sums of both signs would fail
    where they cancel)."""
    return artificial_matrix_generation(**GenParams.from_line(LINE).kwargs())


def jax_high(fn, *args, **kw):
    with jax.default_matmul_precision("high"):
        return np.asarray(fn(*args, **kw))


# form: (the port's layout, its plain version, the wrapper, the Pallas
# kernel's layout and call)
FORMS = {
    "bsr_spmm_bf16x3": (
        lambda c: DeviceBSR.from_csr(c, bm=128, bk=128, pad_multiple=3,
                                     device="cpu"),
        bsr_spmm_bf16x3_plain, bsr_spmm,
        lambda c: JaxBSR.from_csr(c, bm=128, bk=128), jax_bsr.bsr_spmm),
    "panel_spmm_bf16x3": (
        lambda c: DevicePanels.from_csr(c, bk=128, band_rows=256,
                                        device="cpu"),
        panel_spmm_bf16x3_plain, panel_spmm,
        lambda c: jax_panel.DevicePanels.from_csr(c, bk=128, band_rows=256),
        jax_panel.panel_spmm),
    "bsr_spmm_cstat_bf16x3": (
        lambda c: DeviceBSRCol.from_csr(c, bm=128, bk=128, band_rows=256,
                                        device="cpu"),
        bsr_spmm_cstat_bf16x3_plain, bsr_spmm_cstat,
        lambda c: jax_bsrc.DeviceBSRCol.from_csr(c, bm=128, bk=128,
                                                 band_rows=256),
        jax_bsrc.bsr_spmm_cstat),
}


@pytest.fixture(scope="module")
def pallas_high():
    """The matrix, X and each Pallas kernel's interpret output under
    'high', once."""
    csr = matrix()
    x = operand(csr.k)
    outs = {name: jax_high(call, jax_layout(csr), jnp.asarray(x),
                           interpret=True)
            for name, (_, _, _, jax_layout, call) in FORMS.items()}
    return csr, x, outs


def parts(a):
    hi = a.astype(BF16).astype(np.float32)
    return hi, (a - hi).astype(BF16).astype(np.float32)


def passes(block, xt):
    """One block's 3-pass product in numpy: (hi lo + lo hi) + hi hi, each
    pass's sum in f64 rounded once to f32."""
    ah, al = parts(block)
    xh, xl = parts(xt)

    def dot(u, v):
        return (u.astype(np.float64) @ v.astype(np.float64)).astype(
            np.float32)

    return (dot(ah, xl) + dot(al, xh)) + dot(ah, xh)


def emulate(blocks, cols, targets, count, x):
    """The blocks' 3-pass products, block by block, added in f32 into
    ``count`` output blocks at ``targets`` (block order); X padded with zero
    rows to whole block columns."""
    nb, bm, bk = blocks.shape
    kb = -(-x.shape[0] // bk)
    xp = np.zeros((kb * bk, x.shape[1]), np.float32)
    xp[:x.shape[0]] = x
    out = np.zeros((count, bm, x.shape[1]), np.float32)
    for b in range(nb):
        if 0 <= targets[b] < count:
            c = int(cols[b])
            out[targets[b]] += passes(blocks[b], xp[c * bk:(c + 1) * bk])
    return out


def emulate_form(name, a, x):
    """The form's output emulated from its layout's arrays."""
    m = a.shape[0]
    n = x.shape[1]
    cols = a.block_cols.numpy()
    if name == "bsr_spmm_bf16x3":
        out = emulate(a.blocks.numpy(), cols, a.block_rows.numpy(), a.mb, x)
        return out.reshape(-1, n)[:m]
    if name == "panel_spmm_bf16x3":
        band = np.arange(a.bands * a.max_p) // a.max_p
        out = emulate(a.panels.numpy(), cols, band, a.bands, x)
        return out.reshape(-1, n)[:m]
    windows = a.band_rows // a.bm + 1
    band = np.arange(a.bands * a.max_nb) // a.max_nb
    out = emulate(a.blocks.numpy(), cols,
                  band * windows + a.local_rows.numpy(), a.bands * windows, x)
    out = out.reshape(a.bands, windows * a.bm, n)[:, :a.band_rows]
    return out.reshape(-1, n)[:m]


@pytest.mark.parametrize("name", sorted(FORMS))
def test_bf16x3_plain_equals_the_numpy_passes(name):
    make, plain, wrapper, _, _ = FORMS[name]
    csr = matrix()
    x = operand(csr.k)
    a = make(csr)
    got = plain(a, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (csr.m, N)
    want = emulate_form(name, a, x)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    # the wrapper takes the plain version on the CPU: no launch
    before = launch_counts()
    assert torch.equal(wrapper(a, torch.from_numpy(x), precision="high"),
                       got)
    assert launch_counts() == before
    # the empty block row's outputs are zeros
    assert not got[128:256].any()


@pytest.mark.parametrize("name", sorted(FORMS))
def test_bf16x3_plain_within_its_tolerance_of_pallas(pallas_high, name):
    csr, x, outs = pallas_high
    make, plain, wrapper, _, _ = FORMS[name]
    got = plain(make(csr), torch.from_numpy(x)).numpy()
    want = outs[name]
    bound = 2.0 ** -14 * (np.abs(csr.to_dense()).astype(np.float64)
                          @ np.abs(x).astype(np.float64))
    assert got.shape == want.shape
    assert (np.abs(got - want) <= bound).all()
    assert (got != want).any()   # XLA on the CPU computes in f32


def test_bf16x3_forms_are_not_the_f32_forms():
    """On operands of both signs each 3-pass form differs from its f32
    form's plain version on most outputs."""
    csr = matrix()
    x = torch.from_numpy(operand(csr.k))
    a = DeviceBSR.from_csr(csr, bm=128, bk=128, device="cpu")
    high = bsr_spmm(a, x, precision="high")
    live = torch.ones(csr.m, dtype=torch.bool)
    live[128:256] = False
    assert (high != bsr_spmm_plain(a, x))[live].float().mean() > 0.5


@pytest.mark.parametrize("wrapper,make", [
    (bsr_spmm, lambda c: DeviceBSR.from_csr(c, bm=128, bk=128,
                                            device="cpu")),
    (panel_spmm, lambda c: DevicePanels.from_csr(c, device="cpu")),
    (bsr_spmm_cstat, lambda c: DeviceBSRCol.from_csr(c, device="cpu"))])
def test_forms_refuse_a_precision_without_one(wrapper, make):
    csr = matrix()
    a = make(csr)
    x = torch.from_numpy(operand(csr.k))
    with pytest.raises(ValueError, match="ROADMAP"):
        wrapper(a, x, precision="default")


def test_cv_panel_pins_its_own_precision():
    """cv_panel's Pallas body multiplies its bf16 panels at 'default'
    whatever the ambient precision: its row at 'high' is its row."""
    csr = matrix()
    a = DevicePanels.from_csr(csr, device="cpu").as_bf16()
    x = torch.from_numpy(operand(csr.k))
    assert torch.equal(panel_spmm(a, x, precision="high"), panel_spmm(a, x))


# --- the torch ops at 'high' -------------------------------------------------

def test_at_high_is_its_three_products():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((33, 70)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((70, 9)).astype(np.float32))
    ah, al = split_bf16(a)
    bh, bl = split_bf16(b)
    for t in (ah, al, bh, bl):
        assert torch.equal(t.to(torch.bfloat16).float(), t)
    want = (ah @ bl + al @ bh) + ah @ bh
    assert torch.equal(at_high(torch.matmul, a, b), want)
    assert not torch.equal(want, a @ b)


def mask_and_panels():
    """A 256^2 band_and_decay mask and Q, K (256, 48) of both signs."""
    mask = create_mask("band_and_decay", 256, 0.6, band_size=16, seed=3)
    rng = np.random.default_rng(29)
    q = rng.standard_normal((256, 48)).astype(np.float32)
    k = rng.standard_normal((256, 48)).astype(np.float32)
    return mask, q, k


@pytest.fixture(scope="module")
def ops_high():
    """Each torch op's port output at 'high', the JAX function's under
    'high' and the per-entry bound 2^-14 sum |a x|, once."""
    csr = matrix()
    x = operand(csr.k)
    xt = torch.from_numpy(x)
    dense = csr.to_dense().astype(np.float32)
    absprod = (np.abs(dense).astype(np.float64)
               @ np.abs(x).astype(np.float64))
    jx = jnp.asarray(x)
    out = {
        "dense": (spmm_dense(torch.from_numpy(dense), xt, precision="high"),
                  jax_high(jax_xla.spmm_dense, jnp.asarray(dense), jx),
                  absprod),
        "bsr": (spmm_bsr(DeviceBSR.from_csr(csr, bm=8, bk=128, device="cpu"),
                         xt, precision="high"),
                jax_high(jax_xla.spmm_bsr, JaxBSR.from_csr(csr, bm=8,
                                                           bk=128), jx),
                absprod),
        "ell": (spmm_ell(DeviceELL.from_csr(csr, device="cpu"), xt,
                         precision="high"),
                jax_high(jax_xla.spmm_ell, JaxELL.from_csr(csr), jx),
                absprod),
        "merge": (merge_spmm(DeviceMerge.from_csr(csr, device="cpu"), xt,
                             precision="high"),
                  jax_high(jax_merge.merge_spmm,
                           jax_merge.DeviceMerge.from_csr(csr), jx),
                  absprod),
    }
    mask, q, k = mask_and_panels()
    dev = DeviceBSR.from_csr(mask, bm=128, bk=128, device="cpu")
    port = sddmm_bsr_xla(dev, torch.from_numpy(q), torch.from_numpy(k),
                         precision="high")
    jdev = JaxBSR.from_csr(mask, bm=128, bk=128)
    want = jax_high(jax_attention._sddmm_bsr_xla, jdev, jnp.asarray(q),
                    jnp.asarray(k))
    # the bound of each block's values: 2^-14 (|Q| |K|^T) |mask|
    nb = want.shape[0]
    rows = dev.block_rows.numpy()[:nb].astype(np.int64)
    cols = dev.block_cols.numpy()[:nb].astype(np.int64)
    qa, ka = np.abs(q).astype(np.float64), np.abs(k).astype(np.float64)
    bound = np.stack([
        (qa[r * 128:(r + 1) * 128] @ ka[c * 128:(c + 1) * 128].T)
        * np.abs(dev.blocks[b].numpy()) for b, (r, c) in
        enumerate(zip(rows, cols))])
    out["sddmm_bsr_xla"] = (port[:nb], want, bound)
    return out


@pytest.mark.parametrize("op", ["dense", "bsr", "ell", "merge",
                                "sddmm_bsr_xla"])
def test_torch_op_at_high_within_its_tolerance_of_jax(ops_high, op):
    port, want, absprod = ops_high[op]
    got = port.numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert (np.abs(got - want) <= 2.0 ** -14 * absprod).all()
    assert (got != want).any()   # XLA on the CPU computes in f32


# --- the formats that need no form ------------------------------------

# the f32 formats whose JAX dot does not take the ambient precision (the
# SpMV formats at n = 1; ldu on a square matrix with a symmetric pattern)
NO_FORM = tuple(f for f in dispatch.FORMATS
                if f not in dispatch.AMBIENT_FORMATS)
SPMV = ("wcoo_spmv_cuda", "wrow_spmv_cuda", "wpack_spmv_cuda")


def no_form_case(fmt):
    """(matrix, X) of a format's case: LINE's matrix, or for ldu a square
    one with a symmetric pattern; X as the harness makes it."""
    if fmt == "ldu":
        d = np.abs(random_csr(120, 120, 0.1, seed=4).to_dense())
        d = d + d.T + np.eye(120, dtype=np.float32)
        csr = dense_to_csr(d.astype(np.float32), name="sym")
    else:
        csr = line_matrix()
    n = 1 if fmt in SPMV else 16
    return csr, harness.make_x(csr.k, n, "float32", 0)


@pytest.mark.parametrize("fmt", NO_FORM)
def test_format_without_a_form_is_the_same_at_high(fmt):
    """Its output at 'high' is its output at 'highest' bit for bit, and
    ``run_spmm`` gates the same numbers at both."""
    csr, x = no_form_case(fmt)
    a = dispatch.build(csr, fmt, device="cpu")
    xt = torch.from_numpy(x)
    got = {p: dispatch.spmm_fn(fmt, p)(a, xt) for p in ("highest", "high")}
    assert torch.equal(got["highest"], got["high"])
    rows = [harness.run_spmm(csr, fmt, dataclasses.replace(
        FAST, num_cols=x.shape[1], matmul_precision=p), device="cpu")
        for p in ("highest", "high")]
    assert rows[0]["errors_passed"] == rows[1]["errors_passed"] == 1
    for key in ("max_ae", "mae", "mape", "fmt"):
        assert rows[0][key] == rows[1][key]


# --- the harness and the CLI at 'high' --------------------------------

@pytest.mark.parametrize("kernel", sorted(dispatch.AMBIENT_FORMATS)
                         + ["auto", "autotune", "gemm_bound"])
def test_run_spmm_at_high_passes_its_gate(kernel):
    csr = line_matrix()
    row = harness.run_spmm(csr, kernel, HIGH, device="cpu")
    assert row["errors_passed"] == 1
    assert row["dtype"] == "float32" and row["kernel"] == kernel


def test_run_spmm_at_high_runs_the_3_pass_form():
    """At 'high' bsr_cuda's row is gated on the 3-pass product: its error
    against the f64 gold is not its f32 form's."""
    csr = line_matrix()
    rows = [harness.run_spmm(csr, "bsr_cuda", dataclasses.replace(
        HIGH, matmul_precision=p), device="cpu") for p in ("highest", "high")]
    assert rows[0]["max_ae"] != rows[1]["max_ae"]
    assert rows[1]["max_ae"] < 1e-4


@pytest.fixture(scope="module")
def pipeline_case():
    """Weights 256^2 of both signs, a band_and_decay mask and X (256, 16);
    the JAX pipeline's output under 'high' (interpret mode), once."""
    ws = [jax_random_csr(256, 256, 0.3, seed=s) for s in (41, 42, 43)]
    mask = create_mask("band_and_decay", 256, 0.6, band_size=16, seed=3)
    x = operand(256, 16, seed=44) / 4
    jattn = jax_attention.SparseAttention.from_csr(*ws, mask)
    want = {xla: jax_high(lambda *a, **k: jax_attention.attention_pipeline(
        *a, **k)[0], jattn, jnp.asarray(x), use_pallas=not xla,
        interpret=True) for xla in (False, True)}
    return ws, mask, x, want


@pytest.mark.parametrize("xla_only", [False, True])
def test_pipeline_at_high_within_its_tolerance_of_jax(pipeline_case,
                                                      xla_only):
    ws, mask, x, want = pipeline_case
    attn = SparseAttention.from_csr(*ws, mask, device="cpu")
    got, _ = attention_pipeline(attn, torch.from_numpy(x),
                                xla_only=xla_only, precision="high")
    f32, _ = attention_pipeline(attn, torch.from_numpy(x),
                                xla_only=xla_only)
    want = want[xla_only]
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-4 * scale
    assert not torch.equal(got, f32)


@pytest.mark.parametrize("xla_only", [False, True])
def test_run_pipeline_at_high_passes_its_gate(xla_only):
    ws = [weight(256, s) for s in (1, 2, 3)]
    cfg = dataclasses.replace(HIGH, sparsity=0.9)
    row = harness.run_pipeline(*ws, config=cfg, device="cpu",
                               xla_only=xla_only)
    assert row["errors_passed"] == 1
    assert row["kernel"] == ("pipeline_xla" if xla_only
                             else "pipeline_cuda")


def test_cli_spmm_rows_and_pipeline_at_high(monkeypatch, tmp_path):
    monkeypatch.setenv("SPGRID_MATMUL_PRECISION", "high")
    for name, value in (("SPGRID_MIN_TIME_S", "0.005"),
                        ("SPGRID_MIN_ITERS", "2"),
                        ("SPGRID_WARMUP_ITERS", "1")):
        monkeypatch.setenv(name, value)
    out = tmp_path / "rows.csv"
    kernels = "dense,bsr_cuda,panel_cuda,bsrc_cuda,rbh,bsr,ell,merge,coo"
    assert cli.main(["--generate", LINE, "--kernels", kernels,
                     "--num-cols", "16", "--platform", "cpu",
                     "--out", str(out)]) == 0
    from spgrid_torch.io import write_smtx
    paths = []
    for seed in (1, 2, 3):
        paths.append(str(tmp_path / f"w{seed}.smtx"))
        write_smtx(paths[-1], weight(256, seed))
    for extra in ([], ["--xla-only"]):
        assert cli.main(["--pipeline", *paths, "--sparsity", "0.9",
                         "--num-cols", "16", "--platform", "cpu", "--out",
                         str(out), *extra]) == 0
    rows = list(csv.DictReader(out.open()))
    assert [r["kernel"] for r in rows] == kernels.split(",") + [
        "pipeline_cuda", "pipeline_xla"]
    assert all(r["errors_passed"] == "1" for r in rows)
