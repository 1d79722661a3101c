"""Matmul precision in the port (``BenchConfig.matmul_precision``) and the
3-pass bf16 form of the SDDMM kernel, on the CPU.

- The config field, its ``precision`` and its environment variable against
  the JAX package's ``BenchConfig`` for every (dtype, matmul_precision)
  pair the port takes.
- ``bsr_sddmm_bf16x3_plain`` bit for bit against a numpy emulation of the
  three passes (Q and K split into bf16 hi and lo parts with ``ml_dtypes``,
  each pass's sum in f64, rounded once to f32, the cross passes added, then
  the hi pass, times the mask, in f32), on a case where it differs from the
  f32 product: the form is not f32 under another name.
- The kernel's split pass emulated in numpy (Q and K as bf16 hi and lo
  planes of d rounded up to whole 64-deep steps, zeros past d and past the
  operand's rows) and the passes read from those planes as the tiles read
  them, bit for bit against the plain version; the plain split
  (``split_planes_plain``, which the card tests hold the kernel's planes
  to) equal to the emulation's planes.
- The same plain version against ``spgrid``'s ``bsr_sddmm`` in interpret
  mode. XLA on the CPU ignores 'high' and computes in f32, so that output
  is a reference within a tolerance only: per entry ``2^-14 * sum_d |q_d
  k_d| * |mask|`` (the dropped lo x lo term and the split's remainder are
  at most ~2^-16 + 2^-17 of each |q_d k_d|, the f32 sums far below).
- ``run_sddmm`` at 'high' on a 256^2 mask, gated at 1e-4; ``--xla-only`` at
  'high' is the f32 row, because the JAX ``sddmm_coo`` contracts through no
  dot (its product at 'high' is its product at 'highest', bit for bit).
- The SDDMM study's 'high' rows at a tiny size, with the JAX study's row
  names.
- ``run_spmm`` and ``run_pipeline`` at f32 'high' run (every SpMM and the
  pipeline have 3-pass forms: ``tests/test_torch_spmm_high.py``), while a
  precision with no form is refused naming ROADMAP.md, by the harness and
  by the CLI (exit 2): f32 at 'default' (the TPU's one bf16 pass) for a
  format whose dot takes the ambient precision and for the pipeline, and
  bf16 at any precision but 'default'.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from spgrid.core.config import BenchConfig as JaxConfig
from spgrid.ops.layouts import DeviceBSR as JaxBSR
from spgrid.ops.layouts import DeviceCOO as JaxCOO
from spgrid.ops.pallas.sddmm import bsr_sddmm as jax_bsr_sddmm
from spgrid.ops import xla as jax_xla
from spgrid_torch.bench import cli, harness
from spgrid_torch.bench.schema import CSVWriter
from spgrid_torch.core.config import (
    DTYPES, MATMUL_PRECISIONS, BenchConfig,
)
from spgrid_torch.formats.csr import random_csr
from spgrid_torch.gen.masks import create_mask
from spgrid_torch.ops.kernels import launch_counts
from spgrid_torch.ops.kernels.sddmm import (
    bsr_sddmm, bsr_sddmm_bf16x3_plain, bsr_sddmm_plain, plane_shape,
    split_planes_plain,
)
from spgrid_torch.ops.layouts import DeviceBSR, DeviceCOO
from spgrid_torch.ops.xla import sddmm_coo
from spgrid_torch.scripts import sddmm_study

# The suite runs in parallel workers on shared cores: one intra-op thread
# a worker keeps these small CPU tensors from oversubscribing them.
torch.set_num_threads(1)

BF16 = ml_dtypes.bfloat16
FAST = BenchConfig(min_time_s=0.005, min_iters=2, warmup_iters=1)
LINE = "300 280 9 3.0 normal random 0.3 0 0.05 0.05 3"


# --- the config ------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("precision", MATMUL_PRECISIONS)
def test_precision_equals_jax(dtype, precision):
    got = BenchConfig(dtype=dtype, matmul_precision=precision)
    want = JaxConfig(dtype=dtype, matmul_precision=precision)
    assert got.precision == want.precision


def test_precision_from_the_environment(monkeypatch):
    monkeypatch.setenv("SPGRID_MATMUL_PRECISION", "high")
    assert BenchConfig.from_env().precision == "high"
    assert JaxConfig.from_env().precision == "high"
    assert BenchConfig.from_env(matmul_precision="auto",
                                dtype="bfloat16").precision == "default"
    monkeypatch.setenv("SPGRID_MATMUL_PRECISION", "tensorfloat32")
    with pytest.raises(ValueError, match="matmul_precision"):
        BenchConfig.from_env()


# --- the 3-pass form's plain version ----------------------------------------

@pytest.fixture(scope="module")
def high_case():
    """A 256^2 band_and_decay mask at 128 x 128 (its pad blocks too), Q and K
    (256, 40) of both signs, and the JAX kernel's interpret output, once."""
    mask = create_mask("band_and_decay", 256, 0.6, band_size=16, seed=3)
    rng = np.random.default_rng(11)
    q = rng.standard_normal((256, 40)).astype(np.float32)
    k = rng.standard_normal((256, 40)).astype(np.float32)
    jax_out = np.asarray(jax_bsr_sddmm(JaxBSR.from_csr(mask, bm=128, bk=128),
                                       jnp.asarray(q), jnp.asarray(k),
                                       interpret=True))
    dev = DeviceBSR.from_csr(mask, bm=128, bk=128, pad_multiple=3,
                             device="cpu")
    return dev, q, k, jax_out


def emulate_bf16x3(dev: DeviceBSR, q: np.ndarray, k: np.ndarray):
    """The three passes in numpy, block by block."""
    nb, bm, bk = dev.blocks.shape
    rows = dev.block_rows.numpy().astype(np.int64)
    cols = dev.block_cols.numpy().astype(np.int64)
    blocks = dev.blocks.numpy()
    out = np.zeros((nb, bm, bk), np.float32)

    def parts(a):
        hi = a.astype(BF16).astype(np.float32)
        return hi, (a - hi).astype(BF16).astype(np.float32)

    def dot(a, b):
        return (a.astype(np.float64) @ b.astype(np.float64).T).astype(
            np.float32)

    for b in range(nb):
        qb = np.zeros((bm, q.shape[1]), np.float32)
        rq = q[rows[b] * bm:(rows[b] + 1) * bm]
        qb[:len(rq)] = rq
        kb = np.zeros((bk, k.shape[1]), np.float32)
        rk = k[cols[b] * bk:(cols[b] + 1) * bk]
        kb[:len(rk)] = rk
        qh, ql = parts(qb)
        kh, kl = parts(kb)
        cross = dot(qh, kl) + dot(ql, kh)
        out[b] = (cross + dot(qh, kh)) * blocks[b]
    return out


def test_bf16x3_plain_equals_the_numpy_passes(high_case):
    dev, q, k, _ = high_case
    qt, kt = torch.from_numpy(q), torch.from_numpy(k)
    got = bsr_sddmm(dev, qt, kt, precision="high")
    assert got.dtype == torch.float32
    assert int((dev.block_rows == dev.mb).sum()) > 0   # pad blocks
    want = emulate_bf16x3(dev, q, k)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert torch.equal(bsr_sddmm_bf16x3_plain(dev, qt, kt), got)
    # not f32 under another name: the f32 product differs
    f32 = bsr_sddmm_plain(dev, qt, kt)
    live = dev.blocks != 0
    assert (got != f32)[live].float().mean() > 0.5
    # the CPU runs the plain version: no launch
    before = launch_counts()
    bsr_sddmm(dev, qt, kt, precision="high")
    assert launch_counts() == before


def test_bf16x3_plain_within_its_tolerance_of_pallas(high_case):
    dev, q, k, jax_out = high_case
    got = bsr_sddmm(dev, torch.from_numpy(q), torch.from_numpy(k),
                    precision="high").numpy()[:len(jax_out)]
    nb, bm, bk = jax_out.shape
    rows = dev.block_rows.numpy()[:nb].astype(np.int64)
    cols = dev.block_cols.numpy()[:nb].astype(np.int64)
    qa = np.abs(np.concatenate([q, np.zeros((bm, q.shape[1]), np.float32)]))
    ka = np.abs(k)
    for b in range(nb):
        qb = qa[rows[b] * bm:(rows[b] + 1) * bm]
        kb = ka[cols[b] * bk:(cols[b] + 1) * bk]
        bound = (2.0 ** -14 * (qb.astype(np.float64) @ kb.T)
                 * np.abs(dev.blocks[b].numpy()))
        assert (np.abs(got[b] - jax_out[b]) <= bound).all()
    assert (got != jax_out).any()   # XLA on the CPU computes in f32


# --- the split planes ---------------------------------------------------------

def emulate_planes(q: np.ndarray, k: np.ndarray):
    """The split pass in numpy: (Q_hi, Q_lo, K_hi, K_lo) in bf16, each of
    d rounded up to whole 64-deep steps (at least one) and of the operand's
    rows (at least one), zeros past d and past the rows."""
    dp = max(1, -(-q.shape[1] // 64)) * 64
    planes = []
    for a in (q, k):
        p = np.zeros((max(len(a), 1), dp), np.float32)
        p[:len(a), :a.shape[1]] = a
        hi = p.astype(BF16)
        planes += [hi, (p - hi.astype(np.float32)).astype(BF16)]
    return planes


def passes_from_planes(dev: DeviceBSR, planes, mq: int, mk: int):
    """The three passes read from the planes as the tiles read them: block
    b's rows from the Q planes' rows at rows[b] bm on (rows past mq zeros,
    as TMA fills them), its columns from the K planes' rows at cols[b] bk on
    (past mk zeros), every column of the planes; each pass's sum in f64
    rounded once to f32, the cross passes added, then the hi pass, times
    the mask."""
    qh, ql, kh, kl = (p.astype(np.float64) for p in planes)
    nb, bm, bk = dev.blocks.shape
    rows = dev.block_rows.numpy().astype(np.int64)
    cols = dev.block_cols.numpy().astype(np.int64)
    out = np.zeros((nb, bm, bk), np.float32)

    def take(plane, first, count, m):
        at = first + np.arange(count)
        got = np.zeros((count, plane.shape[1]))
        got[at < m] = plane[at[at < m]]
        return got

    for b in range(nb):
        qb = [take(p, rows[b] * bm, bm, mq) for p in (qh, ql)]
        kb = [take(p, cols[b] * bk, bk, mk) for p in (kh, kl)]
        cross = ((qb[0] @ kb[1].T).astype(np.float32)
                 + (qb[1] @ kb[0].T).astype(np.float32))
        out[b] = (cross + (qb[0] @ kb[0].T).astype(np.float32)) \
            * dev.blocks[b].numpy()
    return out


@pytest.mark.parametrize("bm,bk,mq,mk,d", [
    (128, 128, 256, 256, 40), (200, 128, 256, 230, 70),
    (128, 64, 240, 256, 96), (64, 256, 256, 250, 130),
    (128, 128, 256, 256, 64)])
def test_split_planes_give_the_plain_passes(bm, bk, mq, mk, d):
    """A plane of round_up(d, 64) columns and zero rows past mq and mk
    changes no pass: the passes read from the emulated planes are the plain
    version's bit for bit (pad blocks included)."""
    mask = create_mask("band_and_decay", 256, 0.6, band_size=16, seed=3)
    dev = DeviceBSR.from_csr(mask, bm=bm, bk=bk, pad_multiple=3,
                             device="cpu")
    assert int((dev.block_rows == dev.mb).sum()) > 0
    rng = np.random.default_rng(13)
    q = rng.standard_normal((mq, d)).astype(np.float32)
    k = (rng.standard_normal((mk, d)) / 7).astype(np.float32)
    planes = emulate_planes(q, k)
    assert all(p.shape[1] % 64 == 0 and p.shape[1] >= d for p in planes)
    want = bsr_sddmm_bf16x3_plain(dev, torch.from_numpy(q),
                                  torch.from_numpy(k)).numpy()
    got = passes_from_planes(dev, planes, mq, mk)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("mq,mk,d", [(256, 230, 70), (5, 3, 130), (1, 7, 1),
                                     (64, 0, 512), (3, 2, 0)])
def test_plain_split_equals_the_emulated_planes(mq, mk, d):
    rng = np.random.default_rng(17)
    q = (rng.standard_normal((mq, d)) * 3).astype(np.float32)
    k = (rng.standard_normal((mk, d)) / 3).astype(np.float32)
    got = split_planes_plain(torch.from_numpy(q), torch.from_numpy(k))
    want = emulate_planes(q, k)
    rq, rk, dp = plane_shape(mq, mk, d)
    assert [tuple(p.shape) for p in got] == [(rq, dp)] * 2 + [(rk, dp)] * 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      w.view(np.int16))


def test_sddmm_refuses_a_precision_without_a_form(high_case):
    dev, q, k, _ = high_case
    qt, kt = torch.from_numpy(q), torch.from_numpy(k)
    with pytest.raises(ValueError, match="ROADMAP"):
        bsr_sddmm(dev, qt, kt, precision="default")
    with pytest.raises(ValueError, match="ROADMAP"):
        bsr_sddmm(DeviceBSR.from_csr(
            create_mask("band_and_decay", 256, 0.6, band_size=16, seed=3,
                        dtype="bfloat16"), device="cpu"),
            qt.bfloat16(), kt.bfloat16(), precision="high")


# --- the harness, the study and the CLI --------------------------------------

def test_run_sddmm_at_high_passes_its_gate():
    cfg = dataclasses.replace(FAST, num_cols=32, sparsity=0.9,
                              matmul_precision="high")
    row = harness.run_sddmm(256, cfg, device="cpu")
    assert row["errors_passed"] == 1
    assert row["kernel"] == "sddmm_cuda" and row["dtype"] == "float32"
    assert row["fmt"].startswith("bsr_pallas_")
    assert 0 < row["max_ae"] < 1e-4


def test_xla_only_at_high_is_the_f32_row():
    """The JAX ``sddmm_coo`` sums elementwise products, through no dot, so
    'high' does not touch it; the port's row at 'high' is its row at
    'highest'."""
    mask = random_csr(60, 50, 0.1, seed=2)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((60, 16)).astype(np.float32)
    k = rng.standard_normal((50, 16)).astype(np.float32)
    jc = JaxCOO.from_csr(mask)
    outs = []
    for prec in ("highest", "high"):
        with jax.default_matmul_precision(prec):
            outs.append(np.asarray(jax_xla.sddmm_coo(jc, jnp.asarray(q),
                                                     jnp.asarray(k))))
    np.testing.assert_array_equal(outs[0], outs[1])
    port = sddmm_coo(DeviceCOO.from_csr(mask, device="cpu"),
                     torch.from_numpy(q), torch.from_numpy(k))
    np.testing.assert_allclose(port.numpy(), outs[0], rtol=1e-6, atol=1e-6)
    rows = [harness.run_sddmm(128, dataclasses.replace(
        FAST, num_cols=8, matmul_precision=prec), device="cpu",
        xla_only=True) for prec in ("highest", "high")]
    assert rows[0]["errors_passed"] == rows[1]["errors_passed"] == 1
    for key in ("max_ae", "mae", "mape", "kernel", "fmt"):
        assert rows[0][key] == rows[1][key]


def test_study_writes_the_high_arm(tmp_path):
    """One point of the study at length 128: the JAX study's row names,
    'highest' then 'high', every row gated."""
    writer = CSVWriter(str(tmp_path / "study.csv"))
    cfg = dataclasses.replace(FAST, num_cols=8, band_size=None)
    occ, rows, sweep = sddmm_study.sddmm_point(
        128, "band_and_random", 0.9, cfg, "cpu", writer)
    plan = (occ["bm"], occ["bk"])
    suffixes = [""] + (["_b128"] if plan != (128, 128) else [])
    want = [f"mask_128_band_and_random_sp0.9_{prec}{s}"
            for prec in ("highest", "high") for s in suffixes]
    assert [r["matrix_name"] for r in rows] == want
    assert all(r["errors_passed"] == 1 for r in rows)
    assert len(sweep) == len(sddmm_study.CANDIDATES)
    ab = sddmm_study.planner_ab(rows, [occ])
    assert [r["precision"] for r in ab] == ["high", "highest"]


def test_run_spmm_and_run_pipeline_refuse_a_precision_without_a_form():
    """At f32 'high' the SpMM and the pipeline run (their 3-pass forms); f32
    at 'default' and bf16 at 'highest' have no form and raise."""
    csr = random_csr(64, 64, 0.2, seed=1)
    cfg = dataclasses.replace(FAST, num_cols=8, matmul_precision="high")
    assert harness.run_spmm(csr, "bsr_cuda", cfg, device="cpu",
                            check_accuracy=False)["dtype"] == "float32"
    assert harness.run_pipeline(csr, csr, csr, config=cfg, device="cpu",
                                check_accuracy=False)["time"] > 0
    default = dataclasses.replace(cfg, matmul_precision="default")
    with pytest.raises(ValueError, match="ROADMAP"):
        harness.run_spmm(csr, "bsr_cuda", default, device="cpu")
    with pytest.raises(ValueError, match="ROADMAP"):
        harness.run_pipeline(csr, csr, csr, config=default, device="cpu")
    # nor a bf16 row at a precision other than bf16's own
    with pytest.raises(ValueError, match="ROADMAP"):
        harness.run_spmm(csr, "dense", dataclasses.replace(
            cfg, dtype="bfloat16", matmul_precision="highest"), device="cpu")


@pytest.mark.parametrize("precision,args", [
    ("default", ["--generate", LINE, "--kernel", "bsr_cuda"]),
    ("default", ["--pipeline", "w.smtx", "w.smtx", "w.smtx"]),
    ("high", ["--generate", LINE, "--kernel", "dense", "--dtype",
              "bfloat16"]),
    ("default", ["--generate", LINE, "--kernel", "auto"])])
def test_cli_spmm_row_without_a_form_exits_2(precision, args, monkeypatch,
                                             capsys):
    monkeypatch.setenv("SPGRID_MATMUL_PRECISION", precision)
    with pytest.raises(SystemExit) as e:
        cli.main(args + ["--platform", "cpu"])
    assert e.value.code == 2
    assert "ROADMAP" in capsys.readouterr().err


@pytest.mark.parametrize("kernel", ["auto", "auto_tol", "autotune"])
def test_dispatch_kernels_refuse_f32_at_default(kernel):
    """JAX's auto at f32 'default' chooses among every format, some of
    which the port has no one-pass form of: the dispatch kernels raise
    there, and a format that contracts through no dot still runs."""
    csr = random_csr(64, 64, 0.2, seed=1)
    cfg = dataclasses.replace(FAST, num_cols=8, matmul_precision="default")
    with pytest.raises(ValueError, match="ROADMAP"):
        harness.run_spmm(csr, kernel, cfg, device="cpu")
    assert not harness.formats_run_at(harness.kernel_formats(kernel),
                                      "float32", "default")
    assert harness.formats_run_at(harness.kernel_formats(kernel),
                                  "float32", "high")
    assert harness.run_spmm(csr, "coo", cfg, device="cpu",
                            check_accuracy=False)["fmt"] == "coo"


def test_cli_sddmm_at_high(monkeypatch, tmp_path):
    monkeypatch.setenv("SPGRID_MATMUL_PRECISION", "high")
    for name, value in (("SPGRID_MIN_TIME_S", "0.005"),
                        ("SPGRID_MIN_ITERS", "2"),
                        ("SPGRID_WARMUP_ITERS", "1")):
        monkeypatch.setenv(name, value)
    out = tmp_path / "rows.csv"
    assert cli.main(["--sddmm", "128", "--num-cols", "16", "--platform",
                     "cpu", "--out", str(out)]) == 0
    assert cli.main(["--sddmm", "128", "--num-cols", "16", "--xla-only",
                     "--platform", "cpu", "--out", str(out)]) == 0
    import csv
    rows = list(csv.DictReader(out.open()))
    assert [r["kernel"] for r in rows] == ["sddmm_cuda", "sddmm_xla"]
    assert all(r["errors_passed"] == "1" for r in rows)
