"""The port's SDDMM slice against the JAX package's, on the CPU at small
sizes: the occupancy planner (with the JAX constants installed in the
port), the XLA baselines as torch ops (``sddmm_coo``, ``sddmm_dense``,
``spmm_bsr``, ``sddmm_bsr_xla``), the kernel's plain version at every
planner blocking, the harness's ``run_sddmm`` and its helpers, the
pipeline's ``xla_only`` path, and the SDDMM study with the JAX package's
join reading its CSVs; and the gathers on Q and K shorter than the mask's
rows and columns (zeros past them, as the JAX ``take(...,
fill_value=0)`` reads them).

Tolerance: the torch ops sum the same f32 products as XLA in another
order, within 1e-6 relative here (positive operands, d <= 96).
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spgrid.ops.costmodel as jax_costmodel
import spgrid.ops.sddmm_plan as jax_plan
from spgrid.bench.harness import _bsr_blocks_to_nnz as jax_blocks_to_nnz
from spgrid.formats import CSRMatrix, random_csr
from spgrid.formats.csr import dense_to_csr
from spgrid.gen import create_mask
from spgrid.ops import xla as jax_xla
from spgrid.ops.attention import SparseAttention as JaxAttention
from spgrid.ops.attention import _sddmm_bsr_xla as jax_sddmm_bsr_xla
from spgrid.ops.attention import attention_pipeline as jax_pipeline
from spgrid.ops.layouts import DeviceBSR as JaxBSR
from spgrid.ops.layouts import DeviceCOO as JaxCOO
from spgrid.ops.pallas.sddmm import bsr_sddmm as jax_bsr_sddmm
from spgrid_torch.bench import harness
from spgrid_torch.core.config import BenchConfig
from spgrid_torch.ops import costmodel, sddmm_plan, xla
from spgrid_torch.ops.attention import (
    SparseAttention, attention_pipeline, make_pipeline_step, sddmm_bsr_xla,
)
from spgrid_torch.ops.kernels.sddmm import (
    bsr_sddmm_bf16x3_plain, bsr_sddmm_plain,
)
from spgrid_torch.ops.layouts import DeviceBSR, DeviceCOO
from spgrid_torch.scripts import sddmm_study

# The suite runs in parallel workers on shared cores: one intra-op thread
# a worker keeps these small CPU tensors from oversubscribing them.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-6
FAST = BenchConfig(min_time_s=0.005, min_iters=2, warmup_iters=1)


@pytest.fixture
def jax_c(monkeypatch):
    """The JAX package's constants installed in the port's cost model."""
    monkeypatch.setattr(costmodel, "C", costmodel.H100Constants(
        **dataclasses.asdict(jax_costmodel.C), residual_nnz=29e-9))


# both mask types at lengths 512-1024, the reference's band table
PLAN_MASKS = [("band_and_random", 512, 0.9), ("band_and_decay", 768, 0.95),
              ("band_and_decay", 1024, 0.98)]


@pytest.mark.parametrize("kind,length,sparsity", PLAN_MASKS)
def test_plan_equals_jax_under_the_jax_constants(jax_c, kind, length,
                                                 sparsity):
    mask = create_mask(kind, length, sparsity, band_size=None, seed=14)
    for n in (64, 512):
        assert (dataclasses.asdict(sddmm_plan.choose_sddmm_blocks(mask, n))
                == dataclasses.asdict(jax_plan.choose_sddmm_blocks(mask, n)))


def test_plan_is_128_under_the_h100_constants():
    """grid_step 0 prices a blocking by the area its occupied blocks
    cover, which no blocking makes smaller than 128 x 128's."""
    mask = create_mask("band_and_decay", 1024, 0.95, band_size=None, seed=14)
    plan = sddmm_plan.choose_sddmm_blocks(mask, 512)
    assert (plan.bm, plan.bk) == (128, 128)
    assert plan.est_time_s == plan.est_time_128


def test_occupancy_report_equals_jax(jax_c):
    got = sddmm_plan.occupancy_report(512)
    want = jax_plan.occupancy_report(512)
    assert len(got) == len(want) == 8
    assert got == want


@pytest.mark.parametrize("kind,length,sparsity", PLAN_MASKS)
def test_block_counts_equal_jax(kind, length, sparsity):
    mask = create_mask(kind, length, sparsity, band_size=None, seed=14)
    for bm, bk in sddmm_plan.CANDIDATES + ((8, 128), (64, 32)):
        assert (sddmm_plan.block_occupancy(mask, bm, bk)
                == jax_plan.block_occupancy(mask, bm, bk))
        for band in (1, 8, 64):
            assert (sddmm_plan.reachable_blocks(length, bm, bk, band)
                    == jax_plan.reachable_blocks(length, bm, bk, band))
    assert sddmm_plan.CANDIDATES == jax_plan.CANDIDATES


@pytest.fixture(scope="module")
def sddmm_problem():
    """A 300 x 260 mask (neither side a multiple of 128), Q (300, 40) and
    K (260, 40), positive."""
    mask = random_csr(300, 260, 0.08, seed=5)
    mask = CSRMatrix(mask.row_ptr, mask.col_idx,
                     np.abs(mask.values) + 0.5, mask.shape, "m")
    rng = np.random.default_rng(6)
    q = (rng.random((300, 40)) + 0.5).astype(np.float32)
    k = (rng.random((260, 40)) + 0.5).astype(np.float32)
    return mask, q, k


def assert_rel(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=0)


@pytest.mark.parametrize("budget", [xla.SDDMM_CHUNK_BYTES, 8 * 40 * 700])
def test_sddmm_coo_equals_jax(sddmm_problem, budget, monkeypatch):
    """At the default budget in one chunk, and at a budget of 700 nnz a
    chunk: the mask's nnz in 9 chunks."""
    mask, q, k = sddmm_problem
    monkeypatch.setattr(xla, "SDDMM_CHUNK_BYTES", budget)
    assert -(-mask.nnz // xla.sddmm_chunk(40)) >= (
        3 if budget < 1 << 30 else 1)
    got = xla.sddmm_coo(DeviceCOO.from_csr(mask, device="cpu"),
                        torch.from_numpy(q), torch.from_numpy(k))
    want = jax_xla.sddmm_coo(JaxCOO.from_csr(mask), jnp.asarray(q),
                             jnp.asarray(k))
    assert got.shape == want.shape
    assert_rel(got, want)


def test_sddmm_coo_chunks_give_the_same_values(sddmm_problem, monkeypatch):
    mask, q, k = sddmm_problem
    coo = DeviceCOO.from_csr(mask, device="cpu")
    qt, kt = torch.from_numpy(q), torch.from_numpy(k)
    one = xla.sddmm_coo(coo, qt, kt)
    assert torch.equal(one, xla.sddmm_coo(coo, qt, kt))
    for budget in (8 * 40, 8 * 40 * 1000):
        monkeypatch.setattr(xla, "SDDMM_CHUNK_BYTES", budget)
        assert torch.equal(one, xla.sddmm_coo(coo, qt, kt))
    assert not one[mask.nnz:].any()


def test_sddmm_dense_equals_jax(sddmm_problem):
    mask, q, k = sddmm_problem
    dense = mask.to_dense()
    assert_rel(xla.sddmm_dense(torch.from_numpy(dense), torch.from_numpy(q),
                               torch.from_numpy(k)),
               jax_xla.sddmm_dense(jnp.asarray(dense), jnp.asarray(q),
                                   jnp.asarray(k)))


@pytest.mark.parametrize("bm,bk,pad", [(8, 128, 1), (128, 128, 4),
                                       (16, 32, 8)])
def test_spmm_bsr_equals_jax(bm, bk, pad):
    a = random_csr(300, 260, 0.05, seed=8)
    a = CSRMatrix(a.row_ptr, a.col_idx, np.abs(a.values) + 0.5, a.shape, "a")
    x = (np.random.default_rng(9).random((260, 24)) + 0.5).astype(np.float32)
    got = xla.spmm_bsr(DeviceBSR.from_csr(a, bm=bm, bk=bk, pad_multiple=pad,
                                          device="cpu"), torch.from_numpy(x))
    want = jax_xla.spmm_bsr(JaxBSR.from_csr(a, bm=bm, bk=bk,
                                            pad_multiple=pad),
                            jnp.asarray(x))
    assert got.shape == want.shape == (300, 24)
    assert_rel(got, want)


@pytest.mark.parametrize("bm,bk", sddmm_plan.CANDIDATES)
def test_sddmm_bsr_xla_and_plain_equal_jax_at_every_blocking(sddmm_problem,
                                                             bm, bk):
    mask, q, k = sddmm_problem
    port = DeviceBSR.from_csr(mask, bm=bm, bk=bk, pad_multiple=4,
                              device="cpu")
    want = jax_sddmm_bsr_xla(JaxBSR.from_csr(mask, bm=bm, bk=bk,
                                             pad_multiple=4),
                             jnp.asarray(q), jnp.asarray(k))
    qt, kt = torch.from_numpy(q), torch.from_numpy(k)
    assert_rel(sddmm_bsr_xla(port, qt, kt), want)
    assert_rel(bsr_sddmm_plain(port, qt, kt), want)


def short_mask(kind):
    """8 x 8 masks: entries in columns 1, 2, 6 and 7 (rows 0, 6, 3, 5), or
    one 4 x 4 block at block row 1 and block column 1."""
    d = np.zeros((8, 8), np.float32)
    if kind == "columns":
        d[0, 1], d[6, 2], d[3, 6], d[5, 7] = 1.0, 0.5, 2.0, 1.5
    else:
        d[4:, 4:] = np.arange(1, 17, dtype=np.float32).reshape(4, 4) / 8
    return dense_to_csr(d, name=kind)


def bf16_values(a):
    """``a`` rounded to bf16 values (held in f32): the 3-pass form's lo
    parts are then zero and its passes exact."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def sddmm_bsr_case(fn):
    def run(mask, q, k):
        return fn(DeviceBSR.from_csr(mask, bm=4, bk=4, device="cpu"), q, k)
    return run


def jax_bsr_case(mask, q, k):
    return jax_sddmm_bsr_xla(JaxBSR.from_csr(mask, bm=4, bk=4), q, k)


def sddmm_coo_case(mask, q, k):
    return xla.sddmm_coo(DeviceCOO.from_csr(mask, device="cpu"), q, k)


def jax_coo_case(mask, q, k):
    return jax_xla.sddmm_coo(JaxCOO.from_csr(mask), q, k)


SHORT_QK = {
    "plain": (sddmm_bsr_case(bsr_sddmm_plain), jax_bsr_case),
    "bf16x3_plain": (sddmm_bsr_case(bsr_sddmm_bf16x3_plain), jax_bsr_case),
    "sddmm_coo": (sddmm_coo_case, jax_coo_case),
}


@pytest.mark.parametrize("mq,mk", [(8, 4), (4, 8), (3, 4), (8, 8)])
@pytest.mark.parametrize("kind", ["columns", "block_1_1"])
@pytest.mark.parametrize("name", sorted(SHORT_QK))
def test_short_q_and_k_read_zeros_past_their_rows(name, kind, mq, mk):
    """The block SDDMM's plain versions (through ``_panels``) and
    ``sddmm_coo`` on Q of mq and K of mk rows under an 8 x 8 mask equal the
    JAX functions, and equal bit for bit themselves on Q and K padded with
    zero rows to the mask's 8; operands of full length go through
    uncopied."""
    port, jax_fn = SHORT_QK[name]
    mask = short_mask(kind)
    rng = np.random.default_rng(12)
    q = bf16_values((rng.random((mq, 16)) + 0.5).astype(np.float32))
    k = bf16_values((rng.random((mk, 16)) + 0.5).astype(np.float32))
    got = port(mask, torch.from_numpy(q), torch.from_numpy(k))
    assert_rel(got, jax_fn(mask, jnp.asarray(q), jnp.asarray(k)))
    qf, kf = np.zeros((8, 16), np.float32), np.zeros((8, 16), np.float32)
    qf[:mq], kf[:mk] = q, k
    qt, kt = torch.from_numpy(qf), torch.from_numpy(kf)
    assert xla.zero_rows(qt, 8) is qt and xla.zero_rows(kt, 8) is kt
    assert torch.equal(port(mask, qt, kt), got)
    assert_rel(port(mask, qt, kt), jax_fn(mask, jnp.asarray(qf),
                                          jnp.asarray(kf)))


@pytest.fixture(scope="module")
def interpret_sddmm():
    """JAX ``bsr_sddmm`` in interpret mode at one shape: a 256^2 mask at
    128 x 128, d = 32."""
    mask = create_mask("band_and_random", 256, 0.9, band_size=4, seed=14)
    rng = np.random.default_rng(10)
    q = (rng.random((256, 32)) + 0.5).astype(np.float32)
    k = (rng.random((256, 32)) + 0.5).astype(np.float32)
    want = jax_bsr_sddmm(JaxBSR.from_csr(mask, bm=128, bk=128),
                         jnp.asarray(q), jnp.asarray(k), interpret=True)
    return mask, q, k, np.asarray(want)


def test_plain_equals_jax_kernel_in_interpret_mode(interpret_sddmm):
    mask, q, k, want = interpret_sddmm
    got = bsr_sddmm_plain(DeviceBSR.from_csr(mask, bm=128, bk=128,
                                             device="cpu"),
                          torch.from_numpy(q), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("bm,bk", sddmm_plan.CANDIDATES + ((8, 128),))
def test_bsr_blocks_to_nnz_equals_jax(sddmm_problem, bm, bk):
    mask, _, _ = sddmm_problem
    port = DeviceBSR.from_csr(mask, bm=bm, bk=bk, pad_multiple=4,
                              device="cpu")
    blocks = np.random.default_rng(11).random(
        tuple(port.blocks.shape)).astype(np.float32)
    rows = np.repeat(np.arange(mask.m), mask.degrees)
    got = harness._bsr_blocks_to_nnz(port, blocks, mask, rows)
    want = jax_blocks_to_nnz(JaxBSR.from_csr(mask, bm=bm, bk=bk,
                                             pad_multiple=4),
                             blocks, mask, rows)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(   # the mask's own blocks give its values
        harness._bsr_blocks_to_nnz(port, port.blocks.numpy(), mask, rows),
        mask.values)


def test_sddmm_gold_equals_the_jax_harness_numbers(sddmm_problem,
                                                   monkeypatch):
    """The gold is the JAX harness's chunked f64 einsum over the nnz, here
    formed a block of rows at a time (blocks of 7 rows force 43)."""
    mask, q, k = sddmm_problem
    rows = np.repeat(np.arange(mask.m), mask.degrees)
    want = np.einsum("nd,nd->n", q[rows].astype(np.float64),
                     k[mask.col_idx].astype(np.float64))
    want *= mask.values.astype(np.float64)
    np.testing.assert_allclose(harness.sddmm_gold(mask, q, k), want,
                               rtol=1e-13, atol=0)
    monkeypatch.setattr(harness, "SDDMM_GOLD_BYTES", 8 * 260 * 7)
    np.testing.assert_allclose(harness.sddmm_gold(mask, q, k), want,
                               rtol=1e-13, atol=0)


@pytest.mark.parametrize("xla_only", [False, True])
def test_run_sddmm_rows_pass_their_gates(xla_only):
    """As ``tests/test_bench.py::test_run_sddmm_standalone`` runs the JAX
    harness: a 128^2 mask at sparsity 0.85, n = 32."""
    cfg = dataclasses.replace(FAST, num_cols=32, sparsity=0.85, seed=3)
    row = harness.run_sddmm(128, cfg, device="cpu", xla_only=xla_only)
    assert row["errors_passed"] == 1
    assert row["csr_m"] == 128 and row["gflops"] > 0
    assert row["kernel"] == ("sddmm_xla" if xla_only else "sddmm_cuda")
    assert row["fmt"] == ("coo" if xla_only else "bsr_pallas_128x128")
    assert row["fmt_mem_footprint_mb"] > 0


@pytest.mark.parametrize("bm,bk", sddmm_plan.CANDIDATES)
def test_run_sddmm_at_every_blocking(bm, bk):
    mask = create_mask("band_and_decay", 300, 0.9, band_size=None, seed=14)
    cfg = dataclasses.replace(FAST, num_cols=16)
    row = harness.run_sddmm(300, cfg, device="cpu", mask=mask,
                            blocks=(bm, bk))
    assert row["errors_passed"] == 1 and row["fmt"] == f"bsr_pallas_{bm}x{bk}"


def test_run_sddmm_fails_a_wrong_value(monkeypatch):
    def off(mask, q, k):
        out = bsr_sddmm_plain(mask, q, k)
        out[0, 0, :] += 1.0
        return out

    monkeypatch.setattr(harness, "bsr_sddmm", off)
    mask = create_mask("band_and_random", 128, 0.8, band_size=4, seed=3)
    row = harness.run_sddmm(128, dataclasses.replace(FAST, num_cols=8),
                            device="cpu", mask=mask)
    assert row["errors_passed"] == 0


@pytest.fixture(scope="module")
def pipeline_problem():
    """The inputs of tests/test_pipeline.py: m=128, k=96, n=64."""
    def pos(csr):
        return CSRMatrix(csr.row_ptr, csr.col_idx, np.abs(csr.values) + 0.1,
                         csr.shape, csr.name)

    ws = [pos(random_csr(128, 96, density=0.5, seed=s)) for s in (1, 2, 3)]
    mask = create_mask("band_and_random", 128, sparsity=0.8, band_size=4,
                       seed=14)
    x = np.random.default_rng(0).random((96, 64)).astype(np.float32) * 0.2
    return (*ws, mask, x)


BLOCKS = {"bm8": dict(bm=8, bk=128, mask_bm=8, mask_bk=128), "bm128": {}}


@pytest.mark.parametrize("blocks", sorted(BLOCKS))
def test_xla_pipeline_matches_jax_stage_by_stage(pipeline_problem, blocks):
    wk, wq, wv, mask, x = pipeline_problem
    kw = BLOCKS[blocks]
    _, want = jax_pipeline(JaxAttention.from_csr(wk, wq, wv, mask, **kw),
                           jnp.asarray(x), use_pallas=False)
    attn = SparseAttention.from_csr(wk, wq, wv, mask, device="cpu", **kw)
    y, got = attention_pipeline(attn, torch.from_numpy(x), xla_only=True)
    for stage in "KQVSY":
        np.testing.assert_allclose(got[stage].numpy(),
                                   np.asarray(want[stage]), rtol=1e-5,
                                   atol=1e-7, err_msg=stage)
    step = make_pipeline_step(attn, xla_only=True)
    assert torch.equal(step(torch.from_numpy(x)), y)


@pytest.mark.parametrize("xla_only", [False, True])
def test_run_pipeline_rows_pass_their_gates(pipeline_problem, xla_only):
    wk, wq, wv, mask, _ = pipeline_problem
    row = harness.run_pipeline(wk, wq, wv, mask,
                               dataclasses.replace(FAST, num_cols=16),
                               device="cpu", xla_only=xla_only)
    assert row["errors_passed"] == 1
    assert row["kernel"] == ("pipeline_xla" if xla_only else "pipeline_cuda")
    assert row["gflops_sddmm"] > 0


def load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_study_writes_what_the_jax_join_reads(jax_c, tmp_path, monkeypatch):
    """The study at length 256 (the JAX constants plan 256 x 256 there, so
    every point has a 128^2 arm too), at both precisions: every row gated,
    a sweep line for every blocking, and ``planner_ab`` equal to
    ``scripts/analyze_sddmm_ab.py`` run on the study's CSVs."""
    for name, value in (("SPGRID_MIN_ITERS", "2"),
                        ("SPGRID_WARMUP_ITERS", "1")):
        monkeypatch.setenv(name, value)
    for name, value in (("LENGTH", 256), ("PIPELINE_LENGTH", 64), ("N", 8),
                        ("MIN_TIME_S", 0.005)):
        monkeypatch.setattr(sddmm_study, name, value)
    assert sddmm_study.main(["--platform", "cpu",
                             "--out-dir", str(tmp_path)]) == 0
    import csv

    def rows(name):
        with open(tmp_path / name) as f:
            return list(csv.DictReader(f))

    study = rows("sddmm_study.csv")
    assert len(study) == 32 and all(r["errors_passed"] == "1"
                                    for r in study)
    assert {r["fmt"] for r in study} == {"bsr_pallas_256x256",
                                         "bsr_pallas_128x128"}
    assert len(rows("sddmm_blockings.csv")) == 8 * 5
    assert len(rows("pipeline.csv")) == 6
    join = load_jax_script("analyze_sddmm_ab")
    monkeypatch.setattr(join, "RES", str(tmp_path))
    port = rows("sddmm_planner_ab.csv")
    (tmp_path / "sddmm_planner_ab.csv").unlink()
    join.main()
    assert rows("sddmm_planner_ab.csv") == port and len(port) == 16
