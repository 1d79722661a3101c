"""The port's host helpers against the originals, its harness on the CPU
path, its imports without JAX, and its build without nvcc."""

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import spgrid.bench.harness as jax_harness
import spgrid.core.config as jax_config
import spgrid.core.metrics as jax_metrics
import spgrid.core.roofline as jax_roofline
import spgrid.ops.dispatch as jax_dispatch
from spgrid.bench.schema import BenchRow
from spgrid.formats.csr import dense_to_csr, random_csr
from spgrid.gen import artificial_matrix_generation, create_mask
from spgrid_torch.bench import harness, headline
from spgrid_torch.bench.harness import make_x, run_pipeline, run_spmm
from spgrid_torch.bench.headline import headline_line
from spgrid_torch.core import metrics, roofline
from spgrid_torch.core.config import BenchConfig
from spgrid_torch.core.timing import time_kernel, time_kernel_graph
from spgrid_torch.ops import dispatch
from spgrid_torch.ops.dense import gemm, spmm_dense
from spgrid_torch.ops.kernels import _build

# The suite runs in parallel workers on shared cores: one intra-op thread
# a worker keeps these small CPU tensors from oversubscribing them.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FAST = BenchConfig(num_cols=24, warmup_iters=1, min_time_s=0.01, min_iters=2)


def gold_test_pairs():
    rng = np.random.default_rng(2)
    gold = rng.standard_normal(500)
    gold[:20] = 0.0
    test = gold + rng.standard_normal(500) * 1e-6
    yield gold, test
    yield gold, gold.copy()
    yield np.zeros(10), np.zeros(10)
    yield gold[:50], (gold[:50] * 1.01).astype(np.float32)


@pytest.mark.parametrize("eps", [1e-7, 1e-4, 1e-3])
def test_error_metrics_copy_matches_original(eps):
    for gold, test in gold_test_pairs():
        got = dataclasses.asdict(metrics.error_metrics(gold, test, eps))
        want = dataclasses.asdict(jax_metrics.error_metrics(gold, test, eps))
        assert got.keys() == want.keys()
        np.testing.assert_equal(got, want)


@pytest.mark.parametrize("ncols", [None, 1, 7])
def test_gold_spmm_fast_copy_matches_original(ncols):
    d = random_csr(60, 40, 0.2, seed=3).to_dense()
    d[5:9] = 0.0                             # empty rows
    csr = dense_to_csr(d.astype(np.float32))
    rng = np.random.default_rng(4)
    x = rng.random(40) if ncols is None else rng.random((40, ncols))
    args = (csr.row_ptr, csr.col_idx, csr.values, x)
    np.testing.assert_array_equal(metrics.gold_spmm_fast(*args),
                                  jax_metrics.gold_spmm_fast(*args))


@pytest.mark.parametrize("k,n,seed", [(96, 64, 14), (512, 512, 14), (7, 3, 0)])
def test_make_x_copy_matches_original(k, n, seed):
    np.testing.assert_array_equal(make_x(k, n, "float32", seed),
                                  jax_harness.make_x(k, n, "float32", seed))


def test_config_defaults_match_original():
    want = jax_config.BenchConfig()
    got = BenchConfig()
    for f in dataclasses.fields(got):
        if f.name == "timing_protocol":
            # the same field, the card's own protocols (JAX: jit trip counts)
            assert want.timing_protocol in ("dynamic", "static")
            assert got.timing_protocol == "graph"
            continue
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    for dtype in ("float32", "float64", "bfloat16"):
        assert (BenchConfig(dtype=dtype).epsilon
                == jax_config.BenchConfig(dtype=dtype).epsilon)


def test_flop_and_byte_models_match_original():
    for args in [(1000, 512), (7, 0), (0, 3)]:
        assert roofline.spmm_flops(*args) == jax_roofline.spmm_flops(*args)
    assert roofline.gemm_flops(3, 5, 7) == jax_roofline.gemm_flops(3, 5, 7)
    for args in [(1000, 64, 512, 96), (5, 3, 0, 2)]:
        assert roofline.csr_bytes(*args) == jax_roofline.csr_bytes(*args)
        assert (roofline.csr_bytes(*args, val_bytes=8)
                == jax_roofline.csr_bytes(*args, val_bytes=8))


def test_chip_for_name():
    assert roofline.chip_for_name("NVIDIA H100 80GB HBM3") is roofline.H100_SXM
    assert roofline.chip_for_name("NVIDIA H100 PCIe") is roofline.H100_PCIE
    assert roofline.chip_for_name("NVIDIA A100-SXM4-40GB") is None


def test_time_kernel_meets_both_minimums():
    calls = []
    r = time_kernel(lambda v: calls.append(v), 1, device="cpu",
                    warmup_iters=2, min_time_s=0.0, min_iters=5, flops=10.0)
    assert r.iters >= 5 and len(calls) == r.iters + 2
    assert r.time_per_iter_s > 0 and r.gflops == 10.0 / r.time_per_iter_s / 1e9


@pytest.mark.parametrize("kernel", ["dense", "panel_cuda", "bsr_cuda"])
def test_run_spmm_cpu_passes_gate(kernel):
    csr = artificial_matrix_generation(96, 80, 30, 4, "normal", seed=14,
                                       placement="random", bw=1.0,
                                       name="twin_96")
    row = run_spmm(csr, kernel, FAST, device="cpu")
    assert row["errors_passed"] == 1 and row["mae"] < 1e-4
    assert row["device"] == "cpu" and math.isnan(row["sol_time"])
    assert math.isnan(row["roofline_frac"])
    assert row["gflops"] > 0 and row["iters"] >= FAST.min_iters
    assert set(row) <= set(BenchRow.columns())


@pytest.mark.parametrize("given_mask", [True, False])
def test_run_pipeline_cpu_passes_gate(given_mask):
    wk, wq, wv = (artificial_matrix_generation(
        64, 64, 32, 4, "normal", seed=s, placement="random", bw=1.0,
        name=f"w{s}") for s in (1, 2, 3))
    mask = (create_mask("band_and_random", 64, sparsity=0.8, band_size=4,
                        seed=14) if given_mask else None)
    config = dataclasses.replace(FAST, sparsity=0.8, band_size=4)
    row = run_pipeline(wk, wq, wv, mask, config, device="cpu")
    assert row["errors_passed"] == 1
    for key in ("gflops", "gflops_spmm_K", "gflops_spmm_Q", "gflops_spmm_V",
                "gflops_sddmm", "gflops_final_spmm"):
        assert row[key] > 0, key
    assert set(row) <= set(BenchRow.columns())


def test_dispatch_formats_and_jax_names():
    assert set(dispatch.FORMATS) == set(dispatch.JAX_NAME)
    assert set(dispatch.JAX_NAME.values()) <= set(jax_dispatch.FORMATS)
    from spgrid.formats.cv import csr_to_cv, cv_to_csr
    rect = random_csr(40, 30, 0.3, seed=2)
    # ldu takes a square matrix with a symmetric pattern only
    d = random_csr(30, 30, 0.3, seed=2).to_dense()
    square = dense_to_csr(np.where(d.T != 0, d.T, d), name="square")
    for fmt in dispatch.FORMATS:
        csr = square if fmt == "ldu" else rect
        x8 = torch.from_numpy(make_x(csr.k, 8, "float32", 1))
        # the SpMV formats take a (k, 1) operand only
        x = x8[:, :1] if fmt.endswith("spmv_cuda") else x8
        # gell16 and cv_gell multiply the X the JAX harness gates them on
        # by the values split to 16 bits (hi + lo, as the JAX modes split
        # their values, and as the JAX harness splits X for gell16); the
        # cv_* formats multiply their compressed values (cv_panel bf16
        # values by X rounded to bf16, as the JAX harness gates it)
        jax_fmt = dispatch.JAX_NAME[fmt]
        a = csr.to_dense()
        if fmt in ("gell16", "cv_gell"):
            a = jax_harness._xg_host(a, "gell16")
        elif jax_fmt.startswith("cv_"):
            mode = "bf16" if jax_fmt == "cv_panel" else jax_fmt[3:]
            a = cv_to_csr(csr_to_cv(csr, mode)).to_dense()
        want = (a.astype(np.float64)
                @ jax_harness._xg_host(x.numpy(), jax_fmt).astype(np.float64))
        y = dispatch.spmm_fn(fmt)(dispatch.build(csr, fmt, device="cpu"), x)
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=fmt)
    csr = rect
    with pytest.raises(ValueError):
        dispatch.build(csr, "bsr_pallas", device="cpu")
    with pytest.raises(ValueError):
        dispatch.spmm_fn("bsr_pallas")


def test_dense_ops_are_full_f32():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.random((33, 20)).astype(np.float32))
    x = torch.from_numpy(rng.random((20, 7)).astype(np.float32))
    want = a.double() @ x.double()
    for fn in (spmm_dense, gemm):
        torch.testing.assert_close(fn(a, x).double(), want, rtol=1e-6,
                                   atol=1e-6)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_headline_line_takes_best_passing_row():
    rows = [{"kernel": "dense", "gflops": 9.0, "errors_passed": 0},
            {"kernel": "bsr_cuda", "gflops": 5.0, "errors_passed": 1},
            {"kernel": "panel_cuda", "gflops": 4.0, "errors_passed": 1}]
    line = headline_line(rows, "card")
    assert line["kernel"] == "bsr_cuda" and line["value"] == 5.0
    assert line["vs_baseline"] == 5.0 / 251.0
    assert line["metric"] == "spmm_dlmc_n512_f32_gflops"
    with pytest.raises(RuntimeError):
        headline_line(rows[:1], "card")


BLOCKED = ("jax", "jaxlib", "spgrid")
BLOCK_JAX = f"""
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import spgrid_torch, chip_smoke
names = [m.name for m in pkgutil.walk_packages(spgrid_torch.__path__,
                                               "spgrid_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(m.split(".")[0] in {BLOCKED!r} for m in sys.modules)
print(len(names))
"""


def test_port_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", BLOCK_JAX], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").rglob("*.so"))


def test_build_dir_keys_on_sources():
    d = _build.build_dir()
    assert d.parent == _build.BUILD_ROOT and len(d.name) == 16
    assert d == _build.build_dir()
    assert {p.name for p in _build.sources()} >= {
        "bsr_spmm.cu", "panel_spmm.cu", "sddmm.cu", "block_mma.cuh"}


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_cuda(where, tmp_path):
    if where == "alone":
        cwd = tmp_path
        shutil.copy(REPO / "chip_smoke.py", cwd)
    else:
        cwd = REPO
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert torch.cuda.is_available() or "is_available() is false" in proc.stderr
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_timing_protocol_default_env_and_bad_value(monkeypatch):
    assert BenchConfig().timing_protocol == "graph"
    monkeypatch.setenv("SPGRID_TIMING_PROTOCOL", "eager")
    assert BenchConfig.from_env().timing_protocol == "eager"
    assert headline.headline_config().timing_protocol == "eager"
    monkeypatch.setenv("SPGRID_TIMING_PROTOCOL", "dynamic")
    with pytest.raises(ValueError, match="timing_protocol"):
        BenchConfig.from_env()
    with pytest.raises(ValueError, match="timing_protocol"):
        BenchConfig(timing_protocol="static")


def test_time_kernel_graph_needs_a_cuda_device():
    calls = []
    with pytest.raises(ValueError, match="CUDA graph"):
        time_kernel_graph(lambda: calls.append(1), device="cpu")
    assert calls == []


def test_graph_calls_keep_outputs_within_budget():
    assert harness.graph_calls(4 * 512 * 512) == harness.GRAPH_CALLS
    # LINE_S at n=512: a 205 MB Y a call
    assert harness.graph_calls(4 * 100000 * 512) == 10
    assert harness.graph_calls(10 * harness.GRAPH_BYTES) == 2
    for out in (1, 4e6, 2.05e8, 1e9, 1e12):
        calls = harness.graph_calls(out)
        assert calls == 2 or calls * out <= harness.GRAPH_BYTES


@pytest.mark.parametrize("protocol", ["graph", "eager"])
def test_time_call_takes_the_protocol_on_the_card(monkeypatch, protocol):
    seen = []
    monkeypatch.setattr(harness, "time_kernel_graph",
                        lambda *a, **kw: seen.append(("graph", kw)))
    monkeypatch.setattr(harness, "time_kernel",
                        lambda *a, **kw: seen.append(("eager", kw)))
    config = dataclasses.replace(FAST, timing_protocol=protocol)
    harness.time_call(torch.add, 1, 2, config=config,
                      device=torch.device("cuda"), out_bytes=4 * 100000 * 512)
    harness.time_call(torch.add, 1, 2, config=config,
                      device=torch.device("cpu"), out_bytes=4)
    assert [s[0] for s in seen] == [protocol, "eager"]
    if protocol == "graph":
        assert seen[0][1]["calls"] == 10
    assert all(kw["min_iters"] == FAST.min_iters for _, kw in seen)


def test_roofline_frac_is_capped(monkeypatch):
    slow = roofline.ChipSpec(name="slow_card", hbm_gbytes_per_s=1e-6,
                             peak_bf16_tflops=1e-9, peak_f32_tflops=1e-9)
    monkeypatch.setattr(harness, "_device_fields",
                        lambda device: (slow.name, slow))
    csr = random_csr(64, 48, 0.2, seed=1)
    row = run_spmm(csr, "bsr_cuda", FAST, device="cpu",
                   check_accuracy=False)
    assert row["sol_time"] / row["time"] > 9.99
    assert row["roofline_frac"] == 9.99
    assert row["device"] == "slow_card"


def headline_main(monkeypatch, capsys, run):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "card")
    monkeypatch.setattr(headline, "run_spmm", run)
    code = headline.main()
    out = capsys.readouterr()
    lines = out.out.splitlines()
    assert len(lines) == 1
    return code, json.loads(lines[0]), out.err


def test_headline_skips_a_kernel_that_raises(monkeypatch, capsys):
    def run(csr, kernel, config, *, device):
        assert device == "cuda" and config.num_cols == 512
        if kernel == "dense":
            raise RuntimeError("no cuBLAS today")
        return {"kernel": kernel, "errors_passed": 1,
                "gflops": {"panel_cuda": 3.0, "bsr_cuda": 7.0}[kernel]}

    code, line, err = headline_main(monkeypatch, capsys, run)
    assert code == 0
    assert line["value"] == 7.0 and line["kernel"] == "bsr_cuda"
    assert "error" not in line
    assert "kernel dense failed: no cuBLAS today" in err


def test_headline_prints_the_error_line_when_none_passes(monkeypatch,
                                                         capsys):
    def run(csr, kernel, config, *, device):
        if kernel == "panel_cuda":
            raise RuntimeError("launch failed")
        return {"kernel": kernel, "errors_passed": 0, "gflops": 9.0}

    code, line, err = headline_main(monkeypatch, capsys, run)
    assert code == 1
    assert line == {"metric": "spmm_dlmc_n512_f32_gflops", "value": 0.0,
                    "unit": "GFLOPS", "vs_baseline": 0.0,
                    "error": "all_kernels_failed"}
    assert "kernel panel_cuda failed" in err
