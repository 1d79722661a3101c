"""The port's benchmark CLI (``python -m spgrid_torch.bench``) on the CPU:
the JAX package's CSV schema, the slot, block-grid and scattered formats
gated on small parameter lines, resume, and the refusals."""

import csv
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from spgrid.bench.schema import BenchRow
from spgrid.formats.csr import random_csr
from spgrid.io.smtx import write_smtx
from spgrid_torch.bench import cli

# The suite runs in parallel workers on shared cores: one intra-op thread
# a worker keeps these small CPU tensors from oversubscribing them.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
LINE = "700 1100 5 1.6667 normal random 0.05 0 0.05 0.05 14"


@pytest.fixture(autouse=True)
def fast_timing(monkeypatch):
    for name, value in (("SPGRID_MIN_TIME_S", "0.005"),
                        ("SPGRID_MIN_ITERS", "2"),
                        ("SPGRID_WARMUP_ITERS", "1")):
        monkeypatch.setenv(name, value)


def read_rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_labels_print_the_jax_header(capsys):
    assert cli.main(["--labels"]) == 0
    assert capsys.readouterr().out.strip() == BenchRow.header()


def test_module_entry_point_prints_labels():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "spgrid_torch.bench",
                           "--labels"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == BenchRow.header()


@pytest.mark.parametrize("kernels,n", [("wcoo_cuda,wcoo_bands_cuda", "1,24"),
                                       ("wrow_spmv_cuda,wcoo_spmv_cuda", "1")])
def test_generate_on_cpu_passes_the_gate(kernels, n, tmp_path):
    out = tmp_path / "rows.csv"
    assert cli.main(["--generate", LINE, "--kernels", kernels, "--num-cols",
                     n, "--out", str(out), "--platform", "cpu"]) == 0
    with open(out) as f:
        assert f.readline().strip() == BenchRow.header()
    rows = read_rows(out)
    want = [(k, c) for k in kernels.split(",") for c in n.split(",")]
    assert [(r["kernel"], r["input_columns"]) for r in rows] == want
    for r in rows:
        assert r["errors_passed"] == "1" and r["device"] == "cpu"
        assert r["csr_m"] == "700" and r["csr_k"] == "1100"
        assert float(r["max_ae"]) < 1e-4 and float(r["gflops"]) > 0
        assert r["matrix_name"].startswith("art_700_1100_5")


# small counterparts of the block-grid and scattered lines (the JAX
# package's bsrc_pallas smoke line and synth_100k_a20_b0.9)
LINE_B = "1024 1024 50 10 normal random 0.05 0 0.05 0.05 14"
LINE_S = "3000 3000 20 6.6667 normal random 0.9 0 0.05 0.05 14"


@pytest.mark.parametrize("line,kernels,n", [
    (LINE_B, "bsrc_cuda,bsr_cuda", "24"),
    (LINE_S, "dgell_cuda", "1,24"),
    (LINE_S, "wpack_spmv_cuda,wrow_spmv_cuda", "1"),
    (LINE, "coo,sell,merge,gell,gell16,cv_gell", "1,24"),
    (LINE_B, "coo,sell,merge,gell", "24")])
def test_new_formats_on_cpu_pass_the_gate(line, kernels, n, tmp_path):
    out = tmp_path / "rows.csv"
    assert cli.main(["--generate", line, "--kernels", kernels, "--num-cols",
                     n, "--out", str(out), "--platform", "cpu"]) == 0
    rows = read_rows(out)
    want = [(k, c) for k in kernels.split(",") for c in n.split(",")]
    assert [(r["kernel"], r["input_columns"]) for r in rows] == want
    for r in rows:
        assert r["errors_passed"] == "1" and r["device"] == "cpu"
        assert float(r["max_ae"]) < 1e-4 and float(r["gflops"]) > 0
        assert float(r["fmt_mem_footprint_mb"]) > 0


def test_wpack_at_n_2_writes_a_failed_row(tmp_path):
    out = tmp_path / "rows.csv"
    assert cli.main(["--generate", LINE_S, "--kernel", "wpack_spmv_cuda",
                     "--num-cols", "2", "--out", str(out),
                     "--platform", "cpu"]) == 1
    (row,) = read_rows(out)
    assert row["errors_passed"] == "0" and row["input_columns"] == "2"


def test_matrix_files_run_through_the_sweep(tmp_path):
    path = tmp_path / "w.smtx"
    write_smtx(str(path), random_csr(300, 200, 0.02, seed=3))
    out = tmp_path / "rows.csv"
    assert cli.main(["--matrix", str(path), "--kernels",
                     "wcoo_cuda,wrow_spmv_cuda", "--num-cols", "1", "--out",
                     str(out), "--platform", "cpu"]) == 0
    rows = read_rows(out)
    assert [(r["matrix_name"], r["errors_passed"]) for r in rows] == [
        ("w", "1"), ("w", "1")]


def test_out_resumes_without_repeating_rows(tmp_path, capsys):
    out = str(tmp_path / "rows.csv")
    args = ["--generate", LINE, "--kernel", "wrow_spmv_cuda", "--num-cols",
            "1", "--out", out, "--platform", "cpu"]
    assert cli.main(args) == 0
    assert cli.main(args + ["--kernels", "wrow_spmv_cuda,wcoo_spmv_cuda"]) == 0
    assert "skip (done)" in capsys.readouterr().out
    assert [r["kernel"] for r in read_rows(out)] == ["wrow_spmv_cuda",
                                                     "wcoo_spmv_cuda"]


def test_spmv_format_at_n_above_1_writes_a_failed_row(tmp_path):
    out = tmp_path / "rows.csv"
    assert cli.main(["--generate", LINE, "--kernel", "wrow_spmv_cuda",
                     "--num-cols", "4", "--out", str(out),
                     "--platform", "cpu"]) == 1
    (row,) = read_rows(out)
    assert row["errors_passed"] == "0" and row["input_columns"] == "4"


def test_without_cuda_and_without_platform_cpu_exits_nonzero(monkeypatch,
                                                              tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "rows.csv"
    assert cli.main(["--generate", LINE, "--kernel", "wcoo_cuda",
                     "--out", str(out)]) != 0
    assert not out.exists()


@pytest.mark.parametrize("flags", [
    ["--pipeline", "a.smtx", "b.smtx", "c.smtx"], ["--sddmm", "256"],
    ["--xla-only"], ["--reorder", "rcm"], ["--dtype", "bfloat16"],
    ["--kernel", "wcoo_pallas"], []])
def test_unported_flags_exit_nonzero(flags, capsys):
    args = (["--generate", LINE] if "--kernel" in flags else []) + flags
    with pytest.raises(SystemExit) as e:
        cli.main(args + ["--platform", "cpu"])
    assert e.value.code != 0
    err = capsys.readouterr().err
    assert "ROADMAP" in err or "unknown kernel" in err or "need" in err
