"""The port's benchmark CLI (``python -m spgrid_torch.bench``) on the CPU:
the JAX package's CSV schema, the slot, block-grid, scattered and torch-op
formats gated on small parameter lines (ldu on a symmetric .mtx file),
``--reorder``, resume, the ``--sddmm`` and ``--pipeline`` modes with and
without ``--xla-only``, and the refusals."""

import csv
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spgrid.bench.schema import BenchRow
from spgrid.formats.csr import random_csr
from spgrid.io.smtx import write_smtx
from spgrid_torch.bench import cli
from spgrid_torch.io import write_smtx as port_write_smtx

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
    ["--dtype", "float64", "--kernel", "dgell_cuda"],
    ["--kernel", "wcoo_pallas"], []])
def test_unported_flags_exit_nonzero(flags, capsys):
    args = (["--generate", LINE] if "--kernel" in flags else []) + flags
    with pytest.raises(SystemExit) as e:
        cli.main(args + ["--platform", "cpu"])
    assert e.value.code != 0
    err = capsys.readouterr().err
    assert "ROADMAP" in err or "unknown kernel" in err or "need" in err


# the JAX CLI's formats that the port runs as torch ops or, cv_panel_cuda,
# on the bf16 form of the panel kernel; ldu needs a symmetric pattern
NEW_KERNELS = ("csr_xla_coo", "ell_xla", "ell", "csc", "cv_bf16", "cv_int8",
               "scoo", "cv_panel_cuda")


@pytest.mark.parametrize("kernel", NEW_KERNELS)
def test_remaining_formats_on_cpu_pass_the_gate(kernel, tmp_path):
    out = tmp_path / "rows.csv"
    assert cli.main(["--generate", LINE_B, "--kernel", kernel, "--num-cols",
                     "1,24", "--out", str(out), "--platform", "cpu"]) == 0
    rows = read_rows(out)
    assert [(r["kernel"], r["input_columns"]) for r in rows] == [
        (kernel, "1"), (kernel, "24")]
    fmt = {"csr_xla_coo": "coo", "ell_xla": "ell",
           "cv_panel_cuda": "cv_panel"}.get(kernel, kernel)
    for r in rows:
        assert r["errors_passed"] == "1" and r["fmt"] == fmt
        assert float(r["max_ae"]) < 1e-4 and float(r["gflops"]) > 0


def symmetric_mtx(path):
    """A 400^2 matrix with a symmetric pattern and unequal values, written
    as .mtx."""
    from spgrid.formats.csr import dense_to_csr
    from spgrid.io.mtx import write_mtx
    rng = np.random.default_rng(5)
    upper = np.triu(rng.random((400, 400)) < 0.02, 1)
    d = np.where(upper | upper.T, rng.random((400, 400)) + 0.5, 0.0)
    np.fill_diagonal(d, 2.0)
    write_mtx(str(path), dense_to_csr(d.astype(np.float32), name="sym"))
    return str(path)


def test_ldu_on_a_symmetric_matrix_file(tmp_path):
    out = tmp_path / "rows.csv"
    path = symmetric_mtx(tmp_path / "sym.mtx")
    assert cli.main(["--matrix", path, "--kernels", "ldu,csc", "--num-cols",
                     "1,8", "--out", str(out), "--platform", "cpu"]) == 0
    rows = read_rows(out)
    assert [(r["kernel"], r["fmt"], r["errors_passed"]) for r in rows] == [
        ("ldu", "ldu", "1")] * 2 + [("csc", "csc", "1")] * 2


def test_ldu_on_an_asymmetric_pattern_writes_a_failed_row(tmp_path):
    out = tmp_path / "rows.csv"
    assert cli.main(["--generate", LINE, "--kernel", "ldu", "--num-cols",
                     "4", "--out", str(out), "--platform", "cpu"]) == 1
    (row,) = read_rows(out)
    assert row["errors_passed"] == "0"


@pytest.mark.parametrize("order", ["rcm", "shuffle", "degsort"])
def test_reorder_rows_on_cpu(order, tmp_path):
    """``--reorder``: the rows of the permuted matrix, named
    ``<name>_<order>``, gated; the same nnz as the matrix's."""
    out = tmp_path / "rows.csv"
    assert cli.main(["--generate", LINE_B, "--kernels", "bsr_cuda,coo",
                     "--num-cols", "8", "--reorder", order, "--out",
                     str(out), "--platform", "cpu"]) == 0
    rows = read_rows(out)
    assert [r["kernel"] for r in rows] == ["bsr_cuda", "coo"]
    for r in rows:
        assert r["matrix_name"].endswith(f"_{order}")
        assert r["errors_passed"] == "1" and r["csr_m"] == "1024"


def test_every_jax_cli_kernel_has_a_port_name():
    """Each name of the JAX harness's KERNELS runs in the port, as itself
    or under the port's name of its format (``dispatch.PORT_NAME``)."""
    from spgrid.bench.harness import KERNELS as JAX_KERNELS
    from spgrid_torch.bench.harness import KERNELS as PORT_KERNELS
    from spgrid_torch.ops.dispatch import PORT_NAME
    missing = [k for k in JAX_KERNELS
               if k not in PORT_KERNELS and PORT_NAME.get(k) not in
               PORT_KERNELS]
    assert not missing


def test_xla_only_without_a_mode_exits_nonzero(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--generate", LINE, "--xla-only", "--platform", "cpu"])
    assert e.value.code != 0
    assert "--xla-only needs --sddmm or --pipeline" in capsys.readouterr().err


def pipeline_files(tmp_path):
    """Three small weights written as .smtx by the port's ``write_smtx``."""
    paths = []
    for seed in (1, 2, 3):
        paths.append(str(tmp_path / f"w{seed}.smtx"))
        port_write_smtx(paths[-1], random_csr(96, 96, 0.3, seed=seed))
    return paths


# (mode flags, the kernel and fmt of its row)
MODES = {
    "sddmm": (["--sddmm", "128", "--num-cols", "16"], "sddmm_cuda",
              "bsr_pallas_128x128"),
    "sddmm_xla": (["--sddmm", "128", "--num-cols", "16", "--xla-only"],
                  "sddmm_xla", "coo"),
    "pipeline": (["--num-cols", "16", "--band-size", "4"], "pipeline_cuda",
                 "bsr"),
    "pipeline_xla": (["--num-cols", "16", "--band-size", "4", "--xla-only"],
                     "pipeline_xla", "bsr"),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_modes_on_cpu_write_a_gated_row(mode, tmp_path):
    """``--sddmm`` and ``--pipeline`` (on .smtx weights), with and without
    ``--xla-only``: one gated row of the mode's kernel and fmt, exit 0."""
    flags, kernel, fmt = MODES[mode]
    if mode.startswith("pipeline"):
        flags = ["--pipeline", *pipeline_files(tmp_path)] + flags
    out = tmp_path / "rows.csv"
    assert cli.main(flags + ["--out", str(out), "--platform", "cpu"]) == 0
    (row,) = read_rows(out)
    assert (row["kernel"], row["fmt"]) == (kernel, fmt)
    assert row["errors_passed"] == "1" and row["device"] == "cpu"
    assert row["input_columns"] == "16" and float(row["gflops"]) > 0


def test_mode_row_that_fails_its_gate_exits_nonzero(tmp_path, monkeypatch):
    from spgrid_torch.bench import harness
    from spgrid_torch.ops.kernels.sddmm import bsr_sddmm_plain

    def off(mask, q, k):
        return bsr_sddmm_plain(mask, q, k) * 1.01

    monkeypatch.setattr(harness, "bsr_sddmm", off)
    out = tmp_path / "rows.csv"
    assert cli.main(["--sddmm", "128", "--num-cols", "8", "--out", str(out),
                     "--platform", "cpu"]) == 1
    (row,) = read_rows(out)
    assert row["errors_passed"] == "0" and row["kernel"] == "sddmm_cuda"
