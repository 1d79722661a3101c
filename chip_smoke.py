#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spgrid_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each at least; any failure raises, so the script
exits non-zero and never prints the final ``"ok": true`` line:

0. set-up: a CUDA device is required (no CPU fallback); print the card's
   name and power limit from nvidia-smi; build the CUDA kernels from
   ``spgrid_torch/csrc`` and print the build time.
1. kernels: each CUDA kernel against its plain PyTorch version computed in
   f64 on the card, at the main path's shapes, on a banded matrix with empty
   block rows (bm=8), and at a larger shape; with each kernel's time and
   the plain f32 version's time from CUDA events.
2. headline: ``run_spmm`` for dense, panel_cuda and bsr_cuda on the
   headline DLMC twin (512^2, n=512, f32), each gated against the host f64
   oracle at eps 1e-4, then the headline JSON line.
3. flagship: one step of ``spgrid_torch.entry.entry`` (which must launch
   bsr_spmm 4 times and bsr_sddmm once), gated against ``gold_pipeline``,
   then ``run_pipeline`` on the same matrices, gated at eps 1e-3.

Then one JSON line of the kernels (launches counted over phases 2 and 3,
errors and times from phase 1), and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Kernel vs plain: the kernel sums in f32 in another order than the f64
# plain version. With the positive operands used here the f32 rounding
# error of a sum of up to 2048 products stays below ~3e-6 relative, so the
# check is: max relative difference <= 1e-5 where |ref| > 1e-4 (absolute
# difference below that).
REL_TOL = 1e-5
SIGNIFICANT = 1e-4
TIME_S = 0.2            # minimum timed seconds for each kernel time
DEVICE = "cuda"
LARGE = 4096            # side of the larger case of each kernel


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def positive(csr):
    """The same sparsity with values |v| + 0.1 (no cancellation)."""
    from spgrid.formats.csr import CSRMatrix
    return CSRMatrix(csr.row_ptr, csr.col_idx,
                     (np.abs(csr.values) + 0.1).astype(np.float32),
                     csr.shape, csr.name)


def banded_with_empty_rows(m=1000, k=1000, seed=3):
    """A banded matrix whose block rows 1 and 2 (rows 8-23) are empty at
    bm=8."""
    from spgrid.formats.csr import dense_to_csr
    rng = np.random.default_rng(seed)
    i = np.arange(m)[:, None]
    j = np.arange(k)[None, :]
    d = np.where(np.abs(i - j) <= 40, rng.random((m, k)) + 0.5, 0.0)
    d[8:24] = 0.0
    return dense_to_csr(d.astype(np.float32), name="banded_empty_rows")


def rand(shape, seed):
    x = np.random.default_rng(seed).random(shape) + 0.5
    return torch.from_numpy(x.astype(np.float32)).to(DEVICE)


def compare(out: torch.Tensor, ref: torch.Tensor):
    """(max relative difference as the check defines it, max |difference|)."""
    diff = (out.double() - ref).abs()
    sig = ref.abs() > SIGNIFICANT
    rel = torch.where(sig, diff / ref.abs().clamp_min(SIGNIFICANT), diff)
    return rel.max().item(), diff.max().item()


def phase_kernels() -> dict:
    """Phase 1. Returns, per kernel, the numbers of its main-path case."""
    from spgrid.gen import create_mask
    from spgrid.formats.csr import random_csr
    from spgrid_torch.bench.headline import headline_matrix
    from spgrid_torch.core.timing import time_kernel
    from spgrid_torch.entry import flagship_csrs
    from spgrid_torch.ops.kernels.bsr_spmm import bsr_spmm, bsr_spmm_plain
    from spgrid_torch.ops.kernels.panel_spmm import (
        DevicePanels, panel_spmm, panel_spmm_plain)
    from spgrid_torch.ops.kernels.sddmm import bsr_sddmm, bsr_sddmm_plain
    from spgrid_torch.ops.layouts import DeviceBSR

    def ms(fn, *args):
        return time_kernel(fn, *args, device=DEVICE, warmup_iters=5,
                           min_time_s=TIME_S, min_iters=20
                           ).time_per_iter_s * 1e3

    head = headline_matrix()
    wk, _, _, mask = flagship_csrs()
    big = positive(random_csr(LARGE, LARGE, 0.5, seed=7))
    big_mask = create_mask("band_and_random", LARGE, sparsity=0.95, seed=14)
    banded = banded_with_empty_rows()

    def spmm_case(kernel, plain, a, n, seed):
        x = rand((a.shape[1], n), seed)
        return (kernel, plain, (a, x), (a, x.double()))

    def sddmm_case(m, d, seed):
        q, k = rand((m.shape[0], d), seed), rand((m.shape[1], d), seed + 1)
        return (bsr_sddmm, bsr_sddmm_plain, (m, q, k), (m, q.double(), k.double()))

    def bsr(csr, bm):
        return DeviceBSR.from_csr(csr, bm=bm, bk=128, device=DEVICE)

    def panels(csr):
        return DevicePanels.from_csr(csr, bk=128, device=DEVICE)

    cases = [
        ("bsr_spmm", "headline 512^2 bm=128 n=512", True,
         spmm_case(bsr_spmm, bsr_spmm_plain, bsr(head, 128), 512, 1)),
        ("bsr_spmm", "pipeline weight 512^2 bm=128 n=512", False,
         spmm_case(bsr_spmm, bsr_spmm_plain, bsr(wk, 128), 512, 2)),
        ("bsr_spmm", "banded 1000^2 empty block rows bm=8 n=200", False,
         spmm_case(bsr_spmm, bsr_spmm_plain, bsr(banded, 8), 200, 3)),
        ("bsr_spmm", "4096^2 50% bm=128 n=512", False,
         spmm_case(bsr_spmm, bsr_spmm_plain, bsr(big, 128), 512, 4)),
        ("panel_spmm", "headline 512^2 n=512", True,
         spmm_case(panel_spmm, panel_spmm_plain, panels(head), 512, 1)),
        ("panel_spmm", "banded 1000^2 empty rows n=200", False,
         spmm_case(panel_spmm, panel_spmm_plain, panels(banded), 200, 3)),
        ("panel_spmm", "4096^2 50% n=512", False,
         spmm_case(panel_spmm, panel_spmm_plain, panels(big), 512, 4)),
        ("bsr_sddmm", "pipeline mask 512^2 s=0.9 bm=128 d=512", True,
         sddmm_case(bsr(mask, 128), 512, 5)),
        ("bsr_sddmm", "banded 1000^2 empty block rows bm=8 d=200", False,
         sddmm_case(bsr(banded, 8), 200, 6)),
        ("bsr_sddmm", "4096^2 band_and_random s=0.95 bm=128 d=512", False,
         sddmm_case(bsr(big_mask, 128), 512, 7)),
    ]
    main_path, failed = {}, []
    for name, label, on_path, (kernel, plain, args, args64) in cases:
        out = kernel(*args)
        torch.cuda.synchronize()
        ref = plain(*args64)
        rel, err = compare(out, ref)
        del ref
        k_ms, p_ms = ms(kernel, *args), ms(plain, *args)
        ok = bool(torch.isfinite(out).all()) and rel <= REL_TOL
        print(f"phase 1 kernels: {name} [{label}] max_rel={rel:.3e} "
              f"max_abs={err:.3e} kernel_ms={k_ms:.6f} plain_ms={p_ms:.6f} "
              f"{'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(f"{name} [{label}]")
        if on_path:
            main_path[name] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms}
    if failed:
        raise RuntimeError(f"kernel disagrees with its plain version: {failed}")
    return main_path


def phase_headline() -> None:
    from spgrid_torch.bench.headline import headline_line, run_headline
    rows = run_headline(DEVICE)
    for r in rows:
        print(f"phase 2 headline: {r['kernel']} gflops={r['gflops']:.3f} "
              f"time_s={r['time']:.9f} iters={r['iters']} "
              f"errors_passed={r['errors_passed']} mape={r['mape']:.3e}",
              flush=True)
    failed = [r["kernel"] for r in rows if not r["errors_passed"]]
    if failed:
        raise RuntimeError(f"headline gate failed for {failed}")
    print(json.dumps(headline_line(rows, torch.cuda.get_device_name(0))),
          flush=True)


def phase_flagship() -> None:
    from spgrid_torch.bench.harness import run_pipeline
    from spgrid_torch.core.config import BenchConfig
    from spgrid_torch.core.metrics import error_metrics
    from spgrid_torch.entry import entry, flagship_csrs
    from spgrid_torch.ops.attention import gold_pipeline
    from spgrid_torch.ops.kernels import launch_counts

    fn, (attn, x) = entry(DEVICE)
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = fn(attn, x)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    after = launch_counts()
    moved = {k: after[k] - before[k] for k in after}
    if moved["bsr_spmm"] != 4 or moved["bsr_sddmm"] != 1:
        raise RuntimeError(f"one step launched {moved}; expected 4 bsr_spmm "
                           f"and 1 bsr_sddmm")
    wk, wq, wv, mask = flagship_csrs()
    y_host = y.cpu().numpy()
    if y_host.shape != (wk.m, x.shape[1]) or not np.isfinite(y_host).all():
        raise RuntimeError(f"flagship output shape {y_host.shape} or "
                           f"non-finite values")
    gate = error_metrics(gold_pipeline(wk, wq, wv, mask, x.cpu().numpy()),
                         y_host, epsilon=1e-3)
    print(f"phase 3 flagship: entry step (first call) {step_s * 1e3:.3f} ms "
          f"launches {moved} max_rel_diff={gate.max_rel_diff:.3e} "
          f"{'PASS' if gate.passed else 'FAIL'}", flush=True)
    if not gate.passed:
        raise RuntimeError("flagship step failed gold_pipeline at eps 1e-3")

    row = run_pipeline(wk, wq, wv, mask, BenchConfig(), device=DEVICE)
    print(f"phase 3 flagship: run_pipeline step_time_s={row['time']:.9f} "
          f"gflops={row['gflops']:.3f} K={row['gflops_spmm_K']:.3f} "
          f"Q={row['gflops_spmm_Q']:.3f} V={row['gflops_spmm_V']:.3f} "
          f"S={row['gflops_sddmm']:.3f} Y={row['gflops_final_spmm']:.3f} "
          f"errors_passed={row['errors_passed']}", flush=True)
    if not row["errors_passed"]:
        raise RuntimeError("run_pipeline failed gold_pipeline at eps 1e-3")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "the port's smoke run needs a CUDA device")
    from spgrid_torch.ops.kernels import _build, launch_counts, \
        reset_launch_counts

    print(card_line(), flush=True)
    print(f"phase 0 torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    log = (_build.build_dir() / "nvcc.log").read_text()
    print(f"phase 0 build: {time.perf_counter() - t0:.1f} s "
          f"({_build.build_dir()})", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"phase 0 ptxas: {line.strip()}", flush=True)

    main_path = phase_kernels()

    reset_launch_counts()
    phase_headline()
    phase_flagship()
    counts = launch_counts()
    never = [k for k, c in counts.items() if c == 0]
    if never:
        raise RuntimeError(f"kernels never launched on the main path: {never}")

    sources = {
        "bsr_spmm": ("spgrid_torch/csrc/bsr_spmm.cu",
                     "spgrid/ops/pallas/bsr_spmm.py:44"),
        "panel_spmm": ("spgrid_torch/csrc/panel_spmm.cu",
                       "spgrid/ops/pallas/panel_spmm.py:126"),
        "bsr_sddmm": ("spgrid_torch/csrc/sddmm.cu",
                      "spgrid/ops/pallas/sddmm.py:31"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": counts[name],
                **main_path[name]}
               for name, (src, replaces) in sources.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
