"""The bfloat16 benchmark leg: the port of ``scripts/run_bf16_leg.py``.

    python -m spgrid_torch.scripts.run_bf16_leg [--out PATH] \
        [--jobs TAG,...] [--platform cpu]

The JAX leg's matrices and kernels (``JOBS``: the headline DLMC twin and one
matrix per density regime, at the JAX script's full sizes, n = 512), with
the kernels under the port's names, each row ``run_spmm`` at dtype bf16 and
gated against the host or device f64 gold of the bf16 matrix times the bf16
X at eps 3e-2 (``BenchConfig.epsilon``); then one bf16 attention-pipeline
row on three 512^2 DLMC-twin weights (mask band_and_random at sparsity
0.95). Rows go to ``--out`` (default ``benchmark_results/h100/
bf16_leg.csv`` in the repo) in the JAX package's CSV schema, resuming past
the rows already there. ``--jobs`` runs only the named matrices (the
pipeline row always runs). A format whose layout refuses a matrix
(``ops.layouts.LayoutRefused``, the JAX layouts' rule) writes no row; any
other row that raises is reported and the leg goes on, as the JAX script
does. ``main`` returns 1 when a row raised otherwise or failed its gate.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import traceback
from pathlib import Path

from spgrid_torch.bench.harness import run_pipeline, run_spmm
from spgrid_torch.bench.schema import BenchRow, CSVWriter
from spgrid_torch.core.config import BenchConfig
from spgrid_torch.gen.artificial import artificial_matrix_generation
from spgrid_torch.ops.layouts import LayoutRefused
from spgrid_torch.scripts import device_of

OUT = (Path(__file__).resolve().parents[2] / "benchmark_results" / "h100"
       / "bf16_leg.csv")
N = 512
MIN_TIME_S = 0.25           # a row's minimum timed seconds (the JAX leg's)
PIPELINE_MIN_TIME_S = 0.3

# (tag, generator parameters, kernels): the JAX leg's JOBS, the kernels
# under the port's names (bsr_pallas -> bsr_cuda, panel_pallas ->
# panel_cuda, wcoo_bands -> wcoo_bands_cuda)
JOBS = [
    # headline DLMC twin (50% dense transformer weight)
    ("dlmc_twin_512_0.5", dict(m=512, avg=256, std=32, placement="random",
                               bw=1.0, skew=0, neigh=0, crs=0),
     ["dense", "bsr_cuda", "panel_cuda"]),
    # mid-density too big to densify -> panel regime
    ("mid_16k_d2pct", dict(m=16384, avg=328, std=100, placement="random",
                           bw=1.0, skew=0, neigh=1.9, crs=0.25),
     ["panel_cuda", "bsr_cuda"]),
    # banded hypersparse
    ("band_98k", dict(m=98304, avg=8, std=2.6667, placement="random",
                      bw=0.05, skew=0, neigh=0.05, crs=0.5),
     ["gell", "bsr_cuda"]),
    # scattered hypersparse
    ("scat_131k", dict(m=131072, avg=6, std=2, placement="random",
                       bw=0.9, skew=0, neigh=0.9, crs=0.3),
     ["gell", "merge", "sell", "rbh"]),
    ("scat_393k", dict(m=393215, avg=5, std=1.6667, placement="random",
                       bw=0.5, skew=0, neigh=0.5, crs=0.75),
     ["gell", "sell", "rbh"]),
    ("band_229k", dict(m=229375, avg=5, std=1.6667, placement="random",
                       bw=0.05, skew=0, neigh=0.05, crs=0.95),
     ["gell", "sell", "merge"]),
    ("skew1k_131k", dict(m=131072, avg=6, std=2, placement="random",
                         bw=0.9, skew=1000, neigh=0.9, crs=0.3),
     ["merge", "gell"]),
    ("wideband_196k", dict(m=196608, avg=6, std=2, placement="diagonal",
                           bw=0.3, skew=0, neigh=0.3, crs=0.5),
     ["gell", "wcoo_bands_cuda"]),
    ("giant_band_1m", dict(m=1048576, avg=5, std=1.6667,
                           placement="diagonal", bw=0.02, skew=0,
                           neigh=0.02, crs=0.5),
     ["gell"]),
    ("dense_7k_a100", dict(m=7838, avg=100, std=33.3333,
                           placement="random", bw=0.6, skew=100,
                           neigh=0.5, crs=0.5),
     ["dense", "sell", "merge"]),
    ("dense_2k_d20pct", dict(m=2445, avg=500, std=150, placement="random",
                             bw=0.6, skew=3.9, neigh=0.5, crs=0.5),
     ["dense", "bsr_cuda", "panel_cuda"]),
    ("scirc_twin", dict(m=170998, avg=5.60788, std=4.39216,
                        placement="random", bw=0.29725, skew=61.94716,
                        neigh=0.80336, crs=0.63302),
     ["gell", "rbh"]),
]
PIPELINE = "bf16_pipeline_dlmc4096_band_and_random_sp0.95"


def job_matrix(tag: str, p: dict):
    """The f32 matrix of a job (``run_spmm`` casts it to bf16), as the JAX
    leg generates it."""
    return artificial_matrix_generation(
        p["m"], p["m"], p["avg"], p["std"], "normal", seed=14,
        placement=p["placement"], bw=p["bw"], skew=p["skew"],
        avg_num_neighbours=p["neigh"], cross_row_similarity=p["crs"],
        name=f"bf16_{tag}")


def weight(seed: int):
    """A 512^2 DLMC-twin weight of the pipeline row (the JAX leg's
    ``_weight``)."""
    return artificial_matrix_generation(
        512, 512, 256, 32, "normal", seed, "random", 1.0, 0, 0.05, 0.05,
        name=f"bf16_w{seed}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="spgrid_torch.scripts.run_bf16_leg",
                                 description="the bfloat16 leg")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--jobs", default=None,
                    help="comma list of the JOBS tags to run (default all)")
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default), or cpu for the kernels' plain "
                         "versions")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    device = device_of(ap.prog, args.platform)
    if device is None:
        return 1
    tags = None if args.jobs is None else args.jobs.split(",")
    unknown = set(tags or ()) - {tag for tag, _, _ in JOBS}
    if unknown:
        ap.error(f"unknown job(s) {sorted(unknown)}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    writer = CSVWriter(args.out)
    done = writer.done_keys()
    cfg = BenchConfig.from_env(num_cols=N, dtype="bfloat16",
                               min_time_s=MIN_TIME_S)
    bad = []
    for tag, p, kernels in JOBS:
        if tags is not None and tag not in tags:
            continue
        name = f"bf16_{tag}"
        todo = [k for k in kernels if (name, k, str(N)) not in done]
        if not todo:
            print(f"skip (done): {name}", flush=True)
            continue
        print(f"=== {name} -> {todo}", flush=True)
        csr = job_matrix(tag, p)
        for kernel in todo:
            try:
                row = run_spmm(csr, kernel, cfg, device=device)
            except LayoutRefused as e:
                print(f"  {kernel} not applicable: {e}", flush=True)
                continue
            except Exception:  # noqa: BLE001 - reported, and main fails
                print(f"  {kernel} FAILED:", flush=True)
                traceback.print_exc(file=sys.stdout)
                bad.append((name, kernel))
                continue
            writer.write(BenchRow(**row))
            print(f"  {kernel}: {row['gflops']:.1f} GF "
                  f"time_s={row['time']:.9f} passed={row['errors_passed']} "
                  f"mape={row['mape']:.3e}", flush=True)
            if not row["errors_passed"]:
                bad.append((name, kernel))

    if (PIPELINE, "pipeline_cuda", str(N)) not in done:
        pcfg = dataclasses.replace(cfg, sparsity=0.95,
                                   sparse_attention_type="band_and_random",
                                   band_size=None,
                                   min_time_s=PIPELINE_MIN_TIME_S)
        try:
            row = run_pipeline(weight(1), weight(2), weight(3), config=pcfg,
                               device=device)
        except Exception:  # noqa: BLE001 - reported, and main fails
            print(f"{PIPELINE} FAILED:", flush=True)
            traceback.print_exc(file=sys.stdout)
            bad.append((PIPELINE, "pipeline_cuda"))
        else:
            row["matrix_name"] = PIPELINE
            writer.write(BenchRow(**row))
            print(f"{PIPELINE}: total {row['gflops']:.0f} GF "
                  f"time_s={row['time']:.9f} "
                  f"passed={row['errors_passed']}", flush=True)
            if not row["errors_passed"]:
                bad.append((PIPELINE, "pipeline_cuda"))
    if bad:
        print(f"run_bf16_leg: rows that raised or failed their gate: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
