"""The SDDMM study: the port of ``scripts/run_sddmm_study.py``, with the
join of ``scripts/analyze_sddmm_ab.py`` as ``planner_ab``.

    python -m spgrid_torch.scripts.sddmm_study [--out-dir DIR] \
        [--platform cpu]

At the JAX study's sizes (``LENGTH``, ``PIPELINE_LENGTH``, ``N``, each row
timed for ``MIN_TIME_S``), with the reference's band table
(``band_size=None``), it writes under ``--out-dir`` (default
``benchmark_results/h100`` in the repo):

- ``sddmm_occupancy.csv``: ``sddmm_plan``'s occupancy row of each mask;
- ``sddmm_study.csv``: for each mask type (band_and_random,
  band_and_decay) x sparsity (0.5, 0.9, 0.95, 0.98) x matmul precision
  (``PRECISIONS``: highest, high), ``run_sddmm`` at the plan's blocking
  (row ``mask_{L}_{type}_sp{sp}_{precision}``) and at 128x128
  (``..._{precision}_b128``) unless the plan is 128x128; every arm of a
  point runs on one mask, made once a point;
- ``sddmm_blockings.csv``: the point's time at highest at every blocking
  of ``CANDIDATES`` (the highest arms' rows, ungated ``run_sddmm`` for the
  rest) beside ``_est_time``'s, over the fastest's, and whether the plan's
  was the fastest;
- ``pipeline.csv``: ``run_pipeline`` on three DLMC-twin weights (the JAX
  study's ``_weight``), both mask types at sparsities 0.9, 0.95 and 0.98;
- ``sddmm_planner_ab.csv``: ``planner_ab``, the plan's measured speedup
  over 128x128 beside ``est_speedup_vs_128``.

Every arm is f32: ``highest`` on the kernel's 3xTF32 tile, ``high`` on its
3-pass bf16 form (``bsr_sddmm_bf16x3``), each gated at the JAX harness's
1e-4, with the JAX study's row names, so that its join reads this CSV (and
``planner_ab`` joins each precision's arms). Each run
replaces the files it writes (the JAX study resumed where a lost TPU
run stopped). A row that raises stops the study; ``main`` returns 1 when a
row fails its gate.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import re
import sys
from pathlib import Path

from spgrid_torch.bench.harness import run_pipeline, run_sddmm
from spgrid_torch.bench.schema import BenchRow, CSVWriter
from spgrid_torch.core.config import BenchConfig
from spgrid_torch.gen.artificial import artificial_matrix_generation
from spgrid_torch.gen.masks import create_mask
from spgrid_torch.ops.sddmm_plan import (
    CANDIDATES, _est_time, block_occupancy, occupancy_row,
)
from spgrid_torch.scripts import device_of

OUT_DIR = Path(__file__).resolve().parents[2] / "benchmark_results" / "h100"
LENGTH = 4096           # side of the SDDMM masks
PIPELINE_LENGTH = 512   # side of the pipeline's weights and mask
N = 512                 # dense width
MIN_TIME_S = 0.3        # a row's minimum timed seconds
MASK_TYPES = ("band_and_random", "band_and_decay")
SPARSITIES = (0.5, 0.9, 0.95, 0.98)
PIPELINE_SPARSITIES = (0.9, 0.95, 0.98)
PRECISIONS = ("highest", "high")    # the JAX study's matmul precisions


def weight(length: int, seed: int):
    """A DLMC-twin-class weight, ~0.5 dense (the JAX study's ``_weight``
    at its 512: 256 nnz a row, std 32, random placement, bw 1.0)."""
    return artificial_matrix_generation(length, length, length // 2,
                                        length // 16, "normal", seed=seed,
                                        placement="random", bw=1.0)


def write_dicts(path: Path, rows: list) -> None:
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


def planner_ab(study_rows, occ_rows) -> list:
    """``scripts/analyze_sddmm_ab.py``'s join: per (mask type, sparsity,
    precision), the plan arm's GFLOPS beside the 128x128 arm's, the
    measured speedup (128x128's time over the plan's; 1 where the plan is
    128x128) and ``est_speedup_vs_128`` with its error. Rows are dicts of
    strings or numbers (a ``csv.DictReader``'s, or the harness's)."""
    occ = {(r["mask_type"], float(r["sparsity"])): r for r in occ_rows}
    pat = re.compile(
        r"mask_(\d+)_(band_and_\w+?)_sp([\d.]+)_(highest|high)(_b128)?$")
    by_arm: dict = {}
    for r in study_rows:
        m = pat.match(r["matrix_name"])
        if not m:
            continue
        _, mtype, sp, prec, fixed = m.groups()
        by_arm.setdefault((mtype, float(sp), prec), {})[
            "b128" if fixed else "plan"] = r
    out = []
    for (mtype, sp, prec), arms in sorted(by_arm.items()):
        if "plan" not in arms:
            continue
        p = arms["plan"]
        gf_p = float(p["gflops"])
        if "b128" in arms:
            gf_1 = float(arms["b128"]["gflops"])
            meas = float(arms["b128"]["time"]) / float(p["time"])
        elif str(p["fmt"]).endswith("128x128"):
            gf_1, meas = gf_p, 1.0
        else:
            continue
        est = float(occ.get((mtype, sp), {}).get("est_speedup_vs_128",
                                                 "nan"))
        out.append(dict(mask_type=mtype, sparsity=sp, precision=prec,
                        fmt_plan=p["fmt"], gflops_plan=round(gf_p, 1),
                        gflops_128=round(gf_1, 1),
                        measured_speedup=round(meas, 3),
                        est_speedup_vs_128=est,
                        est_error_pct=round((meas / est - 1.0) * 100, 1)
                        if est == est else float("nan")))
    return out


def sddmm_point(length: int, mask_type: str, sparsity: float,
                config: BenchConfig, device, writer: CSVWriter):
    """The arms at each of ``PRECISIONS`` and the blocking sweep (at
    highest) of one point, on one mask. Returns (occupancy row, gated rows,
    sweep rows)."""
    mask = create_mask(mask_type, length, sparsity, band_size=None,
                       seed=config.seed)
    n = config.num_cols
    occ = occupancy_row(mask, mask_type, sparsity, length, n)
    plan = (occ["bm"], occ["bk"])
    rows, times = [], {}
    arms = [(None, "")] + ([((128, 128), "_b128")] if plan != (128, 128)
                           else [])
    for prec in PRECISIONS:
        cfg = dataclasses.replace(config, matmul_precision=prec)
        name = f"mask_{length}_{mask_type}_sp{sparsity}_{prec}"
        for blocks, suffix in arms:
            row = run_sddmm(length, cfg, device=device, mask=mask,
                            blocks=blocks)
            row["matrix_name"] = name + suffix
            writer.write(BenchRow(**row))
            rows.append(row)
            if prec == "highest":
                times[blocks or plan] = row["time"]
            print(f"{row['matrix_name']} [{row['fmt']}]: "
                  f"{row['gflops']:.0f} GFLOPS "
                  f"passed={row['errors_passed']}", flush=True)
    highest = dataclasses.replace(config, matmul_precision="highest")
    for blocks in CANDIDATES:
        if blocks not in times:
            times[blocks] = run_sddmm(length, highest, device=device,
                                      mask=mask, blocks=blocks,
                                      check_accuracy=False)["time"]
    fastest = min(times, key=times.get)
    sweep = []
    for bm, bk in CANDIDATES:
        occupied, total = block_occupancy(mask, bm, bk)
        sweep.append(dict(
            mask_type=mask_type, sparsity=sparsity, length=length,
            nnz=mask.nnz, bm=bm, bk=bk, occupied=occupied, total=total,
            est_time_s=_est_time(occupied, bm, bk, n),
            time_s=times[(bm, bk)],
            vs_fastest=times[(bm, bk)] / times[fastest],
            plan=(bm, bk) == plan, fastest=(bm, bk) == fastest))
    return occ, rows, sweep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="spgrid_torch.scripts.sddmm_study",
                                 description="the SDDMM study")
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default), or cpu for the kernels' plain "
                         "versions")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    device = device_of(ap.prog, args.platform)
    if device is None:
        return 1
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for name in ("sddmm_study.csv", "pipeline.csv"):   # CSVWriter appends
        if (out / name).exists():
            os.remove(out / name)
    base = BenchConfig.from_env(num_cols=N, band_size=None,
                                min_time_s=MIN_TIME_S)

    writer = CSVWriter(str(out / "sddmm_study.csv"))
    occ_rows, study_rows, sweep_rows = [], [], []
    for mtype in MASK_TYPES:
        for sp in SPARSITIES:
            cfg = dataclasses.replace(base, sparsity=sp,
                                      sparse_attention_type=mtype)
            occ, rows, sweep = sddmm_point(LENGTH, mtype, sp, cfg, device,
                                           writer)
            occ_rows.append(occ)
            study_rows += rows
            sweep_rows += sweep
    write_dicts(out / "sddmm_occupancy.csv", occ_rows)
    write_dicts(out / "sddmm_blockings.csv", sweep_rows)

    pipe_writer = CSVWriter(str(out / "pipeline.csv"))
    weights = [weight(PIPELINE_LENGTH, seed) for seed in (1, 2, 3)]
    pipe_rows = []
    for mtype in MASK_TYPES:
        for sp in PIPELINE_SPARSITIES:
            # the dtype's own precision, as the JAX study's pipeline rows
            cfg = dataclasses.replace(base, sparsity=sp,
                                      sparse_attention_type=mtype,
                                      matmul_precision="auto")
            row = run_pipeline(*weights, config=cfg, device=device)
            row["matrix_name"] = (f"pipeline_dlmc{PIPELINE_LENGTH}_{mtype}"
                                  f"_sp{sp}")
            pipe_writer.write(BenchRow(**row))
            pipe_rows.append(row)
            print(f"{row['matrix_name']}: total {row['gflops']:.0f} sddmm "
                  f"{row['gflops_sddmm']:.0f} passed={row['errors_passed']}",
                  flush=True)

    with open(out / "sddmm_study.csv") as f:      # the join reads the CSV
        ab = planner_ab(list(csv.DictReader(f)), occ_rows)
    write_dicts(out / "sddmm_planner_ab.csv", ab)
    for r in ab:
        print(f"planner A/B {r['mask_type']} sp={r['sparsity']} "
              f"{r['fmt_plan']} measured x{r['measured_speedup']} "
              f"est x{r['est_speedup_vs_128']}", flush=True)
    failed = [r["matrix_name"] for r in study_rows + pipe_rows
              if not r["errors_passed"]]
    if failed:
        print(f"sddmm_study: rows failed their gates: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
