"""Benchmark CLI of the port: ``python -m spgrid_torch.bench ...``.

The counterpart of ``python -m spgrid.bench`` (``spgrid/bench/cli.py``),
with the same flags and the same CSV schema. It runs on the CUDA device;
``--platform cpu`` runs the kernels' plain versions on the CPU instead.
Without a CUDA device and without ``--platform cpu`` it exits non-zero. It
also exits non-zero when a row fails its accuracy gate or its run.
``--reorder rcm|shuffle|degsort`` permutes each matrix's rows first
(``formats.reorder``; the matrix's name gains ``_<order>``). ``--dtype
bfloat16|float64`` runs A and X in that type (``BenchConfig.dtype``): a
kernel with no form at the dtype (``ops.dispatch.DTYPE_FORMATS``; at f64 the
hand-written kernels, so ``--sddmm`` and ``--pipeline`` only with
``--xla-only``) exits non-zero naming ROADMAP.md before anything runs. The
matmul precision comes from the environment (``SPGRID_MATMUL_PRECISION``,
``BenchConfig.matmul_precision``), as the JAX CLI's does: 'high' at f32
runs every format, ``--sddmm`` and ``--pipeline`` (the formats whose JAX
dot takes the ambient precision, the SDDMM and the pipeline's stages on
their 3-pass bf16 forms; ``ops.dispatch.runs_at``). A row with no form at
the precision exits 2 naming ROADMAP.md before anything runs: at f32
'default' (the TPU's one bf16 pass) the formats of
``dispatch.AMBIENT_FORMATS``, the dispatch kernels (``auto``, ``auto_tol``,
``autotune``: JAX's choose among every format), ``--sddmm`` and
``--pipeline``; at bf16 and
f64 any precision but the dtype's own; except ``--xla-only``'s SDDMM,
whose COO baseline contracts through no dot.

Examples:
  # the minimum end-to-end slice: artificial matrix -> kernel -> CSV row
  python -m spgrid_torch.bench --generate "65535 65535 5 1.6667 normal \
      random 0.05 0 0.05 0.05 14" --kernel wcoo_cuda --num-cols 512

  # the JAX CLI's torch-op formats and the bf16 panel kernel, on the
  # rows in reverse Cuthill-McKee order
  python -m spgrid_torch.bench --generate "8192 8192 50 10 normal random \
      0.05 0 0.05 0.05 14" --kernels csr_xla_coo,ell_xla,csc,scoo,cv_bf16,\
cv_int8,cv_panel_cuda --reorder rcm --num-cols 512

  # the cost model's pick, the fastest measured format, the hybrid
  python -m spgrid_torch.bench --generate "206500 206500 6.16653 4.43586 \
      normal random 0.00191 6.13529 0.17669 0.33051 14" \
      --kernels rbh,auto,autotune --num-cols 512

  # standalone SDDMM on a 4096^2 attention mask, at the planner's blocking;
  # --xla-only runs the COO baseline (torch ops) instead of the kernel;
  # at matmul precision 'high', the 3-pass bf16 form of the kernel
  python -m spgrid_torch.bench --sddmm 4096 --num-cols 512
  SPGRID_MATMUL_PRECISION=high python -m spgrid_torch.bench --sddmm 4096

  # SpMM rows at matmul precision 'high': the 3-pass bf16 forms
  SPGRID_MATMUL_PRECISION=high python -m spgrid_torch.bench --generate \
      "512 512 256 32 normal random 1.0 0 0.05 0.05 14" \
      --kernels dense,bsr_cuda,panel_cuda,rbh --num-cols 512

  # attention pipeline on DLMC-style weights (.smtx/.mtx), kernels or
  # --xla-only baselines
  python -m spgrid_torch.bench --pipeline wk.smtx wq.smtx wv.smtx \
      --sparsity 0.9

  # parameter-file sweep with resume
  python -m spgrid_torch.bench --param-file params.txt \
      --kernels bsr_cuda,dense --num-cols 128,512 --out results.csv

  # bf16 on the kernels' bf16 forms; f64 on the torch ops
  python -m spgrid_torch.bench --generate "512 512 256 32 normal random \
      1.0 0 0.05 0.05 14" --kernels dense,bsr_cuda,panel_cuda \
      --dtype bfloat16
  python -m spgrid_torch.bench --generate "65535 65535 5 1.6667 normal \
      random 0.05 0 0.05 0.05 14" --kernels wrow_spmv_cuda,auto \
      --num-cols 1 --dtype bfloat16
  python -m spgrid_torch.bench --generate "4000 4000 8 2 normal random \
      0.1 0 0.05 0.05 14" --kernels csr_xla_coo,merge --dtype float64

  # labels only
  python -m spgrid_torch.bench --labels
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from spgrid_torch.bench.schema import BenchRow, CSVWriter
from spgrid_torch.bench.sweep import iter_matrices, run_sweep
from spgrid_torch.core.config import BenchConfig, own_precision
from spgrid_torch.formats.reorder import (
    degree_sort_order, permute, rcm_order, shuffle_order,
)
from spgrid_torch.gen.params import GenParams, read_param_file
from spgrid_torch.bench.harness import (
    KERNELS, formats_run_at, kernel_formats)
from spgrid_torch.ops.dispatch import DTYPE_FORMATS, runs_at

NO_FORM = "has no {dtype} form in the port (ROADMAP.md, Queue 2)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="spgrid_torch.bench",
                                 description="CUDA sparse-kernel benchmark")
    ap.add_argument("--labels", action="store_true",
                    help="print the CSV header row and exit")
    ap.add_argument("--generate", metavar="PARAMS",
                    help="11-field artificial-matrix parameter line")
    ap.add_argument("--param-file", help="file of 11-field parameter lines")
    ap.add_argument("--limit", type=int, default=0,
                    help="use only the first N param-file lines")
    ap.add_argument("--skip", type=int, default=0,
                    help="skip the first N param-file lines")
    ap.add_argument("--stride", type=int, default=1,
                    help="take every Nth param-file line")
    ap.add_argument("--matrix", nargs="*", default=[],
                    help=".mtx/.smtx file path(s)")
    ap.add_argument("--pipeline", nargs=3, metavar=("WK", "WQ", "WV"),
                    help="run the sparse-attention pipeline on 3 weight "
                         "files")
    ap.add_argument("--sddmm", type=int, metavar="LENGTH", default=None,
                    help="standalone SDDMM bench on a LENGTH^2 attention "
                         "mask")
    ap.add_argument("--xla-only", action="store_true",
                    help="the JAX package's XLA baselines as torch ops in "
                         "place of the kernels (--sddmm, --pipeline)")
    ap.add_argument("--kernel", default="bsr_cuda",
                    help=f"one of {', '.join(KERNELS)}")
    ap.add_argument("--kernels", help="comma list (overrides --kernel)")
    ap.add_argument("--num-cols", default=None,
                    help="dense width(s), comma list (default from env/512)")
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16", "float64"],
                    help="value type of A, X and Y (default from env/"
                         "float32)")
    ap.add_argument("--out", help="CSV output path (append + resume)")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the accuracy oracle")
    ap.add_argument("--sparsity", type=float, default=None)
    ap.add_argument("--band-size", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--reorder", default=None,
                    choices=["rcm", "shuffle", "degsort"],
                    help="permute each matrix's rows first")
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default), or cpu for the kernels' plain "
                         "versions")
    args = ap.parse_args(argv)

    if args.labels:
        print(BenchRow.header())
        return 0

    modes = bool(args.sddmm or args.pipeline)
    if args.xla_only and not modes:
        ap.error("--xla-only needs --sddmm or --pipeline")
    kernels = args.kernels.split(",") if args.kernels else [args.kernel]
    unknown = [k for k in kernels if k not in KERNELS]
    if unknown:
        ap.error(f"unknown kernel(s) {unknown}; the port has "
                 f"{', '.join(KERNELS)}")

    if args.platform == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("spgrid_torch.bench: no CUDA device; pass --platform cpu "
                  "to run the plain versions on the CPU", file=sys.stderr)
            return 1

    overrides = {}
    if args.sparsity is not None:
        overrides["sparsity"] = args.sparsity
    if args.band_size is not None:
        overrides["band_size"] = args.band_size
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.dtype is not None:
        overrides["dtype"] = args.dtype
    config = BenchConfig.from_env(**overrides)
    dtype = config.dtype
    precision = config.precision
    at_precision = NO_FORM.format(dtype=f"{precision!r} ({dtype})")
    if modes:
        if dtype == "float64" and not args.xla_only:
            ap.error(f"--sddmm and --pipeline run the CUDA kernels, which "
                     f"{NO_FORM.format(dtype=dtype)}; add --xla-only")
        if args.sddmm:
            runs = (precision == own_precision(dtype) or args.xla_only
                    or (dtype == "float32" and precision == "high"))
        else:
            runs = runs_at("bsr" if args.xla_only else "bsr_cuda", dtype,
                           precision)
        if not runs:
            ap.error(f"matmul precision {precision!r} at {dtype}: "
                     f"{'--sddmm' if args.sddmm else '--pipeline'} "
                     f"{at_precision}")
    else:
        missing = [k for k in kernels if KERNELS[k] is not None
                   and not runs_at(KERNELS[k], dtype)]
        if missing:
            ap.error(f"kernel(s) {missing} {NO_FORM.format(dtype=dtype)}; "
                     f"at {dtype} the port runs "
                     f"{', '.join(DTYPE_FORMATS[dtype])}")
        off = [k for k in kernels if not formats_run_at(
            kernel_formats(k), dtype, precision)]
        if off:
            ap.error(f"kernel(s) {off} at matmul precision {precision!r}: "
                     f"{at_precision}")
    num_cols = ([int(v) for v in args.num_cols.split(",")]
                if args.num_cols else [config.num_cols])

    if modes:
        rows = mode_rows(args, config, num_cols)
    else:
        rows = sweep_rows(ap, args, config, kernels, num_cols)
    failed = [(r.matrix_name, r.kernel, r.input_columns)
              for r in rows if not r.errors_passed]
    if failed:
        print(f"spgrid_torch.bench: failed rows {failed}", file=sys.stderr)
        return 1
    return 0


def mode_rows(args, config: BenchConfig, num_cols) -> list:
    """The rows of ``--sddmm`` or ``--pipeline``, one a width, each written
    to ``--out`` and echoed to stderr."""
    from spgrid_torch.bench.harness import run_pipeline, run_sddmm
    from spgrid_torch.io import read_matrix
    writer = CSVWriter(args.out, stream=sys.stderr)
    if args.pipeline:
        wk, wq, wv = (read_matrix(p, dtype=config.dtype)
                      for p in args.pipeline)
    kw = dict(device=args.platform, xla_only=args.xla_only,
              check_accuracy=not args.no_check)
    rows = []
    for n in num_cols:
        cfg = dataclasses.replace(config, num_cols=n)
        row = BenchRow(**(run_sddmm(args.sddmm, cfg, **kw) if args.sddmm
                          else run_pipeline(wk, wq, wv, config=cfg, **kw)))
        writer.write(row)
        rows.append(row)
    return rows


def sweep_rows(ap, args, config: BenchConfig, kernels, num_cols) -> list:
    """The rows of the sweep over ``--generate``, ``--param-file`` and
    ``--matrix``."""
    params = []
    if args.generate:
        params.append(GenParams.from_line(args.generate))
    if args.param_file:
        lines = read_param_file(args.param_file)
        lines = lines[args.skip::max(args.stride, 1)]
        params.extend(lines[: args.limit] if args.limit else lines)
    if not params and not args.matrix:
        ap.error("need --generate, --param-file, --matrix, --sddmm or "
                 "--pipeline")

    matrices = iter_matrices(params=params, paths=args.matrix,
                             dtype=config.dtype)
    if args.reorder:
        matrices = reordered(matrices, args.reorder, config.seed)
    return run_sweep(matrices, kernels=kernels, num_cols_list=num_cols,
                     config=config, out_csv=args.out,
                     check_accuracy=not args.no_check, device=args.platform)


def reordered(matrices, order: str, seed: int):
    """Each matrix with its rows permuted by ``order`` (reverse
    Cuthill-McKee, a seeded shuffle, or by degree, descending), named
    ``<name>_<order>``: the JAX CLI's ``--reorder``."""
    for csr in matrices:
        if order == "rcm":
            perm = rcm_order(csr)
        elif order == "shuffle":
            perm = shuffle_order(csr, seed=seed)
        else:
            perm = degree_sort_order(csr)
        out = permute(csr, perm)
        out.name = f"{csr.name}_{order}"
        yield out


if __name__ == "__main__":
    sys.exit(main())
