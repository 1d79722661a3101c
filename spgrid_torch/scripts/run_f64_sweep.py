"""The float64 correctness sweep: the port of ``scripts/run_f64_sweep.py``.

    python -m spgrid_torch.scripts.run_f64_sweep [--out PATH] \
        [--platform cpu]

The JAX sweep's three generated matrices (``CASES``, made in f64) and seven
formats (``KERNELS``: the torch ops and ``dense``, the formats with an f64
form), each row ``run_spmm`` at dtype f64, n = 64, gated on the host at eps
1e-10 (``BenchConfig.epsilon``). On the card the sums are native f64
(``xla.acc_dtype``; ``dense`` is cuBLAS's DGEMM), where the JAX sweep ran
on its CPU backend: the TPU has no f64. Rows go to ``--out`` (default
``benchmark_results/h100/f64_correctness.csv`` in the repo) in the JAX
package's CSV schema, resuming past the rows already there. A format
whose layout refuses a matrix (``ops.layouts.LayoutRefused``: ``ell_xla``
on the skewed second matrix, which the JAX layout refuses by the same
rule, so the JAX sweep's CSV holds 20 rows) writes no row; any other row
that raises is reported and the sweep goes on. ``main`` returns 1 when a
row raised otherwise or failed its gate.
"""

from __future__ import annotations

import argparse
import sys
import traceback
from pathlib import Path

from spgrid_torch.bench.harness import run_spmm
from spgrid_torch.bench.schema import BenchRow, CSVWriter
from spgrid_torch.core.config import BenchConfig
from spgrid_torch.gen.artificial import artificial_matrix_generation
from spgrid_torch.ops.layouts import LayoutRefused
from spgrid_torch.scripts import device_of

OUT = (Path(__file__).resolve().parents[2] / "benchmark_results" / "h100"
       / "f64_correctness.csv")
N = 64
MIN_TIME_S = 0.05

# (m, avg nnz a row, std, distribution, bw, skew), as the JAX sweep's
CASES = [
    (4000, 8, 2.0, "normal", 0.1, 0),
    (4000, 40, 30.0, "gamma", 0.8, 1000),
    (8000, 5, 1.7, "normal", 0.05, 0),
]
KERNELS = ("csr_xla_coo", "ell_xla", "csc", "bsr_xla", "dense",
           "merge", "sell")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="spgrid_torch.scripts.run_f64_sweep",
                                 description="the float64 sweep")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default), or cpu for the torch ops on the "
                         "CPU")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    device = device_of(ap.prog, args.platform)
    if device is None:
        return 1
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    writer = CSVWriter(args.out)
    done = writer.done_keys()
    cfg = BenchConfig.from_env(num_cols=N, dtype="float64",
                               min_time_s=MIN_TIME_S)
    bad = []
    for (m, avg, std, dist, bw, skew) in CASES:
        csr = artificial_matrix_generation(m, m, avg, std, dist, seed=14,
                                           placement="random", bw=bw,
                                           skew=skew, dtype="float64")
        for kernel in KERNELS:
            if (csr.name, kernel, str(N)) in done:
                continue
            try:
                row = run_spmm(csr, kernel, cfg, device=device)
            except LayoutRefused as e:
                print(f"{csr.name[:30]} {kernel} not applicable: {e}",
                      flush=True)
                continue
            except Exception:  # noqa: BLE001 - reported, and main fails
                print(f"{csr.name[:30]} {kernel} FAILED:", flush=True)
                traceback.print_exc(file=sys.stdout)
                bad.append((csr.name, kernel))
                continue
            writer.write(BenchRow(**row))
            print(f"{csr.name[:30]} {kernel}: passed={row['errors_passed']} "
                  f"mape={row['mape']:.2e} max_ae={row['max_ae']:.2e} "
                  f"time_s={row['time']:.9f}", flush=True)
            if not row["errors_passed"]:
                bad.append((csr.name, kernel))
    if bad:
        print(f"run_f64_sweep: rows that raised or failed their gate: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
