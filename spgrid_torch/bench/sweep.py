"""Sweep runner: matrices × kernels × dense widths, one CSV row per run,
with resume.

Counterpart of ``spgrid/bench/sweep.py`` over the port's ``run_spmm``: rows
already in the output file are skipped, a run that raises is retried once
and then recorded as a failed row (``errors_passed`` 0), and every row is
also echoed to stderr.
"""

from __future__ import annotations

import sys
import traceback
from typing import Iterable, List, Optional, Sequence

from spgrid_torch.bench.harness import run_spmm
from spgrid_torch.bench.schema import BenchRow, CSVWriter
from spgrid_torch.core.config import BenchConfig
from spgrid_torch.gen.artificial import artificial_matrix_generation
from spgrid_torch.io import read_matrix


def iter_matrices(params=(), paths=(), dtype: str = "float32"):
    """Yield CSR matrices from generator parameter lines, then from matrix
    files, lazily."""
    for p in params:
        yield artificial_matrix_generation(**p.kwargs(), dtype=dtype)
    for path in paths:
        yield read_matrix(path, dtype=dtype)


def run_sweep(matrices: Iterable, kernels: Sequence[str] = ("bsr_cuda",),
              num_cols_list: Sequence[int] = (512,),
              config: Optional[BenchConfig] = None,
              out_csv: Optional[str] = None, check_accuracy: bool = True, *,
              device) -> List[BenchRow]:
    """The rows this call ran, in order; each is appended to ``out_csv``
    and echoed to stderr. A run that raises is tried once more."""
    config = config or BenchConfig()
    writer = CSVWriter(out_csv, stream=sys.stderr)
    done = writer.done_keys()
    rows: List[BenchRow] = []
    for csr in matrices:
        for kernel in kernels:
            for n in num_cols_list:
                key = (csr.name, kernel, str(n))
                if key in done:
                    print(f"skip (done): {key}", file=sys.stdout)
                    continue
                cfg = BenchConfig(**{**config.__dict__, "num_cols": n})
                row = None
                for attempt in range(2):
                    try:
                        row = BenchRow(**run_spmm(
                            csr, kernel, cfg, device=device,
                            check_accuracy=check_accuracy))
                        break
                    except Exception:
                        print(f"error ({csr.name},{kernel},n={n}) "
                              f"attempt {attempt}:", file=sys.stdout)
                        traceback.print_exc(file=sys.stdout)
                if row is None:
                    row = BenchRow(matrix_name=csr.name, kernel=kernel,
                                   input_columns=n, errors_passed=0)
                writer.write(row)
                rows.append(row)
    return rows
