"""Benchmark CSV schema: the port's own copy of ``BenchRow`` and
``CSVWriter`` from ``spgrid/bench/schema.py``, so the port's sweep writes
the JAX package's CSV, header for header (pinned by
``tests/test_torch_hostcopy.py``).

A label row is written when a writer starts a file; CSV rows go to the file
and, when a stream is given, to the stream; human logs go to stdout.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, TextIO


@dataclasses.dataclass
class BenchRow:
    # Identity
    matrix_name: str = ""
    kernel: str = ""
    fmt: str = ""
    dtype: str = "float32"
    device: str = ""
    num_devices: int = 1

    # Shapes (csr_* = the original CSR like the reference; m/n/nnz = as-run)
    input_columns: int = 0           # dense width n (NUM_COLS)
    csr_m: int = 0
    csr_k: int = 0
    csr_nnz: int = 0
    csr_mem_footprint_mb: float = 0.0
    fmt_mem_footprint_mb: float = 0.0

    # Timing & throughput
    time: float = math.nan           # seconds/iteration
    iters: int = 0
    gflops: float = math.nan
    gbytes_per_s: float = math.nan
    sol_time: float = math.nan       # roofline speed-of-light seconds
    roofline_frac: float = math.nan
    energy_j: float = math.nan       # per-iteration, when a meter exists
    w_avg: float = math.nan

    # Accuracy oracle (8-metric vector + gate, spmv_bench.cpp:121-206)
    mae: float = math.nan
    max_ae: float = math.nan
    mse: float = math.nan
    mape: float = math.nan
    smape: float = math.nan
    lnQ_error: float = math.nan
    mlare: float = math.nan
    gmare: float = math.nan
    errors_passed: int = 1

    # Structural features (artificial schema, spmv_bench.cpp:484-520)
    density: float = math.nan
    avg_nnz_per_row: float = math.nan
    std_nnz_per_row: float = math.nan
    avg_bw_scaled: float = math.nan
    std_bw_scaled: float = math.nan
    avg_sc_scaled: float = math.nan
    skew: float = math.nan
    avg_num_neighbours: float = math.nan
    cross_row_similarity: float = math.nan

    # Value features (csr_util_gen.c:1458-2004 value-feature extraction —
    # drives the CV-mode research; nan when value features are off)
    val_unique_fraction: float = math.nan
    val_exp_unique: float = math.nan
    val_kmeans_rel_error_8: float = math.nan

    # Pipeline per-stage gflops (sddmm_bench.cpp:1010-1079), nan for non-pipeline
    gflops_spmm_K: float = math.nan
    gflops_spmm_Q: float = math.nan
    gflops_spmm_V: float = math.nan
    gflops_sddmm: float = math.nan
    gflops_final_spmm: float = math.nan

    @classmethod
    def columns(cls) -> list:
        return [f.name for f in dataclasses.fields(cls)]

    def to_csv(self, columns: Optional[list] = None) -> str:
        vals = []
        for name in (columns or self.columns()):
            v = getattr(self, name, "")
            if isinstance(v, float):
                vals.append("" if math.isnan(v) else f"{v:.6g}")
            else:
                vals.append(str(v))
        return ",".join(vals)

    @staticmethod
    def header() -> str:
        return ",".join(BenchRow.columns())


class CSVWriter:
    """Append-mode CSV writer with resume support.

    Results are appended per run (GPU reference appends with ios::app,
    cuSPARSEcsrmv_11_generate.cu:98); ``done_keys`` lets a sweep skip
    already-recorded (matrix, kernel, n) combinations on restart."""

    def __init__(self, path: Optional[str] = None, stream: Optional[TextIO] = None):
        self.path = path
        self._stream = stream
        self._wrote_header = False
        self._columns = None           # None => current schema
        if path and os.path.exists(path) and os.path.getsize(path) > 0:
            self._wrote_header = True
            # resume against a file written by an older/newer schema:
            # project rows onto ITS header so the CSV stays rectangular
            with open(path) as f:
                existing = f.readline().strip().split(",")
            if existing and existing != BenchRow.columns():
                self._columns = existing

    def write(self, row: BenchRow) -> None:
        line = row.to_csv(self._columns)
        if self.path:
            with open(self.path, "a") as f:
                if not self._wrote_header:
                    f.write(BenchRow.header() + "\n")
                    self._wrote_header = True
                f.write(line + "\n")
        if self._stream is not None:
            if not self._wrote_header and self.path is None:
                self._stream.write(BenchRow.header() + "\n")
                self._wrote_header = True
            self._stream.write(line + "\n")
            self._stream.flush()

    def done_keys(self) -> set:
        """(matrix_name, kernel, input_columns) triples already recorded."""
        done = set()
        if not self.path or not os.path.exists(self.path):
            return done
        with open(self.path) as f:
            header = f.readline().strip().split(",")
            try:
                i_name = header.index("matrix_name")
                i_kernel = header.index("kernel")
                i_n = header.index("input_columns")
            except ValueError:
                return done
            for line in f:
                parts = line.rstrip("\n").split(",")
                if len(parts) > max(i_name, i_kernel, i_n):
                    done.add((parts[i_name], parts[i_kernel], parts[i_n]))
        return done
