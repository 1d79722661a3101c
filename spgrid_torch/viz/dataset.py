"""Merge benchmark result CSVs into one dataset, and the dispatch-accuracy
number: the port's copies of ``merge_result_csvs`` and
``dispatch_accuracy`` from ``spgrid/viz/dataset.py``, on ``csv`` and numpy
instead of pandas (the card's machine has no pandas).

A dataset is a list of row dicts keyed by the CSV's columns. Fields are
parsed as pandas' ``read_csv`` parses them: an empty field is nan, a number
a float (an int where it is written as one), anything else a string. The
derived columns, the provenance tag and the filters are the JAX package's.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Sequence

import numpy as np


def _parse(v: str):
    if v == "" or v.lower() == "nan":
        return math.nan
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def _columns(rows) -> set:
    return set().union(*(r.keys() for r in rows)) if rows else set()


def merge_result_csvs(paths: Sequence[str], *, drop_failed: bool = True,
                      add_derived: bool = True) -> list:
    """Load and concatenate result CSVs into one list of row dicts.

    Adds ``source`` (file stem, the platform/sweep tag) and, with
    ``add_derived``, the modeling columns: ``log_nnz``, ``log_m``,
    ``arithmetic_intensity`` (flops/byte), ``gflops_per_device``; with
    ``drop_failed``, drops rows whose ``errors_passed`` is 0."""
    out: list = []
    columns: set = set()
    for p in paths:
        with open(p, newline="") as f:
            reader = csv.DictReader(f)
            columns |= set(reader.fieldnames or ())
            source = os.path.splitext(os.path.basename(p))[0]
            out.extend({**{k: _parse(v) for k, v in r.items()},
                        "source": source} for r in reader)
    if not paths:
        raise ValueError("no input CSVs")
    if drop_failed and "errors_passed" in columns:
        out = [r for r in out if r.get("errors_passed", math.nan) != 0]
    if add_derived:
        def col(r, c):
            v = r.get(c, math.nan)
            return float(v) if isinstance(v, (int, float)) else math.nan

        for r in out:
            if "csr_nnz" in columns:
                r["log_nnz"] = float(np.log10(np.maximum(col(r, "csr_nnz"),
                                                         1)))
            if "csr_m" in columns:
                r["log_m"] = float(np.log10(np.maximum(col(r, "csr_m"), 1)))
            if {"csr_nnz", "input_columns",
                    "csr_mem_footprint_mb"} <= columns:
                flops = 2.0 * col(r, "csr_nnz") * col(r, "input_columns")
                bytes_ = col(r, "csr_mem_footprint_mb") * 2 ** 20
                r["arithmetic_intensity"] = flops / np.maximum(bytes_, 1)
            if {"gflops", "num_devices"} <= columns:
                r["gflops_per_device"] = col(r, "gflops") / np.maximum(
                    col(r, "num_devices"), 1)
    return out


def dispatch_accuracy(rows, *, tol: float = 0.10, key: str = "matrix_name",
                      auto_kernel: str = "auto", include_lossy: bool = True):
    """(fraction, records): the share of matrices where ``auto`` lands
    within ``tol`` of the best fixed kernel that passed its gate, over the
    matrices that have both; records are (matrix, auto gflops, best fixed
    gflops, within). ``include_lossy=False`` drops the ``cv_*`` kernels
    from the fixed portfolio. The fraction is nan without a record."""
    rows = list(rows)
    gate = "errors_passed" in _columns(rows)
    groups: dict = {}
    for r in rows:
        groups.setdefault(r[key], []).append(r)
    out = []
    for name in sorted(groups):
        g = groups[name]
        auto = [r for r in g if r["kernel"] == auto_kernel]
        fixed = [r for r in g if r["kernel"] != auto_kernel]
        if not include_lossy:
            fixed = [r for r in fixed if not str(r["kernel"]).startswith(
                "cv_")]
        if gate:
            fixed = [r for r in fixed if r.get("errors_passed") == 1]
        fixed = [r for r in fixed
                 if not math.isnan(float(r.get("gflops", math.nan)))]
        if not auto or not fixed:
            continue
        best = max(float(r["gflops"]) for r in fixed)
        a = float(auto[0]["gflops"])
        if best > 0:
            out.append((name, a, best, a >= (1 - tol) * best))
    if not out:
        return float("nan"), out
    return sum(1 for *_, ok in out if ok) / len(out), out
