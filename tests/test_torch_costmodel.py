"""The port's cost model (``spgrid_torch/ops/costmodel.py``) and its result
datasets (``spgrid_torch/viz/dataset.py``) against the JAX package's, with
the JAX package's constants installed in the port: every format's estimate
to 1e-12 relative at n = 1 and 512 on matrices of every regime, the same
picks, the same validation records and fitted corrections from one CSV
written by the port's CLI on the CPU, and the same merged dataset and
dispatch accuracy."""

import csv
import dataclasses
import math

import pandas as pd
import pytest
import torch

import spgrid.ops.costmodel as jax_costmodel
import spgrid.viz.dataset as jax_dataset
from spgrid.features.structural import matrix_features as jax_features
from spgrid.gen import GenParams as JaxParams
from spgrid.gen import artificial_matrix_generation as jax_generate
from spgrid_torch.bench.cli import main as cli_main
from spgrid_torch.features import matrix_features
from spgrid_torch.gen import GenParams, artificial_matrix_generation
from spgrid_torch.ops import costmodel
from spgrid_torch.viz import dataset

torch.set_num_threads(1)

# regimes: the dense-ish DLMC twin, a banded hypersparse slice, scattered
# with cross-row reuse, a skewed matrix, a mac_econ-like clustered twin,
# mid density
LINES = {
    "dlmc": "512 512 256 32 normal random 1.0 0 0.05 0.05 14",
    "banded": "4000 4000 5 1.6667 normal random 0.05 0 0.05 0.05 14",
    "scattered": "8000 8000 5 1.6667 normal random 0.5 0 0.5 0.75 14",
    "skewed": "3000 3000 10 3 normal random 0.3 200 0.05 0.05 7",
    "mac_econ": ("6000 6000 6.16653 4.43586 normal random 0.00191 6.13529 "
                 "0.17669 0.33051 14"),
    "mid": "2048 2048 100 20 normal random 0.3 0 0.5 0.5 14",
}
# the formats the models know, and one they do not
FORMATS = ("dense", "bsr_pallas", "bsr", "panel_pallas", "cv_panel", "gell",
           "gell16", "cv_gell", "ell", "coo", "wcoo_bands", "scoo", "merge",
           "sell", "rbh", "unknown")


def scaled(f, s: float):
    """Features of the same structure at s times the rows and columns: the
    giant-m regimes (dense and panel inapplicable, cv_gell's gate, the
    gather cliff, the block budget)."""
    return dataclasses.replace(
        f, m=int(f.m * s), n=int(f.n * s), nnz=int(f.nnz * s),
        density=f.density / s, avg_bw=f.avg_bw * s, std_bw=f.std_bw * s)


@pytest.fixture(scope="module")
def features():
    """name -> (port features, JAX features), computed once."""
    out = {}
    for name, line in LINES.items():
        port = matrix_features(artificial_matrix_generation(
            **GenParams.from_line(line).kwargs()))
        jax = jax_features(jax_generate(**JaxParams.from_line(line).kwargs()))
        out[name] = (port, jax)
        out[name + "_x100"] = (scaled(port, 100), scaled(jax, 100))
    return out


def jax_constants():
    return costmodel.H100Constants(
        **dataclasses.asdict(jax_costmodel.C), residual_nnz=29e-9)


@pytest.fixture
def jax_c(monkeypatch):
    monkeypatch.setattr(costmodel, "C", jax_constants())


@pytest.fixture
def jax_fudge():
    """The JAX ``fit_constants`` writes into the live JAX constants: keep
    them as they were for the JAX tests that run later in this process."""
    saved = dict(jax_costmodel.C.fudge)
    yield
    jax_costmodel.C.fudge.clear()
    jax_costmodel.C.fudge.update(saved)


def same(a: float, b: float) -> bool:
    if math.isinf(a) or math.isinf(b):
        return a == b
    return abs(a - b) <= 1e-12 * abs(b)


def test_features_of_the_port_equal_jax(features):
    for name, (port, jax) in features.items():
        assert dataclasses.asdict(port) == dataclasses.asdict(jax), name


@pytest.mark.parametrize("n", [1, 512])
def test_estimates_equal_jax(features, jax_c, n):
    finite = set()
    for name, (port, jax) in features.items():
        for fmt in FORMATS:
            got = costmodel.estimate_spmm_time(port, fmt, n)
            want = jax_costmodel.estimate_spmm_time(jax, fmt, n)
            assert same(got, want), (name, fmt, got, want)
            if math.isfinite(want):
                finite.add(fmt)
    # every known format is applicable somewhere, and not everywhere
    assert finite == set(FORMATS) - {"unknown"}


@pytest.mark.parametrize("n", [1, 64, 512])
def test_picks_equal_jax(features, jax_c, n):
    picks = set()
    for name, (port, jax) in features.items():
        got = costmodel.select_format_cost(port, n)
        assert got == jax_costmodel.select_format_cost(jax, n), name
        picks.add(got)
        # auto_tol: the JAX pick at the JAX tolerance, cv_panel offered
        tol = costmodel.CV_TOLERANCE
        want = jax_costmodel.select_format_cost(jax, n, tolerance=tol)
        assert costmodel.select_format_cost(port, n, tolerance=tol) == want, \
            name
        assert costmodel.tolerant_candidates(port, n) == \
            jax_costmodel.tolerant_candidates(jax, n)
    assert len(picks) >= 2


def test_constants_and_candidates(jax_c):
    assert costmodel.AUTO_CANDIDATES == jax_costmodel.AUTO_CANDIDATES
    assert costmodel.CV_TOLERANCE == jax_costmodel.CV_TOLERANCE
    fields = {f.name for f in dataclasses.fields(costmodel.H100Constants)}
    jax_fields = {f.name for f in dataclasses.fields(
        jax_costmodel.V5eConstants)}
    assert fields == jax_fields | {"residual_nnz"}


def test_the_h100_constants_hold_no_v5e_value():
    h100 = dataclasses.asdict(costmodel.H100Constants())
    v5e = dataclasses.asdict(jax_costmodel.V5eConstants())
    for field, value in h100.items():
        if field == "fudge":
            assert not set(value.items()) & set(v5e["fudge"].items())
        elif field in v5e:
            assert value != v5e[field], field
    assert h100["residual_nnz"] != 29e-9


@pytest.fixture(scope="module")
def result_csvs(tmp_path_factory):
    """Two CSVs of the port's CLI on the CPU (three matrices, six fixed
    formats and auto), the second with a row that failed its gate and a
    row without feature columns appended."""
    tmp = tmp_path_factory.mktemp("rows")
    mp = pytest.MonkeyPatch()
    mp.setenv("SPGRID_MIN_TIME_S", "0.005")
    mp.setenv("SPGRID_MIN_ITERS", "2")
    paths = []
    try:
        for i, lines in enumerate(((LINES["banded"], LINES["dlmc"]),
                                   (LINES["mac_econ"],))):
            path = tmp / f"sweep_{i}.csv"
            for line in lines:
                assert cli_main(["--generate", line, "--kernels",
                                 "dense,bsr_cuda,coo,sell,gell,merge,auto",
                                 "--num-cols", "16", "--out", str(path),
                                 "--platform", "cpu"]) == 0
            paths.append(path)
    finally:
        mp.undo()
    with open(paths[1]) as f:
        rows = list(csv.DictReader(f))
    failed = dict(rows[0], kernel="failed_row", errors_passed="0")
    bare = dict(rows[1], kernel="bare_row", skew="", avg_bw_scaled="")
    with open(paths[1], "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writerow(failed)
        w.writerow(bare)
    return paths


def dict_rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_rows_speak_jax_format_names(result_csvs):
    fmts = {r["fmt"] for p in result_csvs for r in dict_rows(p)}
    assert fmts <= set(jax_costmodel.AUTO_CANDIDATES)
    assert {"bsr_pallas", "coo", "sell", "gell", "merge", "dense"} <= fmts


def test_prediction_records_equal_jax(result_csvs, jax_c):
    for path in result_csvs:
        got = costmodel.prediction_records(dict_rows(path))
        want = jax_costmodel.prediction_records(pd.read_csv(path))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for key in g:
                if key in ("pred", "ratio", "time", "avg_bw_scaled",
                           "skew"):
                    assert same(g[key], float(w[key])), key
                else:
                    assert g[key] == w[key], key
    # the appended rows are dropped: the failed one and the bare one
    kernels = {r["matrix_name"] for r in costmodel.prediction_records(
        dict_rows(result_csvs[1]))}
    assert len(costmodel.prediction_records(dict_rows(result_csvs[1]))) \
        == len(dict_rows(result_csvs[1])) - 2 and kernels


def test_fit_constants_equals_jax(result_csvs, jax_c, jax_fudge):
    rows = dict_rows(result_csvs[0]) + dict_rows(result_csvs[1])
    frame = pd.concat([pd.read_csv(p) for p in result_csvs],
                      ignore_index=True)
    before = dict(costmodel.C.fudge)
    got = costmodel.fit_constants(rows, min_rows=3)
    want = jax_costmodel.fit_constants(frame, min_rows=3)
    assert got.keys() == want.keys() and got
    for fmt in got:
        assert same(got[fmt], want[fmt]), fmt
        assert same(costmodel.C.fudge[fmt], before.get(fmt, 1.0) * got[fmt])
    assert {k: costmodel.C.fudge[k] for k in got} == {
        k: jax_costmodel.C.fudge[k] for k in want}


def test_merge_result_csvs_equals_jax(result_csvs):
    paths = [str(p) for p in result_csvs]
    got = dataset.merge_result_csvs(paths)
    want = jax_dataset.merge_result_csvs(paths)
    assert len(got) == len(want) == sum(len(dict_rows(p))
                                        for p in paths) - 1
    for g, (_, w) in zip(got, want.iterrows()):
        assert set(g) == set(want.columns)
        for key, value in g.items():
            wv = w[key]
            if isinstance(value, str):
                assert value == wv, key
            elif isinstance(wv, float) and math.isnan(wv):
                assert math.isnan(value), key
            else:
                assert value == pytest.approx(wv, rel=1e-12), key
    kept = dataset.merge_result_csvs(paths, drop_failed=False,
                                     add_derived=False)
    assert len(kept) == len(got) + 1 and "log_nnz" not in kept[0]
    with pytest.raises(ValueError):
        dataset.merge_result_csvs([])


@pytest.mark.parametrize("lossy", [True, False])
def test_dispatch_accuracy_equals_jax(result_csvs, lossy):
    paths = [str(p) for p in result_csvs]
    got = dataset.dispatch_accuracy(dataset.merge_result_csvs(paths),
                                    tol=0.10, include_lossy=lossy)
    want = jax_dataset.dispatch_accuracy(
        jax_dataset.merge_result_csvs(paths), tol=0.10,
        include_lossy=lossy)
    assert len(got[1]) == len(want[1]) == 3
    assert got[0] == want[0]
    for g, w in zip(got[1], want[1]):
        assert g[0] == w[0] and g[3] == w[3]
        assert g[1] == pytest.approx(w[1]) and g[2] == pytest.approx(w[2])
    # a tolerance of 100 % holds every auto row within
    assert dataset.dispatch_accuracy(dataset.merge_result_csvs(paths),
                                     tol=1.0)[0] == 1.0
