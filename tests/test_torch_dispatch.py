"""Format dispatch of the port (``spgrid_torch/ops/dispatch.py``:
``select_format``, ``autotune_spmm``) and the harness's dispatch kernels
(``auto``, ``auto_tol``, ``autotune``, ``gemm_bound``, ``rbh``) on the CPU:
``select_format`` maps to the JAX package's pick under the JAX constants,
each row passes its gate with a JAX format name as ``fmt``, an ``auto_tol``
row that picks ``cv_gell`` gates as ``cv_gell``, and ``autotune_spmm``
skips what the cost model rules out without building it, raises when
nothing runs and returns the argmin of its own times (which format wins on
the CPU is never asserted)."""

import dataclasses
import math

import pytest
import torch

import spgrid.ops.costmodel as jax_costmodel
import spgrid.ops.dispatch as jax_dispatch
from spgrid.features.structural import matrix_features as jax_features
from spgrid.gen import GenParams as JaxParams
from spgrid.gen import artificial_matrix_generation as jax_generate
from spgrid_torch.bench import harness
from spgrid_torch.core.config import BenchConfig
from spgrid_torch.features import matrix_features
from spgrid_torch.gen import GenParams, artificial_matrix_generation
from spgrid_torch.ops import costmodel, dispatch

torch.set_num_threads(1)

LINES = (
    "512 512 256 32 normal random 1.0 0 0.05 0.05 14",
    "4000 4000 5 1.6667 normal random 0.05 0 0.05 0.05 14",
    "8000 8000 5 1.6667 normal random 0.5 0 0.5 0.75 14",
    "3000 3000 10 3 normal random 0.3 200 0.05 0.05 7",
    "2048 2048 100 20 normal random 0.3 0 0.5 0.5 14",
    "1000 1000 400 40 normal random 1.0 0 0.05 0.05 3",
)
SMALL = "2000 2000 5 1.6667 normal random 0.05 0 0.05 0.05 14"
N = 16


def port_matrix(line):
    return artificial_matrix_generation(**GenParams.from_line(line).kwargs())


@pytest.fixture
def jax_c(monkeypatch):
    monkeypatch.setattr(costmodel, "C", costmodel.H100Constants(
        **dataclasses.asdict(jax_costmodel.C), residual_nnz=29e-9))


@pytest.fixture(scope="module")
def features():
    return [(matrix_features(port_matrix(line)),
             jax_features(jax_generate(**JaxParams.from_line(line).kwargs())))
            for line in LINES]


@pytest.mark.parametrize("n", [64, 512])
def test_tolerant_candidates_equal_jax(features, n):
    """cv_panel first, as the JAX package offers it, then cv_gell outside
    its excluded regime."""
    for port, jax in features:
        got = costmodel.tolerant_candidates(port, n)
        assert got == jax_costmodel.tolerant_candidates(jax, n)
        assert got[0] == "cv_panel"


@pytest.mark.parametrize("n", [64, 512])
def test_tolerant_select_format_maps_to_the_jax_pick(features, jax_c, n):
    tol = costmodel.CV_TOLERANCE
    for port, jax in features:
        got = dispatch.select_format(port, n, tolerance=tol)
        want = jax_dispatch.select_format(jax, n, tolerance=tol)
        assert got == dispatch.PORT_NAME[want], (port.name, got, want)


@pytest.fixture
def quick(monkeypatch):
    monkeypatch.setenv("SPGRID_MIN_TIME_S", "0.005")
    monkeypatch.setenv("SPGRID_MIN_ITERS", "2")
    return BenchConfig.from_env(num_cols=N)


def test_port_and_jax_names_map_both_ways():
    assert dispatch.JAX_NAME["rbh"] == "rbh" and "rbh" in dispatch.FORMATS
    assert all(dispatch.PORT_NAME[j] == p for p, j in dispatch.JAX_NAME.items())
    assert set(dispatch.JAX_NAME.values()) <= set(jax_dispatch.FORMATS)
    assert set(costmodel.AUTO_CANDIDATES) <= set(dispatch.PORT_NAME)


@pytest.mark.parametrize("n", [1, 64, 512])
def test_select_format_maps_to_the_jax_pick(features, jax_c, n):
    picks = set()
    for port, jax in features:
        got = dispatch.select_format(port, n)
        want = jax_dispatch.select_format(jax, n)
        assert got == dispatch.PORT_NAME[want], (port.name, got, want)
        picks.add(got)
    assert len(picks) >= 2


@pytest.mark.parametrize("kernel", ["auto", "autotune", "gemm_bound",
                                    "rbh", "auto_tol"])
def test_dispatch_rows_pass_their_gates(kernel, quick):
    csr = port_matrix(SMALL)
    row = harness.run_spmm(csr, kernel, quick, device="cpu")
    assert row["kernel"] == kernel and row["errors_passed"] == 1
    assert row["fmt"] in set(costmodel.AUTO_CANDIDATES) | set(
        dispatch.JAX_NAME.values()) | {"cv_gell"}
    if kernel == "gemm_bound":
        assert row["fmt"] == "dense"
        assert row["gflops"] == pytest.approx(
            2.0 * csr.m * csr.k * N / row["time"] / 1e9)
    if kernel == "rbh":
        assert row["fmt"] == "rbh"


def test_fixed_rows_write_the_jax_name(quick):
    csr = port_matrix(SMALL)
    for kernel in ("bsr_cuda", "wcoo_bands_cuda", "sell"):
        row = harness.run_spmm(csr, kernel, quick, device="cpu")
        assert row["kernel"] == kernel
        assert row["fmt"] == dispatch.JAX_NAME[kernel]


def test_auto_tol_row_gates_on_the_chosen_format(quick, monkeypatch):
    """auto_tol picking cv_gell gates on bf16-rounded X (the exact gate
    fails there), and the gold is made once a class on one matrix."""
    monkeypatch.setattr(
        dispatch, "select_format",
        lambda f, n, tolerance=0.0, dtype="float32", precision=None:
        "cv_gell" if tolerance else "gell")
    seen = []
    real = harness.gate_x
    monkeypatch.setattr(harness, "gate_x",
                        lambda x, fmt: seen.append(fmt) or real(x, fmt))
    csr = port_matrix(SMALL)
    row = harness.run_spmm(csr, "auto_tol", quick, device="cpu")
    assert (row["fmt"], row["errors_passed"]) == ("cv_gell", 1)
    assert seen == ["cv_gell"]
    exact = harness.run_spmm(csr, "auto", quick, device="cpu")
    assert (exact["fmt"], exact["errors_passed"]) == ("gell", 1)
    harness.run_spmm(csr, "gell", quick, device="cpu")
    harness.run_spmm(csr, "cv_gell", quick, device="cpu")
    assert seen == ["cv_gell", "gell"]         # cached from then on
    # the cv_gell product misses the exact class's gate
    a = dispatch.build(csr, "cv_gell", device="cpu")
    x = harness.make_x(csr.k, N, "float32", quick.seed)
    from spgrid_torch.core.metrics import error_metrics, gold_spmm_fast
    y = dispatch.spmm_fn("cv_gell")(a, torch.from_numpy(x)).numpy()
    gold = gold_spmm_fast(csr.row_ptr, csr.col_idx, csr.values, x)
    assert not error_metrics(gold, y, epsilon=1e-4).passed


def test_gold_cache_keeps_two_classes():
    csr = port_matrix(SMALL)
    x = harness.make_x(csr.k, N, "float32", 3)
    for fmt in ("gell", "gell16", "cv_gell", "coo"):
        harness._cached_gold(csr, fmt, x, (N, "float32", 3))
    keys = list(csr._spgrid_torch_gold)
    assert [k[-1] for k in keys] == ["cv_gell", "exact"]


def test_autotune_skips_what_the_model_rules_out(monkeypatch):
    csr = port_matrix(SMALL)
    x = torch.from_numpy(harness.make_x(csr.k, N, "float32", 1))
    built = []
    real_build = dispatch.build
    monkeypatch.setattr(dispatch, "build", lambda c, fmt, **kw: (
        built.append(fmt), real_build(c, fmt, **kw))[1])
    real_est = costmodel.estimate_spmm_time
    monkeypatch.setattr(costmodel, "estimate_spmm_time", lambda f, fmt, n: (
        math.inf if fmt == "sell" else real_est(f, fmt, n)))
    times = iter([3e-3, 1e-3, 2e-3])
    monkeypatch.setattr(harness, "time_call", lambda *a, **k: type(
        "T", (), {"time_per_iter_s": next(times)})())
    r = dispatch.autotune_spmm(csr, x, ("dense", "sell", "coo", "gell",
                                        "merge"), dense_limit=1)
    assert built == ["coo", "gell", "merge"]
    assert r.times["dense"] == r.times["sell"] == math.inf
    assert r.best == "gell" and r.times["gell"] == 1e-3
    with pytest.raises(RuntimeError, match="no runnable candidate"):
        dispatch.autotune_spmm(csr, x, ("dense", "sell"), dense_limit=1)


@pytest.mark.parametrize("stage", ["build", "run"])
def test_autotune_lets_a_kernel_error_reach_the_caller(stage, monkeypatch):
    """A candidate that fails to build or to launch raises out of
    autotune_spmm (nothing times it as inf and lets another format win)."""
    csr = port_matrix(SMALL)
    x = torch.from_numpy(harness.make_x(csr.k, N, "float32", 1))
    real_build = dispatch.build

    def failing(c, fmt, **kw):
        if stage == "build" and fmt == "gell":
            raise RuntimeError("gell: no kernel image for this device")
        return real_build(c, fmt, **kw)

    def timed(fn, a, x, **kw):
        if stage == "run" and fn is dispatch.spmm_fn("gell"):
            raise RuntimeError("gell: the launch failed")
        return type("T", (), {"time_per_iter_s": 1e-3})()

    monkeypatch.setattr(dispatch, "build", failing)
    monkeypatch.setattr(harness, "time_call", timed)
    with pytest.raises(RuntimeError, match="gell"):
        dispatch.autotune_spmm(csr, x, ("coo", "gell", "merge"))


def test_autotune_leaves_out_a_candidate_out_of_device_memory(monkeypatch):
    csr = port_matrix(SMALL)
    x = torch.from_numpy(harness.make_x(csr.k, N, "float32", 1))
    times = {"coo": 3e-3, "merge": 2e-3}

    def timed(fn, a, x, **kw):
        if fn is dispatch.spmm_fn("gell"):
            raise torch.OutOfMemoryError("gell: out of memory")
        fmt = "coo" if fn is dispatch.spmm_fn("coo") else "merge"
        return type("T", (), {"time_per_iter_s": times[fmt]})()

    monkeypatch.setattr(harness, "time_call", timed)
    r = dispatch.autotune_spmm(csr, x, ("coo", "gell", "merge"))
    assert r.times["gell"] == math.inf and r.best == "merge"


def test_autotune_times_every_default_candidate():
    """The default candidates are the AUTO set's port names; each that the
    model allows is timed (host clock on the CPU) and the best is the
    argmin of those times."""
    csr = port_matrix(SMALL)
    x = torch.from_numpy(harness.make_x(csr.k, N, "float32", 1))
    r = dispatch.autotune_spmm(csr, x, min_time_s=0.001, min_iters=2,
                               warmup_iters=1)
    assert set(r.times) == {dispatch.PORT_NAME[c]
                            for c in costmodel.AUTO_CANDIDATES}
    assert r.best == min(r.times, key=r.times.get)
    assert math.isfinite(r.times[r.best])
