"""The port's device gate (``spgrid_torch.core.device_oracle``) on the CPU
against the host f64 gate of the JAX package (``spgrid.core.metrics.
gold_spmm_fast`` and ``error_metrics``): the gold bit for bit (within
1e-13 relative, the stated bound, and equal in fact: every product is exact
in f64 and each row is summed in numpy's order), the eight metrics within
1e-12 relative (their sums run in another order); empty rows, rows past the
JAX oracle's 8,192 slots, a result that fails the gate, and the gate
classes exact, gell16, cv_int8 and cv_panel; and ``run_spmm`` with
``oracle="device"`` against ``"host"``.
"""

import numpy as np
import pytest
import torch

from spgrid.bench.harness import _xg_host
from spgrid.core.metrics import error_metrics, gold_spmm_fast
from spgrid.formats.csr import CSRMatrix
from spgrid.formats.cv import csr_to_cv, cv_to_csr
from spgrid_torch.bench import harness
from spgrid_torch.core.config import BenchConfig
from spgrid_torch.core.device_oracle import (
    BLOCK, DeviceOracle, block_sums, pairwise_plan,
)

# The suite runs in parallel workers on shared cores: one intra-op thread
# a worker keeps these small CPU tensors from oversubscribing them.
torch.set_num_threads(1)

GOLD_RTOL = 1e-13
METRIC_RTOL = 1e-12
METRICS = ("mae", "max_ae", "mse", "mape", "smape", "lnQ_error", "mlare",
           "gmare")


def skewed(seed=0, m=300, k=20000):
    """Rows of 0-11 nnz around rows at every edge of numpy's sum: 0, 1, 8,
    9, 16, 17, 129, 130, 135, 255, 257 and 9,000 nnz (past the JAX
    oracle's 8,192 slots); no column twice in a row; signed values."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 12, m)
    deg[5:17] = (9000, 129, 130, 257, 255, 0, 1, 8, 9, 16, 17, 135)
    ptr = np.concatenate([[0], np.cumsum(deg)])
    cols = np.concatenate([np.sort(rng.choice(k, d, replace=False))
                           for d in deg]).astype(np.int32)
    vals = rng.normal(size=ptr[-1]).astype(np.float32)
    return CSRMatrix(ptr, cols, vals, (m, k), "skewed")


def operand(k, n, seed=1):
    return (np.random.default_rng(seed).random((k, n)) + 0.5).astype(
        np.float32)


@pytest.fixture(scope="module")
def matrix():
    return skewed()


def rel(a, b):
    return abs(a - b) / max(abs(a), 1e-300)


def assert_metrics_agree(host, dev):
    for f in METRICS:
        h, d = getattr(host, f), getattr(dev, f)
        assert (h == d) or rel(h, d) <= METRIC_RTOL, (f, h, d)
    assert rel(host.max_rel_diff, dev.max_rel_diff) <= METRIC_RTOL
    assert host.passed == dev.passed


@pytest.mark.parametrize("n", [1, 7, 64])
def test_gold_is_the_host_gold(matrix, n):
    x = operand(matrix.k, n)
    want = gold_spmm_fast(matrix.row_ptr, matrix.col_idx, matrix.values, x)
    got = DeviceOracle.from_csr(matrix, device="cpu").gold(
        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=GOLD_RTOL, atol=0)
    np.testing.assert_array_equal(got, want)
    assert not got[10].any()             # the empty row


@pytest.mark.parametrize("length", [1, 5, 7, 8, 9, 15, 16, 17, 64, 127,
                                    128, 129, 130, 255, 257, 1000, 9000])
def test_row_sum_order_is_numpys(length):
    """One row of ``length`` products, summed as ``np.add.reduceat`` sums
    it: the first, plus the pairwise sum of the rest."""
    rng = np.random.default_rng(length)
    p = rng.normal(size=(length, 3)) * 10.0 ** rng.integers(
        -8, 8, (length, 1))
    want = np.add.reduceat(p[:length], [0], axis=0)[0]
    rest = length - 1
    if rest <= BLOCK:
        runs = torch.zeros((1, BLOCK, 3), dtype=torch.float64)
        runs[0, :rest] = torch.from_numpy(p[1:length])
        pw = block_sums(runs, torch.tensor([rest]))[0].numpy()
    else:
        leaves, adds, root = pairwise_plan(rest)
        vals = [block_sums(torch.from_numpy(np.pad(
            p[1 + off:1 + off + ln], ((0, BLOCK - ln), (0, 0))))[None],
            torch.tensor([ln]))[0].numpy() for off, ln in leaves]
        for left, right, _ in adds:
            vals.append(vals[left] + vals[right])
        pw = vals[root]
    np.testing.assert_array_equal(p[0] + pw, want)


@pytest.mark.parametrize("gate", ["exact", "gell16", "cv_int8", "cv_panel"])
def test_metrics_agree_with_the_host_gate(matrix, gate):
    """Each gate class's gold (its values and X, as the JAX harness forms
    them) and a plausible f32 result with one entry off by 3e-6: the
    eight metrics and the verdict agree."""
    x = operand(matrix.k, 16)
    gold_csr, xg = matrix, x
    if gate.startswith("cv_"):
        gold_csr = cv_to_csr(csr_to_cv(matrix, "bf16" if gate == "cv_panel"
                                       else "int8"))
    if gate in ("gell16", "cv_panel"):
        xg = _xg_host(x, gate)
    gold = gold_spmm_fast(gold_csr.row_ptr, gold_csr.col_idx,
                          gold_csr.values, xg)
    test = gold.astype(np.float32)
    test[7, 3] += 3e-6 * abs(test[7, 3])
    host = error_metrics(gold, test, epsilon=1e-4)
    fmt = {"exact": "coo", "gell16": "gell16", "cv_int8": "cv_int8",
           "cv_panel": "cv_panel_cuda"}[gate]
    assert harness.gold_class(fmt) == gate
    orc = DeviceOracle.from_csr(harness.gate_csr(matrix, fmt), device="cpu")
    dev = orc.check(torch.from_numpy(test),
                    harness.gate_x_tensor(torch.from_numpy(x), fmt), 1e-4)
    assert_metrics_agree(host, dev)
    assert dev.passed


def test_corrupted_result_fails_the_gate(matrix):
    x = operand(matrix.k, 4)
    gold = gold_spmm_fast(matrix.row_ptr, matrix.col_idx, matrix.values, x)
    orc = DeviceOracle.from_csr(matrix, device="cpu")
    for row in (3, 5):                   # a short row, the 9,000-nnz row
        bad = gold.astype(np.float32)
        bad[row, 2] += 0.5 * max(abs(bad[row, 2]), 1.0)
        host = error_metrics(gold, bad, epsilon=1e-4)
        dev = orc.check(torch.from_numpy(bad), torch.from_numpy(x), 1e-4)
        assert not host.passed and not dev.passed
        assert_metrics_agree(host, dev)


def test_gold_is_kept_for_its_key_only(matrix):
    orc = DeviceOracle.from_csr(matrix, device="cpu")
    x1, x2 = (torch.from_numpy(operand(matrix.k, 3, s)) for s in (1, 2))
    g1 = orc.gold(x1, key=1)
    assert orc.gold(x2, key=1) is g1
    g2 = orc.gold(x2, key=2)
    assert not torch.equal(g1, g2)
    assert orc.gold(x1) is not g1        # no key: formed anew


def test_empty_matrix_and_shape_check():
    empty = CSRMatrix(np.zeros(5, np.int32), np.zeros(0, np.int32),
                      np.zeros(0, np.float32), (4, 6))
    orc = DeviceOracle.from_csr(empty, device="cpu")
    m = orc.check(torch.zeros(4, 2), torch.ones(6, 2), 1e-4)
    host = error_metrics(np.zeros((4, 2)), np.zeros((4, 2)), 1e-4)
    assert_metrics_agree(host, m)
    with pytest.raises(ValueError):
        orc.check(torch.zeros(3, 2), torch.ones(6, 2), 1e-4)


def positive(csr):
    return CSRMatrix(csr.row_ptr, csr.col_idx,
                     (np.abs(csr.values) + 0.1).astype(np.float32),
                     csr.shape, csr.name)


@pytest.mark.parametrize("kernel", ["coo", "gell16", "cv_int8",
                                    "cv_panel_cuda"])
def test_run_spmm_device_gate_equals_host_gate(kernel):
    csr = positive(skewed(1, m=200))
    kw = dict(num_cols=8, min_time_s=0.001, min_iters=1, warmup_iters=0)
    rows = {o: harness.run_spmm(csr, kernel, BenchConfig(oracle=o, **kw),
                                device="cpu")
            for o in ("host", "device")}
    assert rows["host"]["errors_passed"] == rows["device"]["errors_passed"]
    assert rows["host"]["errors_passed"] == 1
    for f in METRICS:
        h, d = rows["host"][f], rows["device"][f]
        assert h == d or rel(h, d) <= METRIC_RTOL, (f, h, d)


def test_gate_site_follows_the_config():
    auto = BenchConfig()
    assert harness.gate_site(10, 10, auto, torch.device("cpu")) == "host"
    assert harness.gate_site(1 << 20, 512, auto,
                             torch.device("cpu")) == "host"
    assert harness.gate_site(1 << 20, 512, auto,
                             torch.device("cuda")) == "device"
    assert harness.gate_site(16, 16, auto, torch.device("cuda")) == "host"
    for site in ("host", "device"):
        assert harness.gate_site(1, 1, BenchConfig(oracle=site),
                                 torch.device("cpu")) == site
    with pytest.raises(ValueError):
        BenchConfig(oracle="tpu")


def test_disagreements_hold_each_metric_to_its_bound(matrix):
    """The two gates' bounds: 1e-12 relative on the sums and maxima,
    ``LNQ_ABS_TOL`` on lnQ_error (the card's log10 and numpy's differ in
    the last place), ``GMARE_ABS_TOL`` on gmare and 10^mlare."""
    import dataclasses
    from spgrid_torch.core.device_oracle import (
        GMARE_ABS_TOL, LNQ_ABS_TOL, disagreements, finish)
    x = operand(matrix.k, 4)
    gold = gold_spmm_fast(matrix.row_ptr, matrix.col_idx, matrix.values, x)
    host = error_metrics(gold, gold.astype(np.float32), epsilon=1e-4)
    assert disagreements(host, host) == []
    assert disagreements(host, dataclasses.replace(
        host, mae=host.mae * (1 + 1e-11))) == ["mae"]
    assert disagreements(host, dataclasses.replace(
        host, passed=not host.passed)) == ["passed"]
    near = finish(dict(sum_ad=0, sum_d2=0, sum_ape=0, cnt_nz=0, sum_sape=0,
                       cnt_dz=0, max_ad=0, max_rel=0, cnt=1,
                       sum_lnq=host.lnQ_error + LNQ_ABS_TOL / 2), 1e-4)
    far = dataclasses.replace(near, lnQ_error=host.lnQ_error
                              + 2 * LNQ_ABS_TOL)
    for f in ("mae", "max_ae", "mse", "mape", "smape", "max_rel_diff"):
        near = dataclasses.replace(near, **{f: getattr(host, f)})
        far = dataclasses.replace(far, **{f: getattr(host, f)})
    assert disagreements(host, near) == []
    assert disagreements(host, far) == ["lnQ_error"]
    assert GMARE_ABS_TOL > LNQ_ABS_TOL * np.log(10)
