"""The port's feature extraction (``spgrid_torch.features``) against the JAX
package's ``spgrid.features``, field by field, and the 12 feature columns of
a CPU ``run_spmm`` row against the JAX harness's row.

Integers must be equal and floats within 1e-12 relative: the port's copies
run the same numpy arithmetic on the same arrays.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import spgrid.bench.harness as jax_harness
from spgrid.core.config import BenchConfig as JaxConfig
from spgrid.features.structural import matrix_features as jax_features
from spgrid.features.values import kmeans_1d as jax_kmeans
from spgrid.features.values import value_features as jax_value_features
from spgrid.formats.csr import CSRMatrix as JaxCSR
from spgrid_torch.bench import harness
from spgrid_torch.bench.headline import headline_matrix
from spgrid_torch.core.config import BenchConfig
from spgrid_torch.entry import hypersparse_edge
from spgrid_torch.features import kmeans_1d, matrix_features, value_features
from spgrid_torch.formats.csr import CSRMatrix, dense_to_csr, random_csr

torch.set_num_threads(1)

RTOL = 1e-12
FEATURE_COLUMNS = (
    "density", "avg_nnz_per_row", "std_nnz_per_row", "avg_bw_scaled",
    "std_bw_scaled", "avg_sc_scaled", "skew", "avg_num_neighbours",
    "cross_row_similarity", "val_unique_fraction", "val_exp_unique",
    "val_kmeans_rel_error_8")


def banded_with_empty_rows():
    rng = np.random.default_rng(3)
    i = np.arange(1000)[:, None]
    j = np.arange(900)[None, :]
    d = np.where((np.abs(i - j) <= 40) & (rng.random((1000, 900)) < 0.5),
                 rng.standard_normal((1000, 900)), 0.0)
    d[8:24] = 0.0
    d[990:] = 0.0
    return dense_to_csr(d.astype(np.float32), name="banded_empty_rows")


def unsorted(csr):
    """The same matrix with each row's columns in descending order."""
    rows = np.repeat(np.arange(csr.m), csr.degrees)
    order = np.lexsort((-csr.col_idx.astype(np.int64), rows))
    return CSRMatrix(csr.row_ptr, csr.col_idx[order], csr.values[order],
                     csr.shape, csr.name + "_unsorted")


MATRICES = {
    "headline_twin": headline_matrix,
    "banded_empty_rows": banded_with_empty_rows,
    "edge_3000x2000": lambda: hypersparse_edge(
        3000, 2000, density=0.003, empty=slice(1024, 2048), heavy_row=5,
        heavy_nnz=250),
    "unsorted": lambda: unsorted(banded_with_empty_rows()),
    "empty": lambda: dense_to_csr(np.zeros((7, 5), np.float32)),
}


def as_jax(csr):
    return JaxCSR(csr.row_ptr, csr.col_idx, csr.values, csr.shape, csr.name)


def assert_same(got, want):
    got, want = dataclasses.asdict(got), dataclasses.asdict(want)
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if isinstance(w, float):
            assert isinstance(g, float), key
            assert g == pytest.approx(w, rel=RTOL, abs=0.0), key
        else:
            assert type(g) is type(w) and g == w, key


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_matrix_features_match_the_jax_package(name):
    csr = MATRICES[name]()
    assert_same(matrix_features(csr), jax_features(as_jax(csr)))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_value_features_match_the_jax_package(name):
    values = MATRICES[name]().values
    assert_same(value_features(values), jax_value_features(values))


@pytest.mark.parametrize("values", [
    np.array([0.5, 0.5, 0.5]), np.arange(5.0),
    np.random.default_rng(1).standard_normal(2000)])
def test_kmeans_matches_the_jax_package(values):
    for got, want in zip(kmeans_1d(values, k=8, seed=3),
                         jax_kmeans(values, k=8, seed=3)):
        np.testing.assert_array_equal(got, want)


def test_run_spmm_row_has_the_jax_rows_feature_columns():
    csr = headline_matrix()
    config = BenchConfig(num_cols=8, warmup_iters=1, min_time_s=0.01,
                         min_iters=2)
    row = harness.run_spmm(csr, "dense", config, device="cpu",
                           check_accuracy=False)
    jax_row = jax_harness.run_spmm(
        as_jax(csr), "dense", JaxConfig(num_cols=8, warmup_iters=1,
                                        min_time_s=0.01, min_iters=2),
        check_accuracy=False)
    for col in FEATURE_COLUMNS:
        assert math.isfinite(row[col]), col
        assert row[col] == pytest.approx(getattr(jax_row, col), rel=RTOL,
                                         abs=0.0), col


def test_value_features_sample_a_large_matrix_as_the_jax_harness():
    # more than 2^20 values: both harnesses read every (nnz // 2^20 + 1)th
    csr = random_csr(1100, 1000, 0.96, seed=4)
    assert csr.nnz > harness.VALUE_SAMPLE
    got = harness._cached_value_features(csr)
    want = jax_harness._cached_value_features(as_jax(csr))
    assert got.num_values == want.num_values < csr.nnz
    assert_same(got, want)


def test_features_are_cached_and_carried_across_the_cast():
    csr = random_csr(300, 200, 0.05, seed=2, dtype=np.float64)
    feats = harness._cached_features(csr)   # structure only: any dtype
    config = BenchConfig(num_cols=4, warmup_iters=1, min_time_s=0.0,
                         min_iters=1)
    first = harness.run_spmm(csr, "bsr_cuda", config, device="cpu")
    cast = csr._spgrid_torch_cast[1]
    assert cast.values.dtype == np.float32
    assert cast._spgrid_torch_feats is feats
    second = harness.run_spmm(csr, "panel_cuda", config, device="cpu")
    assert csr._spgrid_torch_cast[1] is cast
    assert cast._spgrid_torch_feats is feats
    for col in FEATURE_COLUMNS:
        assert first[col] == second[col], col
    # value features come from the cast values, as the JAX harness's do
    assert_same(cast._spgrid_torch_value_feats,
                jax_value_features(csr.values.astype(np.float32)))
