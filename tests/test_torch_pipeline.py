"""The port's attention pipeline against the JAX package's, stage by stage,
and against the f64 gold pipeline."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from spgrid.core.metrics import error_metrics
from spgrid.formats import CSRMatrix, random_csr
from spgrid.gen import create_mask
from spgrid.ops.attention import SparseAttention as JaxAttention
from spgrid.ops.attention import attention_pipeline as jax_pipeline
from spgrid.ops.attention import blocksparse_softmax as jax_softmax
from spgrid.ops.attention import gold_pipeline as jax_gold
from spgrid_torch.entry import flagship_csrs, flagship_x
from spgrid_torch.ops.attention import (
    SparseAttention, attention_pipeline, blocksparse_softmax, gold_pipeline,
)

# The suite runs in parallel workers on shared cores: one intra-op thread
# a worker keeps these small CPU tensors from oversubscribing them.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    """The inputs of tests/test_pipeline.py: m=128, k=96, n=64."""
    def pos(csr):
        return CSRMatrix(csr.row_ptr, csr.col_idx, np.abs(csr.values) + 0.1,
                         csr.shape, csr.name)

    wk = pos(random_csr(128, 96, density=0.5, seed=1))
    wq = pos(random_csr(128, 96, density=0.5, seed=2))
    wv = pos(random_csr(128, 96, density=0.5, seed=3))
    mask = create_mask("band_and_random", 128, sparsity=0.8, band_size=4,
                       seed=14)
    x = np.random.default_rng(0).random((96, 64)).astype(np.float32) * 0.2
    return wk, wq, wv, mask, x


BLOCKS = {"bm8": dict(bm=8, bk=128, mask_bm=8, mask_bk=128), "bm128": {}}


@pytest.mark.parametrize("blocks", sorted(BLOCKS))
def test_stages_match_jax_pipeline(problem, blocks):
    wk, wq, wv, mask, x = problem
    kw = BLOCKS[blocks]
    _, want = jax_pipeline(JaxAttention.from_csr(wk, wq, wv, mask, **kw),
                           jnp.asarray(x), use_pallas=True, interpret=True)
    _, got = attention_pipeline(
        SparseAttention.from_csr(wk, wq, wv, mask, device="cpu", **kw),
        torch.from_numpy(x))
    assert set(got) == set(want) == {"K", "Q", "V", "S", "Y"}
    for stage in "KQVSY":
        np.testing.assert_allclose(got[stage].numpy(), np.asarray(want[stage]),
                                   rtol=1e-4, atol=1e-6, err_msg=stage)


@pytest.mark.parametrize("blocks", sorted(BLOCKS))
def test_pipeline_matches_gold(problem, blocks):
    wk, wq, wv, mask, x = problem
    attn = SparseAttention.from_csr(wk, wq, wv, mask, device="cpu",
                                    **BLOCKS[blocks])
    y, _ = attention_pipeline(attn, torch.from_numpy(x))
    m = error_metrics(gold_pipeline(wk, wq, wv, mask, x), y.numpy(),
                      epsilon=5e-4)
    assert m.passed, f"max_rel_diff={m.max_rel_diff}"


@pytest.mark.parametrize("softmax", [False, True])
def test_gold_pipeline_copy_matches_original(problem, softmax):
    wk, wq, wv, mask, x = problem
    np.testing.assert_array_equal(
        gold_pipeline(wk, wq, wv, mask, x, softmax=softmax),
        jax_gold(wk, wq, wv, mask, x, softmax=softmax))


def test_blocksparse_softmax_matches_jax(problem):
    wk, wq, wv, mask, x = problem
    kw = BLOCKS["bm8"]
    s = np.random.default_rng(3).standard_normal(
        SparseAttention.from_csr(wk, wq, wv, mask, device="cpu", **kw)
        .mask.blocks.shape).astype(np.float32)
    want = jax_softmax(JaxAttention.from_csr(wk, wq, wv, mask, **kw).mask,
                       jnp.asarray(s))
    got = blocksparse_softmax(
        SparseAttention.from_csr(wk, wq, wv, mask, device="cpu", **kw).mask,
        torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


def test_softmax_pipeline_matches_gold(problem):
    wk, wq, wv, mask, x = problem
    attn = SparseAttention.from_csr(wk, wq, wv, mask, device="cpu",
                                    **BLOCKS["bm8"])
    y, _ = attention_pipeline(attn, torch.from_numpy(x), softmax=True)
    m = error_metrics(gold_pipeline(wk, wq, wv, mask, x, softmax=True),
                      y.numpy(), epsilon=1e-3)
    assert m.passed, f"max_rel_diff={m.max_rel_diff}"


def test_flop_model_matches_jax(problem):
    wk, wq, wv, mask, _ = problem
    assert (SparseAttention.from_csr(wk, wq, wv, mask, device="cpu")
            .flops_per_col
            == JaxAttention.from_csr(wk, wq, wv, mask).flops_per_col
            == 2.0 * (wk.nnz + wq.nnz + wv.nnz + 2 * mask.nnz))


def test_flagship_inputs_match_graft_entry():
    for got, want in zip(flagship_csrs(), __graft_entry__._flagship_csrs()):
        assert got.shape == want.shape and got.name == want.name
        np.testing.assert_array_equal(got.row_ptr, want.row_ptr)
        np.testing.assert_array_equal(got.col_idx, want.col_idx)
        np.testing.assert_array_equal(got.values, want.values)
    _, (_, x) = __graft_entry__.entry()
    np.testing.assert_array_equal(flagship_x(512), np.asarray(x))
