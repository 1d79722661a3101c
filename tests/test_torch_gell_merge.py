"""The merge-path and gather-ELL formats of the port (``spgrid_torch.ops.
merge``, ``spgrid_torch.ops.gell``) against the JAX package's: the layouts
array for array (merge cuts, locals and ``out_rows``; GELL slot width,
slots and tail), ``merge_spmm`` and ``gell_spmm`` in its three modes
against the JAX functions (XLA on the CPU) and the f64 product, the chunked
paths with their budgets made small on both sides, and the bf16 rounding
of the ``gell16``/``cv_gell`` gate against ``ml_dtypes``.

Tolerance: 1e-5 relative against JAX and, for the exact formats, against
the f64 product (positive values, X in [0.5, 1.5)); ``gell16`` and
``cv_gell`` are held to the f64 product on the X they gather by the
harness's gate (eps 1e-4), their values split into 16 bits as the JAX
modes split them.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import spgrid.ops.gell as jax_gell
import spgrid.ops.merge as jax_merge
from spgrid.bench import harness as jax_harness
from spgrid.formats.csr import CSRMatrix, dense_to_csr
from spgrid.gen.artificial import artificial_matrix_generation
from spgrid_torch.bench import harness
from spgrid_torch.core.config import BenchConfig
from spgrid_torch.core.metrics import error_metrics, gold_spmm_fast
from spgrid_torch.ops import dispatch
from spgrid_torch.ops import gell
from spgrid_torch.ops import merge
from spgrid_torch.ops.gell import DeviceGELL, gell_spmm
from spgrid_torch.ops.merge import ROWS_CAP, DeviceMerge, merge_spmm

# The suite runs in parallel workers on shared cores: one intra-op thread
# a worker keeps these small CPU tensors from oversubscribing them.
torch.set_num_threads(1)

RTOL = 1e-5
N = 16


def positive(csr):
    return CSRMatrix(csr.row_ptr, csr.col_idx,
                     (np.abs(csr.values) + 0.1).astype(np.float32),
                     csr.shape, csr.name)


def monster():
    """One 4,000-nnz row among 499 singletons (tests/test_merge.py)."""
    m = 500
    deg = np.ones(m, np.int64)
    deg[7] = 4000
    rng = np.random.default_rng(0)
    nnz = int(deg.sum())
    return CSRMatrix(np.concatenate([[0], np.cumsum(deg)]),
                     rng.integers(0, m, nnz),
                     (rng.random(nnz) + 0.1).astype(np.float32), (m, m),
                     "monster")


def sparse_rows():
    """3000 rows, 2 nnz in every 37th: blocks cut at ROWS_CAP rows."""
    m = 3000
    deg = np.zeros(m, np.int64)
    deg[::37] = 2
    rng = np.random.default_rng(2)
    nnz = int(deg.sum())
    return CSRMatrix(np.concatenate([[0], np.cumsum(deg)]),
                     rng.integers(0, m, nnz),
                     (rng.random(nnz) + 0.1).astype(np.float32), (m, m),
                     "sparse_rows")


def empty_and_dense_rows():
    """13 x 40 (m not a multiple of 8): rows 0, 5 and 6 empty, row 3 full
    (a tail of 37 nnz past its 3 slots), the rest 1-3 nnz."""
    rng = np.random.default_rng(4)
    d = np.zeros((13, 40), np.float32)
    for i in range(13):
        d[i, rng.choice(40, size=1 + i % 3, replace=False)] = rng.random() + 1
    d[[0, 5, 6]] = 0.0
    d[3] = rng.random(40) + 0.5
    return dense_to_csr(d, name="empty_dense")


MATRICES = {
    "generated": lambda: positive(artificial_matrix_generation(
        777, 777, 6, 2.0, "normal", seed=3, placement="random", bw=0.3)),
    "skewed": lambda: positive(artificial_matrix_generation(
        999, 999, 8, 40.0, "gamma", seed=5, placement="random", bw=0.9)),
    "monster": monster,
    "sparse_rows": sparse_rows,
    "empty_dense": empty_and_dense_rows,
}
# block_nnz of each matrix's merge layout: the JAX merge test's 256 for the
# monster row, the default 512 elsewhere
BLOCK_NNZ = {"monster": 256}


@pytest.fixture(scope="module")
def cases():
    """Each matrix with X (k, N), its JAX layouts and the JAX functions'
    outputs, computed once."""
    out = {}
    for name, make in MATRICES.items():
        csr = make()
        x = (np.random.default_rng(7).random((csr.k, N)) + 0.5).astype(
            np.float32)
        mj = jax_merge.DeviceMerge.from_csr(csr, BLOCK_NNZ.get(name, 512))
        c = dict(csr=csr, x=x, merge=mj,
                 merge_y=np.asarray(jax_merge.merge_spmm(mj,
                                                         jnp.asarray(x))))
        for mode in gell.MODES:
            gj = jax_gell.DeviceGELL.from_csr(csr, mode=mode)
            assert gj.win_plan is None      # the port leaves windows out
            c[f"gell_{mode}"] = gj
            c[f"gell_{mode}_y"] = np.asarray(jax_gell.gell_spmm(
                gj, jnp.asarray(x)))
        out[name] = c
    return out


def gold(csr, x):
    return gold_spmm_fast(csr.row_ptr, csr.col_idx, csr.values, x)


@pytest.mark.parametrize("name", MATRICES)
def test_merge_layout_is_the_jax_one(cases, name):
    c = cases[name]
    a = DeviceMerge.from_csr(c["csr"], BLOCK_NNZ.get(name, 512),
                             device="cpu")
    for field in ("cols", "values", "local_rows", "out_rows"):
        want = np.asarray(getattr(c["merge"], field))
        got = getattr(a, field).numpy()
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    assert (a.shape, a.nnz, a.block_nnz) == (
        c["merge"].shape, c["merge"].nnz, c["merge"].block_nnz)
    # each block spans at most ROWS_CAP rows; out_rows clipped to m
    assert int(a.local_rows.max()) < ROWS_CAP
    assert int(a.out_rows.max()) <= c["csr"].m


def test_merge_cuts_blocks_early():
    """The monster row fills whole blocks; the sparse rows' blocks stop
    at 128 rows, well short of 512 nnz."""
    csr = monster()
    a = DeviceMerge.from_csr(csr, 256, device="cpu")
    assert a.cols.shape[0] >= 4000 // 256
    s = sparse_rows()
    b = DeviceMerge.from_csr(s, device="cpu")
    assert b.cols.shape[0] > s.nnz // 512 + 1
    assert int((b.values != 0).sum(1).max()) <= 2 * (-(-ROWS_CAP // 37))


@pytest.mark.parametrize("name", MATRICES)
def test_merge_spmm_matches_jax_and_the_f64_product(cases, name):
    c = cases[name]
    a = DeviceMerge.from_csr(c["csr"], BLOCK_NNZ.get(name, 512),
                             device="cpu")
    got = merge_spmm(a, torch.from_numpy(c["x"]))
    assert got.shape == (c["csr"].m, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), c["merge_y"], rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), gold(c["csr"], c["x"]),
                               rtol=RTOL)
    x = np.ascontiguousarray(c["x"][:, 0])
    np.testing.assert_allclose(merge_spmm(a, torch.from_numpy(x)).numpy(),
                               gold(c["csr"], x), rtol=RTOL)


def test_merge_chunked_path(cases, monkeypatch):
    """A budget of ~4 blocks a chunk on both sides: the same product."""
    c = cases["sparse_rows"]
    a = DeviceMerge.from_csr(c["csr"], device="cpu")
    x = torch.from_numpy(c["x"])
    whole = merge_spmm(a, x)
    budget = 512 * N * 4
    assert merge._CHUNK_BYTES // budget * 4 >= a.cols.shape[0]
    with monkeypatch.context() as jax_side:
        jax_side.setattr(jax_merge, "_CHUNK_BYTES", budget)
        jax_merge._merge_spmm.clear_cache()
        try:
            want = np.asarray(jax_merge.merge_spmm(c["merge"],
                                                   jnp.asarray(c["x"])))
        finally:
            jax_merge._merge_spmm.clear_cache()
    monkeypatch.setattr(merge, "_CHUNK_BYTES", budget)
    chunked = merge_spmm(a, x)
    assert a.cols.shape[0] > 4        # several chunks of 4 blocks
    np.testing.assert_allclose(chunked.numpy(), want, rtol=RTOL)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=RTOL)


@pytest.mark.parametrize("name", MATRICES)
def test_gell_layout_is_the_jax_one(cases, name):
    c = cases[name]
    j = c["gell_f32"]
    a = DeviceGELL.from_csr(c["csr"], device="cpu")
    for field in ("cols", "values", "tail_cols", "tail_vals"):
        want = np.asarray(getattr(j, field))
        got = getattr(a, field).numpy()
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    tail_rows = np.repeat(a.tail_keys.numpy(), np.diff(a.tail_ptr.numpy()))
    np.testing.assert_array_equal(tail_rows, np.asarray(j.tail_rows))
    assert (a.slots, a.shape, a.nnz) == (j.slots, j.shape, j.nnz)
    assert a.cols.shape[0] % 8 == 0 and a.cols.shape[0] - c["csr"].m < 8


def test_gell_tails_hold_what_the_slots_do_not():
    """The skewed matrix and the full row spill into the tail; every nnz is
    in a slot or in the tail once."""
    for make in (MATRICES["skewed"], empty_and_dense_rows):
        csr = make()
        a = DeviceGELL.from_csr(csr, device="cpu")
        assert a.tail_cols.numel() > 0
        assert int((a.values != 0).sum()) + a.tail_cols.numel() == csr.nnz
        assert bool((torch.diff(a.tail_keys) > 0).all())
        assert a.tail_ptr[-1] == a.tail_cols.numel()
        assert bool((torch.diff(a.tail_ptr) > 0).all())


def gate_x(x, mode):
    """The X the mode's gate multiplies, as the harness forms it."""
    fmt = {"f32": "gell", "split16": "gell16", "bf16": "cv_gell"}[mode]
    return harness.gate_x(x, fmt)


@pytest.mark.parametrize("mode", gell.MODES)
@pytest.mark.parametrize("name", MATRICES)
def test_gell_spmm_matches_jax_and_its_gate(cases, name, mode):
    c = cases[name]
    a = DeviceGELL.from_csr(c["csr"], mode=mode, device="cpu")
    got = gell_spmm(a, torch.from_numpy(c["x"]))
    assert got.shape == (c["csr"].m, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), c[f"gell_{mode}_y"], rtol=RTOL)
    want = gold(c["csr"], gate_x(c["x"], mode))
    if mode == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    else:
        assert error_metrics(want, got.numpy(), epsilon=1e-4).passed
        # against X itself, bf16 misses the gate where split16 holds it
        exact = error_metrics(gold(c["csr"], c["x"]), got.numpy(),
                              epsilon=1e-4)
        assert exact.passed == (mode == "split16")


def test_gell_spmv_vector(cases):
    c = cases["skewed"]
    x = np.ascontiguousarray(c["x"][:, 0])
    a = DeviceGELL.from_csr(c["csr"], device="cpu")
    got = gell_spmm(a, torch.from_numpy(x))
    assert got.shape == (c["csr"].m,)
    np.testing.assert_allclose(got.numpy(), gold(c["csr"], x), rtol=RTOL)


@pytest.mark.parametrize("mode", gell.MODES)
def test_gell_chunked_path(cases, mode, monkeypatch):
    """A budget of a few hundred rows a chunk on both sides."""
    c = cases["generated"]
    a = DeviceGELL.from_csr(c["csr"], mode=mode, device="cpu")
    x = torch.from_numpy(c["x"])
    whole = gell_spmm(a, x)
    budget_small = 64 * a.slots * 2 * N * 2
    rows = gell._chunk_rows(a.cols.shape[0], a.slots, N, budget_small)
    assert a.cols.shape[0] > 2 * rows
    real = jax_gell._chunk_rows
    with monkeypatch.context() as jax_side:
        # the JAX budget has a 256 MB floor: its chunk rows are forced
        jax_side.setattr(jax_gell, "_chunk_rows",
                         lambda m_pad, slots, n, mode_, budget=None: real(
                             m_pad, slots, n, mode_, budget=budget_small))
        jax_gell._gell_spmm.clear_cache()
        try:
            want = np.asarray(jax_gell.gell_spmm(c[f"gell_{mode}"],
                                                 jnp.asarray(c["x"])))
        finally:
            jax_gell._gell_spmm.clear_cache()
    monkeypatch.setattr(gell, "_CHUNK_BUDGET", budget_small)
    monkeypatch.setattr(gell, "_MIN_BUDGET", budget_small)
    chunked = gell_spmm(a, x)
    np.testing.assert_allclose(chunked.numpy(), want, rtol=RTOL)
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())


class Intermediates(TorchDispatchMode):
    """Records each op's name and the bytes of the tensor it returns."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor):
            self.made.append((func.overloadpacket.__name__, out.dtype,
                              out.numel() * out.element_size()))
        return out


def float_products(made):
    """The floating tensors that an out-of-place multiply made."""
    return [b for name, dtype, b in made
            if name == "mul" and dtype.is_floating_point]


@pytest.mark.parametrize("mode", gell.MODES)
def test_gell_chunk_holds_its_budget(cases, mode, monkeypatch):
    """A chunk's gathered f32 rows fill the budget and do not pass it, in
    every mode, and the slot values multiply them in place: no second
    intermediate of their size."""
    c = cases["generated"]
    a = DeviceGELL.from_csr(c["csr"], mode=mode, device="cpu")
    budget = 64 * a.slots * N * 4
    assert a.cols.shape[0] > 2 * 64
    monkeypatch.setattr(gell, "_CHUNK_BUDGET", budget)
    monkeypatch.setattr(gell, "_MIN_BUDGET", budget)
    with Intermediates() as seen:
        gell_spmm(a, torch.from_numpy(c["x"]))
    gathers = [b for name, _, b in seen.made if name == "index_select"]
    assert max(gathers) == budget
    assert float_products(seen.made) == []


def test_merge_chunk_holds_its_budget(cases, monkeypatch):
    """A chunk's gathered rows and one-hot weights come to 4 x _CHUNK_BYTES
    at most (here 4 blocks a chunk: N < ROWS_CAP, so the one-hot weights
    set it), the values go into the one-hot weights (no multiply of the
    gathered rows), the chunk's strips and the strip rows its fix-up reads
    each take at most a quarter of its gathered rows, and its row sums the
    chunk's rows of Y: every row once, and the row at each chunk edge
    twice. Over all chunks each strip row a block's nnz reach is read
    once."""
    c = cases["sparse_rows"]
    a = DeviceMerge.from_csr(c["csr"], device="cpu")
    budget = 512 * ROWS_CAP * 4
    monkeypatch.setattr(merge, "_CHUNK_BYTES", budget)
    with Intermediates() as seen:
        merge_spmm(a, torch.from_numpy(c["x"]))
    y_bytes = c["csr"].m * N * 4
    floats = [(name, b) for name, dtype, b in seen.made
              if dtype.is_floating_point and b != y_bytes]
    gathered = 4 * 512 * N * 4
    chunks = -(-a.cols.shape[0] // 4)
    assert chunks > 2
    assert max(b for name, b in floats if name == "zeros") == 4 * budget
    gathers = [b for name, b in floats if name == "index_select"]
    x_rows, fix_rows = gathers[0::2], gathers[1::2]
    assert len(x_rows) == chunks and max(x_rows) == gathered
    assert gathered <= 4 * budget
    assert max(b for name, b in floats if name == "bmm") == gathered // 4
    assert max(fix_rows) <= gathered // 4
    assert sum(fix_rows) == a.fix_rows.numel() * N * 4
    sums = [b for name, b in floats if name == "segment_reduce"]
    assert len(sums) == chunks
    assert sum(sums) == (c["csr"].m + chunks - 1) * N * 4
    assert float_products(seen.made) == []


@pytest.mark.parametrize("name", ["monster", "sparse_rows", "generated"])
def test_merge_runs_cut_by_chunk_edges(cases, name, monkeypatch):
    """Chunks of 4 blocks (8 of the monster's 256-nnz blocks), whose edges
    cut a row's run of strip rows (the monster row spans 16 blocks, cut at
    block 8): each part is summed in its chunk and
    added in chunk order, to the f64 product, and the same bits on a
    second call."""
    c = cases[name]
    a = DeviceMerge.from_csr(c["csr"], BLOCK_NNZ.get(name, 512),
                             device="cpu")
    x = torch.from_numpy(c["x"])
    monkeypatch.setattr(merge, "_CHUNK_BYTES", 512 * ROWS_CAP * 4)
    chunk = 512 // a.block_nnz * 4      # blocks a chunk at N < ROWS_CAP
    edges = a.fix_ptr[chunk:-1:chunk]
    cut = np.isin(edges, a.row_ptr_host, invert=True)
    if name == "monster":
        assert cut.sum() >= 1
    got = merge_spmm(a, x)
    np.testing.assert_allclose(got.numpy(), gold(c["csr"], c["x"]),
                               rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), c["merge_y"], rtol=RTOL)
    assert torch.equal(merge_spmm(a, x), got)


def ties_and_random(seed=9):
    """f32 values halfway between two bf16 neighbours, low word 0x8000
    with even and odd upper halves (they round to the even one), next to
    random values of many magnitudes and signs."""
    rng = np.random.default_rng(seed)
    upper = rng.integers(0x3000, 0x4F00, 512).astype(np.uint32)
    ties = ((upper << 16) | 0x8000).view(np.float32)
    rand = (rng.standard_normal(4096)
            * 10.0 ** rng.integers(-20, 20, 4096)).astype(np.float32)
    return np.concatenate([ties, -ties, rand])


def test_bf16_rounding_is_ml_dtypes():
    v = ties_and_random()
    want = v.astype(ml_dtypes.bfloat16).astype(np.float32)
    got = gell.round_bf16(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    # ties went to the even neighbour: the kept low bit is 0
    t = got[:512].view(np.uint32)
    assert ((t >> 16) & 1 == 0).all() and (t & 0xFFFF == 0).all()
    hi = (v.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    np.testing.assert_array_equal(gell.trunc_bf16(torch.from_numpy(v))
                                  .numpy(), hi)


@pytest.mark.parametrize("fmt", ["gell", "gell16", "cv_gell", "coo"])
def test_gate_x_is_the_jax_harness_transform(fmt):
    x = np.abs(ties_and_random(10)).reshape(-1, 4) + np.float32(0.5)
    np.testing.assert_array_equal(harness.gate_x(x, fmt),
                                  jax_harness._xg_host(x, fmt))
    jax_class = (fmt if fmt in ("cv_gell", "gell16") else "exact")
    assert harness.gold_class(fmt) == jax_class


@pytest.mark.parametrize("fmt", ["merge", "gell", "gell16", "cv_gell"])
def test_run_spmm_gates_each_format_on_its_class(fmt):
    csr = MATRICES["skewed"]()
    config = BenchConfig(num_cols=8, min_time_s=0.0, min_iters=1,
                         warmup_iters=0)
    row = harness.run_spmm(csr, fmt, config, device="cpu")
    assert row["errors_passed"] == 1 and row["kernel"] == fmt
    assert row["fmt_mem_footprint_mb"] > 0
    assert dispatch.JAX_NAME[fmt] == fmt
