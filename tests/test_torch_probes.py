"""The probe kernels and drivers of the port against the JAX package's TPU
probes under ``scripts/`` (``exp_spmv_ablate.py``, ``exp_pallas_gather.py``,
``exp_lanegather.py``), loaded with importlib: the scripts are not a
package. Their Pallas kernels run in interpret mode on the CPU, once per
module in fixtures (interpret mode compiles for seconds).

Tolerance: the gathers and the shuffle chain are copies and the same f32
additions, so they must match bit for bit; the ablation variants match the
JAX probe within rtol 1e-5 (f32 sums in another order, positive operands,
so no sum cancels below its terms' rounding).
"""

import functools
import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spgrid.ops.pallas import wrow_spmv as jax_wrow
from spgrid_torch.ops import convert
from spgrid_torch.ops.kernels import _build, _wrappers, launch_counts
from spgrid_torch.ops.kernels.lanegather import (
    lanegather, lanegather_plain, walk_plain,
)
from spgrid_torch.ops.kernels.pallas_gather import (
    MAX_N, dma_gather, dma_gather_plain, shuffle_bench, shuffle_bench_plain,
)
from spgrid_torch.ops.kernels.spmv_ablate import (
    VARIANTS, spmv_ablate, spmv_ablate_plain, spmv_ablate_rows_plain,
)
from spgrid_torch.ops.kernels.wrow_spmv import DeviceWROW, wrow_spmv
from spgrid_torch.scripts import (
    exp_lanegather, exp_pallas_gather, exp_spmv_ablate, sm_clock_mhz, timed,
)

# The suite runs in parallel workers on shared cores: one intra-op thread
# a worker keeps these small CPU tensors from oversubscribing them.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
ABLATE_M = 1000     # x2 of the JAX probe has exactly 8 rows: noload reads
                    # x indices 1000..1023, past k


def load_script(name):
    """``scripts/<name>.py`` as a module (it may put "." on sys.path)."""
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        f"jax_probe_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


def positive_vector(k, seed):
    return (np.random.default_rng(seed).random(k) + 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def jax_ablate():
    """The JAX probe's matrix at m = 1000 (its own generator call), its
    DeviceWROW's leaves, x, and each ``_spmv_variant``'s y (m,)."""
    mod = load_script("exp_spmv_ablate")
    m, avg, bw = ABLATE_M, 20.0, 0.05
    csr = mod.artificial_matrix_generation(m, m, avg, avg / 3, "normal",
                                           seed=14, placement="random",
                                           bw=bw)
    ja = jax_wrow.DeviceWROW.from_csr(csr)
    x = positive_vector(m, 6)
    k2 = m2 = -(-m // mod.LANE)
    x2 = jnp.zeros((k2 * mod.LANE,), jnp.float32).at[:m].set(
        jnp.asarray(x)).reshape(k2, mod.LANE)
    ys = {v: np.asarray(mod._spmv_variant(
        ja.piece_w, ja.group_sub, ja.cols, ja.values, x2, m2=m2,
        variant=v)).reshape(-1)[:m] for v in VARIANTS}
    leaves, aux = ja.tree_flatten()
    return (csr, [np.asarray(c) for c in leaves], list(aux), x, ys,
            mod.VARIANTS)


def test_ablation_variants_are_the_jax_probes(jax_ablate):
    *_, jax_variants = jax_ablate
    assert VARIANTS == jax_variants


def test_ablate_matrix_is_the_jax_probes(jax_ablate):
    csr = jax_ablate[0]
    port = exp_spmv_ablate.ablate_matrix(ABLATE_M, 20.0, 0.05)
    for f in ("row_ptr", "col_idx", "values"):
        np.testing.assert_array_equal(getattr(port, f), getattr(csr, f))
    assert port.shape == csr.shape


@pytest.mark.parametrize("variant", VARIANTS)
def test_spmv_ablate_matches_the_jax_probe(jax_ablate, variant):
    csr, leaves, aux, x, ys, _ = jax_ablate
    a = convert.wrow_from_jax(*leaves, *aux, device="cpu")
    xt = torch.from_numpy(x)
    got = spmv_ablate(a, xt, variant)
    assert got.dtype == torch.float32 and got.shape == (ABLATE_M,)
    np.testing.assert_allclose(got.numpy(), ys[variant], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(
        spmv_ablate_plain(a, xt.double(), variant).numpy(), ys[variant],
        rtol=RTOL, atol=ATOL)
    # the port's own layout of the same matrix gives the same y
    own = DeviceWROW.from_csr(csr, device="cpu")
    np.testing.assert_array_equal(spmv_ablate(own, xt, variant).numpy(),
                                  got.numpy())


def test_full_variant_is_wrow_v1_and_noload_reads_past_k(jax_ablate):
    csr, leaves, aux, x, ys, _ = jax_ablate
    a = convert.wrow_from_jax(*leaves, *aux, device="cpu")
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(spmv_ablate(a, xt, "full").numpy(),
                               wrow_spmv(a, xt).numpy(), rtol=RTOL,
                               atol=ATOL)
    live = a.values != 0
    r = torch.arange(a.cols.shape[0]) % 8
    assert ((r[:, None] * 128 + a.cols.long() >= csr.shape[1]) & live).any()


def numpy_ablation(a, x, variant):
    """The variant table of the JAX probe, slot by slot in f64."""
    m, k = a.shape
    y = np.zeros(m)
    cols, vals = a.cols.numpy().astype(np.int64), a.values.numpy()
    pw, gsub = a.piece_w.numpy(), a.group_sub.numpy()
    for p in range(cols.shape[0]):
        b, r = gsub[p // 8], p % 8
        for t in range(128):
            v = float(vals[p, t])
            xi = {"nogather": 128 * pw[p] + t,
                  "noload": 128 * r + cols[p, t]}.get(
                      variant, 128 * pw[p] + cols[p, t])
            add = v if variant == "empty" else v * (x[xi] if xi < k else 0.0)
            row = t if variant in ("normw", "empty") else 128 * b + t
            if row < m:
                y[row] += add
    return y


@pytest.mark.parametrize("variant", VARIANTS)
def test_spmv_ablate_with_fewer_than_128_rows(variant):
    csr = exp_spmv_ablate.ablate_matrix(100, 8.0, 0.5)
    a = DeviceWROW.from_csr(csr, device="cpu")
    x = positive_vector(100, 7)
    np.testing.assert_allclose(
        spmv_ablate(a, torch.from_numpy(x), variant).numpy(),
        numpy_ablation(a, x.astype(np.float64), variant), rtol=RTOL,
        atol=ATOL)


def stream_layout(jax_ablate, source):
    """The ablation's layouts: the JAX probe's (through its leaves) at
    m = 1000, and the port's own at m = 100, below one target block."""
    if source == "jax_1000":
        _, leaves, aux, *_ = jax_ablate
        return convert.wrow_from_jax(*leaves, *aux, device="cpu")
    return DeviceWROW.from_csr(exp_spmv_ablate.ablate_matrix(100, 8.0, 0.5),
                               device="cpu")


@pytest.mark.parametrize("source", ["jax_1000", "own_100"])
def test_row_piece_is_each_slots_place_in_its_group(jax_ablate, source):
    a = stream_layout(jax_ablate, source)
    m, k = a.shape
    values, cols = a.values.numpy(), a.cols.numpy().astype(np.uint8)
    xi = a.piece_w.numpy()[:, None] * 128 + cols
    piece, lane = np.nonzero((values != 0) & (xi < k))
    row = a.group_sub.numpy().astype(np.int64)[piece // 8] * 128 + lane
    order = np.lexsort((piece, row))      # the stream: by row, then piece
    assert a.row_piece.dtype == torch.uint8
    np.testing.assert_array_equal(a.row_piece.numpy(), piece[order] % 8)
    np.testing.assert_array_equal(a.row_cols.numpy(), xi[piece, lane][order])


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("source", ["jax_1000", "own_100"])
def test_row_stream_ablation_is_the_variant_table(jax_ablate, source,
                                                  variant):
    """The variant table over the row stream that the kernel reads (with
    its piece byte) is the table over the padded pieces, slot by slot; on
    the JAX probe's layout it is the JAX probe's output."""
    a = stream_layout(jax_ablate, source)
    m = a.shape[0]
    x = positive_vector(a.shape[1], 8) if source == "own_100" else \
        jax_ablate[3]
    want = numpy_ablation(a, x.astype(np.float64), variant)
    got = spmv_ablate_rows_plain(a, torch.from_numpy(x).double(), variant)
    assert got.dtype == torch.float64 and got.shape == (m,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    got32 = spmv_ablate_rows_plain(a, torch.from_numpy(x), variant)
    np.testing.assert_allclose(got32.numpy(), want, rtol=RTOL, atol=ATOL)
    if source == "jax_1000":
        np.testing.assert_allclose(got32.numpy(), jax_ablate[4][variant],
                                   rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def jax_gather():
    """The JAX probe's shuffle_bench (3 steps) and dma_gather (X (1000,
    256), idx (8, 64), G = 64) in interpret mode, with their inputs."""
    mod = load_script("exp_pallas_gather")
    rng = np.random.default_rng(5)
    src = rng.standard_normal((256, 128)).astype(np.float32)
    idx = rng.integers(0, 128, (256, 128)).astype(np.int32)
    x = rng.standard_normal((1000, 256)).astype(np.float32)
    idx2 = rng.integers(0, 1000, (8, 64)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        shuf = jax.jit(mod.shuffle_bench(3))(jnp.asarray(src),
                                             jnp.asarray(idx))
        rows = jax.jit(functools.partial(mod.dma_gather, G=64, n=256))(
            jnp.asarray(x), jnp.asarray(idx2))
    return src, idx, np.asarray(shuf), x, idx2, np.asarray(rows)


def test_shuffle_bench_matches_the_jax_probe_bit_for_bit(jax_gather):
    src, idx, want, *_ = jax_gather
    got = shuffle_bench(torch.from_numpy(src), torch.from_numpy(idx), 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dma_gather_matches_the_jax_probe_bit_for_bit(jax_gather):
    *_, x, idx2, want = jax_gather
    got = dma_gather(torch.from_numpy(x), torch.from_numpy(idx2), 64)
    assert got.shape == (8 * 64, 256)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, x[idx2.reshape(-1)])


@pytest.fixture(scope="module")
def jax_forms():
    """Each form of the JAX lane-gather probe as its ``main`` ran it in
    interpret mode: (name, inputs, output), in order."""
    mod = load_script("exp_lanegather")
    ran = []
    compile_form = mod.try_compile

    def record(name, kernel, out_shape, inputs):
        r = compile_form(name, kernel, out_shape, inputs)
        ran.append((name, [np.asarray(i) for i in inputs],
                    None if r is None else np.asarray(r)))
        return r

    mod.try_compile = record
    with pltpu.force_tpu_interpret_mode():
        mod.main()
    return ran


def test_lanegather_forms_match_the_jax_probe_bit_for_bit(jax_forms):
    forms = exp_lanegather.forms(np.random.default_rng(0))
    assert len(forms) == len(jax_forms) == 6
    for (name, src, idx, axis), (jname, inputs, want) in zip(forms,
                                                             jax_forms):
        assert want is not None, jname
        np.testing.assert_array_equal(src, inputs[0])
        if jname.startswith("stack"):   # idx row 0 picks the 8 rows
            np.testing.assert_array_equal(idx[:, 0], inputs[1][0, :8])
            assert (idx == idx[:, :1]).all()
        else:
            assert name == jname
            np.testing.assert_array_equal(idx, inputs[1])
        got = lanegather(torch.from_numpy(src), torch.from_numpy(idx), axis)
        np.testing.assert_array_equal(got.numpy(), want)


LANE_FORMS = exp_lanegather.forms(np.random.default_rng(0))


# staged tiles of rows (axis 1) or columns (axis 0): the kernel's own
# tile on each probe form (``card_plan``: 8, 2, 1 and 8 rows, 8 columns)
# is among them, and a ragged last tile shows at 3 rows and 12 columns
TILES = {1: (1, 2, 3, 8), 0: (4, 8, 12, 32)}


@pytest.mark.parametrize("walk", ["direct", 0, 1, 2, 3], ids=[
    "direct", "staged_tile0", "staged_tile1", "staged_tile2",
    "staged_tile3"])
@pytest.mark.parametrize("form", range(len(LANE_FORMS)),
                         ids=[f[0] for f in LANE_FORMS])
def test_lanegather_walks_are_take_along_axis(form, walk):
    """Each path's walk (the staged one CTA tile by tile) on each probe
    form gives np.take_along_axis exactly."""
    _, src, idx, axis = LANE_FORMS[form]
    tile = 0 if walk == "direct" else TILES[axis][walk]
    got = walk_plain(torch.from_numpy(src), torch.from_numpy(idx), axis,
                     tile)
    np.testing.assert_array_equal(got.numpy(),
                                  np.take_along_axis(src, idx, axis))


@pytest.mark.parametrize("walk", ["direct", 0, 3], ids=[
    "direct", "staged_tile0", "staged_tile3"])
@pytest.mark.parametrize("shape", [((300, 100), (300, 36), 1),
                                   ((200, 84), (5, 84), 0),
                                   ((70, 13), (6, 13), 0)])
def test_lanegather_walks_read_zero_outside_src(shape, walk):
    """Ragged last tiles, and indices outside src read as 0."""
    (s0, s1), ishape, axis = shape
    rng = np.random.default_rng(41)
    src = rng.standard_normal((s0, s1)).astype(np.float32)
    high = (s0, s1)[axis]
    idx = rng.integers(-3, high + 3, ishape).astype(np.int32)
    inside = (idx >= 0) & (idx < high)
    want = np.where(inside, np.take_along_axis(src, np.where(inside, idx, 0),
                                               axis), 0.0)
    tile = 0 if walk == "direct" else TILES[axis][walk]
    got = walk_plain(torch.from_numpy(src), torch.from_numpy(idx), axis,
                     tile)
    np.testing.assert_array_equal(got.numpy(), want)


def run_driver(capsys, main, argv):
    code = main(argv + ["--platform", "cpu"])
    return code, capsys.readouterr()


def test_ablate_driver_on_cpu(capsys):
    code, out = run_driver(capsys, exp_spmv_ablate.main, ["800", "5", "0.1"])
    assert code == 0
    lines = out.out.splitlines()
    assert lines[0].startswith("m=800 nnz=") and "max_rel~" in lines[0]
    assert [ln.split()[0] for ln in lines[1:]] == list(VARIANTS)
    assert all("ns/group" in ln for ln in lines[1:])


def test_gather_driver_on_cpu(capsys):
    code, out = run_driver(capsys, exp_pallas_gather.main,
                           ["--k", "500", "--n", "12", "--steps", "3"])
    assert code == 0
    text = out.out
    assert text.startswith("index_select ")
    assert text.count("exact=True") == 4 and "False" not in text
    assert "dma-gather G=64" in text and "dma-gather G=256" in text
    assert "per shuffle+add (256,128):" in text and "cycles" not in text


def test_gather_driver_selectors(capsys):
    code, out = run_driver(capsys, exp_pallas_gather.main,
                           ["dma", "--k", "300", "--n", "8", "--steps", "2"])
    assert code == 0
    assert "index_select" not in out.out and "shuffle" not in out.out
    with pytest.raises(SystemExit):
        exp_pallas_gather.main(["gell", "--platform", "cpu"])


def test_lanegather_driver_on_cpu(capsys):
    code, out = run_driver(capsys, exp_lanegather.main, [])
    assert code == 0
    assert out.out.count(" OK\n") == 6
    assert out.out.count("correct: True") == 6


def test_lanegather_driver_never_swallows_a_failure(capsys, monkeypatch):
    real = exp_lanegather.lanegather

    def flaky(src, idx, axis):
        if axis == 0:
            raise RuntimeError("no such gather")
        out = real(src, idx, axis)
        return out + (src.shape[1] == 512)    # wrong at (8, 512)

    monkeypatch.setattr(exp_lanegather, "lanegather", flaky)
    code, out = run_driver(capsys, exp_lanegather.main, [])
    assert code == 1
    assert out.out.count("FAIL RuntimeError: no such gather") == 2
    assert out.out.count("correct: False") == 1


@pytest.mark.parametrize("main,argv", [
    (exp_spmv_ablate.main, []), (exp_pallas_gather.main, []),
    (exp_lanegather.main, [])])
def test_drivers_exit_nonzero_without_a_card(monkeypatch, capsys, main,
                                             argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(argv) != 0
    out = capsys.readouterr()
    assert out.out == "" and "--platform cpu" in out.err


def test_modules_run_as_scripts():
    import subprocess
    proc = subprocess.run(
        [sys.executable, "-m", "spgrid_torch.scripts.exp_lanegather",
         "--platform", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("correct: True") == 6


def test_timed_and_clock():
    median, spread = timed(torch.add, torch.ones(4), 1.0, device="cpu")
    assert median > 0 and spread >= 0
    clock = sm_clock_mhz()
    assert clock is None or clock > 0


def test_probe_kernels_are_registered():
    assert {"lanegather", "dma_gather", "shuffle_bench",
            "spmv_ablate"} <= set(_wrappers())
    assert {"spgrid_lanegather", "spgrid_dma_gather", "spgrid_shuffle_bench",
            "spgrid_spmv_ablate"} <= set(_build.SIGNATURES)
    assert {"lanegather.cu", "pallas_gather.cu", "spmv_ablate.cu"} <= {
        p.name for p in _build.sources()}


def test_cpu_path_counts_no_launch():
    before = launch_counts()
    x = torch.ones(20, 8)
    lanegather(x, torch.zeros((20, 3), dtype=torch.int32), 1)
    dma_gather(x, torch.zeros((2, 4), dtype=torch.int32), 4)
    shuffle_bench(torch.ones(2, 128), torch.zeros((2, 128),
                                                  dtype=torch.int32), 2)
    a = DeviceWROW.from_csr(exp_spmv_ablate.ablate_matrix(100, 8.0, 0.5),
                            device="cpu")
    spmv_ablate(a, torch.ones(100), "normw")
    assert launch_counts() == before


def test_gather_plain_versions_are_the_library_calls():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((30, 7)).astype(np.float32))
    idx2 = torch.from_numpy(rng.integers(0, 30, (3, 5)).astype(np.int32))
    assert torch.equal(dma_gather_plain(x, idx2), x[idx2.reshape(-1).long()])
    src = torch.from_numpy(rng.standard_normal((4, 128)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 128, (4, 128)).astype(np.int32))
    want = src.numpy()
    for _ in range(5):
        want = np.take_along_axis(want, idx.numpy(), 1) + np.float32(1.0)
    assert np.array_equal(shuffle_bench_plain(src, idx, 5).numpy(), want)
    assert torch.equal(shuffle_bench_plain(src, idx, 0), src)
    assert torch.equal(lanegather_plain(src, idx[:, :3], 1),
                       torch.from_numpy(np.take_along_axis(
                           src.numpy(), idx[:, :3].numpy(), 1)))


def i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


LANEGATHER_BAD = {
    "axis": (lambda: (torch.ones(4, 8), i32(4, 2), 2), ValueError),
    "ndim": (lambda: (torch.ones(4, 8, 1), i32(4, 2), 1), ValueError),
    "rows": (lambda: (torch.ones(4, 8), i32(3, 2), 1), ValueError),
    "cols": (lambda: (torch.ones(4, 8), i32(3, 2), 0), ValueError),
    "dtype": (lambda: (torch.ones(4, 8).double(), i32(4, 2), 1), TypeError),
    "idx_dtype": (lambda: (torch.ones(4, 8), i32(4, 2).long(), 1),
                  TypeError),
    "strided": (lambda: (torch.ones(8, 4).t(), i32(4, 2), 1), ValueError),
    "device": (lambda: (torch.ones(4, 8, device="meta"),
                        i32(4, 2).to("meta"), 1), ValueError),
}


@pytest.mark.parametrize("bad", sorted(LANEGATHER_BAD))
def test_lanegather_refuses_what_the_kernel_does_not_take(bad):
    make, err = LANEGATHER_BAD[bad]
    with pytest.raises(err):
        lanegather(*make())


DMA_BAD = {
    "G": (lambda: (torch.ones(10, 8), i32(2, 4), 3), ValueError),
    "G0": (lambda: (torch.ones(10, 8), i32(2, 0), 0), ValueError),
    "wide": (lambda: (torch.ones(2, MAX_N + 1), i32(1, 2), 2), ValueError),
    "empty_x": (lambda: (torch.ones(0, 8), i32(1, 2), 2), ValueError),
    "dtype": (lambda: (torch.ones(10, 8).double(), i32(2, 4), 4), TypeError),
    "idx_dtype": (lambda: (torch.ones(10, 8), i32(2, 4).long(), 4),
                  TypeError),
    "ndim": (lambda: (torch.ones(10, 8), i32(8), 8), ValueError),
    "device": (lambda: (torch.ones(10, 8, device="meta"),
                        i32(2, 4).to("meta"), 4), ValueError),
}


@pytest.mark.parametrize("bad", sorted(DMA_BAD))
def test_dma_gather_refuses_what_the_kernel_does_not_take(bad):
    make, err = DMA_BAD[bad]
    with pytest.raises(err):
        dma_gather(*make())


SHUFFLE_BAD = {
    "width": (lambda: (torch.ones(4, 64), i32(4, 64), 1), ValueError),
    "shape": (lambda: (torch.ones(4, 128), i32(3, 128), 1), ValueError),
    "reps": (lambda: (torch.ones(4, 128), i32(4, 128), -1), ValueError),
    "dtype": (lambda: (torch.ones(4, 128).double(), i32(4, 128), 1),
              TypeError),
    "device": (lambda: (torch.ones(4, 128, device="meta"),
                        i32(4, 128).to("meta"), 1), ValueError),
}


@pytest.mark.parametrize("bad", sorted(SHUFFLE_BAD))
def test_shuffle_bench_refuses_what_the_kernel_does_not_take(bad):
    make, err = SHUFFLE_BAD[bad]
    with pytest.raises(err):
        shuffle_bench(*make())


@pytest.mark.parametrize("bad", ["variant", "dtype", "shape", "device"])
def test_spmv_ablate_refuses_what_the_kernel_does_not_take(bad):
    a = DeviceWROW.from_csr(exp_spmv_ablate.ablate_matrix(100, 8.0, 0.5),
                            device="cpu")
    x, variant, err = {
        "variant": (torch.ones(100), "nostore", ValueError),
        "dtype": (torch.ones(100).double(), "full", TypeError),
        "shape": (torch.ones(99), "full", ValueError),
        "device": (torch.ones(100, device="meta"), "full", ValueError),
    }[bad]
    with pytest.raises(err):
        spmv_ablate(a, x, variant)


def test_widest_row_fits_the_ring():
    """The widest row the wrapper takes (MAX_N floats) fits the kernel's
    ring of two stages of one row, and its 4-byte path's stage: the limits
    as csrc/pallas_gather.cu states them."""
    text = (_build.CSRC / "pallas_gather.cu").read_text()

    def const(name):
        expr = re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)
        return eval(expr, {"__builtins__": {}})     # digits, * and -

    assert 2 * 4 * MAX_N <= const("MAX_RING_BYTES") <= 227 * 1024
    assert 4 * MAX_N <= 2 * const("STAGE_BYTES")
    assert const("MAX_STAGES") >= 2 and const("MAX_RING_ROWS") == 32


def ring_schedule(total, R, S, grid):
    """The bulk kernel's schedule, replayed in order for each CTA: chunk i
    of CTA b is chunk b + i * grid of the output, loaded into stage i % S
    (S at first, then chunk i - 1 + S after chunk i's store, once chunk
    i - 1's store has read its stage: all but the newest bulk group),
    awaited in phase (i / S) & 1. Returns the output rows each store
    wrote, in order, and raises on a stage refilled under a store that
    may still read it or a wait on a phase the stage never reached."""
    chunks = -(-total // R)
    stores = []
    for b in range(min(grid, chunks)):
        mine = (chunks - 1 - b) // grid + 1
        stage_chunk, phases, pending = {}, [0] * S, []

        def load(i):
            s = i % S
            if s in stage_chunk:              # the previous occupant
                assert stage_chunk[s] not in pending, "refill under a store"
            stage_chunk[s] = i
            phases[s] += 1

        for i in range(min(S, mine)):
            load(i)
        for i in range(mine):
            s = i % S
            assert stage_chunk[s] == i and phases[s] == i // S + 1
            assert (phases[s] - 1) & 1 == (i // S) & 1
            r0 = (b + i * grid) * R
            stores.append(range(r0, min(r0 + R, total)))
            pending.append(i)
            if i >= 1 and i - 1 + S < mine:
                del pending[:-1]              # wait_group.read 1
                load(i - 1 + S)
    return stores


@pytest.mark.parametrize("total,R,S,grid", [
    (24576, 16, 6, 132), (24576, 8, 2, 924), (98304, 16, 6, 132),
    (6, 32, 6, 3), (37 * 64, 1, 3, 7), (1000, 32, 8, 5), (17, 4, 2, 64)])
def test_ring_schedule_writes_each_row_once(total, R, S, grid):
    written = np.zeros(total, np.int64)
    for rows in ring_schedule(total, R, S, grid):
        written[rows.start:rows.stop] += 1
    assert np.all(written == 1)


def register_chain(src, idx, reps):
    """The shuffle_bench kernel's chain, emulated in numpy: element t + 32q
    of a row in register q of lane t; a step shuffles every register from
    the source lane (idx & 31), selects register idx >> 5, reads 0 for an
    index outside the row, and adds 1.0."""
    rows = src.shape[0]
    R = src.astype(np.float32).reshape(rows, 4, 32)         # [row, q, t]
    ix = idx.reshape(rows, 4, 32)
    ok = (ix >= 0) & (ix < 128)
    lane = np.broadcast_to((ix & 31)[:, :, None, :], (rows, 4, 4, 32))
    reg = np.where(ok, ix >> 5, 0)[:, :, None, :]
    for _ in range(reps):
        # s[row, q, q2, t]: register q2 of lane (idx & 31) for element q
        s = np.take_along_axis(np.broadcast_to(R[:, None], lane.shape),
                               lane, axis=3)
        g = np.take_along_axis(s, reg, axis=2)[:, :, 0]
        R = np.where(ok, g, np.float32(0)) + np.float32(1.0)
    return R.reshape(rows, 128)


@pytest.mark.parametrize("case", ["in_row", "past_the_row"])
def test_shuffle_chain_emulation_is_the_plain_chain(case):
    rng = np.random.default_rng(31)
    src = rng.standard_normal((9, 128)).astype(np.float32)
    idx = rng.integers(0, 128, (9, 128)).astype(np.int32)
    if case == "in_row":
        want = shuffle_bench_plain(torch.from_numpy(src),
                                   torch.from_numpy(idx), 7).numpy()
    else:
        idx[rng.random(idx.shape) < 0.05] = 128
        idx[0, :3] = (-1, 130, 1000)
        ok = (idx >= 0) & (idx < 128)
        want = src
        for _ in range(7):
            want = np.where(ok, np.take_along_axis(want, np.clip(idx, 0, 127),
                                                   1), np.float32(0)) \
                + np.float32(1.0)
    got = register_chain(src, idx, 7)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
