"""WPACK's ablation knobs (``wpack_spmv(a, x, ablate=, prefix=)``) against
the JAX package's ``wpack_spmv(..., interpret=True, ablate=, prefix=)``.

One layout at wsel 2 (a 1500^2 matrix, 35 groups: one grid step of the TPU
kernel), built by the JAX package and carried to the port through
``DeviceWPACK.from_arrays``, so both packages read the same arrays. The JAX
outputs are computed once in a module fixture: each tag compiles its own
interpret-mode kernel (~10-25 s each on these CPUs).

Tolerance: 1e-5 of max |y|. The prefix difference P[end] - (P - p)[start]
rounds with the size of the piece's whole prefix, not of the row's sum,
and the JAX package's own pad and roll forms differ in the last ulp, so
no comparison here is bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgrid.gen import artificial_matrix_generation
from spgrid.ops.pallas import wpack_spmv as jax_wpack
from spgrid_torch.core.metrics import gold_spmm_fast
from spgrid_torch.ops import dispatch
from spgrid_torch.ops.kernels import _build, launch_counts
from spgrid_torch.ops.kernels import wpack_spmv as wpack_mod
from spgrid_torch.ops.kernels.wpack_spmv import (
    DeviceWPACK, wpack_spmv, wpack_spmv_plain,
)
from spgrid_torch.scripts import exp_wpack_ablate

# The suite runs in parallel workers on shared cores: one intra-op thread
# a worker keeps these small CPU tensors from oversubscribing them.
torch.set_num_threads(1)

TOL = 1e-5
# tag -> the JAX wrapper's knobs; the port takes the same names
TAGS = {"noseg": dict(ablate="noseg"),
        "nogather/pad": dict(ablate="nogather", prefix="pad"),
        "nogather/roll": dict(ablate="nogather", prefix="roll"),
        "full/pad": dict(prefix="pad"),
        "full/roll": dict(prefix="roll")}


def matrix():
    return artificial_matrix_generation(1500, 1500, 20, 6.6667, "normal", 14,
                                        "random", 0.05, 0, 0.05, 0.05)


def port_layout(j):
    """The JAX layout's flat arrays as the port's DeviceWPACK."""
    return DeviceWPACK.from_arrays(
        np.asarray(j.cols), np.asarray(j.values), np.asarray(j.ends),
        np.asarray(j.starts), np.asarray(j.sel), np.asarray(j.piece_w),
        np.asarray(j.group_sub), j.shape, j.nnz, j.utilization,
        j.num_groups, j.wsel, j.name, device="cpu")


@pytest.fixture(scope="module")
def jax_tags():
    """(csr, x, the port's layout, {tag: the JAX kernel's output})."""
    csr = matrix()
    j = jax_wpack.DeviceWPACK.from_csr(csr, 2)
    x = (np.random.default_rng(0).random(csr.k) + 0.5).astype(np.float32)
    xj = jnp.asarray(x)
    want = {tag: np.asarray(jax_wpack.wpack_spmv(j, xj, interpret=True,
                                                 **knobs))
            for tag, knobs in TAGS.items()}
    return csr, x, port_layout(j), want


def scaled_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_layout_is_wsel_2_in_one_grid_step(jax_tags):
    csr, _, a, _ = jax_tags
    assert a.wsel == 2 and 0 < a.num_groups <= jax_wpack.GROUPS_PER_STEP
    assert torch.equal(a.cols, DeviceWPACK.from_csr(csr, 2,
                                                    device="cpu").cols)


@pytest.mark.parametrize("tag", sorted(TAGS))
def test_plain_matches_the_jax_tag(jax_tags, tag):
    _, x, a, want = jax_tags
    got = wpack_spmv_plain(a, torch.from_numpy(x), **TAGS[tag]).numpy()
    assert got.shape == want[tag].shape and np.isfinite(got).all()
    assert scaled_err(got, want[tag]) <= TOL
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        wpack_spmv(a, torch.from_numpy(x), **TAGS[tag]).numpy(), got)


@pytest.mark.parametrize("prefix", ["pad", "roll", "direct"])
def test_full_forms_match_the_f64_product(jax_tags, prefix):
    csr, x, a, _ = jax_tags
    gold = gold_spmm_fast(csr.row_ptr, csr.col_idx, csr.values, x)
    got = wpack_spmv(a, torch.from_numpy(x), prefix=prefix).numpy()
    assert scaled_err(got, gold) <= TOL
    # in f64 the prefix difference is the product up to f64 rounding
    exact = wpack_spmv_plain(a, torch.from_numpy(x).double(), prefix=prefix)
    np.testing.assert_allclose(exact.numpy(), gold, rtol=1e-12, atol=1e-12)


def test_wrong_by_design_tags_are_not_the_product(jax_tags):
    csr, x, a, _ = jax_tags
    gold = gold_spmm_fast(csr.row_ptr, csr.col_idx, csr.values, x)
    for tag in ("noseg", "nogather/pad"):
        got = wpack_spmv(a, torch.from_numpy(x), **TAGS[tag]).numpy()
        assert scaled_err(got, gold) > 1e-2, tag


@pytest.mark.parametrize("knobs,match", [
    (dict(ablate="nogather"), "nogather"),
    (dict(ablate="nogather", prefix="direct"), "nogather"),
    (dict(ablate="full"), "ablate"),
    (dict(prefix="shuffle"), "prefix"),
    (dict(ablate="noseg", prefix="scan"), "prefix"),
])
def test_knobs_are_checked(knobs, match):
    csr = matrix()
    a = DeviceWPACK.from_csr(csr, device="cpu")
    x = torch.ones(csr.k)
    with pytest.raises(ValueError, match=match):
        wpack_spmv(a, x, **knobs)
    with pytest.raises(ValueError, match=match):
        wpack_spmv_plain(a, x, **knobs)


def test_knob_variants_cover_every_accepted_pair():
    pairs = {(ab, pr) for ab in wpack_mod.ABLATE for pr in wpack_mod.PREFIX
             if (ab, pr) not in (("", "direct"), ("nogather", "direct"))}
    assert set(wpack_mod.VARIANTS) == pairs
    assert set(wpack_mod.VARIANTS.values()) == set(range(5))
    assert "spgrid_wpack_ablate" in _build.SIGNATURES
    assert "wpack_ablate" in launch_counts()


def test_dispatch_format_passes_no_knob(monkeypatch):
    seen = []
    real = wpack_mod.wpack_spmv_plain

    def spy(a, x, **knobs):
        seen.append(knobs)
        return real(a, x, **knobs)

    monkeypatch.setattr(wpack_mod, "wpack_spmv_plain", spy)
    csr = matrix()
    a = dispatch.build(csr, "wpack_spmv_cuda", device="cpu")
    x = torch.from_numpy(
        np.random.default_rng(1).random((csr.k, 1)).astype(np.float32))
    before = launch_counts()
    dispatch.spmm_fn("wpack_spmv_cuda")(a, x)
    assert seen == [dict(ablate="", prefix="direct")]
    assert launch_counts() == before


def test_pad_rows_past_m_are_dropped():
    # m = 200: the second target block holds rows 128-255, of which 56 lie
    # past m; noseg and nogather add at every lane of a block
    csr = artificial_matrix_generation(200, 300, 20, 6.6667, "normal", 14,
                                       "random", 0.5, 0, 0.05, 0.05)
    a = DeviceWPACK.from_csr(csr, device="cpu")
    x = torch.from_numpy(np.ones(csr.k, np.float32))
    for knobs in TAGS.values():
        assert wpack_spmv(a, x, **knobs).shape == (200,)


def test_driver_on_cpu(capsys):
    code = exp_wpack_ablate.main(["2000", "20", "0.05", "--platform", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert code == 0
    assert out[0].startswith("m=2000 nnz=")
    assert out[1].startswith("wrow v1") and "max_rel~" in out[1]
    assert out[2].startswith("wpack: util ") and " wsel " in out[2]
    tags = [ln.split()[0] for ln in out[3:]]
    assert tags == [t for t, _ in exp_wpack_ablate.FORMS]
    assert all("ns/group" in ln and " GF " in ln for ln in out[3:])
    assert sum("max_rel~" in ln for ln in out[3:]) == 3
    assert "FAIL" not in "\n".join(out)


def test_driver_exits_nonzero_when_a_full_form_misses(capsys, monkeypatch):
    real = exp_wpack_ablate.wpack_spmv

    def off(a, x, **knobs):
        y = real(a, x, **knobs)
        return y * 1.001 if knobs.get("prefix") == "roll" else y

    monkeypatch.setattr(exp_wpack_ablate, "wpack_spmv", off)
    code = exp_wpack_ablate.main(["1000", "20", "0.05", "--platform", "cpu"])
    out = capsys.readouterr()
    assert code == 1
    assert "full/roll" in out.err and out.out.count(" FAIL") == 1


def test_driver_exits_nonzero_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert exp_wpack_ablate.main([]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "--platform cpu" in out.err


def test_driver_matrix_is_the_jax_scripts():
    # scripts/exp_wpack_ablate.py's call at a smaller m
    want = artificial_matrix_generation(
        3000, 3000, 20, round(20 / 3, 4), "normal", 14, "random", 0.05, 0,
        0.05, 0.05)
    got = exp_wpack_ablate.wpack_matrix(3000, 20.0, 0.05)
    for f in ("row_ptr", "col_idx", "values"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_from_arrays_keeps_the_jax_arrays(jax_tags):
    csr, _, a, _ = jax_tags
    b = DeviceWPACK.from_csr(csr, 2, device="cpu")
    for f in dataclasses.fields(b):
        g, w = getattr(a, f.name), getattr(b, f.name)
        if isinstance(w, torch.Tensor):
            assert torch.equal(g, w), f.name
