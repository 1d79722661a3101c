"""The kernels' plain PyTorch versions (what the wrappers run on the CPU)
against the JAX Pallas kernels in interpret mode, on the same inputs.

Tolerance rtol 1e-5, atol 1e-6: both are f32, summed in another order.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgrid.formats import random_csr
from spgrid.formats.csr import dense_to_csr
from spgrid.gen import create_mask
from spgrid.ops.layouts import DeviceBSR as JaxBSR
from spgrid.ops.pallas.bsr_spmm import bsr_spmm as jax_bsr_spmm
from spgrid.ops.pallas.panel_spmm import DevicePanels as JaxPanels
from spgrid.ops.pallas.panel_spmm import panel_spmm as jax_panel_spmm
from spgrid.ops.pallas.sddmm import bsr_sddmm as jax_bsr_sddmm
from spgrid_torch.ops.kernels import _build, launch_counts
from spgrid_torch.ops.kernels.bsr_spmm import bsr_spmm, bsr_spmm_plain
from spgrid_torch.ops.kernels.panel_spmm import (
    DevicePanels, panel_spmm, panel_spmm_plain,
)
from spgrid_torch.ops.kernels.sddmm import bsr_sddmm, bsr_sddmm_plain
from spgrid_torch.ops.layouts import DeviceBSR

# The suite runs in parallel workers on shared cores: one intra-op thread
# a worker keeps these small CPU tensors from oversubscribing them.
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def with_empty_rows(m, k, seed, empty=slice(8, 24)):
    d = random_csr(m, k, 0.1, seed=seed).to_dense()
    d[empty] = 0.0
    return dense_to_csr(d.astype(np.float32), name="empty_rows")


def operand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


SPMM_CASES = {
    # name: (matrix, bm, n, pad_multiple)
    "small_bm8": (lambda: random_csr(128, 96, 0.1, seed=1), 8, 64, 1),
    "small_bm128": (lambda: random_csr(128, 96, 0.3, seed=2), 128, 64, 1),
    "empty_block_rows_bm8": (lambda: with_empty_rows(100, 150, 3), 8, 70, 1),
    "ragged_k_n_pad_blocks": (lambda: random_csr(130, 150, 0.2, seed=4), 8,
                              70, 4),
    "ragged_bm128_pad": (lambda: random_csr(200, 260, 0.1, seed=5), 128, 33,
                         2),
}


@pytest.mark.parametrize("case", sorted(SPMM_CASES))
def test_bsr_spmm_plain_matches_pallas(case):
    make, bm, n, pad = SPMM_CASES[case]
    csr = make()
    x = operand((csr.k, n), 7)
    want = np.asarray(jax_bsr_spmm(
        JaxBSR.from_csr(csr, bm=bm, bk=128, pad_multiple=pad),
        jnp.asarray(x), interpret=True))
    a = DeviceBSR.from_csr(csr, bm=bm, bk=128, pad_multiple=pad, device="cpu")
    got = bsr_spmm_plain(a, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(bsr_spmm(a, torch.from_numpy(x)).numpy(),
                                  got.numpy())


PANEL_CASES = {
    # name: (matrix, band_rows, n)
    "small_one_band": (lambda: random_csr(128, 96, 0.1, seed=1), 2048, 64),
    "bands64": (lambda: random_csr(300, 200, 0.2, seed=2), 64, 70),
    "empty_band": (lambda: with_empty_rows(300, 200, 3, slice(64, 128)), 64,
                   40),
    "ragged_rows": (lambda: random_csr(100, 260, 0.05, seed=4), 72, 33),
}


@pytest.mark.parametrize("case", sorted(PANEL_CASES))
def test_panel_spmm_plain_matches_pallas(case):
    make, band_rows, n = PANEL_CASES[case]
    csr = make()
    x = operand((csr.k, n), 8)
    want = np.asarray(jax_panel_spmm(
        JaxPanels.from_csr(csr, bk=128, band_rows=band_rows),
        jnp.asarray(x), interpret=True))
    a = DevicePanels.from_csr(csr, bk=128, band_rows=band_rows, device="cpu")
    got = panel_spmm_plain(a, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(panel_spmm(a, torch.from_numpy(x)).numpy(),
                                  got.numpy())


SDDMM_CASES = {
    # name: (mask, bm, d, pad_multiple)
    "mask128_bm8": (lambda: create_mask("band_and_random", 128, 0.8,
                                        band_size=4, seed=14), 8, 64, 1),
    "mask200_bm128_pad": (lambda: create_mask("band_and_random", 200, 0.8,
                                              band_size=4, seed=3), 128, 70,
                          2),
    "ragged_pad_blocks_bm8": (lambda: create_mask("band_and_decay", 150, 0.7,
                                                  band_size=6, seed=5), 8, 40,
                              8),
}


@pytest.mark.parametrize("case", sorted(SDDMM_CASES))
def test_bsr_sddmm_plain_matches_pallas(case):
    make, bm, d, pad = SDDMM_CASES[case]
    mask = make()
    q, k = operand((mask.m, d), 9), operand((mask.k, d), 10)
    want = np.asarray(jax_bsr_sddmm(
        JaxBSR.from_csr(mask, bm=bm, bk=128, pad_multiple=pad),
        jnp.asarray(q), jnp.asarray(k), interpret=True))
    a = DeviceBSR.from_csr(mask, bm=bm, bk=128, pad_multiple=pad,
                           device="cpu")
    got = bsr_sddmm_plain(a, torch.from_numpy(q), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert not got[a.num_blocks:].any(), "pad blocks give zero blocks"
    np.testing.assert_array_equal(
        bsr_sddmm(a, torch.from_numpy(q), torch.from_numpy(k)).numpy(),
        got.numpy())


def test_cpu_path_counts_no_launch():
    csr = random_csr(64, 64, 0.2, seed=1)
    a = DeviceBSR.from_csr(csr, bm=8, bk=128, device="cpu")
    p = DevicePanels.from_csr(csr, device="cpu")
    x = torch.from_numpy(operand((64, 16), 1))
    before = launch_counts()
    bsr_spmm(a, x)
    panel_spmm(p, x)
    bsr_sddmm(a, x, x)
    assert launch_counts() == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    csr = random_csr(64, 48, 0.2, seed=1)
    a = DeviceBSR.from_csr(csr, bm=8, bk=128, device="cpu")
    p = DevicePanels.from_csr(csr, device="cpu")
    x = torch.from_numpy(operand((48, 16), 1))
    q = torch.from_numpy(operand((64, 16), 2))
    if bad == "dtype":
        x, q, err = x.double(), q.double(), TypeError
    elif bad == "shape":
        x, q, err = x[:40], q[:, :8], ValueError
    else:
        x, q, err = x.to("meta"), q.to("meta"), ValueError
    with pytest.raises(err):
        bsr_spmm(a, x)
    with pytest.raises(err):
        panel_spmm(p, x)
    with pytest.raises(err):
        bsr_sddmm(a, q, torch.from_numpy(operand((64, 16), 3)))


def c_entry_points() -> dict:
    """{name: [ctypes type of each parameter]} of every ``extern "C"``
    function of the CUDA sources: pointers as c_void_p, ints as c_int."""
    kinds = {"int": ctypes.c_int, "void*": ctypes.c_void_p}
    found = {}
    for path in _build.sources():
        text = re.sub(r"//[^\n]*", "", path.read_text())
        for name, params in re.findall(
                r'extern "C" \S+ (spgrid_\w+)\(([^)]*)\)', text):
            found[name] = [
                kinds[re.sub(r"\s+", "", re.sub(r"\bconst\b|\w+$", "",
                                                p.strip()))]
                for p in params.split(",")]
    return found


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signatures_match_the_c_entry_points(name):
    """ctypes passes each argument as the library's declared type: a
    pointer passed as an int is cut to 32 bits, a missing argument leaves
    the stream undefined."""
    assert c_entry_points()[name] == _build.SIGNATURES[name]
