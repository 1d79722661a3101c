"""The CUDA kernels against their plain versions on the card.

Needs a CUDA device with the CUDA toolkit (sm_90a); every test here skips
without one. The file imports nothing of JAX or the JAX package, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: the kernels sum in f32 in another order than the plain version
in f64; with positive operands that stays below 1e-5 relative.
"""

import numpy as np
import pytest
import torch

from spgrid_torch.entry import hypersparse_edge
from spgrid_torch.formats.csr import CSRMatrix, dense_to_csr, random_csr
from spgrid_torch.gen import artificial_matrix_generation, create_mask
from spgrid_torch.ops.kernels import launch_counts
from spgrid_torch.ops.kernels.bsr_spmm import bsr_spmm, bsr_spmm_plain
from spgrid_torch.ops.kernels.bsr_spmm_cstat import (
    DeviceBSRCol, bsr_spmm_cstat, bsr_spmm_cstat_plain,
)
from spgrid_torch.ops.kernels.dgell import (
    DeviceDGELL, dgell_spmm, dgell_spmm_plain,
)
from spgrid_torch.ops.kernels.panel_spmm import (
    DevicePanels, panel_spmm, panel_spmm_plain,
)
from spgrid_torch.ops.kernels.sddmm import bsr_sddmm, bsr_sddmm_plain
from spgrid_torch.ops.kernels.wcoo_spmm import (
    DeviceWCOO, wcoo_spmm, wcoo_spmm_plain,
)
from spgrid_torch.ops.kernels.wcoo_spmm_aligned import (
    DeviceWCOOBands, wcoo_spmm_aligned, wcoo_spmm_aligned_plain,
)
from spgrid_torch.ops.kernels.wcoo_spmv import (
    DeviceWCOOAligned, wcoo_spmv, wcoo_spmv_plain,
)
from spgrid_torch.ops.kernels.wpack_spmv import (
    DeviceWPACK, wpack_spmv, wpack_spmv_plain,
)
from spgrid_torch.ops.kernels.wrow_spmv import (
    DeviceWROW, wrow_spmv, wrow_spmv_plain, wrow_spmv_v2,
)
from spgrid_torch.ops.layouts import DeviceBSR

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    return torch.device("cuda")


def positive(csr):
    return CSRMatrix(csr.row_ptr, csr.col_idx,
                     (np.abs(csr.values) + 0.1).astype(np.float32),
                     csr.shape, csr.name)


def with_empty_rows(m, k, seed, empty=slice(8, 24)):
    d = positive(random_csr(m, k, 0.1, seed=seed)).to_dense()
    d[empty] = 0.0
    return dense_to_csr(d.astype(np.float32), name="empty_rows")


def operand(shape, seed, device):
    x = np.random.default_rng(seed).random(shape) + 0.5
    return torch.from_numpy(x.astype(np.float32)).to(device)


def assert_close(got, want):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


SPMM = {
    "bm8": (lambda: positive(random_csr(128, 96, 0.1, seed=1)), 8, 64, 1),
    "bm128": (lambda: positive(random_csr(300, 260, 0.3, seed=2)), 128, 70, 1),
    "empty_block_rows_pad": (lambda: with_empty_rows(100, 150, 3), 8, 70, 4),
    "ragged": (lambda: positive(random_csr(70, 33, 0.3, seed=4)), 16, 5, 1),
}


@pytest.mark.parametrize("case", sorted(SPMM))
def test_bsr_spmm_kernel(cuda, case):
    make, bm, n, pad = SPMM[case]
    csr = make()
    a = DeviceBSR.from_csr(csr, bm=bm, bk=128, pad_multiple=pad, device=cuda)
    x = operand((csr.k, n), 5, cuda)
    before = launch_counts()["bsr_spmm"]
    got = bsr_spmm(a, x)
    assert launch_counts()["bsr_spmm"] == before + 1
    assert_close(got, bsr_spmm_plain(a, x.double()))


@pytest.mark.parametrize("case", ["one_band", "bands64", "empty_band"])
def test_panel_spmm_kernel(cuda, case):
    csr, band_rows = {
        "one_band": (positive(random_csr(300, 260, 0.3, seed=2)), 2048),
        "bands64": (positive(random_csr(200, 150, 0.1, seed=3)), 64),
        "empty_band": (with_empty_rows(300, 200, 4, slice(64, 128)), 64),
    }[case]
    a = DevicePanels.from_csr(csr, bk=128, band_rows=band_rows, device=cuda)
    x = operand((csr.k, 70), 6, cuda)
    before = launch_counts()["panel_spmm"]
    got = panel_spmm(a, x)
    assert launch_counts()["panel_spmm"] == before + 1
    assert_close(got, panel_spmm_plain(a, x.double()))


@pytest.mark.parametrize("bm,pad", [(8, 8), (128, 2)])
def test_bsr_sddmm_kernel(cuda, bm, pad):
    mask = create_mask("band_and_random", 200, 0.8, band_size=4, seed=14)
    a = DeviceBSR.from_csr(mask, bm=bm, bk=128, pad_multiple=pad, device=cuda)
    q, k = operand((200, 70), 7, cuda), operand((200, 70), 8, cuda)
    before = launch_counts()["bsr_sddmm"]
    got = bsr_sddmm(a, q, k)
    assert launch_counts()["bsr_sddmm"] == before + 1
    assert_close(got, bsr_sddmm_plain(a, q.double(), k.double()))


def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    a = DeviceBSR.from_csr(random_csr(64, 48, 0.2, seed=1), bm=8, bk=128,
                           device=cuda)
    with pytest.raises(TypeError):
        bsr_spmm(a, operand((48, 16), 1, cuda).double())
    with pytest.raises(ValueError):
        bsr_spmm(a, operand((48, 16), 1, "cpu"))


SLOT_MATRICES = {
    "edge": hypersparse_edge,
    "hypersparse": lambda: artificial_matrix_generation(
        5000, 6000, 5, 1.6667, "normal", seed=14, placement="random",
        bw=0.05, name="hyper"),
}
SLOT_SPMM = {
    "wcoo_spmm": (lambda c, d: DeviceWCOO.from_csr(c, R=256, device=d),
                  wcoo_spmm, wcoo_spmm_plain),
    "wcoo_spmm_aligned": (
        lambda c, d: DeviceWCOOBands.from_csr(c, band_rows=256, device=d),
        wcoo_spmm_aligned, wcoo_spmm_aligned_plain),
}
SLOT_SPMV = {
    "wcoo_spmv": (lambda c, d: DeviceWCOOAligned.from_csr(c, device=d),
                  wcoo_spmv, wcoo_spmv_plain),
    "wrow_spmv": (lambda c, d: DeviceWROW.from_csr(c, device=d), wrow_spmv,
                  wrow_spmv_plain),
}


@pytest.mark.parametrize("n", [1, 70])
@pytest.mark.parametrize("matrix", sorted(SLOT_MATRICES))
@pytest.mark.parametrize("kernel", sorted(SLOT_SPMM))
def test_slot_spmm_kernel(cuda, kernel, matrix, n):
    layout, fn, plain = SLOT_SPMM[kernel]
    csr = SLOT_MATRICES[matrix]()
    a = layout(csr, cuda)
    x = operand((csr.k, n), 9, cuda)
    before = launch_counts()[kernel]
    got = fn(a, x)
    assert launch_counts()[kernel] == before + 1
    assert_close(got, plain(a, x.double()))


@pytest.mark.parametrize("matrix", sorted(SLOT_MATRICES))
@pytest.mark.parametrize("kernel", sorted(SLOT_SPMV))
def test_slot_spmv_kernel(cuda, kernel, matrix):
    layout, fn, plain = SLOT_SPMV[kernel]
    csr = SLOT_MATRICES[matrix]()
    a = layout(csr, cuda)
    x = operand((csr.k,), 10, cuda)
    before = launch_counts()[kernel]
    got = fn(a, x)
    assert launch_counts()[kernel] == before + 1
    assert_close(got, plain(a, x.double()))


def test_slot_wrappers_raise_instead_of_falling_back(cuda):
    csr = hypersparse_edge()
    for kernel, (layout, fn, _) in {**SLOT_SPMM, **SLOT_SPMV}.items():
        a = layout(csr, cuda)
        shape = (csr.k,) if kernel in SLOT_SPMV else (csr.k, 8)
        with pytest.raises(TypeError):
            fn(a, operand(shape, 1, cuda).double())
        with pytest.raises(ValueError):
            fn(a, operand(shape, 1, "cpu"))


def bands_with_gaps():
    d = positive(random_csr(300, 260, 0.1, seed=2)).to_dense()
    d[64:128] = 0.0
    return dense_to_csr(d.astype(np.float32), name="bands_with_gaps")


BSRC = {
    # name: (matrix, bm, band_rows, n)
    "gaps_bm8_short_last_band": (bands_with_gaps, 8, 64, 20),
    "one_band_bm128_ragged_n": (
        lambda: positive(random_csr(300, 260, 0.3, seed=2)), 128, 2048, 33),
    "bands_bm128": (lambda: positive(artificial_matrix_generation(
        1024, 1024, 50, 10, "normal", seed=14, placement="random", bw=0.05)),
        128, 256, 40),
}


@pytest.mark.parametrize("case", sorted(BSRC))
def test_bsr_spmm_cstat_kernel(cuda, case):
    make, bm, band_rows, n = BSRC[case]
    csr = make()
    a = DeviceBSRCol.from_csr(csr, bm=bm, bk=128, band_rows=band_rows,
                              device=cuda)
    x = operand((csr.k, n), 12, cuda)
    before = launch_counts()["bsr_spmm_cstat"]
    got = bsr_spmm_cstat(a, x)
    assert launch_counts()["bsr_spmm_cstat"] == before + 1
    assert_close(got, bsr_spmm_cstat_plain(a, x.double()))


def test_bsr_spmm_cstat_raises_for_what_it_cannot_take(cuda):
    csr = positive(random_csr(600, 64, 0.05, seed=1))
    with pytest.raises(ValueError, match="bm"):
        bsr_spmm_cstat(DeviceBSRCol.from_csr(csr, bm=256, device=cuda),
                       operand((64, 8), 1, cuda))
    # a 4096-row slab of 16 columns is more shared memory than a CTA has
    big = DeviceBSRCol.from_csr(positive(random_csr(5000, 64, 0.01, seed=1)),
                                band_rows=4096, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        bsr_spmm_cstat(big, operand((64, 8), 1, cuda))


def misaligned(shape, seed, device):
    """A contiguous operand whose data starts 4 bytes past an aligned
    address, so the kernel cannot read it as float4."""
    x = operand((int(np.prod(shape)) + 1,), seed, device)[1:]
    return x.view(shape)


@pytest.mark.parametrize("n,layout", [(1, "plain"), (64, "plain"),
                                      (70, "plain"), (64, "misaligned")])
@pytest.mark.parametrize("matrix", sorted(SLOT_MATRICES))
def test_dgell_kernel(cuda, matrix, n, layout):
    csr = SLOT_MATRICES[matrix]()
    a = DeviceDGELL.from_csr(csr, device=cuda)
    assert a.tail_rows.numel() > 0
    x = (operand((csr.k, n), 13, cuda) if layout == "plain"
         else misaligned((csr.k, n), 13, cuda))
    before = launch_counts()["dgell"]
    got = dgell_spmm(a, x)
    assert launch_counts()["dgell"] == before + 1
    assert_close(got, dgell_spmm_plain(a, x.double()))


@pytest.mark.parametrize("wsel", [None, 1, 2, 4])
@pytest.mark.parametrize("matrix", sorted(SLOT_MATRICES))
def test_wpack_spmv_kernel(cuda, matrix, wsel):
    csr = SLOT_MATRICES[matrix]()
    a = DeviceWPACK.from_csr(csr, wsel, device=cuda)
    x = operand((csr.k,), 14, cuda)
    before = launch_counts()["wpack_spmv"]
    got = wpack_spmv(a, x)
    assert launch_counts()["wpack_spmv"] == before + 1
    assert_close(got, wpack_spmv_plain(a, x.double()))


@pytest.mark.parametrize("groups_per_cta", [1, 3, 32, 1 << 20])
@pytest.mark.parametrize("matrix", sorted(SLOT_MATRICES))
def test_wrow_spmv_v2_kernel(cuda, matrix, groups_per_cta):
    csr = SLOT_MATRICES[matrix]()
    a = DeviceWROW.from_csr(csr, device=cuda)
    x = operand((csr.k,), 15, cuda)
    before = launch_counts()["wrow_spmv_v2"]
    got = wrow_spmv_v2(a, x, groups_per_cta=groups_per_cta)
    assert launch_counts()["wrow_spmv_v2"] == before + 1
    assert_close(got, wrow_spmv_plain(a, x.double()))
    torch.testing.assert_close(wrow_spmv(a, x, variant="v2"),
                               wrow_spmv(a, x), rtol=1e-5, atol=1e-5)


def test_new_wrappers_raise_instead_of_falling_back(cuda):
    csr = hypersparse_edge()
    cases = [
        (DeviceBSRCol.from_csr(csr, device=cuda), bsr_spmm_cstat,
         (csr.k, 8)),
        (DeviceDGELL.from_csr(csr, device=cuda), dgell_spmm, (csr.k, 8)),
        (DeviceWPACK.from_csr(csr, device=cuda), wpack_spmv, (csr.k,)),
        (DeviceWROW.from_csr(csr, device=cuda), wrow_spmv_v2, (csr.k,)),
    ]
    for a, fn, shape in cases:
        with pytest.raises(TypeError):
            fn(a, operand(shape, 1, cuda).double())
        with pytest.raises(ValueError):
            fn(a, operand(shape, 1, "cpu"))
