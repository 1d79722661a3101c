"""The CUDA kernels against their plain versions on the card.

Needs a CUDA device with the CUDA toolkit (sm_90a); every test here skips
without one. The file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: the kernels sum in f32 in another order than the plain version
in f64; with positive operands that stays below 1e-5 relative.
"""

import numpy as np
import pytest
import torch

from spgrid.formats import random_csr
from spgrid.formats.csr import CSRMatrix, dense_to_csr
from spgrid.gen import create_mask
from spgrid_torch.ops.kernels import launch_counts
from spgrid_torch.ops.kernels.bsr_spmm import bsr_spmm, bsr_spmm_plain
from spgrid_torch.ops.kernels.panel_spmm import (
    DevicePanels, panel_spmm, panel_spmm_plain,
)
from spgrid_torch.ops.kernels.sddmm import bsr_sddmm, bsr_sddmm_plain
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
