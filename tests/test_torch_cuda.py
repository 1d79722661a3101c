"""The CUDA kernels against their plain versions on the card.

Needs a CUDA device with the CUDA toolkit (sm_90a); every test here skips
without one. The file imports nothing of JAX or the JAX package, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: the kernels sum in f32 in another order than the plain version
in f64; with positive operands that stays below 1e-5 relative. The probe
kernels' gathers and shuffle chain are copies and the same f32 additions,
so they match their plain versions bit for bit; the ablation variants
normw and empty add every block's sum to y[0:128] with atomics, in any
order: within 1e-4. The WPACK ablation's pad and roll prefixes make the
same f32 additions in the same order, so they agree bit for bit.
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
from spgrid_torch.ops.kernels.lanegather import lanegather, lanegather_plain
from spgrid_torch.ops.kernels.pallas_gather import (
    dma_gather, dma_gather_plain, shuffle_bench, shuffle_bench_plain,
)
from spgrid_torch.ops.kernels.spmv_ablate import (
    VARIANTS, spmv_ablate, spmv_ablate_plain,
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
from spgrid_torch.scripts import (
    exp_lanegather, exp_pallas_gather, exp_spmv_ablate, exp_wpack_ablate,
)

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


def misaligned(shape, seed, device):
    """A contiguous operand whose data starts 4 bytes past an aligned
    address, so the kernel cannot read it as float4."""
    x = operand((int(np.prod(shape)) + 1,), seed, device)[1:]
    return x.view(shape)


def bsrc_bands():
    return positive(artificial_matrix_generation(
        1024, 1024, 50, 10, "normal", seed=14, placement="random", bw=0.05))


BSRC = {
    # name: (matrix, bm, bk, band_rows, n, x layout)
    "gaps_bm8_short_last_band": (bands_with_gaps, 8, 128, 64, 20, "plain"),
    "one_band_bm128_ragged_n": (
        lambda: positive(random_csr(300, 260, 0.3, seed=2)), 128, 128, 2048,
        33, "plain"),
    "bands_bm128": (bsrc_bands, 128, 128, 256, 40, "plain"),
    "bands_bm128_n1": (bsrc_bands, 128, 128, 256, 1, "plain"),
    "bands_bm128_n33": (bsrc_bands, 128, 128, 256, 33, "plain"),
    "bands_bm128_n70": (bsrc_bands, 128, 128, 256, 70, "plain"),
    # x 4 bytes past 16-byte alignment: staged by 4-byte copies
    "misaligned_x_n64": (bsrc_bands, 128, 128, 256, 64, "misaligned"),
    "misaligned_x_n70": (bsrc_bands, 128, 128, 256, 70, "misaligned"),
    "bm64": (bsrc_bands, 64, 128, 256, 40, "plain"),
    # a bm and bk off the wgmma shape, blocks staged by 4-byte copies
    "bm24_bk100": (lambda: positive(random_csr(300, 260, 0.2, seed=5)), 24,
                   100, 96, 36, "plain"),
    "bm100_bk30": (lambda: positive(random_csr(300, 260, 0.2, seed=6)), 100,
                   30, 200, 12, "plain"),
    "band_4096_rows": (lambda: positive(random_csr(5000, 64, 0.01, seed=1)),
                       128, 128, 4096, 8, "plain"),
    "band_with_no_block": (
        lambda: with_empty_rows(300, 200, 4, slice(128, 256)), 128, 128, 128,
        24, "plain"),
}


@pytest.mark.parametrize("case", sorted(BSRC))
def test_bsr_spmm_cstat_kernel(cuda, case):
    make, bm, bk, band_rows, n, layout = BSRC[case]
    csr = make()
    a = DeviceBSRCol.from_csr(csr, bm=bm, bk=bk, band_rows=band_rows,
                              device=cuda)
    if case == "band_with_no_block":
        assert a.counts[1] == 0
    x = (operand((csr.k, n), 12, cuda) if layout == "plain"
         else misaligned((csr.k, n), 12, cuda))
    before = launch_counts()["bsr_spmm_cstat"]
    got = bsr_spmm_cstat(a, x)
    assert launch_counts()["bsr_spmm_cstat"] == before + 1
    assert_close(got, bsr_spmm_cstat_plain(a, x.double()))


def test_bsr_spmm_cstat_raises_for_what_it_cannot_take(cuda):
    csr = positive(random_csr(600, 64, 0.05, seed=1))
    with pytest.raises(ValueError, match="bm"):
        bsr_spmm_cstat(DeviceBSRCol.from_csr(csr, bm=256, device=cuda),
                       operand((64, 8), 1, cuda))


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


def straddle():
    """1200 x 1000, ~1 % scattered, and target block 2 (rows 256-383) half
    dense: ~64K live slots in one block, across many ranges of slots."""
    rng = np.random.default_rng(30)
    d = np.where(rng.random((1200, 1000)) < 0.01,
                 rng.random((1200, 1000)) + 0.5, 0.0)
    band = rng.random((128, 1000))
    d[256:384] = np.where(band < 0.5, band + 0.5, 0.0)
    return dense_to_csr(d.astype(np.float32), name="straddle")


def empty_blocks():
    """Banded 1000 x 1000 whose target blocks 1 and 2 and ragged last block
    (rows 128-383 and 896-999) hold no nnz."""
    i, j = np.ogrid[:1000, :1000]
    d = np.where(np.abs(i - j) <= 40,
                 np.random.default_rng(31).random((1000, 1000)) + 0.5, 0.0)
    d[128:384] = 0.0
    d[896:] = 0.0
    return dense_to_csr(d.astype(np.float32), name="empty_blocks")


# the live-slot stream kernels (wrow_spmv_v2, wpack_spmv): one CTA a range
# of slots_per_cta live slots, blocks that straddle ranges combined
STREAM_MATRICES = {**SLOT_MATRICES, "straddle": straddle,
                   "empty_blocks": empty_blocks}
SLOTS_PER_CTA = [1, 7, 128, 2048, 1 << 20]


@pytest.mark.parametrize("slots_per_cta", [7, 2048])
@pytest.mark.parametrize("matrix", sorted(STREAM_MATRICES))
def test_wpack_spmv_stream_ranges(cuda, matrix, slots_per_cta):
    csr = STREAM_MATRICES[matrix]()
    a = DeviceWPACK.from_csr(csr, device=cuda)
    x = operand((csr.k,), 16, cuda)
    before = launch_counts()["wpack_spmv"]
    got = wpack_spmv(a, x, slots_per_cta=slots_per_cta)
    assert launch_counts()["wpack_spmv"] == before + 1
    assert_close(got, wpack_spmv_plain(a, x.double()))


@pytest.mark.parametrize("slots_per_cta", SLOTS_PER_CTA)
@pytest.mark.parametrize("matrix", ["straddle", "empty_blocks"])
def test_wpack_spmv_kernel_on_range_edges(cuda, matrix, slots_per_cta):
    csr = STREAM_MATRICES[matrix]()
    for wsel in (1, 4):
        a = DeviceWPACK.from_csr(csr, wsel, device=cuda)
        x = operand((csr.k,), 17, cuda)
        before = launch_counts()["wpack_spmv"]
        got = wpack_spmv(a, x, slots_per_cta=slots_per_cta)
        assert launch_counts()["wpack_spmv"] == before + 1
        assert_close(got, wpack_spmv_plain(a, x.double()))


@pytest.mark.parametrize("slots_per_cta", SLOTS_PER_CTA)
@pytest.mark.parametrize("matrix", sorted(STREAM_MATRICES))
def test_wrow_spmv_v2_kernel(cuda, matrix, slots_per_cta):
    csr = STREAM_MATRICES[matrix]()
    a = DeviceWROW.from_csr(csr, device=cuda)
    x = operand((csr.k,), 15, cuda)
    before = launch_counts()["wrow_spmv_v2"]
    got = wrow_spmv_v2(a, x, slots_per_cta=slots_per_cta)
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


FORMS = exp_lanegather.forms(np.random.default_rng(0))


@pytest.mark.parametrize("form", range(len(FORMS)),
                         ids=[f[0] for f in FORMS])
def test_lanegather_kernel(cuda, form):
    _, src, idx, axis = FORMS[form]
    s, i = torch.from_numpy(src).to(cuda), torch.from_numpy(idx).to(cuda)
    before = launch_counts()["lanegather"]
    got = lanegather(s, i, axis)
    assert launch_counts()["lanegather"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, lanegather_plain(s, i, axis))


def gather_operands(k, n, steps, G, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    idx2 = rng.integers(0, k, (steps, G)).astype(np.int32)
    return x.to(device), torch.from_numpy(idx2).to(device)


@pytest.mark.parametrize("k,n,steps,G,layout", [
    (300, 201, 3, 6, "plain"),          # n % 4 != 0: 4-byte copies
    (1000, 256, 8, 64, "plain"),        # bulk copies, 2 chunks a step
    (2000, 512, 2, 256, "plain"),       # 16 chunks of 16 rows a step
    (1000, 256, 8, 64, "misaligned"),   # x not 16-byte aligned
    (40, 16384, 2, 3, "plain"),         # one 64 KB row a chunk
])
def test_dma_gather_kernel(cuda, k, n, steps, G, layout):
    x, idx2 = gather_operands(k, n, steps, G, 22, cuda)
    if layout == "misaligned":
        x = misaligned((k, n), 22, cuda)
    before = launch_counts()["dma_gather"]
    got = dma_gather(x, idx2, G)
    assert launch_counts()["dma_gather"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, dma_gather_plain(x, idx2))


def test_dma_gather_reads_no_row_outside_x(cuda):
    x, _ = gather_operands(10, 8, 1, 4, 23, cuda)
    idx2 = torch.tensor([[0, 10, -3, 9]], dtype=torch.int32, device=cuda)
    got = dma_gather(x, idx2, 4)
    torch.cuda.synchronize()
    assert torch.equal(got[[0, 3]], x[[0, 9]])
    assert not got[1:3].any()


@pytest.mark.parametrize("rows,reps", [(256, 0), (256, 3), (256, 64),
                                       (256, 256), (7, 11)])
def test_shuffle_bench_kernel(cuda, rows, reps):
    rng = np.random.default_rng(24)
    src = torch.from_numpy(rng.standard_normal((rows, 128)).astype(
        np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, 128, (rows, 128)).astype(
        np.int32)).to(cuda)
    before = launch_counts()["shuffle_bench"]
    got = shuffle_bench(src, idx, reps)
    assert launch_counts()["shuffle_bench"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, shuffle_bench_plain(src, idx, reps))


ABLATE_MATRICES = {
    "probe_1000": lambda: exp_spmv_ablate.ablate_matrix(1000, 20.0, 0.05),
    "m_below_128": lambda: exp_spmv_ablate.ablate_matrix(100, 20.0, 0.5),
    "edge": hypersparse_edge,
}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("matrix", sorted(ABLATE_MATRICES))
def test_spmv_ablate_kernel(cuda, matrix, variant):
    csr = ABLATE_MATRICES[matrix]()
    a = DeviceWROW.from_csr(csr, device=cuda)
    x = operand((csr.k,), 25, cuda)
    before = launch_counts()["spmv_ablate"]
    got = spmv_ablate(a, x, variant)
    assert launch_counts()["spmv_ablate"] == before + 1
    torch.cuda.synchronize()
    tol = 1e-4 if variant in ("normw", "empty") else 1e-5
    torch.testing.assert_close(got.double(),
                               spmv_ablate_plain(a, x.double(), variant),
                               rtol=tol, atol=tol)
    if variant == "full":     # WROW v1's arithmetic in v1's order
        assert torch.equal(got, wrow_spmv(a, x))


def test_probe_wrappers_raise_instead_of_falling_back(cuda):
    x, idx2 = gather_operands(50, 16, 2, 4, 26, cuda)
    a = DeviceWROW.from_csr(hypersparse_edge(), device=cuda)
    lane_idx = torch.zeros((50, 3), dtype=torch.int32, device=cuda)
    calls = [
        (lambda t: lanegather(t, lane_idx, 1), x),
        (lambda t: dma_gather(t, idx2, 4), x),
        (lambda t: spmv_ablate(a, t, "full"), operand((a.shape[1],), 1, cuda)),
    ]
    for fn, t in calls:
        with pytest.raises(TypeError):
            fn(t.double())
        with pytest.raises(ValueError):
            fn(t.cpu())
    src = operand((8, 128), 1, cuda)
    idx = torch.zeros((8, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        shuffle_bench(src.double(), idx, 1)
    with pytest.raises(ValueError):
        shuffle_bench(src, idx.cpu(), 1)


WPACK_ABLATE_MATRICES = {
    "probe_3000": lambda: exp_wpack_ablate.wpack_matrix(3000, 20.0, 0.05),
    "m_below_128": lambda: exp_wpack_ablate.wpack_matrix(100, 20.0, 0.5),
    "edge": hypersparse_edge,
}


@pytest.mark.parametrize("wsel", [1, 2, 4])
@pytest.mark.parametrize("matrix", sorted(WPACK_ABLATE_MATRICES))
@pytest.mark.parametrize("tag", [t for t, _ in exp_wpack_ablate.FORMS[:-1]])
def test_wpack_ablate_kernel(cuda, tag, matrix, wsel):
    knobs = dict(exp_wpack_ablate.FORMS)[tag]
    csr = WPACK_ABLATE_MATRICES[matrix]()
    a = DeviceWPACK.from_csr(csr, wsel, device=cuda)
    x = operand((csr.k,), 27, cuda)
    before = launch_counts()
    got = wpack_spmv(a, x, **knobs)
    after = launch_counts()
    assert after["wpack_ablate"] == before["wpack_ablate"] + 1
    assert after["wpack_spmv"] == before["wpack_spmv"]
    assert_close(got, wpack_spmv_plain(a, x.double(), **knobs))


@pytest.mark.parametrize("matrix", sorted(WPACK_ABLATE_MATRICES))
def test_wpack_pad_and_roll_prefixes_agree_bit_for_bit(cuda, matrix):
    csr = WPACK_ABLATE_MATRICES[matrix]()
    a = DeviceWPACK.from_csr(csr, device=cuda)
    x = operand((csr.k,), 28, cuda)
    for ablate in ("", "nogather"):
        pad = wpack_spmv(a, x, ablate=ablate, prefix="pad")
        roll = wpack_spmv(a, x, ablate=ablate, prefix="roll")
        torch.cuda.synchronize()
        assert torch.equal(pad, roll), ablate
    # the full forms are the product, up to the prefix difference's rounding
    torch.testing.assert_close(wpack_spmv(a, x, prefix="roll"),
                               wpack_spmv(a, x), rtol=1e-5, atol=1e-5)


def test_wpack_ablate_raises_instead_of_falling_back(cuda):
    a = DeviceWPACK.from_csr(hypersparse_edge(), device=cuda)
    x = operand((a.shape[1],), 1, cuda)
    with pytest.raises(TypeError):
        wpack_spmv(a, x.double(), prefix="pad")
    with pytest.raises(ValueError):
        wpack_spmv(a, x.cpu(), prefix="roll")
    with pytest.raises(ValueError, match="nogather"):
        wpack_spmv(a, x, ablate="nogather")


@pytest.mark.parametrize("driver,argv", [
    (exp_spmv_ablate, ["2000", "5", "0.05"]),
    (exp_pallas_gather, ["--k", "3000", "--n", "512", "--steps", "8"]),
    (exp_lanegather, []),
    (exp_wpack_ablate, ["3000", "20", "0.05"]),
])
def test_probe_drivers_run_on_the_card(cuda, driver, argv, capsys):
    assert driver.main(argv) == 0
    out = capsys.readouterr().out
    assert "FAIL" not in out and "False" not in out
