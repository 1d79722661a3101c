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

import dataclasses
import functools

import numpy as np
import pytest
import torch

from spgrid_torch.bench.headline import headline_matrix
from spgrid_torch.entry import hypersparse_edge
from spgrid_torch.formats.csr import CSRMatrix, dense_to_csr, random_csr
from spgrid_torch.gen import artificial_matrix_generation, create_mask
from spgrid_torch.ops.kernels import launch_counts
from spgrid_torch.ops.kernels.bsr_spmm import (
    bsr_spmm, bsr_spmm_bf16x3_plain, bsr_spmm_plain,
)
from spgrid_torch.ops.kernels.bsr_spmm import launch as bsr_launch
from spgrid_torch.ops.kernels.bsr_spmm import x3_launch as bsr_x3_launch
from spgrid_torch.ops.kernels.bsr_spmm_cstat import (
    DeviceBSRCol, bsr_spmm_cstat, bsr_spmm_cstat_bf16x3_plain,
    bsr_spmm_cstat_plain,
)
from spgrid_torch.ops.kernels.bsr_spmm_cstat import (
    launch_grid as bsrc_launch_grid,
)
from spgrid_torch.ops.kernels.dgell import (
    DeviceDGELL, dgell_arrays, dgell_rows_plain, dgell_spmm,
    dgell_spmm_plain, launch, launch_plan, launch_shape,
)
from spgrid_torch.ops.kernels import lanegather as lanegather_module
from spgrid_torch.ops.kernels.lanegather import (
    DIRECT, STAGED, lanegather, lanegather_plain, walk_plain,
)
from spgrid_torch.ops.kernels import pallas_gather
from spgrid_torch.ops.kernels.pallas_gather import (
    MAX_N, dma_gather, dma_gather_plain, ring_shape, shuffle_bench,
    shuffle_bench_plain,
)
from spgrid_torch.ops.kernels.spmv_ablate import (
    VARIANTS, spmv_ablate, spmv_ablate_plain, spmv_ablate_rows_plain,
)
from spgrid_torch.ops.kernels.panel_spmm import (
    DevicePanels, panel_spmm, panel_spmm_bf16, panel_spmm_bf16x3_plain,
    panel_spmm_plain,
)
from spgrid_torch.ops.kernels.panel_spmm import launch as panel_launch
from spgrid_torch.ops.kernels.panel_spmm import (
    x3_launch as panel_x3_launch,
)
from spgrid_torch.ops.kernels.panel_spmm import (
    x3_shape as panel_x3_shape, x3_split_launch as panel_x3_split,
)
from spgrid_torch.ops.kernels.bf16x3 import plane_cols
from spgrid_torch.ops.kernels.bsr_spmm import x3_shape as bsr_x3_shape
from spgrid_torch.ops.kernels.bsr_spmm_cstat import (
    x3_shape as bsrc_x3_shape,
)
from spgrid_torch.ops.kernels.sddmm import (
    bf16_shape, bsr_sddmm, bsr_sddmm_bf16x3_plain, bsr_sddmm_plain,
    plane_shape, split_launch, split_planes, split_planes_plain, x3_shape,
)
from spgrid_torch.ops.kernels.sddmm import launch as sddmm_launch
from spgrid_torch.ops.kernels.wcoo_spmm import (
    DeviceWCOO, wcoo_spmm, wcoo_spmm_plain,
)
from spgrid_torch.ops.kernels import wcoo_spmm_aligned as bands_module
from spgrid_torch.ops.kernels.wcoo_spmm_aligned import (
    DeviceWCOOBands, wcoo_spmm_aligned, wcoo_spmm_aligned_plain,
)
from spgrid_torch.ops.kernels import wcoo_spmv as wcoo_spmv_module
from spgrid_torch.ops.kernels.wcoo_spmv import (
    TILE_CHOICES, DeviceWCOOAligned, wcoo_spmv, wcoo_spmv_plain,
    wcoo_spmv_rows_plain,
)
from spgrid_torch.ops.kernels import wpack_spmv as wpack_module
from spgrid_torch.ops.kernels.wpack_spmv import (
    GROUPS_PER_CTA, DeviceWPACK, launch_prefix_bf16, wpack_spmv,
    wpack_spmv_plain,
)
from spgrid_torch.ops.kernels.wrow_spmv import (
    DeviceWROW, wrow_spmv, wrow_spmv_plain, wrow_spmv_v2,
)
from spgrid_torch.ops.layouts import DeviceBSR
from spgrid_torch.ops.sddmm_plan import CANDIDATES
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


def misaligned(shape, seed, device):
    """A contiguous operand whose data starts 4 bytes past an aligned
    address, so the kernel cannot read it as float4."""
    x = operand((int(np.prod(shape)) + 1,), seed, device)[1:]
    return x.view(shape)


# the block kernels' tensor-core tile (csrc/block_mma.cuh): bm below one
# warpgroup (8, 16), one and two warpgroups (64, 128), slices of 128 rows
# (200); empty block rows, pad blocks, ragged m and k
SPMM = {
    "bm8": (lambda: positive(random_csr(128, 96, 0.1, seed=1)), 8, 1),
    "bm16_ragged": (lambda: positive(random_csr(70, 33, 0.3, seed=4)), 16, 1),
    "bm64": (lambda: positive(random_csr(300, 260, 0.3, seed=2)), 64, 1),
    "bm128": (lambda: positive(random_csr(300, 260, 0.3, seed=2)), 128, 1),
    "bm200_slices": (lambda: positive(random_csr(500, 300, 0.2, seed=6)),
                     200, 3),
    "empty_block_rows_pad": (lambda: with_empty_rows(100, 150, 3), 8, 4),
}


@pytest.mark.parametrize("x_layout", ["aligned", "misaligned"])
@pytest.mark.parametrize("n", [1, 77, 200, 512])
@pytest.mark.parametrize("case", sorted(SPMM))
def test_bsr_spmm_kernel(cuda, case, n, x_layout):
    make, bm, pad = SPMM[case]
    csr = make()
    a = DeviceBSR.from_csr(csr, bm=bm, bk=128, pad_multiple=pad, device=cuda)
    x = (operand((csr.k, n), 5, cuda) if x_layout == "aligned"
         else misaligned((csr.k, n), 5, cuda))
    before = launch_counts()["bsr_spmm"]
    got = bsr_spmm(a, x)
    assert launch_counts()["bsr_spmm"] == before + 1
    assert_close(got, bsr_spmm_plain(a, x.double()))


def test_bsr_spmm_kernel_4096(cuda):
    csr = positive(random_csr(4096, 4096, 0.05, seed=7))
    a = DeviceBSR.from_csr(csr, bm=128, bk=128, device=cuda)
    x = operand((csr.k, 512), 5, cuda)
    assert_close(bsr_spmm(a, x), bsr_spmm_plain(a, x.double()))


def tall_bands():
    """2500 x 300: two bands of the default R = 2048 (16 row slices each,
    the second ragged), the second without block column 2 (a pad slot),
    rows 208-311 empty."""
    d = positive(random_csr(2500, 300, 0.05, seed=11)).to_dense()
    d[208:312] = 0.0
    d[2048:, 256:] = 0.0
    return dense_to_csr(d.astype(np.float32), name="tall_bands")


# the panel kernel on the same tile: R = 300 (three slices, the last of
# 44 rows), bands of 64 and 104 rows (pad slots, an empty band), R = 40
# (one warpgroup), R = 2048 (16 slices)
PANELS = {
    "one_band": (lambda: positive(random_csr(300, 260, 0.3, seed=2)), 2048),
    "bands64": (lambda: positive(random_csr(200, 150, 0.1, seed=3)), 64),
    "empty_band": (lambda: with_empty_rows(300, 200, 4, slice(64, 128)), 64),
    "r40": (lambda: positive(random_csr(40, 300, 0.2, seed=12)), 2048),
    "r104": (tall_bands, 104),
    "r2048": (tall_bands, 2048),
}


@pytest.mark.parametrize("x_layout", ["aligned", "misaligned"])
@pytest.mark.parametrize("n", [1, 70, 512])
@pytest.mark.parametrize("case", sorted(PANELS))
def test_panel_spmm_kernel(cuda, case, n, x_layout):
    make, band_rows = PANELS[case]
    csr = make()
    a = DevicePanels.from_csr(csr, bk=128, band_rows=band_rows, device=cuda)
    x = (operand if x_layout == "aligned" else misaligned)((csr.k, n), 6,
                                                           cuda)
    before = launch_counts()["panel_spmm"]
    got = panel_spmm(a, x)
    assert launch_counts()["panel_spmm"] == before + 1
    assert_close(got, panel_spmm_plain(a, x.double()))


def test_panel_spmm_kernel_4096(cuda):
    # the default R = 2048: two bands of 16 slices, 32 panels each
    csr = positive(random_csr(4096, 4096, 0.05, seed=7))
    a = DevicePanels.from_csr(csr, bk=128, device=cuda)
    x = operand((csr.k, 512), 5, cuda)
    assert_close(panel_spmm(a, x), panel_spmm_plain(a, x.double()))


@pytest.mark.parametrize("x_layout", ["aligned", "misaligned"])
@pytest.mark.parametrize("n", [1, 70, 512])
@pytest.mark.parametrize("case", sorted(PANELS))
def test_panel_spmm_bf16_kernel(cuda, case, n, x_layout):
    """The bf16 form (cv_panel) against its plain version in f64 on the
    same bf16 panels and bf16-rounded X."""
    make, band_rows = PANELS[case]
    csr = make()
    a = DevicePanels.from_csr(csr, bk=128, band_rows=band_rows,
                              device=cuda).as_bf16()
    x = (operand if x_layout == "aligned" else misaligned)((csr.k, n), 6,
                                                           cuda)
    before = launch_counts()
    got = panel_spmm(a, x)
    after = launch_counts()
    assert after["panel_spmm_bf16"] == before["panel_spmm_bf16"] + 1
    assert after["panel_spmm"] == before["panel_spmm"]
    assert_close(got, panel_spmm_plain(a, x.double()))


def line_matrix(line):
    from spgrid_torch.gen import GenParams
    return artificial_matrix_generation(**GenParams.from_line(line).kwargs())


# chip_smoke.py's phase-1 shapes of the bf16 form: the headline twin, LINE_B,
# a banded edge with empty rows, and the 4096^2 larger case
PANEL_BF16_SHAPES = {
    "headline": (headline_matrix, 512),
    "line_b": (lambda: line_matrix(
        "8192 8192 50 10 normal random 0.05 0 0.05 0.05 14"), 512),
    "banded_edge": (lambda: with_empty_rows(1000, 1000, 3), 200),
    "4096": (lambda: positive(random_csr(4096, 4096, 0.5, seed=7)), 512),
}


@pytest.mark.parametrize("shape", sorted(PANEL_BF16_SHAPES))
def test_panel_spmm_bf16_at_the_smoke_shapes(cuda, shape):
    make, n = PANEL_BF16_SHAPES[shape]
    csr = make()
    a = DevicePanels.from_csr(csr, bk=128, device=cuda).as_bf16()
    x = operand((csr.k, n), 8, cuda)
    got = panel_spmm_bf16(a, x)
    assert_close(got, panel_spmm_plain(a, x.double()))
    assert torch.equal(panel_spmm_bf16(a, x), got)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["one_band", "r104", "r2048"])
def test_panel_spmm_bf16_at_every_cluster_size(cuda, case, cluster):
    make, band_rows = PANELS[case]
    csr = make()
    a = DevicePanels.from_csr(csr, bk=128, band_rows=band_rows,
                              device=cuda).as_bf16()
    x = operand((csr.k, 70), 9, cuda)
    y = torch.full((csr.m, 70), float("nan"), device=cuda)
    panel_launch(a, x, y, cluster)
    assert_close(y, panel_spmm_plain(a, x.double()))


def dead_slice():
    """300 x 260 in one band of 304 rows (slices of 128, 128 and 48 rows),
    rows 128-255 empty: the middle slice of a band with panels has no live
    slot, and the last slice's live slots are some of the band's."""
    d = positive(random_csr(300, 260, 0.3, seed=13)).to_dense()
    d[128:256] = 0.0
    d[256:, :128] = 0.0
    return dense_to_csr(d.astype(np.float32), name="dead_slice")


@pytest.mark.parametrize("cluster", [0, 1, 2, 4, 8])
def test_panel_spmm_bf16_writes_zeros_where_a_slice_has_no_live_slot(
        cuda, cluster):
    csr = dead_slice()
    a = DevicePanels.from_csr(csr, bk=128, device=cuda).as_bf16()
    ptr = a.slice_ptr.tolist()
    assert a.counts.tolist() == [3] and ptr == [0, 3, 3, 5]
    x = operand((csr.k, 70), 10, cuda)
    y = torch.full((csr.m, 70), float("nan"), device=cuda)
    panel_launch(a, x, y, cluster)
    assert_close(y, panel_spmm_plain(a, x.double()))
    assert torch.equal(y[128:256], torch.zeros_like(y[128:256]))


# bk = 96: a slot's second step is 32 deep; bk = 100: rows of 200 bytes,
# so the panels come in by 2-byte loads
@pytest.mark.parametrize("x_layout", ["aligned", "misaligned"])
@pytest.mark.parametrize("n", [1, 70, 512])
@pytest.mark.parametrize("bk", [96, 100])
@pytest.mark.parametrize("case", ["one_band", "r104", "empty_band"])
def test_panel_spmm_bf16_at_depths_other_than_the_step(cuda, case, bk, n,
                                                       x_layout):
    make, band_rows = PANELS[case]
    csr = make()
    a = DevicePanels.from_csr(csr, bk=bk, band_rows=band_rows,
                              device=cuda).as_bf16()
    x = (operand if x_layout == "aligned" else misaligned)((csr.k, n), 11,
                                                           cuda)
    assert_close(panel_spmm_bf16(a, x), panel_spmm_plain(a, x.double()))


@functools.lru_cache(maxsize=1)
def line_b_bf16_panels():
    csr = PANEL_BF16_SHAPES["line_b"][0]()
    return csr, DevicePanels.from_csr(csr, bk=128, device="cuda").as_bf16()


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_panel_spmm_bf16_line_b_at_every_cluster_size(cuda, cluster):
    """LINE_B (four bands of 2048 rows, 316 live (panel, slice) pairs of
    1,216) at each cluster size, against the plain version in f64."""
    csr, a = line_b_bf16_panels()
    x = operand((csr.k, 512), 12, cuda)
    y = torch.full((csr.m, 512), float("nan"), device=cuda)
    panel_launch(a, x, y, cluster)
    assert_close(y, panel_spmm_plain(a, x.double()))


@pytest.mark.parametrize("qk_layout", ["aligned", "misaligned"])
@pytest.mark.parametrize("d", [1, 8, 70, 512])
@pytest.mark.parametrize("bm", [8, 16, 64, 128, 200])
def test_bsr_sddmm_kernel(cuda, bm, d, qk_layout):
    # the 200^2 mask is ragged against every bm and bk = 128; pad blocks
    # (pad_multiple 4) give zero blocks
    mask = create_mask("band_and_random", 200, 0.8, band_size=4, seed=14)
    a = DeviceBSR.from_csr(mask, bm=bm, bk=128, pad_multiple=4, device=cuda)
    make = operand if qk_layout == "aligned" else misaligned
    q, k = make((200, d), 7, cuda), make((200, d), 8, cuda)
    before = launch_counts()["bsr_sddmm"]
    got = bsr_sddmm(a, q, k)
    assert launch_counts()["bsr_sddmm"] == before + 1
    assert_close(got, bsr_sddmm_plain(a, q.double(), k.double()))


def test_bsr_sddmm_kernel_4096(cuda):
    mask = create_mask("band_and_random", 4096, 0.95, seed=14)
    a = DeviceBSR.from_csr(mask, bm=128, bk=128, device=cuda)
    q, k = operand((4096, 512), 7, cuda), operand((4096, 512), 8, cuda)
    assert_close(bsr_sddmm(a, q, k), bsr_sddmm_plain(a, q.double(),
                                                     k.double()))


def pad_one_block(csr, bm, bk, device):
    """``csr``'s DeviceBSR at (bm, bk) with exactly one pad block (block
    row mb) after its stored blocks."""
    nb = DeviceBSR.from_csr(csr, bm=bm, bk=bk, device="cpu").num_blocks
    a = DeviceBSR.from_csr(csr, bm=bm, bk=bk, pad_multiple=nb + 1,
                           device=device)
    assert a.blocks.shape[0] == a.num_blocks + 1
    return a


@pytest.mark.parametrize("d", [70, 512])
@pytest.mark.parametrize("bm,bk", CANDIDATES)
def test_bsr_sddmm_at_every_planner_blocking(cuda, bm, bk, d):
    """The planner's blockings on a 1000 x 700 mask (no blocking divides mq
    or mk; bm = 256 is two 128-row slices a block) with a pad block row,
    random Q and K: within 1e-5 of the f64 plain version, the pad block
    zero, and the same bits on two calls."""
    mask = positive(random_csr(1000, 700, 0.02, seed=31))
    a = pad_one_block(mask, bm, bk, cuda)
    q, k = operand((1000, d), 32, cuda), operand((700, d), 33, cuda)
    got = bsr_sddmm(a, q, k)
    assert_close(got, bsr_sddmm_plain(a, q.double(), k.double()))
    assert not got[a.num_blocks:].any()
    assert torch.equal(bsr_sddmm(a, q, k), got)


@pytest.mark.parametrize("bm,bk", CANDIDATES)
def test_bsr_sddmm_4096_decay_at_every_planner_blocking(cuda, bm, bk):
    """The study's ragged mask: 4096^2 band_and_decay at sparsity 0.95,
    whose far-band blocks are empty, at d = 512."""
    mask = create_mask("band_and_decay", 4096, 0.95, seed=14)
    a = DeviceBSR.from_csr(mask, bm=bm, bk=bk, device=cuda)
    q, k = operand((4096, 512), 34, cuda), operand((4096, 512), 35, cuda)
    assert_close(bsr_sddmm(a, q, k), bsr_sddmm_plain(a, q.double(),
                                                     k.double()))


def test_sddmm_coo_holds_its_chunk_budget(cuda, monkeypatch):
    """A 2048^2 mask at sparsity 0.5 (4.2M nnz) at d = 64 would gather 2.1
    GB of Q and K rows unchunked; at a 64 MB budget a call's peak stays
    within the budget, its output and the chunk's row indices. Its values
    are the CPU's, and two calls give the same bits."""
    from spgrid_torch.ops import xla
    from spgrid_torch.ops.layouts import DeviceCOO
    mask = create_mask("band_and_random", 2048, 0.5, seed=14)
    q, k = operand((2048, 64), 42, cuda), operand((2048, 64), 43, cuda)
    coo = DeviceCOO.from_csr(mask, device=cuda)
    budget = 64 << 20
    monkeypatch.setattr(xla, "SDDMM_CHUNK_BYTES", budget)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    got = xla.sddmm_coo(coo, q, k)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda) - base
    chunk = xla.sddmm_chunk(64)
    assert -(-mask.nnz // chunk) >= 3
    assert peak <= budget + got.numel() * 4 + 32 * chunk + (1 << 20)
    want = xla.sddmm_coo(DeviceCOO.from_csr(mask, device="cpu"), q.cpu(),
                         k.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=0)
    assert torch.equal(xla.sddmm_coo(coo, q, k), got)


def test_sddmm_and_pipeline_rows_launch_the_kernels(cuda, monkeypatch):
    """``run_sddmm`` and ``run_pipeline`` on the card launch ``bsr_sddmm``
    and ``bsr_spmm`` and never their plain versions."""
    from spgrid_torch.bench import harness
    from spgrid_torch.core.config import BenchConfig
    from spgrid_torch.ops.kernels import bsr_spmm as spmm_module
    from spgrid_torch.ops.kernels import sddmm as sddmm_module

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(sddmm_module, "bsr_sddmm_plain", refuse)
    monkeypatch.setattr(spmm_module, "bsr_spmm_plain", refuse)
    cfg = BenchConfig(num_cols=64, min_time_s=0.01, min_iters=2,
                      warmup_iters=1)
    before = launch_counts()
    row = harness.run_sddmm(512, cfg, device=cuda)
    moved = launch_counts()["bsr_sddmm"] - before["bsr_sddmm"]
    assert row["errors_passed"] == 1 and moved > 0
    assert row["kernel"] == "sddmm_cuda"
    w = positive(random_csr(256, 256, 0.3, seed=36))
    before = launch_counts()
    row = harness.run_pipeline(w, w, w, config=cfg, device=cuda)
    after = launch_counts()
    assert row["errors_passed"] == 1 and row["kernel"] == "pipeline_cuda"
    assert after["bsr_spmm"] > before["bsr_spmm"]
    assert after["bsr_sddmm"] > before["bsr_sddmm"]


def flagship_layouts(device):
    from spgrid_torch.entry import flagship_csrs
    wk, _, _, mask = flagship_csrs()
    return (DeviceBSR.from_csr(wk, bm=128, bk=128, device=device),
            DeviceBSR.from_csr(mask, bm=128, bk=128, device=device))


def test_block_kernels_give_the_same_bits_twice(cuda):
    """The cluster sums its partial tiles in rank order, with no atomics:
    two calls give bit-identical outputs (and so does WROW v1, a thread a
    row in a fixed order)."""
    from spgrid_torch.bench.headline import headline_matrix
    w, mask = flagship_layouts(cuda)
    x = operand((512, 512), 3, cuda)
    assert torch.equal(bsr_spmm(w, x), bsr_spmm(w, x))
    q, k = operand((512, 512), 4, cuda), operand((512, 512), 5, cuda)
    assert torch.equal(bsr_sddmm(mask, q, k), bsr_sddmm(mask, q, k))
    p = DevicePanels.from_csr(headline_matrix(), bk=128, device=cuda)
    assert torch.equal(panel_spmm(p, x), panel_spmm(p, x))
    csr = scattered_line()
    a = DeviceWROW.from_csr(csr, device=cuda)
    v = operand((csr.k,), 6, cuda)
    assert torch.equal(wrow_spmv(a, v), wrow_spmv(a, v))


def test_block_kernels_launch_grid(cuda):
    """What ``launch_grid`` reports on this card, from the C side's launch
    rule: the flagship's few tiles of 128 x 64 (32 for the SpMM, 26 for the
    SDDMM) split across the largest cluster that keeps the grid on the
    card's SMs; bm = 200 as two row slices; many tiles at cluster 1."""
    from spgrid_torch.ops.kernels.bsr_spmm import launch_grid as spmm_grid
    from spgrid_torch.ops.kernels.sddmm import launch_grid as sddmm_grid
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    w, mask = flagship_layouts(cuda)
    for grid, tiles in ((spmm_grid(w, 512), 32), (sddmm_grid(mask), 26)):
        assert (grid.rows, grid.cols, grid.step) == (128, 64, 32)
        assert grid.tiles == tiles
        assert grid.cluster in (1, 2, 4, 8)
        assert grid.ctas <= sms or grid.cluster == 1
        assert grid.cluster == 8 or 2 * grid.ctas > sms
    if sms == 132:
        assert spmm_grid(w, 512).cluster == sddmm_grid(mask).cluster == 4
    tall = DeviceBSR.from_csr(positive(random_csr(500, 300, 0.2, seed=9)),
                              bm=200, bk=128, device=cuda)
    assert spmm_grid(tall, 70).tiles == 3 * 2 * 2
    assert spmm_grid(w, 64 * sms).cluster == 1


def test_panel_spmm_launch_grid(cuda):
    """The headline's panels (one band of 512 rows, four panels) take
    ``bsr_spmm``'s grid: 4 slices x 8 column tiles, the same cluster;
    R = 2048 runs as 16 slices a band."""
    from spgrid_torch.bench.headline import headline_matrix
    from spgrid_torch.ops.kernels.bsr_spmm import launch_grid as spmm_grid
    from spgrid_torch.ops.kernels.panel_spmm import launch_grid
    head = headline_matrix()
    grid = launch_grid(DevicePanels.from_csr(head, bk=128, device=cuda), 512)
    assert (grid.tiles, grid.rows, grid.cols, grid.step) == (32, 128, 64, 32)
    assert grid == spmm_grid(DeviceBSR.from_csr(head, bm=128, bk=128,
                                                device=cuda), 512)
    tall = DevicePanels.from_csr(tall_bands(), bk=128, device=cuda)
    assert launch_grid(tall, 70).tiles == 2 * 16 * 2


@pytest.mark.parametrize("cluster", [0, 1, 2, 4, 8])
def test_block_kernels_at_every_cluster_size(cuda, cluster):
    """The C entry points at each cluster size the launch rule may pick, and
    at cluster 0 (the rule itself), on ragged shapes (bm = 200 in two row
    slices, n = 77, d = 70)."""
    from spgrid_torch.ops.kernels import _build
    lib = _build.library()
    csr = positive(random_csr(500, 300, 0.2, seed=6))
    a = DeviceBSR.from_csr(csr, bm=200, bk=128, pad_multiple=3, device=cuda)
    x = operand((300, 77), 5, cuda)
    y = torch.empty((500, 77), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    _build.check(lib.spgrid_bsr_spmm(
        a.row_ptr.data_ptr(), a.block_cols.data_ptr(), a.blocks.data_ptr(),
        x.data_ptr(), y.data_ptr(), a.mb, a.bm, a.bk, 500, 300, 77, cluster,
        stream), "bsr_spmm")
    assert_close(y, bsr_spmm_plain(a, x.double()))
    mask = create_mask("band_and_random", 200, 0.8, band_size=4, seed=14)
    m = DeviceBSR.from_csr(mask, bm=200, bk=128, pad_multiple=4, device=cuda)
    q, k = operand((200, 70), 7, cuda), operand((200, 70), 8, cuda)
    nb, bm, bk = m.blocks.shape
    out = torch.empty((nb, bm, bk), device=cuda)
    _build.check(lib.spgrid_bsr_sddmm(
        m.block_rows.data_ptr(), m.block_cols.data_ptr(), m.blocks.data_ptr(),
        q.data_ptr(), k.data_ptr(), out.data_ptr(), nb, bm, bk, 200, 200, 70,
        cluster, stream), "bsr_sddmm")
    assert_close(out, bsr_sddmm_plain(m, q.double(), k.double()))


@pytest.mark.parametrize("cluster", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("case", ["r104", "r2048", "r40"])
def test_panel_spmm_at_every_cluster_size(cuda, case, cluster):
    """The panel C entry point at each cluster size the launch rule may
    pick, and at 0 (the rule), on bands of 104, 2048 and 40 rows with pad
    slots and an empty band, n = 77 (4-byte X copies)."""
    from spgrid_torch.ops.kernels import _build
    make, band_rows = PANELS[case]
    csr = make()
    a = DevicePanels.from_csr(csr, bk=128, band_rows=band_rows, device=cuda)
    x = operand((csr.k, 77), 5, cuda)
    y = torch.full((csr.m, 77), float("nan"), device=cuda)
    _build.check(_build.library().spgrid_panel_spmm(
        a.counts.data_ptr(), a.block_cols.data_ptr(), a.panels.data_ptr(),
        x.data_ptr(), y.data_ptr(), a.bands, a.max_p, a.band_rows, a.bk,
        csr.m, csr.k, 77, cluster, torch.cuda.current_stream().cuda_stream),
        "panel_spmm")
    assert_close(y, panel_spmm_plain(a, x.double()))


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
# the bf16 form of the bands kernel, a case of test_slot_spmm_kernel
BANDS_BF16 = {"wcoo_spmm_aligned_bf16": (
    lambda c, d: DeviceWCOOBands.from_csr(c.astype("bfloat16"),
                                          band_rows=256, device=d),
    wcoo_spmm_aligned, wcoo_spmm_aligned_plain)}
BANDS_SLABS = (0, 64, 128, 256, 512)
SLOT_SPMV = {
    "wcoo_spmv": (lambda c, d: DeviceWCOOAligned.from_csr(c, device=d),
                  wcoo_spmv, wcoo_spmv_plain),
    "wrow_spmv": (lambda c, d: DeviceWROW.from_csr(c, device=d), wrow_spmv,
                  wrow_spmv_plain),
}


@pytest.mark.parametrize("n", [1, 70, 96, 200, 512])
@pytest.mark.parametrize("matrix", sorted(SLOT_MATRICES))
@pytest.mark.parametrize("kernel", sorted(SLOT_SPMM) + sorted(BANDS_BF16))
def test_slot_spmm_kernel(cuda, kernel, matrix, n):
    """f32: within 1e-5 of the f64 plain product. The bf16 bands form: bit
    for bit with its plain version through the wrapper and, into Y that
    starts as NaN, at every slab in the form X and Y take (the 16-byte walk
    where n % 8 == 0), in the 8-byte form on copies 8 bytes off, each the
    same bits twice."""
    layout, fn, plain = {**SLOT_SPMM, **BANDS_BF16}[kernel]
    csr = SLOT_MATRICES[matrix]()
    a = layout(csr, cuda)
    bf16 = kernel in BANDS_BF16
    x = (bf16_operand if bf16 else operand)((csr.k, n), 9, cuda)
    before = launch_counts()[kernel]
    got = fn(a, x)
    assert launch_counts()[kernel] == before + 1
    if not bf16:
        assert_close(got, plain(a, x.double()))
        return
    want = plain(a, x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    base = torch.empty((csr.k * n + 8,), dtype=torch.bfloat16, device=cuda)
    for off in (0, 4):    # 4 bf16: 8 bytes off 16
        xo = base[off:off + csr.k * n].view(csr.k, n)
        xo.copy_(x)
        for slab in BANDS_SLABS:
            ys = []
            for _ in range(2):
                yb = torch.full((csr.m * n + 8,), float("nan"),
                                dtype=torch.bfloat16, device=cuda)
                y = yb[off:off + csr.m * n].view(csr.m, n)
                assert bands_module.vector_form(xo, y) == (
                    2 if n % 8 == 0 and off == 0 else 1 if n % 4 == 0
                    else 0)
                bands_module.launch(a, xo, y, slab)
                ys.append(y)
            torch.cuda.synchronize()
            assert torch.equal(ys[0], want) and torch.equal(ys[1], want)


@pytest.mark.parametrize("vec", [0, 1, 2])
def test_wcoo_bands_bf16_slab_rule(cuda, vec):
    """The bf16 walk's launch, asked of the card, is ``launch_plan``'s (the
    rule in Python) at every slab and the rule, at n from 8 to 1,024."""
    for n in (8, 64, 96, 200, 512, 1024):
        for slab in BANDS_SLABS:
            assert (bands_module.launch_shape(n, vec, slab)
                    == bands_module.launch_plan(n, vec, slab))


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


def long_row():
    """1000 x 3200, ~0.3 % scattered; rows 100-499 empty (400 in a row, past
    a tile's 256 rows) and row 700 full in its last 3,000 columns, past
    every TILE_SLOTS of the sweep; m is not a multiple of 128."""
    return hypersparse_edge(1000, 3200, density=0.003, empty=slice(100, 500),
                            heavy_row=700, heavy_nnz=3000, seed=31)


WCOO_SPMV_MATRICES = {**SLOT_MATRICES, "long_row": long_row}


@pytest.mark.parametrize("tile_slots", TILE_CHOICES)
@pytest.mark.parametrize("matrix", sorted(WCOO_SPMV_MATRICES))
def test_wcoo_spmv_at_every_tile_size(cuda, matrix, tile_slots):
    """The row-tiled stream kernel at each TILE_SLOTS: every row written (y
    starts as NaN), within 1e-5 of the padded plain version and of the
    stream's, and the same bits on two calls (no atomics)."""
    csr = WCOO_SPMV_MATRICES[matrix]()
    a = DeviceWCOOAligned.from_csr(csr, device=cuda).tiled(tile_slots)
    x = operand((csr.k,), 13, cuda)
    y = torch.full((csr.m,), float("nan"), device=cuda)
    wcoo_spmv_module.launch(a, x, y)
    assert_close(y, wcoo_spmv_plain(a, x.double()))
    assert_close(y, wcoo_spmv_rows_plain(a, x.double()))
    again = torch.full_like(y, float("nan"))
    wcoo_spmv_module.launch(a, x, again)
    torch.cuda.synchronize()
    assert torch.equal(y, again)


def test_wcoo_spmv_refuses_a_tile_size_it_cannot_take(cuda):
    a = DeviceWCOOAligned.from_csr(hypersparse_edge(), device=cuda)
    x = operand((a.shape[1],), 1, cuda)
    y = torch.empty((a.shape[0],), device=cuda)
    for tile_slots in (0, 256, 1000, 4096):
        with pytest.raises(RuntimeError):
            wcoo_spmv_module.launch(
                dataclasses.replace(a, tile_slots=tile_slots), x, y)


def scattered_line():
    """LINE_S's generator line at 20000^2: ~20 scattered nnz a row in 90 %
    of the columns, each piece ~2.5 % full."""
    return artificial_matrix_generation(
        20000, 20000, 20, 6.6667, "normal", seed=14, placement="random",
        bw=0.9, name="scattered_line")


def long_rows():
    """3000 x 5000, ~0.2 % scattered; rows 1024-1151 hold ~2,500 nnz each
    (a target block of ~320K live slots, 79 rounds of its kernel) and row
    2999, the last of a ragged block, 700."""
    rng = np.random.default_rng(21)
    d = np.where(rng.random((3000, 5000)) < 0.002,
                 rng.random((3000, 5000)) + 0.5, 0.0)
    band = rng.random((128, 5000))
    d[1024:1152] = np.where(band < 0.5, band + 0.5, 0.0)
    d[2999, :700] = rng.random(700) + 0.5
    return dense_to_csr(d.astype(np.float32), name="long_rows")


WROW_MATRICES = {
    "scattered_line": scattered_line,
    "long_rows": long_rows,
    "edge": hypersparse_edge,
    "empty": lambda: dense_to_csr(np.zeros((130, 70), np.float32)),
    "empty_blocks": lambda: with_empty_rows(1000, 900, 5, slice(128, 384)),
}


@pytest.mark.parametrize("matrix", sorted(WROW_MATRICES))
def test_wrow_spmv_v1_kernel(cuda, matrix):
    """WROW v1 on the row stream: against the f64 plain version, every row
    written (y starts as whatever torch.empty holds), and bit for bit the
    padded pieces' sum, which spmv_ablate's full form still computes."""
    csr = WROW_MATRICES[matrix]()
    a = DeviceWROW.from_csr(csr, device=cuda)
    x = operand((csr.k,), 12, cuda)
    before = launch_counts()["wrow_spmv"]
    got = wrow_spmv(a, x)
    assert launch_counts()["wrow_spmv"] == before + 1
    assert_close(got, wrow_spmv_plain(a, x.double()))
    assert torch.equal(got, spmv_ablate(a, x, "full"))


def test_slot_wrappers_raise_instead_of_falling_back(cuda):
    csr = hypersparse_edge()
    for kernel, (layout, fn, _) in {**SLOT_SPMM, **SLOT_SPMV}.items():
        a = layout(csr, cuda)
        shape = (csr.k,) if kernel in SLOT_SPMV else (csr.k, 8)
        with pytest.raises(TypeError):
            fn(a, operand(shape, 1, cuda).double())
        with pytest.raises(ValueError):
            fn(a, operand(shape, 1, "cpu"))


def empty_tail():
    """300 x 260, ~5 % scattered; rows 10-39 and the last 100 rows empty."""
    rng = np.random.default_rng(32)
    d = np.where(rng.random((300, 260)) < 0.05, rng.random((300, 260)) + 0.5,
                 0.0)
    d[10:40] = 0.0
    d[200:] = 0.0
    return dense_to_csr(d.astype(np.float32), name="empty_tail")


# the slot SpMMs' row walk (csrc/slot_rows.cuh): the float4 form at n = 512
# (C = 4) and 200 (C = 2, a ragged slab), the scalar form at n = 77 and 1
# and on an X 4 bytes off alignment; long rows (the edge matrices' 200-,
# 250- and 2000-nnz rows) go to the long-row walk
ROW_WALK_MATRICES = {
    **SLOT_MATRICES, "empty_tail": empty_tail,
    "edge_250": lambda: hypersparse_edge(3000, 2000, density=0.003,
                                         empty=slice(1024, 2048),
                                         heavy_row=5, heavy_nnz=250),
    "edge_2000": lambda: hypersparse_edge(3000, 2100, density=0.003,
                                          empty=slice(1024, 2048),
                                          heavy_row=5, heavy_nnz=2000),
}


@pytest.mark.parametrize("n", [512, 200, 77, 1])
@pytest.mark.parametrize("matrix", sorted(ROW_WALK_MATRICES))
@pytest.mark.parametrize("kernel", sorted(SLOT_SPMM))
def test_slot_spmm_row_walk(cuda, kernel, matrix, n):
    layout, fn, plain = SLOT_SPMM[kernel]
    csr = ROW_WALK_MATRICES[matrix]()
    a = layout(csr, cuda)
    x = operand((csr.k, n), 19, cuda)
    want = plain(a, x.double())
    before = launch_counts()[kernel]
    got = fn(a, x)
    # one launch, with or without the long-row walk
    assert launch_counts()[kernel] == before + 1
    assert_close(got, want)
    xm = misaligned((csr.k, n), 19, cuda)
    assert_close(fn(a, xm), plain(a, xm.double()))


def test_slot_spmm_refuse_a_non_contiguous_x(cuda):
    csr = hypersparse_edge()
    for layout, fn, _ in SLOT_SPMM.values():
        a = layout(csr, cuda)
        with pytest.raises(ValueError, match="contiguous"):
            fn(a, operand((64, csr.k), 1, cuda).t())


def bands_with_gaps():
    d = positive(random_csr(300, 260, 0.1, seed=2)).to_dense()
    d[64:128] = 0.0
    return dense_to_csr(d.astype(np.float32), name="bands_with_gaps")


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


def tail_only(csr, device):
    """``csr``'s DGELL layout with every third row's slots moved into the
    tail: those rows hold tail nnz only."""
    cols, vals, t_rows, t_cols, t_vals, slots = dgell_arrays(csr)
    moved = np.arange(0, csr.m, 3)
    live = vals[moved] != 0
    t_rows = np.concatenate([t_rows, np.repeat(moved, live.sum(1))])
    t_cols = np.concatenate([t_cols, cols[moved][live]])
    t_vals = np.concatenate([t_vals, vals[moved][live]])
    cols[moved], vals[moved] = 0, 0.0
    return DeviceDGELL.from_arrays(cols, vals, t_rows, t_cols, t_vals,
                                   csr.shape, csr.nnz, slots, device=device)


def wide_k():
    """2000 x 150000, ~20 scattered nnz a row: at n = 96 the slab rule
    takes several slabs of X (150000 x C floats each)."""
    return artificial_matrix_generation(
        2000, 150000, 20, 6.6667, "normal", seed=14, placement="random",
        bw=0.9, name="wide_k")


# the dgell kernel's slabs (csrc/dgell.cu): several slabs by its rule, the
# scalar form (n % 4 != 0), a misaligned X, rows whose nnz are all in the
# tail, fewer rows than one CTA's
DGELL = {
    "wide_k_n96": (lambda d: DeviceDGELL.from_csr(wide_k(), device=d), 96,
                   "plain"),
    "edge_n77": (lambda d: DeviceDGELL.from_csr(hypersparse_edge(), device=d),
                 77, "plain"),
    "edge_misaligned": (lambda d: DeviceDGELL.from_csr(hypersparse_edge(),
                                                       device=d), 200,
                        "misaligned"),
    "tail_only_n64": (lambda d: tail_only(hypersparse_edge(), d), 64,
                      "plain"),
    "tail_only_n13": (lambda d: tail_only(hypersparse_edge(), d), 13,
                      "misaligned"),
    "m5": (lambda d: DeviceDGELL.from_csr(positive(random_csr(
        5, 300, 0.2, seed=2)), device=d), 40, "plain"),
}


@pytest.mark.parametrize("case", sorted(DGELL))
def test_dgell_kernel_cases(cuda, case):
    """The kernel against its f64 plain version and the product in its own
    order (slots, then the row's tail), the same bits on two calls."""
    make, n, layout = DGELL[case]
    a = make(cuda)
    k = a.shape[1]
    x = (operand((k, n), 14, cuda) if layout == "plain"
         else misaligned((k, n), 14, cuda))
    if case.startswith("wide_k"):
        assert launch_shape(k, n).slabs > 1
    before = launch_counts()["dgell"]
    got = dgell_spmm(a, x)
    assert launch_counts()["dgell"] == before + 1
    assert_close(got, dgell_spmm_plain(a, x.double()))
    assert_close(got, dgell_rows_plain(a, x.double()))
    assert torch.equal(got, dgell_spmm(a, x))


@pytest.mark.parametrize("slab", [0, 8, 16, 32, 64, 128, 512, "n"])
@pytest.mark.parametrize("n,layout", [(96, "plain"), (77, "plain"),
                                      (200, "misaligned")])
def test_dgell_kernel_at_every_slab(cuda, slab, n, layout):
    """The C entry point at each slab width (0: the rule; n) on the edge
    matrix: every slab of Y written (it starts as NaN), the same bits on
    two calls."""
    csr = hypersparse_edge()
    a = DeviceDGELL.from_csr(csr, device=cuda)
    x = (operand((csr.k, n), 15, cuda) if layout == "plain"
         else misaligned((csr.k, n), 15, cuda))
    slab = n if slab == "n" else slab
    y = torch.full((csr.m, n), float("nan"), device=cuda)
    launch(a, x, y, slab)
    assert_close(y, dgell_spmm_plain(a, x.double()))
    again = torch.full_like(y, float("nan"))
    launch(a, x, again, slab)
    assert torch.equal(y, again)
    shape = launch_shape(csr.k, n, slab, layout == "plain" and n % 4 == 0)
    assert shape.slabs == -(-n // shape.slab)
    assert shape.slab == (n if slab in (0, 512, n) or slab >= n else slab)


def test_dgell_refuses_a_slab_it_cannot_take(cuda):
    csr = hypersparse_edge()
    a = DeviceDGELL.from_csr(csr, device=cuda)
    x = operand((csr.k, 64), 1, cuda)
    y = torch.empty((csr.m, 64), device=cuda)
    for slab in (4, 24, 1024):
        with pytest.raises(RuntimeError):
            launch(a, x, y, slab)


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


@pytest.mark.parametrize("path", [DIRECT, STAGED], ids=["direct", "staged"])
@pytest.mark.parametrize("form", range(len(FORMS)),
                         ids=[f[0] for f in FORMS])
def test_lanegather_paths(cuda, form, path):
    """Each path on each form equals the plain version bit for bit; the
    rule takes the direct path on every form (a thread an output), and a
    staged tile fits each form."""
    _, src, idx, axis = FORMS[form]
    s, i = torch.from_numpy(src).to(cuda), torch.from_numpy(idx).to(cuda)
    shape = (*s.shape, *i.shape, axis)
    assert lanegather_module.card_plan(*shape) == lanegather_module.Plan(
        DIRECT, 0, -(-i.numel() // 256))
    staged = lanegather_module.card_plan(*shape, STAGED)
    along = s.shape[0] if axis == 1 else s.shape[1]
    assert staged.path == STAGED and staged.tile > 0
    assert staged.ctas == -(-along // staged.tile)
    out = torch.full(i.shape, float("nan"), device=cuda)
    lanegather_module.launch(s, i, out, axis, path)
    torch.cuda.synchronize()
    assert torch.equal(out, lanegather_plain(s, i, axis))


@pytest.mark.parametrize("path", [DIRECT, STAGED], ids=["direct", "staged"])
@pytest.mark.parametrize("case", [
    "ragged_rows", "ragged_slab", "scalar_axis1", "scalar_axis0",
    "misaligned", "outside"])
def test_lanegather_path_edges(cuda, case, path):
    """Ragged last tiles, the 4-byte forms (n % 4 != 0, a misaligned
    pointer) and indices outside src (read as 0) on both paths, against
    the walk's plain version."""
    rng = np.random.default_rng(40)
    shapes = {"ragged_rows": ((300, 100), (300, 36), 1),
              "ragged_slab": ((200, 84), (5, 84), 0),
              "scalar_axis1": ((9, 131), (9, 7), 1),
              "scalar_axis0": ((70, 13), (6, 13), 0),
              "misaligned": ((16, 64), (16, 64), 1),
              "outside": ((40, 64), (40, 32), 1)}
    (s0, s1), ishape, axis = shapes[case]
    src = torch.from_numpy(rng.standard_normal((s0 * s1 + 1,)).astype(
        np.float32))
    src = (src[1:] if case == "misaligned" else src[:-1]).reshape(s0, s1)
    high = (s0, s1)[axis]
    idx = rng.integers(-3 if case == "outside" else 0,
                       high + (3 if case == "outside" else 0), ishape)
    idx = torch.from_numpy(idx.astype(np.int32))
    tile = (0 if path == DIRECT else lanegather_module.card_plan(
        s0, s1, *ishape, axis, STAGED).tile)
    want = walk_plain(src, idx, axis, tile)
    s, i = src.to(cuda), idx.to(cuda)
    if case == "misaligned":
        s = torch.empty(s0 * s1 + 1, device=cuda)[1:].view(s0, s1)
        s.copy_(src.to(cuda))
    out = torch.full(ishape, float("nan"), device=cuda)
    lanegather_module.launch(s, i, out, axis, path)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), want)


TORCH_OP_FORMATS = ("coo", "sell", "merge", "gell", "gell16", "cv_gell",
                    "ell", "csc", "cv_bf16", "cv_int8", "scoo",
                    "cv_panel_cuda")


def captured(fn, *args):
    """(graph, its output): ``fn(*args)`` captured in a CUDA graph after
    one eager call on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    return graph, out


# the edge matrix's row of 250 nnz; a row of 3,000 nnz spans several
# merge blocks of 512, so its carry fix-up sums four or more strip rows
TORCH_OP_MATRICES = {
    "edge": hypersparse_edge,
    "long_row": lambda: hypersparse_edge(1000, 3200, density=0.003,
                                         empty=slice(100, 500),
                                         heavy_row=700, heavy_nnz=3000,
                                         seed=31),
}


def symmetric_pattern(m=2000, seed=2):
    """m x m, a symmetric pattern of ~0.5 % with unequal values, rows 40-49
    holding only their diagonal, two diagonal entries missing."""
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((m, m)) < 0.005, 1)
    upper[40:50] = False
    upper[:, 40:50] = False
    d = np.where(upper | upper.T, rng.random((m, m)) + 0.5, 0.0)
    np.fill_diagonal(d, rng.random(m) + 1.0)
    d[[3, 17], [3, 17]] = 0.0
    return dense_to_csr(d.astype(np.float32), name="symmetric")


@pytest.mark.parametrize("matrix", TORCH_OP_MATRICES)
@pytest.mark.parametrize("n", [1, 24])
@pytest.mark.parametrize("fmt", TORCH_OP_FORMATS)
def test_torch_op_formats_on_the_card(cuda, fmt, n, matrix):
    """The torch-op formats on the card give their CPU results (the same
    ops, summed in another order), are captured in a CUDA graph (nothing
    on their path waits for the host), and give the same bits on every
    call, eager and by graph replay."""
    from spgrid_torch.core.timing import time_kernel_graph
    from spgrid_torch.ops import dispatch
    csr = TORCH_OP_MATRICES[matrix]()
    x = operand((csr.k, n), 41, cuda)
    a = dispatch.build(csr, fmt, device=cuda)
    fn = dispatch.spmm_fn(fmt)
    got = fn(a, x)
    want = fn(dispatch.build(csr, fmt, device="cpu"), x.cpu())
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)
    time_kernel_graph(fn, a, x, device=cuda, calls=2, warmup_iters=1,
                      min_time_s=0.0, min_iters=2)
    assert torch.equal(fn(a, x), got)
    graph, out = captured(fn, a, x)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, got)


@pytest.mark.parametrize("n", [1, 24])
def test_ldu_on_the_card(cuda, n):
    """LDU's face sums on the card: its CPU result, captured in a graph,
    the same bits every call."""
    from spgrid_torch.ops import dispatch
    csr = symmetric_pattern()
    x = operand((csr.k, n), 42, cuda)
    a = dispatch.build(csr, "ldu", device=cuda)
    fn = dispatch.spmm_fn("ldu")
    got = fn(a, x)
    want = fn(dispatch.build(csr, "ldu", device="cpu"), x.cpu())
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)
    assert torch.equal(fn(a, x), got)
    graph, out = captured(fn, a, x)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, got)


@pytest.mark.parametrize("kernel", ["coo", "gell16", "cv_int8",
                                    "cv_panel_cuda"])
def test_device_gate_agrees_with_the_host_gate(cuda, kernel):
    """One row of each gate class gated on the card and on the host: the
    metrics within their bounds (``device_oracle.disagreements``), the
    same verdict."""
    from spgrid_torch.bench.harness import run_spmm
    from spgrid_torch.core.config import BenchConfig
    from spgrid_torch.core.device_oracle import disagreements
    from spgrid_torch.core.metrics import ErrorMetrics
    csr = positive(line_matrix(
        "20000 20000 8 3 normal random 0.05 0 0.05 0.05 14"))
    kw = dict(num_cols=64, min_time_s=0.01, min_iters=2, warmup_iters=1)
    gates = {}
    for site in ("host", "device"):
        row = run_spmm(csr, kernel, BenchConfig(oracle=site, **kw),
                       device=cuda)
        gates[site] = ErrorMetrics(
            **{f: row[f] for f in ("mae", "max_ae", "mse", "mape", "smape",
                                   "lnQ_error", "mlare", "gmare")},
            max_rel_diff=0.0, passed=bool(row["errors_passed"]))
    assert gates["host"].passed
    assert disagreements(gates["host"], gates["device"]) == []


def test_device_gold_is_the_host_gold_on_the_card(cuda):
    from spgrid_torch.core.device_oracle import DeviceOracle
    from spgrid_torch.core.metrics import gold_spmm_fast
    rng = np.random.default_rng(3)
    deg = rng.integers(0, 12, 500)
    deg[5:9] = (9000, 129, 257, 0)
    k = 20000
    ptr = np.concatenate([[0], np.cumsum(deg)])
    cols = np.concatenate([np.sort(rng.choice(k, d, replace=False))
                           for d in deg]).astype(np.int32)
    csr = CSRMatrix(ptr, cols, rng.normal(size=ptr[-1]).astype(np.float32),
                    (500, k), "skewed")
    x = operand((k, 33), 4, cuda)
    got = DeviceOracle.from_csr(csr, device=cuda).gold(x).cpu().numpy()
    want = gold_spmm_fast(csr.row_ptr, csr.col_idx, csr.values,
                          x.cpu().numpy())
    np.testing.assert_array_equal(got, want)


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


def test_dma_gather_takes_more_chunks_than_ctas(cuda):
    """The probe's rows at G = 64 and 256 over a smaller X: 25,600 output
    rows, 1,600 chunks of R = 16 rows, ~12 for each CTA of the persistent
    grid, so every CTA walks its ring around twice or more."""
    for G, steps in ((64, 400), (256, 100)):
        x, idx2 = gather_operands(5000, 512, steps, G, 27, cuda)
        out = torch.empty((steps * G, 512), device=cuda)
        grid = pallas_gather.launch(x, idx2, out)
        ring = ring_shape(512, steps, G)
        assert grid == ring.ctas and 0 < grid < steps * G // ring.chunk_rows
        torch.cuda.synchronize()
        assert torch.equal(out, dma_gather_plain(x, idx2))


def gather_with_outside_rows(k, n, steps, G, seed, device):
    """x, idx2 with ~3 % of the indices outside x (negative or >= k), and
    the rows the kernel must give: index_select with those rows zero."""
    x, idx2 = gather_operands(k, n, steps, G, seed, device)
    rng = np.random.default_rng(seed + 1)
    flat = idx2.reshape(-1).cpu().numpy()
    bad = rng.random(flat.size) < 0.03
    flat[bad] = rng.choice([-1, -7, k, k + 5], bad.sum())
    idx2 = torch.from_numpy(flat.reshape(steps, G)).to(device)
    want = x.index_select(0, idx2.reshape(-1).clamp(0, k - 1))
    want[torch.from_numpy(bad).to(device)] = 0.0
    return x, idx2, want


@pytest.mark.parametrize("stages,chunk_rows", [
    (2, 8), (2, 16), (2, 32), (4, 8), (4, 16), (6, 8), (6, 16)])
def test_dma_gather_at_every_ring(cuda, stages, chunk_rows):
    """The bulk path at each ring of the sweep that fits at n 512 (S stages
    of R rows), with rows outside x (zero rows, filled in the stage before
    its store): equal to index_select."""
    x, idx2, want = gather_with_outside_rows(3000, 512, 37, 64, 28, cuda)
    out = torch.full((37 * 64, 512), float("nan"), device=cuda)
    assert pallas_gather.launch(x, idx2, out, stages, chunk_rows) > 0
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_dma_gather_refuses_a_ring_it_cannot_take(cuda):
    x, idx2 = gather_operands(100, 512, 2, 64, 29, cuda)
    out = torch.empty((128, 512), device=cuda)
    for stages, chunk_rows in ((1, 16), (9, 1), (2, 33), (6, 32), (4, 32)):
        with pytest.raises(RuntimeError):
            pallas_gather.launch(x, idx2, out, stages, chunk_rows)
        with pytest.raises(RuntimeError):
            ring_shape(512, 2, 64, stages, chunk_rows)


@pytest.mark.parametrize("n", [4, 8, 200, 512, 1000, 4096, 8192, MAX_N])
def test_ring_rule_fits_shared_memory(cuda, n):
    """The rule's ring (S stages of R rows of n floats) is one the kernel
    takes: S 2-8, R 1-32 (a lane a row), within the H100's 227 KB of shared
    memory for a CTA; a stage of about 32 KB where a row is at most 32 KB;
    at most a CTA a chunk."""
    S, R, ctas = ring_shape(n, 4, 64)
    assert 2 <= S <= 8 and 1 <= R <= 32
    assert S * R * 4 * n <= 227 * 1024
    assert R == max(1, min(32, 32768 // (4 * n)))
    assert 1 <= ctas <= -(-256 // R)
    assert ring_shape(512, 4, 64)[:2] == (6, 16)
    assert ring_shape(MAX_N, 4, 64)[:2] == (3, 1)
    assert ring_shape(n, 4, 64, 2, 1)[:2] == (2, 1)
    with pytest.raises(RuntimeError):        # no bulk path
        ring_shape(n + 1, 4, 64)


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
    "straddle": straddle,
    "empty_blocks": empty_blocks,
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
    torch.testing.assert_close(got.double(),
                               spmv_ablate_rows_plain(a, x.double(), variant),
                               rtol=tol, atol=tol)
    if variant == "full":     # WROW v1's kernel: the same walk, the same bits
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


WPACK_WARPS = (4, 8, 16)


@pytest.mark.parametrize("warps", WPACK_WARPS)
@pytest.mark.parametrize("matrix", sorted(WPACK_ABLATE_MATRICES))
@pytest.mark.parametrize("tag", [t for t, _ in exp_wpack_ablate.FORMS[:-1]])
def test_wpack_ablate_at_every_warp_form(cuda, tag, matrix, warps):
    """The kernel at W = 4, 8 and 16 warps a CTA, uncounted: within 1e-5
    of the f64 plain version, and the same bits from two calls (no
    atomics)."""
    knobs = dict(exp_wpack_ablate.FORMS)[tag]
    variant = wpack_module.VARIANTS[knobs.get("ablate", ""),
                                    knobs.get("prefix", "direct")]
    csr = WPACK_ABLATE_MATRICES[matrix]()
    a = DeviceWPACK.from_csr(csr, 2, device=cuda)
    x = operand((csr.k,), 29, cuda)
    before = launch_counts()["wpack_ablate"]
    y1 = torch.full((csr.m,), float("nan"), device=cuda)
    y2 = torch.full((csr.m,), float("nan"), device=cuda)
    wpack_module.launch(a, x, y1, variant, warps)
    wpack_module.launch(a, x, y2, variant, warps)
    assert launch_counts()["wpack_ablate"] == before
    assert_close(y1, wpack_spmv_plain(a, x.double(), **knobs))
    assert torch.equal(y1, y2)


def test_wpack_ablate_warps_rule(cuda):
    """The fewest warps a CTA (4, 8, 16) that give every SM 16 warps: 16
    for the edge matrix's 24 blocks, 4 for the probe's 782 on a card of at
    most 195 SMs."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    a = DeviceWPACK.from_csr(hypersparse_edge(), device=cuda)
    for blocks in (1, 24, 100, 300, 600, 782, 5000):
        b = dataclasses.replace(a, block_ptr=torch.zeros(
            blocks + 1, dtype=torch.int32, device=cuda))
        want = next((w for w in WPACK_WARPS if blocks * w >= 16 * sms), 16)
        assert wpack_module.launch_warps(b) == want, blocks
        assert [wpack_module.launch_warps(b, w) for w in WPACK_WARPS] == list(
            WPACK_WARPS)
    for w in (1, 2, 3, 32):
        with pytest.raises(RuntimeError):
            wpack_module.launch_warps(a, w)
    x = operand((a.shape[1],), 1, cuda)
    y = torch.empty((a.shape[0],), device=cuda)
    with pytest.raises(RuntimeError):
        wpack_module.launch(a, x, y, 4, 32)
    with pytest.raises(RuntimeError):
        wpack_module.launch(a, x, y, 5, 0)


@pytest.mark.parametrize("wsel", [1, 4])
@pytest.mark.parametrize("matrix", sorted(WPACK_ABLATE_MATRICES))
def test_wpack_ablate_reads_no_dead_piece_or_quarter(cuda, matrix, wsel):
    """Values of pieces with piece_lanes 0 and of quarters wholly past it,
    set to NaN after piece_lanes was built, are never read: every form at
    every W gives the unpoisoned layout's bits."""
    csr = WPACK_ABLATE_MATRICES[matrix]()
    a = DeviceWPACK.from_csr(csr, wsel, device=cuda)
    lanes = a.piece_lanes.long()
    dead = torch.arange(4, device=cuda)[None, :] * 32 >= lanes[:, None]
    assert dead[lanes > 0].any()
    # its 16 pieces make two whole groups: no group padding
    assert (lanes == 0).any() or matrix == "m_below_128"
    values = a.values.clone()
    values[dead.repeat_interleave(32, dim=1)] = float("nan")
    bad = dataclasses.replace(a, values=values)
    x = operand((csr.k,), 30, cuda)
    for variant in range(5):
        for warps in WPACK_WARPS:
            clean = torch.empty((csr.m,), device=cuda)
            got = torch.empty((csr.m,), device=cuda)
            wpack_module.launch(a, x, clean, variant, warps)
            wpack_module.launch(bad, x, got, variant, warps)
            torch.cuda.synchronize()
            assert torch.equal(got, clean), (variant, warps)
    for tag, knobs in exp_wpack_ablate.FORMS[:-1]:
        assert_close(wpack_spmv(bad, x, **knobs),
                     wpack_spmv_plain(a, x.double(), **knobs))


@pytest.mark.parametrize("rows", [1, 133, 300])
def test_shuffle_bench_kernel_at_more_rows(cuda, rows):
    """A CTA a row: one row alone, a grid past the 132 SMs and past 256."""
    rng = np.random.default_rng(32)
    src = torch.from_numpy(rng.standard_normal((rows, 128)).astype(
        np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, 128, (rows, 128)).astype(
        np.int32)).to(cuda)
    for reps in (1, 64):
        got = shuffle_bench(src, idx, reps)
        torch.cuda.synchronize()
        assert torch.equal(got, shuffle_bench_plain(src, idx, reps))


def test_shuffle_bench_reads_0_outside_the_row(cuda):
    rng = np.random.default_rng(33)
    src = rng.standard_normal((5, 128)).astype(np.float32)
    idx = rng.integers(0, 128, (5, 128)).astype(np.int32)
    idx[:, ::9] = 128
    idx[1, :4] = (-1, -128, 300, 2 ** 30)
    ok = (idx >= 0) & (idx < 128)
    want = src
    for _ in range(9):
        want = np.where(ok, np.take_along_axis(want, np.clip(idx, 0, 127), 1),
                        np.float32(0)) + np.float32(1.0)
    got = shuffle_bench(torch.from_numpy(src).to(cuda),
                        torch.from_numpy(idx).to(cuda), 9)
    assert np.array_equal(got.cpu().numpy(), want)


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


def sparse_block_rows(m=4096, full=(3, 17), seed=51):
    """m x m, ~0.1 % scattered, and block rows ``full`` (128 rows each)
    half dense in one 128-column window: their blocks clear any rbh
    threshold below ~8,000 nnz, every other block holds ~16 nnz, so the
    block part has 2 full block rows and m / 128 - 2 empty ones."""
    rng = np.random.default_rng(seed)
    d = np.where(rng.random((m, m)) < 0.001, rng.random((m, m)) + 0.5, 0.0)
    for b in full:
        win = rng.random((128, 128))
        d[b * 128:(b + 1) * 128, 1024:1152] = np.where(win < 0.5, win + 0.5,
                                                      0.0)
    return dense_to_csr(d.astype(np.float32), name="sparse_block_rows")


@pytest.mark.parametrize("n", [1, 64, 512])
def test_rbh_on_the_card(cuda, n):
    """rbh's block part on the card (the bsr_spmm kernel over a DeviceBSR
    whose empty block rows outnumber its full ones, their coverage blocks
    included) and its residual give the CPU result, the same bits twice,
    and one bsr_spmm launch a call."""
    from spgrid_torch.ops.rbh import DeviceRBH, rbh_spmm
    csr = sparse_block_rows()
    a = DeviceRBH.from_csr(csr, threshold=64, device=cuda)
    assert a.stats.hi_blocks == 2 and a.bsr.mb == 32
    assert a.coverage_blocks == 30 > a.stats.hi_blocks
    x = operand((csr.k, n), 52, cuda)
    before = launch_counts()["bsr_spmm"]
    got = rbh_spmm(a, x)
    assert launch_counts()["bsr_spmm"] == before + 1
    want = rbh_spmm(DeviceRBH.from_csr(csr, threshold=64, device="cpu"),
                    x.cpu())
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)
    assert torch.equal(rbh_spmm(a, x), got)


def test_softmax_row_sum_gives_the_same_bits_twice(cuda):
    """blocksparse_softmax's row sums (segment sums at row_ptr) on the
    card: the CPU result, and the same bits on two calls and by graph
    replay."""
    from spgrid_torch.ops.attention import blocksparse_softmax
    mask = create_mask("band_and_random", 1024, 0.9, seed=53)
    bsr = DeviceBSR.from_csr(mask, bm=128, bk=128, device=cuda)
    s = operand(tuple(bsr.blocks.shape), 54, cuda)
    got = blocksparse_softmax(bsr, s)
    want = blocksparse_softmax(
        DeviceBSR.from_csr(mask, bm=128, bk=128, device="cpu"), s.cpu())
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-7)
    assert torch.equal(blocksparse_softmax(bsr, s), got)
    graph, out = captured(blocksparse_softmax, bsr, s)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


@pytest.mark.parametrize("matrix", TORCH_OP_MATRICES)
def test_merge_chunks_on_the_card(cuda, matrix, monkeypatch):
    """merge in chunks of 4 blocks (the long row's run of strip rows cut by
    chunk edges, each part added in chunk order): the one-chunk result on
    the card to 1e-5, and the same bits eager and by graph replay."""
    from spgrid_torch.ops import merge
    csr = TORCH_OP_MATRICES[matrix]()
    a = merge.DeviceMerge.from_csr(csr, device=cuda)
    x = operand((csr.k, 24), 55, cuda)
    whole = merge.merge_spmm(a, x)
    monkeypatch.setattr(merge, "_CHUNK_BYTES", 512 * merge.ROWS_CAP * 4)
    got = merge.merge_spmm(a, x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-6)
    assert torch.equal(merge.merge_spmm(a, x), got)
    graph, out = captured(merge.merge_spmm, a, x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


# --- the dtype axis: the four bf16 forms (bsr_spmm_bf16, panel_spmm_bf16_xy,
# bsr_sddmm_bf16, wcoo_spmm_aligned_bf16) against their plain versions on
# the same bf16 inputs. Both sum in f32 (the plain version in another
# order, or, for the slot walk, in slot order as well) and round once to
# bf16, so they differ by at most 1 bf16 ulp of the plain result; the slot
# walk rounds each product to bf16 first, as its plain version does.

def bf16_operand(shape, seed, device):
    return operand(shape, seed, device).to(torch.bfloat16)


def misaligned_bf16(shape, seed, device):
    """A contiguous bf16 operand whose data starts 2 bytes past an aligned
    address: no 8- or 16-byte loads of it."""
    x = bf16_operand((int(np.prod(shape)) + 1,), seed, device)[1:]
    return x.view(shape)


def assert_within_one_ulp(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.double(), want.double()
    assert torch.isfinite(g).all()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    # an absolute floor of 1e-30: exact zeros (empty rows) compare exactly
    assert ((g - w).abs() <= torch.maximum(ulp, torch.full_like(ulp, 1e-30))
            ).all()


def bf16_csr(make):
    return make().astype("bfloat16")


BF16_MATRICES = {
    "twin": lambda: headline_matrix(),
    "ragged": lambda: positive(random_csr(500, 300, 0.2, seed=6)),
    "empty_rows": lambda: with_empty_rows(400, 260, 11),
}


def bf16_form(kind, csr, device, bm=128):
    """(the form's wrapper call, its plain version, its launch counter) of
    a bf16 SpMM layout of ``csr``."""
    if kind == "bsr":
        a = DeviceBSR.from_csr(csr, bm=bm, bk=128, device=device)
        return (lambda x: bsr_spmm(a, x), lambda x: bsr_spmm_plain(a, x),
                "bsr_spmm_bf16")
    if kind == "panel":
        a = DevicePanels.from_csr(csr, bk=128, device=device)
        return (lambda x: panel_spmm(a, x), lambda x: panel_spmm_plain(a, x),
                "panel_spmm_bf16_xy")
    a = DeviceWCOOBands.from_csr(csr, device=device)
    return (lambda x: wcoo_spmm_aligned(a, x),
            lambda x: wcoo_spmm_aligned_plain(a, x), "wcoo_spmm_aligned_bf16")


@pytest.mark.parametrize("kind", ["bsr", "panel", "bands"])
@pytest.mark.parametrize("matrix", sorted(BF16_MATRICES))
@pytest.mark.parametrize("n,x_layout", [(512, "aligned"), (77, "aligned"),
                                        (200, "aligned"),
                                        (64, "misaligned")])
def test_bf16_spmm_forms(cuda, kind, matrix, n, x_layout):
    """Within 1 ulp of the plain version, one launch on the form's own
    counter a call, the same bits twice and by graph replay."""
    csr = bf16_csr(BF16_MATRICES[matrix])
    call, plain, counter = bf16_form(kind, csr, cuda)
    make_x = bf16_operand if x_layout == "aligned" else misaligned_bf16
    x = make_x((csr.k, n), 31, cuda)
    before = launch_counts()[counter]
    got = call(x)
    assert launch_counts()[counter] == before + 1
    assert_within_one_ulp(got, plain(x))
    assert torch.equal(call(x), got)
    graph, out = captured(call, x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


@pytest.mark.parametrize("bm", [64, 200, 256])
def test_bsr_spmm_bf16_at_other_block_heights(cuda, bm):
    """Block rows below one warpgroup, of two ragged slices, and of two
    full slices."""
    csr = bf16_csr(BF16_MATRICES["ragged"])
    call, plain, _ = bf16_form("bsr", csr, cuda, bm=bm)
    x = bf16_operand((csr.k, 96), 32, cuda)
    assert_within_one_ulp(call(x), plain(x))


@pytest.mark.parametrize("cluster", [0, 1, 2, 4, 8])
def test_bf16_block_forms_at_every_cluster_size(cuda, cluster):
    """The bf16 C entry points at each cluster size (the ranks' f32 partial
    tiles summed in rank order, then rounded once) on ragged shapes: bm =
    200 in two row slices, n = 77, d = 70."""
    csr = bf16_csr(BF16_MATRICES["ragged"])
    a = DeviceBSR.from_csr(csr, bm=200, bk=128, pad_multiple=3, device=cuda,
                           route="tile")
    x = bf16_operand((300, 77), 33, cuda)
    y = torch.empty((500, 77), dtype=torch.bfloat16, device=cuda)
    bsr_launch(a, x, y, cluster)
    assert_within_one_ulp(y, bsr_spmm_plain(a, x))
    p = DevicePanels.from_csr(csr, bk=128, band_rows=104, device=cuda)
    yp = torch.empty((500, 77), dtype=torch.bfloat16, device=cuda)
    panel_launch(p, x, yp, cluster)
    assert_within_one_ulp(yp, panel_spmm_plain(p, x))
    mask = create_mask("band_and_random", 200, 0.8, band_size=4, seed=14,
                       dtype="bfloat16")
    m = DeviceBSR.from_csr(mask, bm=200, bk=128, pad_multiple=4, device=cuda)
    q = bf16_operand((200, 70), 34, cuda)
    k = bf16_operand((200, 70), 35, cuda)
    out = torch.full(m.blocks.shape, float("nan"), dtype=torch.bfloat16,
                     device=cuda)
    sddmm_launch(m, q, k, out, cluster)
    assert_within_one_ulp(out, bsr_sddmm_plain(m, q, k))


# 3b's cases: (mask kind, side, sparsity, mask kwargs, (bm, bk), mq, mk,
# d, Q and K 2 bytes off 16); 4096^2 walks 559 tiles on one CTA an SM
SDDMM_BF16 = {
    "4096_random_d512": ("band_and_random", 4096, 0.95, {}, (128, 128),
                         4096, 4096, 512, False),
    "1000_decay_d77": ("band_and_decay", 1000, 0.9, {}, (128, 128), 1000,
                       1000, 77, False),
    "1000_random_d64_bk256": ("band_and_random", 1000, 0.8, {}, (64, 256),
                              1000, 1000, 64, False),
    "512_decay_d130_bm256": ("band_and_decay", 512, 0.9, {}, (256, 128),
                             512, 512, 130, False),
    "200_d70_bm200": ("band_and_random", 200, 0.8, {"band_size": 4},
                      (200, 128), 200, 200, 70, False),
    "1000_d96_mq_below_mk": ("band_and_decay", 1000, 0.9, {}, (128, 128),
                             900, 1000, 96, False),
    "1000_d96_k_below_cols": ("band_and_random", 1000, 0.8, {}, (128, 128),
                              1000, 900, 96, False),
    "600_d96_bm200": ("band_and_decay", 600, 0.8, {}, (200, 128), 560, 600,
                      96, False),
    "500_d64_bk100": ("band_and_random", 500, 0.8, {}, (128, 100), 500, 500,
                      64, False),
    "1000_d512_misaligned": ("band_and_random", 1000, 0.8, {}, (128, 128),
                             1000, 1000, 512, True),
}


def sddmm_bf16_case(name, device):
    """(bf16 mask layout, Q, K) of SDDMM_BF16[name]."""
    kind, side, sparsity, kwargs, (bm, bk), mq, mk, d, off = SDDMM_BF16[name]
    mask = create_mask(kind, side, sparsity, seed=36, dtype="bfloat16",
                       **kwargs)
    m = DeviceBSR.from_csr(mask, bm=bm, bk=bk, pad_multiple=4, device=device)
    make = misaligned_bf16 if off else bf16_operand
    return m, make((mq, d), 37, device), make((mk, d), 38, device)


@pytest.mark.parametrize("cluster", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("case", sorted(SDDMM_BF16))
def test_bsr_sddmm_bf16(cuda, case, cluster):
    """At each cluster size (0 the rule: the persistent walk where it gives
    1), into an output that starts as NaN: within 1 ulp of the plain
    version (pad blocks zero), the same bits twice; through the wrapper
    (cluster 0), one launch on bsr_sddmm_bf16's counter and the same bits
    by graph replay."""
    m, q, k = sddmm_bf16_case(case, cuda)

    def call():
        out = torch.full(m.blocks.shape, float("nan"), dtype=torch.bfloat16,
                         device=cuda)
        return sddmm_launch(m, q, k, out, cluster)

    got = call()
    assert_within_one_ulp(got, bsr_sddmm_plain(m, q, k))
    assert torch.equal(call(), got)
    if cluster != 0:
        return
    before = launch_counts()["bsr_sddmm_bf16"]
    assert torch.equal(bsr_sddmm(m, q, k), got)
    assert launch_counts()["bsr_sddmm_bf16"] == before + 1
    graph, out = captured(bsr_sddmm, m, q, k)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


def test_bsr_sddmm_bf16_launch(cuda):
    """The persistent walk on a mask of more tiles than 2 x SMs (one CTA
    an SM), a cluster a tile on a short grid, and the copy pass's scratch
    only where TMA cannot read Q and K as they lie."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    m, q, k = sddmm_bf16_case("4096_random_d512", cuda)
    shape, scratch = bf16_shape(m, q, k)
    assert shape.tiles == m.blocks.shape[0] > 2 * sms
    assert (shape.cluster, shape.ctas, shape.cols) == (1, sms, 128)
    assert shape.persistent and scratch == 0
    m, q, k = sddmm_bf16_case("200_d70_bm200", cuda)
    shape, scratch = bf16_shape(m, q, k)
    assert shape.cluster > 1 and shape.ctas == shape.tiles * shape.cluster
    assert scratch == 2 * (200 + 200) * 128
    m, q, k = sddmm_bf16_case("1000_d512_misaligned", cuda)
    assert bf16_shape(m, q, k)[1] == 2 * (1000 + 1000) * 512


@pytest.mark.parametrize("slab", [0, 64, 128, 256, 512])
def test_wcoo_bands_bf16_long_rows(cuda, slab):
    """Rows of more than LONG_ROW slots go to the long-row walk, whose
    warps' f32 sums are added in warp order before the one rounding, at
    each slab: bit for bit with the plain version, which sums so."""
    csr = bf16_csr(lambda: positive(hypersparse_edge()))
    a = DeviceWCOOBands.from_csr(csr, device=cuda)
    assert len(a.long_rows) > 0
    x = bf16_operand((csr.k, 200), 39, cuda)
    y = torch.full((csr.m, 200), float("nan"), dtype=torch.bfloat16,
                   device=cuda)
    bands_module.launch(a, x, y, slab)
    torch.cuda.synchronize()
    assert torch.equal(y, wcoo_spmm_aligned_plain(a, x))


# kernel formats whose f64 refusal is checked here: every kernel has a
# bf16 form, and none an f64 one
F32_ONLY_FORMATS = ("wcoo_cuda", "wcoo_spmv_cuda", "wrow_spmv_cuda",
                    "bsrc_cuda", "dgell_cuda", "wpack_spmv_cuda")


@pytest.mark.parametrize("fmt,dtype", [
    (fmt, "float64") for fmt in F32_ONLY_FORMATS])
def test_f32_only_formats_refuse_other_dtypes(cuda, fmt, dtype):
    from spgrid_torch.ops import dispatch
    csr = BF16_MATRICES["ragged"]().astype(dtype)
    with pytest.raises(ValueError, match=f"no {dtype} form.*ROADMAP"):
        dispatch.build(csr, fmt, device=cuda)


@pytest.mark.parametrize("kind", ["bsr", "panel", "sddmm", "bands"])
def test_hand_written_kernels_refuse_f64(cuda, kind):
    """An f64 operand raises, naming the dtype: no kernel computes in f32
    and calls the result f64."""
    csr = BF16_MATRICES["ragged"]()
    x = operand((csr.k, 8), 40, cuda).double()
    with pytest.raises(TypeError, match="float64"):
        if kind == "bsr":
            bsr_spmm(DeviceBSR.from_csr(csr, bm=128, bk=128, device=cuda), x)
        elif kind == "panel":
            panel_spmm(DevicePanels.from_csr(csr, device=cuda), x)
        elif kind == "sddmm":
            mask = DeviceBSR.from_csr(csr, bm=128, bk=128, device=cuda)
            bsr_sddmm(mask, operand((500, 8), 41, cuda).double(), x)
        else:
            wcoo_spmm_aligned(DeviceWCOOBands.from_csr(csr, device=cuda), x)


def test_f32_only_kernels_refuse_a_bf16_x(cuda):
    """A bf16 X against an f32 layout raises: each form takes operands of
    its own type only. (A DGELL layout holds f32 values at every dtype, so
    its bf16 form takes any DGELL layout; it refuses an f64 X.)"""
    csr = BF16_MATRICES["ragged"]()
    x = bf16_operand((csr.k, 8), 42, cuda)
    with pytest.raises(TypeError):
        wcoo_spmm(DeviceWCOO.from_csr(csr, device=cuda), x)
    with pytest.raises(TypeError):
        dgell_spmm(DeviceDGELL.from_csr(csr, device=cuda), x.double())
    with pytest.raises(TypeError):
        bsr_spmm_cstat(DeviceBSRCol.from_csr(csr, device=cuda), x)


# --- the SpMV path at bf16: wrow_spmv_bf16 (v1), wrow_spmv_v2_bf16,
# wcoo_spmv_bf16 and wpack_spmv_bf16 (wpack_spmv_bf16_prefix at wsel 1)
# against their plain versions on the same bf16 inputs, each rounding where
# the Pallas body rounds. v1 and wcoo_spmv's rows of at most a tile sum in
# the plain version's order (a row's group partial in slot order, then the
# groups in group order), so they give its bits. Elsewhere only the order
# of f32 sums differs, so they agree within 1 bf16 ulp of the plain result:
# v2 and WPACK at wsel 2 and 4 walk the row-ordered stream, each run of a
# row in a 32-slot pass summed by a segmented scan, then the passes, the
# warps' stretches and the ranges in order; the wsel-1 form sums each
# group's 8 pieces in piece order (the plain version's bits), then a
# block's rounded group sums in each CTA's order and the CTAs' partials in
# CTA order; a long wcoo_spmv row its partials in a tree.

def spmv_bf16_csr(make):
    return positive(make()).astype("bfloat16")


def dense_pieces():
    """384 x 1024 at 60 %: every (block, window) run ~9,800 nnz, so WPACK
    packs it at wsel 1 in pieces of 128 live lanes."""
    rng = np.random.default_rng(40)
    d = np.where(rng.random((384, 1024)) < 0.6,
                 rng.random((384, 1024)) + 0.5, 0.0)
    return dense_to_csr(d.astype(np.float32), name="dense_pieces")


SPMV_BF16_MATRICES = {"edge": hypersparse_edge, "long_row": long_row,
                      "scattered": scattered_line, "straddle": straddle,
                      "empty_blocks": empty_blocks,
                      "dense_pieces": dense_pieces}
SPMV_BF16_FORMS = {
    "wrow_v1": (lambda c, d: DeviceWROW.from_csr(c, device=d), wrow_spmv,
                wrow_spmv_plain, lambda a: "wrow_spmv_bf16"),
    "wrow_v2": (lambda c, d: DeviceWROW.from_csr(c, device=d),
                lambda a, x: wrow_spmv(a, x, variant="v2"),
                lambda a, x: wrow_spmv_plain(a, x, variant="v2"),
                lambda a: "wrow_spmv_v2_bf16"),
    "wcoo_spmv": (lambda c, d: DeviceWCOOAligned.from_csr(c, device=d),
                  wcoo_spmv, wcoo_spmv_plain, lambda a: "wcoo_spmv_bf16"),
    "wpack": (lambda c, d: DeviceWPACK.from_csr(c, device=d), wpack_spmv,
              wpack_spmv_plain,
              lambda a: ("wpack_spmv_bf16_prefix" if a.wsel == 1
                         else "wpack_spmv_bf16")),
}


def assert_as_plain(form, a, got, want):
    """Within 1 ulp of the plain version, and its bits on the rows that
    ``form`` sums in the plain version's order: every row of v1, every row
    of wcoo_spmv but those longer than a tile."""
    assert_within_one_ulp(got, want)
    if form == "wrow_v1":
        assert torch.equal(got, want)
    elif form == "wcoo_spmv":
        short = torch.diff(a.row_slot.long()) <= a.tile_slots
        assert torch.equal(got[short], want[short])


@pytest.mark.parametrize("form", sorted(SPMV_BF16_FORMS))
@pytest.mark.parametrize("matrix", sorted(SPMV_BF16_MATRICES))
def test_bf16_spmv_forms(cuda, form, matrix):
    """As its plain version (``assert_as_plain``), one launch on the form's
    own counter a call, the same bits twice and by graph replay."""
    csr = spmv_bf16_csr(SPMV_BF16_MATRICES[matrix])
    build, call, plain, counter = SPMV_BF16_FORMS[form]
    a = build(csr, cuda)
    x = bf16_operand((csr.k,), 43, cuda)
    before = launch_counts()[counter(a)]
    got = call(a, x)
    assert launch_counts()[counter(a)] == before + 1
    assert_as_plain(form, a, got, plain(a, x))
    assert torch.equal(call(a, x), got)
    graph, out = captured(call, a, x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


@pytest.mark.parametrize("wsel", [1, 2, 4])
@pytest.mark.parametrize("matrix", ["edge", "dense_pieces", "straddle"])
def test_wpack_bf16_at_every_wsel(cuda, matrix, wsel):
    """The wsel-1 form (the TPU body's bf16 prefix) and the stream walk at
    wsel 2 and 4, each within 1 ulp of its plain version; a piece of 128
    live lanes on dense_pieces."""
    csr = spmv_bf16_csr(SPMV_BF16_MATRICES[matrix])
    a = DeviceWPACK.from_csr(csr, wsel, device=cuda)
    if matrix == "dense_pieces":
        assert int(a.piece_lanes.max()) == 128
    x = bf16_operand((csr.k,), 44, cuda)
    got = wpack_spmv(a, x)
    assert_within_one_ulp(got, wpack_spmv_plain(a, x))
    assert torch.equal(wpack_spmv(a, x), got)


@pytest.mark.parametrize("groups_per_cta", GROUPS_PER_CTA)
def test_wpack_bf16_prefix_at_every_warp_form(cuda, groups_per_cta):
    """The wsel-1 form (a warp a piece) at each count of groups a CTA: a
    block's groups summed in each CTA's order, then the CTAs' partials in
    order; 1 ulp, the same bits twice and by graph replay."""
    csr = spmv_bf16_csr(dense_pieces)
    a = DeviceWPACK.from_csr(csr, 1, device=cuda)
    x = bf16_operand((csr.k,), 45, cuda)

    def call(a, x):
        y = torch.empty((csr.m,), dtype=torch.bfloat16, device=cuda)
        launch_prefix_bf16(a, x, y, groups_per_cta)
        return y

    got = call(a, x)
    assert_within_one_ulp(got, wpack_spmv_plain(a, x))
    assert torch.equal(call(a, x), got)
    graph, out = captured(call, a, x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


@pytest.mark.parametrize("slots_per_cta", [1, 7, 100, 128, 1000, 2048])
@pytest.mark.parametrize("form", ["wrow_v2", "wpack"])
def test_bf16_stream_walk_at_every_range(cuda, form, slots_per_cta):
    """The bf16 row walk with rows cut by many ranges (the carry combine),
    rows and warps' stretches cut mid-run (100, 1000) and with ranges of
    whole rows: 1 ulp, the same bits twice and by graph replay."""
    csr = spmv_bf16_csr(straddle)
    if form == "wpack":
        a = DeviceWPACK.from_csr(csr, 2, device=cuda)
        call = functools.partial(wpack_spmv, slots_per_cta=slots_per_cta)
        plain = wpack_spmv_plain
    else:
        a = DeviceWROW.from_csr(csr, device=cuda)
        call = functools.partial(wrow_spmv_v2, slots_per_cta=slots_per_cta)
        plain = functools.partial(wrow_spmv_plain, variant="v2")
    x = bf16_operand((csr.k,), 46, cuda)
    got = call(a, x)
    assert_within_one_ulp(got, plain(a, x))
    assert torch.equal(call(a, x), got)
    graph, out = captured(call, a, x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


@pytest.mark.parametrize("tile_slots", TILE_CHOICES)
@pytest.mark.parametrize("matrix", ["long_row", "edge", "scattered"])
def test_wcoo_spmv_bf16_at_every_tile_size(cuda, matrix, tile_slots):
    """Tiles of rows, and a row longer than a tile (long_row's 3,000
    slots), whose groups each thread that holds a group's first slot
    sums."""
    csr = spmv_bf16_csr(SPMV_BF16_MATRICES[matrix])
    a = DeviceWCOOAligned.from_csr(csr, device=cuda).tiled(tile_slots)
    x = bf16_operand((csr.k,), 47, cuda)
    y = torch.empty((csr.m,), dtype=torch.bfloat16, device=cuda)
    wcoo_spmv_module.launch(a, x, y)
    assert_as_plain("wcoo_spmv", a, y, wcoo_spmv_plain(a, x))
    y2 = torch.empty_like(y)
    wcoo_spmv_module.launch(a, x, y2)
    torch.cuda.synchronize()
    assert torch.equal(y, y2)


def v1_v2_rows():
    """2048 x 8192 at 0.4 % (~33 nnz a row over 64 windows, so most rows
    hold several groups), values and x in [0.5, 1.5): every product of two
    bf16 numbers has at most 16 significant bits and lies below 2.25, so
    every row's f32 sum of products is exact in any order."""
    rng = np.random.default_rng(41)
    d = np.where(rng.random((2048, 8192)) < 0.004,
                 rng.random((2048, 8192)) + 0.5, 0.0)
    return dense_to_csr(d.astype(np.float32), name="v1_v2_rows")


def test_wrow_bf16_v1_and_v2_differ_where_their_plain_versions_do(cuda):
    """v1 rounds each group's sum for a row, v2 does not. Where f32 sums
    are exact in any order, each kernel gives its plain version's bits, so
    the two kernels differ on exactly the rows where the plain versions
    do, and on some rows."""
    csr = v1_v2_rows().astype("bfloat16")
    a = DeviceWROW.from_csr(csr, device=cuda)
    x = bf16_operand((csr.k,), 49, cuda)
    v1, v2 = wrow_spmv(a, x), wrow_spmv(a, x, variant="v2")
    p1 = wrow_spmv_plain(a, x)
    p2 = wrow_spmv_plain(a, x, variant="v2")
    torch.cuda.synchronize()
    assert int((p1 != p2).sum()) >= 10
    assert torch.equal(v1, p1)
    assert torch.equal(v2, p2)
    assert torch.equal(v1 != v2, p1 != p2)


def test_wpack_bf16_wsel_1_takes_no_slots_per_cta(cuda):
    csr = spmv_bf16_csr(dense_pieces)
    a = DeviceWPACK.from_csr(csr, 1, device=cuda)
    with pytest.raises(ValueError):
        wpack_spmv(a, bf16_operand((csr.k,), 44, cuda), slots_per_cta=128)


def test_bf16_spmv_forms_refuse_an_f32_x(cuda):
    csr = spmv_bf16_csr(hypersparse_edge)
    x = bf16_operand((csr.k,), 48, cuda).float()
    for build, call, _, _ in SPMV_BF16_FORMS.values():
        with pytest.raises(TypeError):
            call(build(csr, cuda), x)


# --- the last kernel forms: bsr_sddmm_bf16x3 (matmul precision 'high'),
# bsr_spmm_cstat_bf16, wcoo_spmm_bf16 and dgell_spmm_bf16 against their
# plain versions on the same inputs. The 3-pass form sums each pass's 64-deep
# steps on the tensor cores (products exact, the accumulate truncating) and
# the plain version each pass exactly in f64: on positive operands within
# 1e-6 relative. The bf16 forms: within 1 bf16 ulp (f32 sums in another
# order, one rounding); dgell's FMA chain is its row-order plain version's
# bit for bit (a product of a bf16 X element and a value that bf16 holds is
# exact in f32), and wcoo's rows of at most LONG_ROW slots are its plain
# version's on the CPU bit for bit (the rounded products added in stream
# order).

def assert_rel_1e6(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.float32
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.double(), want.double(), rtol=1e-6,
                               atol=0)


# 3c's cases: (mask kind, side, sparsity, mask kwargs, (bm, bk), mq, mk, d).
# The masks of the first five are the form's first cases (Q and K as many
# rows as the mask); then d neither a multiple of 8 nor of 64 (70) or of 64
# (96), Q and K of other row counts than each other and the mask (Q fewer
# rows than the mask's, K more than its columns: the plain version reads a
# block column of K past mk as an index error), pad blocks (pad_multiple 4
# below), bm = 200 in two row slices, bk = 64 (a tile of 128 columns past
# the block's)
X3_CASES = {
    "4096_decay_d512": ("band_and_decay", 4096, 0.95, {}, (128, 128), 4096,
                        4096, 512),
    "4096_random_d512": ("band_and_random", 4096, 0.95, {}, (128, 128),
                         4096, 4096, 512),
    "1000_decay_d77": ("band_and_decay", 1000, 0.9, {}, (128, 128), 1000,
                       1000, 77),
    "1000_random_d64_bk256": ("band_and_random", 1000, 0.8, {}, (64, 256),
                              1000, 1000, 64),
    "512_decay_d130_bm256": ("band_and_decay", 512, 0.9, {}, (256, 128), 512,
                             512, 130),
    "200_d70_bm200": ("band_and_random", 200, 0.8, {"band_size": 4},
                      (200, 128), 200, 200, 70),
    "1000_d96_mq_below_mk": ("band_and_decay", 1000, 0.9, {}, (128, 128),
                             900, 1000, 96),
    "1000_d70_mk_above_mq_bk64": ("band_and_random", 1000, 0.8, {},
                                  (128, 64), 1000, 1030, 70),
    "600_d96_bm200": ("band_and_decay", 600, 0.8, {}, (200, 128), 560, 600,
                      96),
    "1000_d96_k_below_cols": ("band_and_random", 1000, 0.8, {}, (128, 128),
                              1000, 900, 96),
}


def x3_case(name, device):
    """(mask layout, Q, K) of X3_CASES[name]."""
    kind, side, sparsity, kwargs, (bm, bk), mq, mk, d = X3_CASES[name]
    mask = create_mask(kind, side, sparsity, seed=36, **kwargs)
    m = DeviceBSR.from_csr(mask, bm=bm, bk=bk, pad_multiple=4, device=device)
    return m, operand((mq, d), 43, device), operand((mk, d), 44, device)


@pytest.mark.parametrize("case", sorted(X3_CASES))
def test_bsr_sddmm_bf16x3(cuda, case):
    """Within 1e-6 of the plain version (pad blocks zero), one launch on
    bsr_sddmm_bf16x3's counter, the same bits twice and by graph replay."""
    m, q, k = x3_case(case, cuda)
    assert int((m.block_rows == m.mb).sum()) > 0   # pad blocks
    before = launch_counts()["bsr_sddmm_bf16x3"]
    got = bsr_sddmm(m, q, k, precision="high")
    assert launch_counts()["bsr_sddmm_bf16x3"] == before + 1
    assert_rel_1e6(got, bsr_sddmm_bf16x3_plain(m, q, k))
    assert torch.equal(bsr_sddmm(m, q, k, precision="high"), got)
    graph, out = captured(lambda *a: bsr_sddmm(*a, precision="high"), m, q,
                          k)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


def test_bsr_sddmm_bf16x3_is_not_the_f32_form(cuda):
    """On operands of both signs the 3-pass form lies within 1e-6 of its
    plain version and farther than that from the f32 product (the dropped
    lo x lo term)."""
    mask = create_mask("band_and_decay", 1000, 0.9, seed=36)
    m = DeviceBSR.from_csr(mask, bm=128, bk=128, device=cuda)
    g = torch.Generator(device="cpu").manual_seed(45)
    q = torch.randn((1000, 96), generator=g).to(cuda)
    k = torch.randn((1000, 96), generator=g).to(cuda)
    high = bsr_sddmm(m, q, k, precision="high")
    want = bsr_sddmm_bf16x3_plain(m, q, k)
    torch.cuda.synchronize()
    scale = want.abs().max()
    assert (high - want).abs().max() <= 1e-6 * scale
    f32 = bsr_sddmm_plain(m, q.double(), k.double())
    assert (want.double() - f32).abs().max() > 1e-6 * scale


@pytest.mark.parametrize("cluster", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("case", [c for c in sorted(X3_CASES)
                                  if not c.startswith("4096")])
def test_bsr_sddmm_bf16x3_at_every_cluster_size(cuda, case, cluster):
    """The C entry point (split pass, then the tiles, into scratch of the
    bytes its shape entry reports) at each cluster size on the ragged
    cases: every output element written (it starts as NaN), within 1e-6 of
    the plain version, the same bits on two calls."""
    from spgrid_torch.ops.kernels import _build
    m, q, k = x3_case(case, cuda)
    nb, bm, bk = m.blocks.shape
    (mq, d), mk = q.shape, k.shape[0]
    scratch = torch.empty(x3_shape(m, mq, mk, d)[1], dtype=torch.uint8,
                          device=cuda)

    def call():
        out = torch.full((nb, bm, bk), float("nan"), device=cuda)
        _build.check(_build.library().spgrid_bsr_sddmm_bf16x3(
            m.block_rows.data_ptr(), m.block_cols.data_ptr(),
            m.blocks.data_ptr(), q.data_ptr(), k.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), nb, bm, bk, mq, mk, d, cluster,
            torch.cuda.current_stream().cuda_stream), "bsr_sddmm_bf16x3")
        return out

    out = call()
    assert_rel_1e6(out, bsr_sddmm_bf16x3_plain(m, q, k))
    assert torch.equal(call(), out)


@pytest.mark.parametrize("mq,mk,d", [(200, 200, 70), (900, 1000, 96),
                                     (5, 3, 130), (1, 7, 1), (64, 0, 512),
                                     (3, 2, 0)])
def test_bsr_sddmm_bf16x3_split_planes_equal_the_plain_split(cuda, mq, mk,
                                                             d):
    """The split pass's planes element for element against the plain split
    (``split_bf16`` of Q and K of both signs, zero-padded to whole steps
    and to at least one row), every byte of the scratch written (it starts
    as 0xFF), and the scratch bytes its shape entry reports those of
    ``plane_shape``."""
    g = torch.Generator(device="cpu").manual_seed(47)
    q = (torch.randn((mq, d), generator=g) * 3).to(cuda)
    k = (torch.randn((mk, d), generator=g) / 3).to(cuda)
    m = DeviceBSR.from_csr(create_mask("band_and_decay", 256, 0.5, seed=3),
                           bm=128, bk=128, device=cuda)
    rq, rk, dp = plane_shape(mq, mk, d)
    assert dp % 64 == 0 and dp >= max(d, 1)
    nbytes = x3_shape(m, mq, mk, d)[1]
    assert nbytes == 2 * 2 * (rq + rk) * dp
    scratch = torch.full((nbytes,), 0xFF, dtype=torch.uint8, device=cuda)
    split_launch(q, k, scratch)
    torch.cuda.synchronize()
    for got, want in zip(split_planes(scratch, mq, mk, d),
                         split_planes_plain(q, k)):
        assert got.shape == want.shape
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


# --- the SpMMs' 3-pass forms (matmul precision 'high'): 1c, 2c and 4c on
# the f32 forms' cases against their plain versions on the same inputs, as
# 3c's: positive operands, within 1e-6 relative (the plain version sums
# each pass exactly in f64, the tiles 64-deep steps on the tensor cores);
# one launch on the form's counter, the same bits twice and by graph
# replay. python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
# -k bf16x3

def x3_checked(fn, counter, plain, *args):
    """fn(*args): one launch on ``counter``, within 1e-6 of ``plain``, the
    same bits on a second call and by graph replay."""
    before = launch_counts()[counter]
    got = fn(*args)
    assert launch_counts()[counter] == before + 1
    assert_rel_1e6(got, plain(*args))
    assert torch.equal(fn(*args), got)
    graph, out = captured(fn, *args)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)
    return got


def high(fn):
    return functools.partial(fn, precision="high")


@pytest.mark.parametrize("x_layout", ["aligned", "misaligned"])
@pytest.mark.parametrize("n", [1, 77, 512])
@pytest.mark.parametrize("case", sorted(SPMM))
def test_bsr_spmm_bf16x3(cuda, case, n, x_layout):
    make, bm, pad = SPMM[case]
    csr = make()
    a = DeviceBSR.from_csr(csr, bm=bm, bk=128, pad_multiple=pad, device=cuda)
    x = (operand if x_layout == "aligned" else misaligned)((csr.k, n), 5,
                                                           cuda)
    x3_checked(high(bsr_spmm), "bsr_spmm_bf16x3", bsr_spmm_bf16x3_plain, a,
               x)


@pytest.mark.parametrize("x_layout", ["aligned", "misaligned"])
@pytest.mark.parametrize("n", [1, 70, 512])
@pytest.mark.parametrize("case", sorted(PANELS))
def test_panel_spmm_bf16x3(cuda, case, n, x_layout):
    make, band_rows = PANELS[case]
    csr = make()
    a = DevicePanels.from_csr(csr, bk=128, band_rows=band_rows, device=cuda)
    x = (operand if x_layout == "aligned" else misaligned)((csr.k, n), 6,
                                                           cuda)
    x3_checked(high(panel_spmm), "panel_spmm_bf16x3",
               panel_spmm_bf16x3_plain, a, x)


@pytest.mark.parametrize("case", sorted(BSRC))
def test_bsr_spmm_cstat_bf16x3(cuda, case):
    make, bm, bk, band_rows, n, layout = BSRC[case]
    csr = make()
    a = DeviceBSRCol.from_csr(csr, bm=bm, bk=bk, band_rows=band_rows,
                              device=cuda)
    x = (operand((csr.k, n), 12, cuda) if layout == "plain"
         else misaligned((csr.k, n), 12, cuda))
    x3_checked(high(bsr_spmm_cstat), "bsr_spmm_cstat_bf16x3",
               bsr_spmm_cstat_bf16x3_plain, a, x)


@pytest.mark.parametrize("cluster", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("form", ["bsr", "panel"])
def test_spmm_bf16x3_at_every_cluster_size(cuda, form, cluster):
    """1c and 2c's C entry points at each cluster size into a Y that starts
    as NaN: every element written, within 1e-6 of the plain version, the
    same bits on two calls."""
    csr = positive(random_csr(500, 300, 0.2, seed=6))
    if form == "bsr":
        a = DeviceBSR.from_csr(csr, bm=200, bk=128, pad_multiple=3,
                               device=cuda)
        launch_x3, plain = bsr_x3_launch, bsr_spmm_bf16x3_plain
    else:
        a = DevicePanels.from_csr(csr, bk=128, band_rows=300, device=cuda)
        launch_x3, plain = panel_x3_launch, panel_spmm_bf16x3_plain
    x = operand((csr.k, 200), 5, cuda)

    def call():
        y = torch.full((csr.m, 200), float("nan"), device=cuda)
        launch_x3(a, x, y, cluster)
        return y

    y = call()
    assert_rel_1e6(y, plain(a, x))
    assert torch.equal(call(), y)


def test_spmm_bf16x3_is_not_the_f32_form(cuda):
    """On operands of both signs each 3-pass form lies within 1e-6 (of the
    largest magnitude) of its plain version and farther than that from the
    f32 product (the dropped lo x lo term)."""
    g = torch.Generator(device="cpu").manual_seed(45)
    csr = random_csr(600, 500, 0.3, seed=9)
    x = torch.randn((500, 256), generator=g).to(cuda)
    f32 = torch.from_numpy(csr.to_dense()).double().to(cuda) @ x.double()
    for layout, fn, plain in (
            (DeviceBSR.from_csr(csr, bm=128, bk=128, device=cuda), bsr_spmm,
             bsr_spmm_bf16x3_plain),
            (DevicePanels.from_csr(csr, device=cuda), panel_spmm,
             panel_spmm_bf16x3_plain),
            (DeviceBSRCol.from_csr(csr, device=cuda), bsr_spmm_cstat,
             bsr_spmm_cstat_bf16x3_plain)):
        got = fn(layout, x, precision="high")
        want = plain(layout, x)
        torch.cuda.synchronize()
        scale = want.abs().max()
        assert (got - want).abs().max() <= 1e-6 * scale
        assert (want.double() - f32).abs().max() > 1e-6 * scale


def packed_panel_rows(a):
    """2c's packed panel rows: for live pair p (the p-th of slice_slots),
    ((its plane rows p 128 .. p 128 + rows - 1), the panel rows they hold)
    as (plane row, slot, panel row) index tensors."""
    ptr = a.slice_ptr.cpu().tolist()
    slots = a.slice_slots.cpu().tolist()
    per = -(-a.band_rows // 128)
    plane, slot, row = [], [], []
    for s in range(len(ptr) - 1):
        i0 = s % per * 128
        rows = min(128, a.band_rows - i0)
        for p in range(ptr[s], ptr[s + 1]):
            plane += range(p * 128, p * 128 + rows)
            slot += [slots[p]] * rows
            row += range(i0, i0 + rows)
    return (torch.tensor(plane), torch.tensor(slot), torch.tensor(row))


@pytest.mark.parametrize("form", ["bsr", "bsrc", "panel"])
def test_spmm_bf16x3_split_planes_equal_the_plain_split(cuda, form):
    """The SpMMs' split alone against the plain split of operands of both
    signs, element for element: 1c's and 4c's (``split_pair`` over their
    blocks, pad blocks included, and X) every byte of the scratch written
    (it starts as 0xFF); 2c's the live pairs' panel rows packed 128 rows a
    pair, then X, its scratch only the live pairs' (fewer than the
    panels' on a matrix with dead slices)."""
    g = torch.Generator(device="cpu").manual_seed(48)
    csr = random_csr(700, 300, 0.004, seed=10)
    n = 96
    x = (torch.randn((300, n), generator=g) * 3).to(cuda)
    if form == "bsr":
        a = DeviceBSR.from_csr(csr, bm=200, bk=128, pad_multiple=3,
                               device=cuda)
        nbytes = bsr_x3_shape(a, n)[1]
    elif form == "bsrc":
        a = DeviceBSRCol.from_csr(csr, device=cuda)
        nbytes = bsrc_x3_shape(a, n)[1]
    else:
        a = DevicePanels.from_csr(csr, bk=128, band_rows=300, device=cuda)
        nbytes = panel_x3_shape(a, n)[1]
    g2 = torch.Generator(device="cpu").manual_seed(49)
    blocks = (torch.randn(a.panels.shape if form == "panel"
                          else a.blocks.shape, generator=g2) / 3).to(cuda)
    if form == "panel":
        a = dataclasses.replace(a, panels=blocks)
        pairs = a.slice_slots.numel()
        assert pairs < a.bands * a.max_p * -(-a.band_rows // 128)
        rows = 128 * max(pairs, 1)
    else:
        a = dataclasses.replace(a, blocks=blocks)
        rows = blocks.shape[0] * blocks.shape[1]
    dp, dx = plane_cols(a.bk), plane_cols(n)
    assert nbytes == 2 * 2 * (rows * dp + 300 * dx)
    scratch = torch.full((nbytes,), 0xFF, dtype=torch.uint8, device=cuda)
    if form == "panel":
        panel_x3_split(a, x, scratch)
        plane, slot, row = packed_panel_rows(a)
        a_rows = torch.zeros((rows, a.bk), device=cuda)
        a_rows[plane] = blocks[slot, row]
    else:
        split_launch(blocks.reshape(-1, a.bk), x, scratch)
        a_rows = blocks.reshape(-1, a.bk)
        plane = torch.arange(rows)
    torch.cuda.synchronize()
    flat = scratch.view(torch.bfloat16)
    got = (flat[:rows * dp].view(rows, dp),
           flat[rows * dp:2 * rows * dp].view(rows, dp),
           flat[2 * rows * dp:2 * rows * dp + 300 * dx].view(300, dx),
           flat[2 * rows * dp + 300 * dx:].view(300, dx))
    want = split_planes_plain(a_rows, x)
    plane = plane.to(cuda)
    for i, (g_, w_) in enumerate(zip(got, want)):
        if i < 2:
            g_, w_ = g_[plane], w_[plane]
        assert torch.equal(g_.view(torch.int16), w_.view(torch.int16))


@pytest.mark.parametrize("case", sorted(BSRC))
def test_bsr_spmm_cstat_bf16_kernel(cuda, case):
    """Every band size, block shape, n and X layout of the f32 form's cases:
    within 1 ulp of the plain version, one launch on its own counter, the
    same bits twice and by graph replay."""
    make, bm, bk, band_rows, n, layout = BSRC[case]
    csr = bf16_csr(make)
    a = DeviceBSRCol.from_csr(csr, bm=bm, bk=bk, band_rows=band_rows,
                              device=cuda)
    assert a.blocks.dtype == torch.bfloat16
    ctas, cols, rows = bsrc_launch_grid(a, n)
    assert cols == 64 and rows == 128 // bm * bm
    x = (bf16_operand((csr.k, n), 48, cuda) if layout == "plain"
         else misaligned_bf16((csr.k, n), 48, cuda))
    before = launch_counts()["bsr_spmm_cstat_bf16"]
    got = bsr_spmm_cstat(a, x)
    assert launch_counts()["bsr_spmm_cstat_bf16"] == before + 1
    assert_within_one_ulp(got, bsr_spmm_cstat_plain(a, x))
    assert torch.equal(bsr_spmm_cstat(a, x), got)
    graph, out = captured(bsr_spmm_cstat, a, x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


BF16_SLOT_MATRICES = {
    **BF16_MATRICES, "edge": lambda: positive(hypersparse_edge()),
    "hypersparse": lambda: positive(SLOT_MATRICES["hypersparse"]())}


@pytest.mark.parametrize("matrix", sorted(BF16_SLOT_MATRICES))
@pytest.mark.parametrize("n,x_layout", [(512, "aligned"), (77, "aligned"),
                                        (200, "aligned"),
                                        (64, "misaligned")])
def test_wcoo_spmm_bf16_kernel(cuda, matrix, n, x_layout):
    """Within 1 ulp of the plain version on the card, and its CPU plain
    version's bits where no row takes the long-row walk; one launch, the
    same bits twice and by graph replay."""
    csr = bf16_csr(BF16_SLOT_MATRICES[matrix])
    a = DeviceWCOO.from_csr(csr, R=256, device=cuda)
    make_x = bf16_operand if x_layout == "aligned" else misaligned_bf16
    x = make_x((csr.k, n), 49, cuda)
    before = launch_counts()["wcoo_spmm_bf16"]
    got = wcoo_spmm(a, x)
    assert launch_counts()["wcoo_spmm_bf16"] == before + 1
    assert_within_one_ulp(got, wcoo_spmm_plain(a, x))
    if a.long_rows.numel() == 0:
        host = DeviceWCOO.from_csr(csr, R=256, device="cpu")
        assert torch.equal(got.cpu(), wcoo_spmm_plain(host, x.cpu()))
    assert torch.equal(wcoo_spmm(a, x), got)
    graph, out = captured(wcoo_spmm, a, x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


def bf16_edge():
    return bf16_csr(lambda: positive(hypersparse_edge()))


# the f32 form's cases (DGELL) on bf16 matrices (their values are the f32
# numbers bf16 holds, as the layout keeps them); wide_k at n = 600 (the
# 16-byte form), whose 150,000 rows take the slab rule to several slabs,
# the last a ragged one
DGELL_BF16 = {
    "wide_k_n600": (lambda d: DeviceDGELL.from_csr(
        bf16_csr(lambda: positive(wide_k())), device=d), 600, "plain"),
    "edge_n77": (lambda d: DeviceDGELL.from_csr(bf16_edge(), device=d), 77,
                 "plain"),
    "edge_misaligned": (lambda d: DeviceDGELL.from_csr(bf16_edge(),
                                                       device=d), 200,
                        "misaligned"),
    "tail_only_n64": (lambda d: tail_only(bf16_edge(), d), 64, "plain"),
    "tail_only_n13": (lambda d: tail_only(bf16_edge(), d), 13,
                      "misaligned"),
    "m5": (lambda d: DeviceDGELL.from_csr(bf16_csr(lambda: positive(
        random_csr(5, 300, 0.2, seed=2))), device=d), 40, "plain"),
}


@pytest.mark.parametrize("case", sorted(DGELL_BF16))
def test_dgell_bf16_kernel_cases(cuda, case):
    """The f32 form's cases at bf16 (several slabs, the scalar form, a
    misaligned X, rows of tail nnz only, fewer rows than a CTA's): the row-
    order plain version's bits, one launch, the same bits twice and by
    graph replay."""
    make, n, layout = DGELL_BF16[case]
    a = make(cuda)
    k = a.shape[1]
    x = (bf16_operand((k, n), 50, cuda) if layout == "plain"
         else misaligned_bf16((k, n), 50, cuda))
    if case.startswith("wide_k"):
        assert launch_shape(k, n, dtype=torch.bfloat16).slabs > 1
    before = launch_counts()["dgell_bf16"]
    got = dgell_spmm(a, x)
    assert launch_counts()["dgell_bf16"] == before + 1
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, dgell_rows_plain(a, x))
    assert_within_one_ulp(got, dgell_spmm_plain(a, x))
    assert torch.equal(dgell_spmm(a, x), got)
    graph, out = captured(dgell_spmm, a, x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


def offset8_bf16(shape, seed, device):
    """A contiguous bf16 operand whose data starts 8 bytes past a 16-byte
    boundary: 8-byte loads of it, no 16-byte ones."""
    x = bf16_operand((int(np.prod(shape)) + 4,), seed, device)[4:]
    return x.view(shape)


# X and Y of the bf16 form's vector forms: (make, the form a launch takes
# where n % 8 == 0: 2 the 16-byte vector, 1 the 8-byte one, 0 the scalar)
BF16_LAYOUTS = {"plain": (bf16_operand, 2), "offset8": (offset8_bf16, 1),
                "misaligned": (misaligned_bf16, 0)}


@pytest.mark.parametrize("slab", [0, 8, 16, 32, 64, 128, 512, "n"])
@pytest.mark.parametrize("n,layout", [(96, "plain"), (77, "plain"),
                                      (200, "misaligned"), (200, "plain"),
                                      (512, "plain"), (96, "offset8")])
def test_dgell_bf16_kernel_at_every_slab(cuda, slab, n, layout):
    """The bf16 C entry point at each slab width of the f32 form's sweep on
    the edge matrix, in each vector form (the 16-byte one where n % 8 == 0
    and X and Y lie on 16 bytes; 8 bytes off, the 8-byte one): every slab
    of Y written (it starts as NaN), the row-order plain version's bits,
    the same bits on two calls."""
    csr = bf16_edge()
    a = DeviceDGELL.from_csr(csr, device=cuda)
    make, vec = BF16_LAYOUTS[layout]
    x = make((csr.k, n), 51, cuda)
    slab = n if slab == "n" else slab
    y = make((csr.m, n), 52, cuda).fill_(float("nan"))
    launch(a, x, y, slab)
    torch.cuda.synchronize()
    assert torch.equal(y, dgell_rows_plain(a, x))
    again = make((csr.m, n), 53, cuda).fill_(float("nan"))
    launch(a, x, again, slab)
    assert torch.equal(y, again)
    vec = vec if n % 8 == 0 else min(vec, 1) if n % 4 == 0 else 0
    shape = launch_shape(csr.k, n, slab, vec, dtype=torch.bfloat16)
    assert shape.slabs == -(-n // shape.slab)
    assert shape.slab == (n if slab in (0, 512, n) or slab >= n else slab)


def test_dgell_bf16_slab_rule_takes_the_f32_rules_slab(cuda):
    """At a k whose f32 slab rule stops below n, the bf16 rule takes the
    same columns, the widest slab whose k x C floats fit in half of the
    card's L2 (its bf16 X a quarter); and the launch that ``launch_plan``
    (the rule in Python) predicts, at every vector form and at slabs given,
    on the card's L2."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    f32 = launch_shape(150000, 512).slab
    assert f32 < 512
    assert launch_shape(150000, 512, dtype=torch.bfloat16).slab == f32
    assert 4 * 150000 * f32 <= l2 // 2 < 4 * 150000 * (2 * f32)
    shape = launch_shape(150000, 600, dtype=torch.bfloat16)
    assert (shape.slab, shape.slabs) == (f32, -(-600 // f32))
    for k in (150000, 100000, 5000):
        for n in (512, 96, 600, 77):
            for slab in (0, 64, 128, 512):
                for vec, width in ((2, 8), (1, 4), (0, 1)):
                    assert launch_shape(k, n, slab, vec, torch.bfloat16) == \
                        launch_plan(k, n, l2, width, slab)[0]
                assert launch_shape(k, n, slab, True) == \
                    launch_plan(k, n, l2, 4, slab)[0]


# --- 1b's two routes and the pipelined bf16 tile (1b and 2b): the entry
# route's walk, the tile route on the pipelined TMA tile (n and bk
# multiples of 8, operands on 16 bytes) or the cp.async tile, and matrices
# whose block rows take both

def route_band():
    """~8 nnz a row over a wide band: every 128^2 block on the entry
    route."""
    return artificial_matrix_generation(
        2048, 2048, 8, 2.6667, "normal", seed=14, placement="random",
        bw=0.9, skew=0, avg_num_neighbours=0.05, cross_row_similarity=0.5,
        name="route_band")


def route_mixed():
    """Block rows of a dense block beside sparse ones (the tile), a block
    row of sparse blocks with a long row, an empty block row (walked)."""
    rng = np.random.default_rng(3)
    d = np.zeros((520, 384), np.float32)
    d[:128, :128] = rng.random((128, 128)) + 0.5
    d[:128, 256:] = (rng.random((128, 128)) < 0.004) * 1.5
    d[256:384] = (rng.random((128, 384)) < 0.003) * 1.25
    d[300, :200] = 0.625                      # a long walked row
    d[384:, 128:256] = rng.random((136, 128)) + 0.5
    d[384:, :128] = (rng.random((136, 128)) < 0.002) * 0.75
    return dense_to_csr(d, name="route_mixed")


ROUTE_MATRICES = {"twin": headline_matrix, "band": route_band,
                  "mixed": route_mixed,
                  "empty_rows": lambda: with_empty_rows(400, 260, 11)}


@pytest.mark.parametrize("route", ["auto", "tile", "entry"])
@pytest.mark.parametrize("matrix", sorted(ROUTE_MATRICES))
@pytest.mark.parametrize("n,x_layout", [(512, "aligned"), (136, "aligned"),
                                        (77, "aligned"),
                                        (64, "misaligned")])
def test_bsr_spmm_bf16_under_each_route(cuda, route, matrix, n, x_layout):
    """Within 1 ulp of the plain version under the chosen and each forced
    route, one launch a call (and one of each kernel the route runs), the
    same bits twice and by graph replay."""
    csr = bf16_csr(ROUTE_MATRICES[matrix])
    a = DeviceBSR.from_csr(csr, bm=128, bk=128, device=cuda, route=route)
    make_x = bf16_operand if x_layout == "aligned" else misaligned_bf16
    x = make_x((csr.k, n), 61, cuda)
    from spgrid_torch.ops.kernels.bsr_spmm import bsr_spmm_bf16
    before = (launch_counts()["bsr_spmm_bf16"], bsr_spmm_bf16.tile_launches,
              bsr_spmm_bf16.entry_launches)
    got = bsr_spmm(a, x)
    after = (launch_counts()["bsr_spmm_bf16"], bsr_spmm_bf16.tile_launches,
             bsr_spmm_bf16.entry_launches)
    assert after[0] == before[0] + 1
    assert after[1] - before[1] == int(a.route.tile_slices.numel() > 0)
    assert after[2] - before[2] == int(a.route.walk_rows.numel() > 0)
    assert_within_one_ulp(got, bsr_spmm_plain(a, x))
    assert torch.equal(bsr_spmm(a, x), got)
    graph, out = captured(bsr_spmm, a, x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


@pytest.mark.parametrize("n", [512, 77])
@pytest.mark.parametrize("route", ["auto", "tile"])
@pytest.mark.parametrize("cluster", [0, 1, 2, 4, 8])
def test_bsr_spmm_bf16_routes_at_every_cluster_size(cuda, cluster, route, n):
    """The tile route (pipelined at n = 512, cp.async at n = 77) at each
    cluster size, beside walked rows or alone: 1 ulp, the same bits
    twice."""
    csr = bf16_csr(route_mixed)
    a = DeviceBSR.from_csr(csr, bm=128, bk=128, device=cuda, route=route)
    x = bf16_operand((csr.k, n), 62, cuda)
    y = torch.empty((csr.m, n), dtype=torch.bfloat16, device=cuda)
    again = torch.empty_like(y)
    bsr_launch(a, x, y, cluster)
    bsr_launch(a, x, again, cluster)
    assert_within_one_ulp(y, bsr_spmm_plain(a, x))
    assert torch.equal(y, again)


@pytest.mark.parametrize("bm,n", [(64, 512), (200, 96), (256, 136),
                                  (8, 64), (200, 77)])
@pytest.mark.parametrize("route", ["auto", "tile", "entry"])
def test_bsr_spmm_bf16_routes_at_other_block_heights(cuda, bm, n, route):
    """Block rows below one warpgroup, of ragged and full slices, and of 8
    rows (the threshold scaled to the block), on both tiles."""
    csr = bf16_csr(route_mixed)
    a = DeviceBSR.from_csr(csr, bm=bm, bk=128, pad_multiple=3, device=cuda,
                           route=route)
    x = bf16_operand((csr.k, n), 63, cuda)
    assert_within_one_ulp(bsr_spmm(a, x), bsr_spmm_plain(a, x))


def test_bsr_spmm_bf16_keeps_the_route_through_with_blocks(cuda):
    """The pipeline's final SpMM: the mask's route, its entries' values read
    from the SDDMM's blocks."""
    mask = create_mask("band_and_random", 1024, 0.99, seed=14,
                       dtype="bfloat16")
    m = DeviceBSR.from_csr(mask, bm=128, bk=128, device=cuda)
    assert m.route.entry_blocks and m.route.tile_blocks
    s = (m.blocks.float() * 0.5).to(torch.bfloat16)
    a = m.with_blocks(s)
    v = bf16_operand((1024, 512), 64, cuda)
    assert_within_one_ulp(bsr_spmm(a, v), bsr_spmm_plain(a, v))


@pytest.mark.parametrize("cluster", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("case", ["r104", "r2048", "empty_band"])
def test_panel_spmm_bf16_xy_pipelined_at_every_cluster_size(cuda, case,
                                                            cluster):
    """2b on the pipelined tile (n = 512) at each cluster size: 1 ulp, the
    same bits twice."""
    make, band_rows = PANELS[case]
    csr = bf16_csr(make)
    p = DevicePanels.from_csr(csr, bk=128, band_rows=band_rows, device=cuda)
    x = bf16_operand((csr.k, 512), 65, cuda)
    y = torch.empty((csr.m, 512), dtype=torch.bfloat16, device=cuda)
    again = torch.empty_like(y)
    panel_launch(p, x, y, cluster)
    panel_launch(p, x, again, cluster)
    assert_within_one_ulp(y, panel_spmm_plain(p, x))
    assert torch.equal(y, again)


def test_pipelined_tile_launch_grid(cuda):
    """1b's and 2b's launches at n = 512 run the pipelined tile (128
    columns, PT_STAGES); n = 77 the cp.async tile; 2a stays on it."""
    from spgrid_torch.ops.kernels.bsr_spmm import launch_grid as bsr_grid
    from spgrid_torch.ops.kernels.panel_spmm import launch_grid as p_grid
    head = bf16_csr(headline_matrix)
    a = DeviceBSR.from_csr(head, bm=128, bk=128, device=cuda)
    p = DevicePanels.from_csr(head, bk=128, device=cuda)
    g = bsr_grid(a, 512)
    assert (g.tiles, g.rows, g.cols, g.step, g.stages) == (16, 128, 128, 64,
                                                            6)
    assert bsr_grid(a, 77).cols == 64
    assert p_grid(p, 512, torch.bfloat16) == g
    assert p_grid(p, 512).cols == 64
    band = DeviceBSR.from_csr(bf16_csr(route_band), bm=128, bk=128,
                              device=cuda)
    assert bsr_grid(band, 512).tiles == 0
