"""Occupancy-driven SDDMM planning: the port's copy of
``spgrid/ops/sddmm_plan.py``.

``block_occupancy(mask, bm, bk)`` counts the occupied (bm, bk) blocks of a
mask exactly (one O(nnz) bincount), ``reachable_blocks`` the blocks a causal
band-and-fill mask can ever touch, and ``choose_sddmm_blocks(mask, n)``
prices each blocking of ``CANDIDATES`` by the per-block cost model and
returns the cheapest as an ``SDDMMPlan``; ``occupancy_report`` is the SDDMM
study's table of occupancy, plan and predicted speedup over 128x128
(``occupancy_row`` its row of one mask).

The functions are the JAX package's, verbatim (pinned by
``tests/test_torch_hostcopy.py``), except that ``_est_time`` reads the
constants as ``costmodel.C`` when it is called (the JAX module binds ``C``
at import), so a test that installs the JAX constants gets the JAX plan;
``occupancy_report`` makes its masks with the port's own generator and
takes each row from ``occupancy_row`` (pinned to the JAX report row for
row by ``tests/test_torch_sddmm.py``).
Under ``H100Constants`` the grid step is 0 and ``mxu_f32`` is cuBLAS f32
with TF32 off, so each candidate is priced by its product term alone: the
plan ranks blockings by the area their occupied blocks cover.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from spgrid_torch.formats.csr import CSRMatrix
from spgrid_torch.ops import costmodel

# candidate (bm, bk) mask blockings: bm=8 measured 15x worse (grid-step
# floor, see run_sddmm docstring) so candidates stay MXU-height; bk spans
# lane multiples up to 512 to amortize grid steps on dense-ish masks
CANDIDATES = ((128, 128), (128, 256), (128, 512), (256, 128), (256, 256))


@dataclasses.dataclass
class SDDMMPlan:
    bm: int
    bk: int
    occupied: int                 # occupied (bm, bk) blocks
    total: int                    # all (bm, bk) blocks in the bounding grid
    occupancy: float              # occupied / total
    nnz_per_occupied: float
    est_time_s: float             # planner's estimate for the chosen plan
    est_time_128: float           # estimate for the old fixed 128x128 plan
    inherent: bool                # True when >=95% blocks occupied at 128^2
                                  # (no blocking can skip meaningful work)


def block_occupancy(mask: CSRMatrix, bm: int, bk: int):
    """Exact occupied-block count for a (bm, bk) blocking: O(nnz)."""
    rows = np.repeat(np.arange(mask.m, dtype=np.int64), mask.degrees)
    br = rows // bm
    bc = mask.col_idx.astype(np.int64) // bk
    kb = -(-mask.k // bk)
    occ = np.bincount(br * kb + bc, minlength=(-(-mask.m // bm)) * kb)
    occupied = int(np.count_nonzero(occ))
    return occupied, occ.size


def reachable_blocks(length: int, bm: int, bk: int, band_size: int) -> int:
    """Blocks a causal band+fill mask can ever touch: the random/decay
    fill is lower-triangular (col <= row) and the band is symmetric with
    half-width ``band_size`` (gen/masks.py).  The bounding grid is the
    wrong inherence denominator — a causal mask occupies at most ~55% of
    it no matter how dense the fill is."""
    mb, kb = -(-length // bm), -(-length // bk)
    br = np.arange(mb)[:, None]
    bc = np.arange(kb)[None, :]
    causal = bc * bk <= br * bm + bm - 1
    # band reaches above the diagonal: block is touched when its leftmost
    # col is within band of the block's last row and vice versa
    band = (bc * bk - (br * bm + bm - 1) <= band_size - 1) \
        & (br * bm - (bc * bk + bk - 1) <= band_size - 1)
    return int(np.count_nonzero(causal | band))


def _est_time(occupied: int, bm: int, bk: int, n: int) -> float:
    """Per-plan time: each occupied block costs max(MXU matmul, operand
    DMA) + a grid step; d(=n) is tiled inside the kernel so VMEM fits."""
    per_block = max(
        2.0 * bm * bk * n / costmodel.C.mxu_f32,
        (bm + bk) * n * 4.0 / costmodel.C.eff_bw,
    ) + costmodel.C.grid_step
    out_bytes = occupied * bm * bk * 4.0
    return occupied * per_block + out_bytes / costmodel.C.eff_bw


def choose_sddmm_blocks(mask: CSRMatrix, n: int = 512) -> SDDMMPlan:
    best = None
    occ128 = None
    for bm, bk in CANDIDATES:
        occupied, total = block_occupancy(mask, bm, bk)
        t = _est_time(occupied, bm, bk, n)
        if (bm, bk) == (128, 128):
            occ128 = (occupied, total, t)
        if best is None or t < best[0]:
            best = (t, bm, bk, occupied, total)
    t, bm, bk, occupied, total = best
    o128, tot128, t128 = occ128
    return SDDMMPlan(
        bm=bm, bk=bk, occupied=occupied, total=total,
        occupancy=occupied / max(total, 1),
        nnz_per_occupied=mask.nnz / max(occupied, 1),
        est_time_s=t, est_time_128=t128,
        inherent=(o128 / max(tot128, 1)) >= 0.95,
    )


def occupancy_report(length: int = 4096, n: int = 512,
                     sparsities=(0.5, 0.9, 0.95, 0.98),
                     mask_types=("band_and_random", "band_and_decay"),
                     seed: int = 14):
    """The inherence analysis as data: per (mask type, sparsity), the
    128^2 occupancy, the planner's chosen blocking, and the predicted
    speedup — committed by the SDDMM study next to its measured rows.

    band_size=None so the reference's band table applies (0.95 -> 16,
    0.98 -> 8, sddmm_mask.h:28-34); a fixed wide band would swamp the
    high-sparsity targets and degenerate both mask types to the same
    pure band."""
    from spgrid_torch.gen.masks import create_mask

    return [occupancy_row(create_mask(mt, length, sp, band_size=None,
                                      seed=seed), mt, sp, length, n)
            for mt in mask_types for sp in sparsities]


def occupancy_row(mask: CSRMatrix, mask_type: str, sparsity: float,
                  length: int, n: int = 512) -> dict:
    """``occupancy_report``'s row of one mask, made with ``band_size=None``
    (the JAX report's loop body, so the SDDMM study reads it off the mask
    its arms run on)."""
    from spgrid_torch.gen.masks import default_band_size

    plan = choose_sddmm_blocks(mask, n)
    band = default_band_size(length, sparsity)
    o128, _tot = block_occupancy(mask, 128, 128)
    reach = reachable_blocks(length, 128, 128, band)
    # inherence, correctly denominated: fraction of blocks the causal
    # band+fill mask could EVER touch that this mask's nnz actually occupy
    occ_reach = o128 / max(reach, 1)
    return {
        "mask_type": mask_type, "sparsity": sparsity, "length": length,
        "nnz": mask.nnz,
        "occupancy_128": round(o128 / max(_tot, 1), 4),
        "reachable_128": reach,
        "occupancy_reachable": round(occ_reach, 4),
        "bm": plan.bm, "bk": plan.bk,
        "occupancy_plan": round(plan.occupancy, 4),
        "nnz_per_occupied": round(plan.nnz_per_occupied, 1),
        "est_speedup_vs_128": round(plan.est_time_128 / plan.est_time_s, 3),
        "inherent": bool(occ_reach >= 0.95),
    }
