#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spgrid_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each at least; any failure raises, so the script
exits non-zero and never prints the final ``"ok": true`` line:

0. set-up: a CUDA device is required (no CPU fallback); print the card's
   name and power limit from nvidia-smi; build the CUDA kernels from
   ``spgrid_torch/csrc`` (one nvcc per source, all started together) and
   print the build time.
1. kernels: each CUDA kernel against its plain PyTorch version computed in
   f64 on the card, at the shapes of the paths that run it, at an edge
   shape and, for the block kernels, at a larger shape; with the kernel's
   time, the plain f32 version's time and the time of one PyTorch library
   call that computes the same function (``torch.sparse.mm``,
   ``torch.sparse.sampled_addmm``, ``torch.take_along_dim``,
   ``torch.index_select``; a yardstick the port never calls; none for the
   shuffle chain and the wrong-by-design ablation variants), all from CUDA
   events around eager calls; for bsr_spmm_cstat also its grid (CTAs,
   column tile, row slice) and the floor of its 3xTF32 tensor-core work
   (three products of the blocks' dense flops at 495 TFLOP/s); for
   bsr_spmm, panel_spmm and bsr_sddmm their grid (tiles, the cluster a
   tile's contraction is split across, CTAs; panel_spmm's from its own
   shape query), ring depth and 3xTF32 floor, and on their main-path case
   the device ms at each cluster size; the
   kernel's device time alone, from CUDA-graph replay (and, for the
   main-path case, the library call's, where it can be captured in a
   graph); and the kernel's bound: the larger
   of the bytes the
   function needs on these inputs (each nnz, each dense operand, each
   gathered row and the output once) over the card's memory rate and its
   operations (2 a nnz a column) over its f32-accurate rate (3xTF32 on the
   tensor cores, 165 TFLOP/s). The probe gathers and
   the shuffle chain are held to their plain versions in f32, bit for bit;
   the ablation variants to theirs in f64, within 1e-5 where each row is
   written once and within ``ATOMIC_TOL`` where blocks sum with atomics;
   the ablation (WROW v1's row walk with one stage compiled out) prints the
   bytes of the row stream it reads beside the padded pieces'. dgell (X in
   column slabs that stay in L2, the tail summed in the same pass) prints
   the slab width its rule picks on this card, the slab count and the bytes
   it moves from device memory if each slab stays in L2, and on its
   main-path case the device ms at slab widths 16, 32, 64, 128 and n; it
   runs on LINE_S at n=512 and n=100 (a ragged last slab) and on the edge
   matrix at n=200 and n=77 (the scalar form). wcoo_spmv (the aligned
   layout's row-ordered live-slot stream in row tiles, a CTA a tile) prints
   the stream's bytes beside the padded groups', its tiles, its longest row
   and the layout's build seconds, and on MAIN_LINE the device ms at each
   TILE_SLOTS; it also runs on the edge matrix and on a matrix with a
   3,000-slot row and 400 empty rows. dma_gather (a ring of TMA bulk copies
   both ways) prints the ring its rule picks and the CTAs launched, and at
   G = 64 the device ms and TB/s over the bound's bytes at each ring of S
   2, 4, 6 by R 8, 16, 32 that the kernel takes.
   The WPACK ablation's five variants (``wpack_spmv(a, x, ablate=,
   prefix=)``; a warp a piece, W warps a CTA) run on ``exp_wpack_ablate``'s
   matrix at its own wsel (2) and on the edge matrix at wsel 1 and 4, each
   held to its f64 plain version within 1e-5 at the rule's W and at W 4, 8
   and 16, the pad forms equal to the roll forms; each line gives the
   layout's bytes the kernel reads (live quarters, starts and ends) beside
   the padded pieces', W and the CTAs, and the device ms at each W (full/
   roll also on MAIN_LINE, whose 512 blocks the rule gives 8 warps). The
   shuffle chain (a CTA of one warp a row) runs at 256 rows and at 1 row,
   64 and 256 steps, and prints the device ns and SM cycles a step at
   each. lanegather runs the probe's six forms: its rule's path (direct)
   as the entry point takes it, then the A/B of its two paths, the staged
   one (a CTA's tile of src in shared memory) and the direct one (a
   thread an element), each held to the plain version bit for bit, with
   each path's launch as the card plans it and its device ms printed
   beside the launch floor, an empty kernel's device ms timed the same
   way. The
   two live-slot stream kernels (``wrow_spmv_v2``,
   ``wpack_spmv``; ``slots_per_cta`` live slots a CTA) run on LINE_S and
   the edge matrix, and also on a 4096^2 matrix whose one 128-row block
   holds ~256 CTAs' ranges of slots, on a banded matrix with empty target
   blocks and on MAIN_LINE; each line gives the bytes of the stream they
   read beside the padded pieces' bytes, the live slots, the grid and S,
   and the host seconds the layout took to build (set-up, not timed work).
   The two slot SpMMs (``wcoo_spmm``, ``wcoo_spmm_aligned``) walk a
   row-ordered live-slot stream, a warp a row: they run on MAIN_LINE at
   n=512 and at n=77 (the walk's scalar form), on the edge matrix at n=200
   and on the banded matrix with empty target blocks at n=128; each line
   gives the stream's bytes beside the padded layout's, the live slots, the
   grid (a warp a row, 8 rows a CTA), C, U, the rows of more than
   ``LONG_ROW`` slots (a CTA each) and the layout's build seconds. WROW v1
   (``wrow_spmv``, a CTA a 128-row target block reading the row-ordered
   live-slot stream) runs on MAIN_LINE, the edge matrix, LINE_S (with its
   library call's device time too: the case where the padded kernel lost
   to it), the 4096^2 straddling band and the banded matrix with empty
   target blocks; each line gives the row stream's bytes beside the padded
   pieces', the live slots, the grid and the layout's build seconds.
   bsr_sddmm also runs at the SDDMM planner's other blockings (128x256,
   128x512, 256x128, 256x256; ``SDDMM_BLOCKINGS``) on the 4096^2
   band_and_decay mask at sparsity 0.95 and on a 1000^2 mask with pad
   blocks, each printed with its grid, 3xTF32 floor and device ms.
   The bf16 form of the panel kernel (``panel_spmm_bf16``, ``cv_panel``:
   bf16 panels, X rounded to bf16 on the card; a tile walks only the
   panels live in its 128-row slice, through a cp.async ring into bf16
   wgmma) runs on the headline twin (with the device ms at each cluster
   size), LINE_B, the banded matrix with empty rows at n=200 and the
   4096^2 case, held to its plain version in f64 on the same bf16
   operands; each line gives the launch with its ring's stages, the live
   steps against the steps of a walk over every panel of the band, and the
   live slices' bf16 tensor floor (their dense work at 989 TFLOP/s) beside
   the byte bound; its bound counts 2 bytes a panel value and bf16's 989
   TFLOP/s, its library call is ``torch.sparse.mm`` on the bf16 values as
   an f32 CSR times X rounded to bf16, timed on the device too on LINE_B
   and the 4096^2 case.
2. headline: ``run_spmm`` for dense, panel_cuda and bsr_cuda on the
   headline DLMC twin (512^2, n=512, f32), each gated against the host f64
   oracle at eps 1e-4, then the headline JSON line. The rows of phases 2-5
   carry the harness's time: device time from CUDA-graph replays (its
   ``timing_protocol`` "graph").
3. flagship: one step of ``spgrid_torch.entry.entry`` (which must launch
   bsr_spmm 4 times and bsr_sddmm once), gated against ``gold_pipeline``,
   then ``run_pipeline`` on the same matrices, gated at eps 1e-3.
4. CLI: ``python -m spgrid_torch.bench`` (its ``main``) on the minimum
   end-to-end slice, the hypersparse matrix ``MAIN_LINE``: wcoo_cuda and
   wcoo_bands_cuda at n=512, wrow_spmv_cuda and wcoo_spmv_cuda at n=1, and
   the torch-op formats coo, sell, merge, gell, gell16 and cv_gell at
   n=512; then coo, sell, merge and gell on ``LINE_B`` at n=512; each row
   gated at eps 1e-4, gell16 and cv_gell on the X they gather (their gate
   class, printed with each row beside where the gate ran: on the card
   for a result past 32 MB, the harness's ``oracle="auto"``, else on the
   host).
5. scattered and block-grid CLI: the CLI on the matrices the JAX package
   ran these kernels on: ``LINE_B`` (8192^2, 316 blocks of 128^2) with
   bsrc_cuda and bsr_cuda at n=512, ``LINE_S`` (100000^2, 2.1M scattered
   nnz) with dgell_cuda at n=512 and wpack_spmv_cuda and wrow_spmv_cuda at
   n=1, each row gated at eps 1e-4; then the WROW v1/v2 A/B on ``LINE_S``
   (``scripts/exp_wrow_v2.py``'s check): each variant against the host f64
   product, with both times.
6. probes: the four probe drivers of ``spgrid_torch.scripts``
   (``exp_spmv_ablate``, ``exp_pallas_gather``, ``exp_lanegather``,
   ``exp_wpack_ablate``: the ports of the JAX package's TPU probes under
   ``scripts/``), each its ``main`` at the JAX script's default sizes on the
   card; a non-zero exit (a gather not exact, a form that fails, WROW v1 or
   a full WPACK form off its f64 product) fails the run.
7. dispatch: cost-model dispatch (``ops/costmodel.py``, ``ops/rbh.py``,
   ``dispatch.select_format``/``autotune_spmm``) on the headline's twin,
   ``LINE_B``, ``MAIN_LINE``, the mac_econ twin and r3_scat_393k at n=512,
   the big rows gated on the card (``oracle="auto"``): rbh's split on each (its SplitStats, residual format and
   coverage blocks), then ``run_spmm`` for every AUTO candidate the cost
   model finds applicable, auto and autotune (auto_tol on MAIN_LINE,
   gemm_bound on the twin), each row gated and printed with its predicted
   time beside its measured one, and auto's and autotune's picks; then
   ``fit_constants`` over the fixed formats' rows (the fitted ``fudge``),
   ``dispatch_accuracy`` (tol 0.10, no cv_*) over the matrices and the
   phase's seconds; then, after the path's launches are read, the
   calibration: each ``H100Constants`` field measured on the card by graph
   replay and printed beside the committed value (and ``auto_threshold``
   at both).
8. only with ``--eager-ab``: the headline and CLI rows of phases 2, 4 and
   5 once more under the eager protocol (CUDA events around eager calls),
   without their gates, printed on one line: the A/B of the two protocols.
9. SDDMM and the CLI's modes (run before phase 8): the SDDMM study
   (``spgrid_torch.scripts.sddmm_study``'s ``main``) at its full grid, 4096^2
   masks of both types at sparsities 0.5, 0.9, 0.95 and 0.98 and n = 512:
   for each point the nnz, the 128^2 occupancy, the plan's blocking, its
   predicted speedup over 128^2 beside the measured one, the device µs of
   bsr_sddmm at all five blockings (graph replay) beside ``_est_time``'s,
   and whether the plan's was the fastest; its rows, at matmul precisions
   highest and high (the 3-pass bf16 form ``bsr_sddmm_bf16x3``, the JAX
   study's second arm), gated at 1e-4 and its six pipeline rows (512^2
   DLMC twins) at 1e-3; then the CLI's
   ``--sddmm 4096 --num-cols 512`` and ``--pipeline`` on three twins
   written as .smtx (sparsity 0.9), each with and without ``--xla-only``,
   one gated row each; then the phase's seconds.
10. the remaining formats (after phase 9): the CLI at n=512 on the JAX
   CLI's formats no earlier phase runs: ell, csc, cv_bf16, cv_int8, scoo,
   csr_xla_coo and ell_xla on MAIN_LINE and LINE_B; cv_panel_cuda on the
   headline twin (written as .smtx) and LINE_B; ldu on an 8192^2 matrix
   with a symmetric pattern written as .mtx and read through --matrix;
   bsr_cuda on LINE_B under --reorder rcm, shuffle and degsort; every row
   gated and printed with its gate class and site. Then one row of each
   gate class (coo, gell16 and cv_int8 on MAIN_LINE, cv_panel_cuda on
   LINE_B) gated on the host and on the card, the metrics side by side;
   the run fails where they differ past ``device_oracle.disagreements``'
   bounds (1e-12 relative; lnQ_error, mlare and gmare within the card's
   and numpy's log10 differing in the last place).
11. dtypes: (a) right after phase 1, the bf16 forms (``bsr_spmm_bf16``
   and ``panel_spmm_bf16_xy`` on the headline twin and LINE_B,
   ``bsr_sddmm_bf16`` on a 4096^2 band_and_random mask at sparsity 0.95
   with d = 512, ``wcoo_spmm_aligned_bf16`` on MAIN_LINE; and each form on
   the leg's matrices that (b) runs it on, ``LEG_SHAPES``; n = 512; the
   SpMV forms at n = 1: ``wrow_spmv_bf16`` and ``wcoo_spmv_bf16`` on
   MAIN_LINE, ``wrow_spmv_bf16``, ``wrow_spmv_v2_bf16`` and
   ``wpack_spmv_bf16`` on LINE_S, ``wpack_spmv_bf16_prefix`` at wsel 1 on
   the twin, each with the bytes it reads of its layout; the last forms:
   ``bsr_spmm_cstat_bf16`` on LINE_B, ``wcoo_spmm_bf16`` on MAIN_LINE and
   ``dgell_bf16`` on LINE_S at n = 512, and the 3-pass form
   ``bsr_sddmm_bf16x3`` on f32 operands on a 4096^2 band_and_decay mask at
   sparsity 0.95, d = 512) against their plain versions on the same
   inputs, within 1 bf16 ulp (``BF16_FLOOR`` absolutely below it; the
   3-pass form within ``HIGH_TOL`` of its f32 result), bit for bit where a
   form sums in its plain version's order (``wrow_spmv_bf16``;
   ``wcoo_spmv_bf16`` on every row of at most a tile; ``dgell_bf16``
   against ``dgell_rows_plain``), and the same bits on two calls,
   each with its device ms by graph replay (eager in brackets), bound and
   library time; ``bsr_spmm_bf16`` also under each forced route, with its
   route split, and the route sweep of ``ENTRY_ROUTE_MAX``; the redesigned
   forms with the device ms of the forms they replaced beside theirs
   (``BEFORE_DEVICE_MS``); ``bsr_sddmm_bf16`` with its launch (the
   128 x 128 tile, its stages, the persistent walk or the cluster a tile),
   ptxas's registers, the dense-block floor beside the nnz bound, and
   again on Q and K 2 bytes off 16, where its copy pass runs (timed alone
   too); ``wcoo_spmm_aligned_bf16`` bit for bit (its plain version sums
   as the walk does) with its slab rule's launch and its slab sweep
   (``BANDS_SWEEP``, the 16-byte and the 8-byte form, each bit for bit
   and the same bits twice) on MAIN_LINE and the leg's wideband_196k;
   ``wrow_spmv_v2_bf16`` and ``wpack_spmv_bf16`` also
   at two more ranges of live slots (``SPMV_RANGES``) and
   ``wpack_spmv_bf16_prefix`` at every count of groups a CTA, each held to
   1 ulp with the same bits twice; then,
   on its own path after phase 10: (b) the bf16 leg
   (``spgrid_torch.scripts.run_bf16_leg``, its jobs at full width, or
   ``BF16_LEG_JOBS``, and its pipeline row), every row gated at 3e-2;
   (c) the f64 sweep (``run_f64_sweep``) on the card, every row gated at
   1e-10; (d) the CLI at ``--dtype bfloat16`` (dense, bsr_cuda, panel_cuda
   on the twin; wrow_spmv_cuda, wcoo_spmv_cuda and auto on MAIN_LINE at
   n = 1, where auto must run wrow_spmv as the JAX package's
   ``select_format`` picks; wpack_spmv_cuda and wrow_spmv_cuda on LINE_S at
   n = 1; wpack_spmv_cuda at wsel 1 on the twin at n = 1; bsrc_cuda on
   LINE_B, wcoo_cuda on MAIN_LINE and dgell_cuda on LINE_S at n = 512; the
   WROW v1/v2 A/B at bf16 on LINE_S; ``--sddmm 4096`` and
   ``--pipeline``, each with and without ``--xla-only``), ``--dtype
   float64`` (csr_xla_coo, n = 1), and at f32 under
   ``SPGRID_MATMUL_PRECISION=high``: ``--sddmm 4096`` with and without
   ``--xla-only``, gated at 1e-4, and one SpMM row, which must exit 2
   naming ROADMAP.md.

Each phase prints its seconds. ``SPGRID_ORACLE=host python3 chip_smoke.py``
gates every row of phases 4, 5, 7 and 10 on the host (phase 10's pairs
excepted): the A/B of the device gate's seconds.

The launch counts are set to 0 before phases 2-3 (the headline and
flagship path), before phase 4 (the CLI path), before phase 5 (the
scattered and block-grid path), before phase 6 (the probe path), before
phase 7 (the dispatch path: ``bsr_spmm`` in rbh's block part and the
bsr_cuda rows, ``panel_spmm`` in the panel_cuda rows), before phase 9
(the SDDMM path: ``bsr_sddmm``, ``bsr_spmm`` and ``bsr_sddmm_bf16x3``),
before phase 10 (the remaining formats: ``panel_spmm_bf16`` and
``bsr_spmm``) and before phase 11's (b)-(d) (the dtype path: the twelve
bf16 forms and ``bsr_sddmm_bf16x3``), and read after each; a
kernel of a path that was not launched there fails the run, and a
kernel's launches are summed over its paths. Then one JSON
line of the kernels (launches from their path, errors and times from phase
1), and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Kernel vs plain: the kernel sums in f32 in another order than the f64
# plain version. With the positive operands used here the f32 rounding
# error of a sum of up to 2048 products stays below ~3e-6 relative, so the
# check is: max relative difference <= 1e-5 where |ref| > 1e-4 (absolute
# difference below that).
REL_TOL = 1e-5
SIGNIFICANT = 1e-4
# spmv_ablate's normw and empty: each thread sums its row's live slots in
# f32 and adds the sum to y[t] with atomicAdd, in any order of the 782
# blocks of the probe's matrix and of LINE_S. A sum of positive f32 terms is
# off by at most (terms in its chain) * 2^-24 relative: (782 block sums + a
# row's slots) * 6e-8 < 1e-4 while the two together stay below ~1,670 (a
# row holds at most ~60 live slots there).
ATOMIC_TOL = 1e-4
# minimum timed seconds for each eager kernel, plain and library time of
# phases 1 and 11a: thousands of calls of the microsecond kernels, and at
# least 20 of every call (0.2 s until the SpMV path at bf16 joined phase
# 11; cut to keep the run's length)
TIME_S = 0.05
DEVICE = "cuda"
LARGE = 4096            # side of the larger case of each block kernel
RAGGED = 1000           # side of the SDDMM case no blocking divides
# the mask blockings the SDDMM planner can pick besides 128 x 128
# (spgrid_torch/ops/sddmm_plan.py CANDIDATES)
SDDMM_BLOCKINGS = ((128, 256), (128, 512), (256, 128), (256, 256))
# The README's minimum end-to-end slice: a hypersparse 65535^2 matrix with
# 5 nnz a row in a band of 5 % of the columns.
MAIN_LINE = "65535 65535 5 1.6667 normal random 0.05 0 0.05 0.05 14"
# The matrices the JAX package ran the last four kernels on: its
# bsrc_pallas smoke configuration (scripts/run_pallas_smoke.py) and the
# fully scattered SpMV configuration synth_100k_a20_b0.9
# (scripts/exp_wpack.py).
LINE_B = "8192 8192 50 10 normal random 0.05 0 0.05 0.05 14"
LINE_S = "100000 100000 20 6.6667 normal random 0.9 0 0.05 0.05 14"
# The probes' default sizes (scripts/exp_spmv_ablate.py and
# scripts/exp_wpack_ablate.py: m avg bw; scripts/exp_pallas_gather.py: X
# rows, columns and gather steps).
ABLATE = (100000, 20.0, 0.05)
WPACK_ABLATE = (100000, 20.0, 0.05)
GATHER = (65536, 512, 384)
# A phase-1 case off the main path whose library call is timed on the
# device too (its ``on_path`` entry).
LIBRARY_TOO = "library device ms"
# Peaks of one H100 SXM (NVIDIA's data sheet): device memory, and TF32 on
# the tensor cores, dense (the floor of the block kernels' 3xTF32 products:
# three products for each of the blocks' dense flops).
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS_PER_S = 495e12
# The card's fastest f32-accurate rate, for each kernel's bound: 3xTF32 on
# the tensor cores (three TF32 products a flop, 165 TFLOP/s), above the
# CUDA cores' 67 TFLOP/s of f32 FMA.
F32_FLOPS_PER_S = TF32_FLOPS_PER_S / 3
# bf16 on the tensor cores, dense: the bound of the bf16 panel form, whose
# products are exact bf16 x bf16 in f32 sums (one product a flop)
BF16_FLOPS_PER_S = 989e12

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def positive(csr):
    """The same sparsity with values |v| + 0.1 (no cancellation)."""
    from spgrid_torch.formats.csr import CSRMatrix
    return CSRMatrix(csr.row_ptr, csr.col_idx,
                     (np.abs(csr.values) + 0.1).astype(np.float32),
                     csr.shape, csr.name)


def banded_with_empty_rows(m=1000, k=1000, seed=3, empty=slice(8, 24)):
    """A banded matrix whose rows ``empty`` hold no nnz: by default rows
    8-23, block rows 1 and 2 at bm=8; ``slice(128, 384)`` empties 128-row
    target blocks 1 and 2."""
    from spgrid_torch.formats.csr import dense_to_csr
    rng = np.random.default_rng(seed)
    i = np.arange(m)[:, None]
    j = np.arange(k)[None, :]
    d = np.where(np.abs(i - j) <= 40, rng.random((m, k)) + 0.5, 0.0)
    d[empty] = 0.0
    return dense_to_csr(d.astype(np.float32), name="banded_empty_rows")


def straddling_band(n=4096, seed=21):
    """n x n, ~0.2 % scattered, and target block 8 (rows 1024-1151) half
    dense over all n columns: ~262K live slots in one 128-row block, ~256
    times the SpMV stream kernels' range of 1,024 slots at this size, so the
    block straddles many CTAs' ranges."""
    from spgrid_torch.formats.csr import dense_to_csr
    rng = np.random.default_rng(seed)
    d = np.where(rng.random((n, n)) < 0.002, rng.random((n, n)) + 0.5, 0.0)
    band = rng.random((128, n))
    d[1024:1152] = np.where(band < 0.5, band + 0.5, 0.0)
    return dense_to_csr(d.astype(np.float32), name="straddling_band")


def edge_matrix():
    """~6 scattered nnz a row; rows 1024-2047 empty (an empty row block of
    1024 rows and eight empty 128-row blocks); row 5 holds 250 nnz in the
    last 250 columns, so it collides in each of the last three 128-column
    windows; neither m nor k is a multiple of 128."""
    from spgrid_torch.entry import hypersparse_edge
    return hypersparse_edge(3000, 2000, density=0.003,
                            empty=slice(1024, 2048), heavy_row=5,
                            heavy_nnz=250)


def long_row_matrix():
    """1000 x 3200, ~0.3 % scattered; rows 100-499 empty (400 in a row) and
    row 700 full in its last 3,000 columns, longer than wcoo_spmv's tiles of
    2,048 slots; m is not a multiple of 128."""
    from spgrid_torch.entry import hypersparse_edge
    return hypersparse_edge(1000, 3200, density=0.003, empty=slice(100, 500),
                            heavy_row=700, heavy_nnz=3000, seed=31)


def line_matrix(line: str):
    """The CSR matrix of a parameter line, as the CLI generates it."""
    from spgrid_torch.gen import GenParams, artificial_matrix_generation
    return artificial_matrix_generation(**GenParams.from_line(line).kwargs())


def rand(shape, seed):
    x = np.random.default_rng(seed).random(shape) + 0.5
    return torch.from_numpy(x.astype(np.float32)).to(DEVICE)


def compare(out: torch.Tensor, ref: torch.Tensor):
    """(max relative difference as the check defines it, max |difference|)."""
    diff = (out.double() - ref).abs()
    sig = ref.abs() > SIGNIFICANT
    rel = torch.where(sig, diff / ref.abs().clamp_min(SIGNIFICANT), diff)
    return rel.max().item(), diff.max().item()


def device_ms(fn, *args, calls: int = 20, replays: int = 20) -> float:
    """Device time of one call: ``calls`` calls captured in a CUDA graph,
    the graph replayed ``replays`` times between CUDA events, so the host's
    cost to enqueue a call is left out. nan off the card."""
    if DEVICE != "cuda":
        return float("nan")
    from spgrid_torch.core.timing import time_kernel_graph
    return time_kernel_graph(fn, *args, device=DEVICE, calls=calls,
                             warmup_iters=0, min_time_s=0.0,
                             min_iters=calls * replays).time_per_iter_s * 1e3


def show_ms(v) -> str:
    return "—" if v is None else f"{v:.6f}"


def library_device_ms(fn, *args):
    """``device_ms`` of a library call, or None where the call cannot be
    captured in a CUDA graph (its eager time is kept all the same)."""
    try:
        return device_ms(fn, *args)
    except RuntimeError as e:
        torch.cuda.synchronize()
        print(f"phase 1 library call not captured: {str(e)[:120]}",
              flush=True)
        return None


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: float, flops: float, rate: float = F32_FLOPS_PER_S):
    """(least ms the card could take, "bytes" or "operations"), the
    operations at ``rate`` a second."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def csr_tensor(csr, dtype=torch.float32):
    """``csr`` as a ``torch.sparse_csr_tensor`` on the card, its values in
    ``dtype`` (a bf16 matrix's f32 values exactly), for the library
    yardsticks."""
    return torch.sparse_csr_tensor(
        torch.from_numpy(csr.row_ptr.astype(np.int64)),
        torch.from_numpy(csr.col_idx.astype(np.int64)),
        torch.from_numpy(csr.values.astype(np.float32)).to(dtype),
        size=csr.shape).to(DEVICE)


def phase_kernels() -> dict:
    """Phase 1. Returns, per kernel, the numbers of its main-path case."""
    from spgrid_torch.formats.csr import random_csr
    from spgrid_torch.gen import create_mask
    from spgrid_torch.bench.headline import headline_matrix
    from spgrid_torch.core.timing import time_kernel
    from spgrid_torch.entry import flagship_csrs
    from spgrid_torch.ops.kernels import _build
    from spgrid_torch.ops.kernels.bsr_spmm import bsr_spmm, bsr_spmm_plain
    from spgrid_torch.ops.kernels.bsr_spmm import launch as bsr_launch
    from spgrid_torch.ops.kernels.bsr_spmm import launch_grid as bsr_grid
    from spgrid_torch.ops.kernels.bsr_spmm_cstat import (
        DeviceBSRCol, bsr_spmm_cstat, bsr_spmm_cstat_plain, launch_grid)
    from spgrid_torch.ops.kernels.dgell import (
        DeviceDGELL, dgell_spmm, dgell_spmm_plain)
    from spgrid_torch.ops.kernels.dgell import launch as dgell_launch
    from spgrid_torch.ops.kernels.dgell import launch_shape as dgell_shape
    from spgrid_torch.ops.kernels.lanegather import (
        DIRECT, STAGED, card_plan, lanegather, lanegather_plain,
        launch_floor)
    from spgrid_torch.ops.kernels.lanegather import launch as lane_launch
    from spgrid_torch.ops.kernels.pallas_gather import (
        dma_gather, dma_gather_plain, ring_shape, shuffle_bench,
        shuffle_bench_plain)
    from spgrid_torch.ops.kernels.pallas_gather import launch as gather_launch
    from spgrid_torch.ops.kernels.spmv_ablate import (
        VARIANTS, spmv_ablate, spmv_ablate_plain)
    from spgrid_torch.formats.cv import csr_to_cv, cv_to_csr
    from spgrid_torch.ops.kernels.panel_spmm import (
        DevicePanels, panel_spmm, panel_spmm_bf16, panel_spmm_plain)
    from spgrid_torch.ops.kernels.panel_spmm import launch as panel_launch
    from spgrid_torch.ops.kernels.panel_spmm import launch_grid as panel_grid
    from spgrid_torch.ops.kernels.bsr_spmm_cstat import (
        DeviceBSRCol, bsr_spmm_cstat, bsr_spmm_cstat_plain)
    from spgrid_torch.ops.kernels.bsr_spmm_cstat import (
        launch_grid as bsrc_grid)
    from spgrid_torch.ops.kernels.dgell import (
        DeviceDGELL, dgell_rows_plain, dgell_spmm)
    from spgrid_torch.ops.kernels.dgell import launch as dgell_launch
    from spgrid_torch.ops.kernels.dgell import launch_shape as dgell_shape
    from spgrid_torch.ops.kernels.sddmm import (
        bsr_sddmm, bsr_sddmm_bf16x3_plain, bsr_sddmm_plain)
    from spgrid_torch.ops.kernels.sddmm import launch_grid as sddmm_grid
    from spgrid_torch.ops.kernels.wcoo_spmm import (
        DeviceWCOO, wcoo_spmm, wcoo_spmm_plain)
    from spgrid_torch.ops.kernels.wcoo_spmm import (
        DeviceWCOO, wcoo_spmm, wcoo_spmm_plain)
    from spgrid_torch.ops.kernels.wcoo_spmm_aligned import (
        DeviceWCOOBands, wcoo_spmm_aligned, wcoo_spmm_aligned_plain)
    from spgrid_torch.ops.kernels.wcoo_spmv import (
        TILE_CHOICES, DeviceWCOOAligned, wcoo_spmv, wcoo_spmv_plain)
    from spgrid_torch.ops.kernels.wcoo_spmv import launch as wcoo_spmv_launch
    from spgrid_torch.ops.kernels.slot_rows import row_stream, walk_shape
    from spgrid_torch.ops.kernels.slot_stream import default_slots_per_cta
    from spgrid_torch.ops.kernels.wpack_spmv import (
        DeviceWPACK, launch_warps, wpack_spmv, wpack_spmv_plain)
    from spgrid_torch.ops.kernels.wpack_spmv import VARIANTS as WPACK_VARIANTS
    from spgrid_torch.ops.kernels.wpack_spmv import launch as wpack_launch
    from spgrid_torch.ops.kernels.wrow_spmv import (
        DeviceWROW, wrow_spmv, wrow_spmv_plain, wrow_spmv_v2)
    from spgrid_torch.ops.layouts import DeviceBSR
    from spgrid_torch.scripts.exp_lanegather import forms
    from spgrid_torch.scripts.exp_spmv_ablate import ablate_matrix
    from spgrid_torch.scripts import sm_clock_mhz
    from spgrid_torch.scripts.exp_wpack_ablate import FORMS, wpack_matrix

    def ms(fn, *args):
        return time_kernel(fn, *args, device=DEVICE, warmup_iters=5,
                           min_time_s=TIME_S, min_iters=20
                           ).time_per_iter_s * 1e3

    head = headline_matrix()
    wk, _, _, mask = flagship_csrs()
    big = positive(random_csr(LARGE, LARGE, 0.5, seed=7))
    big_mask = create_mask("band_and_random", LARGE, sparsity=0.95, seed=14)
    decay_mask = create_mask("band_and_decay", LARGE, sparsity=0.95, seed=14)
    ragged_mask = create_mask("band_and_random", RAGGED, sparsity=0.9,
                              seed=14)
    banded = banded_with_empty_rows()
    empty_blocks = banded_with_empty_rows(empty=slice(128, 384))
    straddle = straddling_band()
    hyper = line_matrix(MAIN_LINE)
    edge = edge_matrix()
    line_b = line_matrix(LINE_B)
    line_s = line_matrix(LINE_S)
    ablate = ablate_matrix(*ABLATE)
    ablate_small = ablate_matrix(1000, *ABLATE[1:])
    wpack_ab = wpack_matrix(*WPACK_ABLATE)

    # Each case: (kernel, plain, args, args in f64, library call and its
    # args, bytes moved, flops). Bytes and flops are what the product needs
    # on this matrix, whatever the layout holds: each nnz's value and column
    # index once (``index_bytes``: the layout's own width where it stores
    # one a slot, else CSR's int32), the dense operands read once and the
    # output written once; 2 flops per nnz per column. Padding, dense block
    # work and empty slots count for nothing.
    def spmm_case(kernel, plain, a, csr, n, seed, index_bytes=4):
        x = rand((a.shape[1], n), seed)
        return (kernel, plain, (a, x), (a, x.double()), torch.sparse.mm,
                (csr_tensor(csr), x),
                csr.nnz * (4 + index_bytes) + nbytes(x) + 4 * a.shape[0] * n,
                2.0 * csr.nnz * n)

    def spmv_case(kernel, plain, a, csr, seed, index_bytes):
        x = rand((a.shape[1],), seed)
        return (kernel, plain, (a, x), (a, x.double()), torch.sparse.mm,
                (csr_tensor(csr), x[:, None]),
                csr.nnz * (4 + index_bytes) + nbytes(x) + 4 * a.shape[0],
                2.0 * csr.nnz)

    def block_note(grid, flops, sweep=None):
        """The block kernels' launch (grid, cluster, ring), the floor of
        their 3xTF32 work (three products of the blocks' dense flops) and,
        on a main-path case, the device ms at each cluster size."""
        note = (f"{grid} tensor_floor_ms="
                f"{3 * flops / TF32_FLOPS_PER_S * 1e3:.6f} (3xTF32)")
        if sweep is not None:
            note += " device_ms_by_cluster " + " ".join(
                f"{c}:{device_ms(sweep, c):.6f}" for c in (1, 2, 4, 8))
        return note

    def bsr_case(csr, bm, n, seed, sweep=False):
        a = DeviceBSR.from_csr(csr, bm=bm, bk=128, device=DEVICE)
        case = spmm_case(bsr_spmm, bsr_spmm_plain, a, csr, n, seed)
        x = case[2][1]
        y = torch.empty((a.shape[0], n), device=DEVICE)

        def at_cluster(c):
            _build.check(_build.library().spgrid_bsr_spmm(
                a.row_ptr.data_ptr(), a.block_cols.data_ptr(),
                a.blocks.data_ptr(), x.data_ptr(), y.data_ptr(), a.mb,
                a.bm, a.bk, *a.shape, n, c,
                torch.cuda.current_stream().cuda_stream), "bsr_spmm")

        return case + (REL_TOL, block_note(
            bsr_grid(a, n), 2.0 * a.num_blocks * a.bm * a.bk * n,
            at_cluster if sweep else None))

    def panel_case(csr, n, seed, sweep=False):
        a = DevicePanels.from_csr(csr, bk=128, device=DEVICE)
        case = spmm_case(panel_spmm, panel_spmm_plain, a, csr, n, seed)
        x = case[2][1]
        y = torch.empty((a.shape[0], n), device=DEVICE)

        note = block_note(panel_grid(a, n),
                          2.0 * a.num_panels * a.band_rows * a.bk * n,
                          (lambda c: panel_launch(a, x, y, c)) if sweep
                          else None)
        return case + (REL_TOL, f"R={a.band_rows} bands={a.bands} {note}")

    def panel_bf16_case(csr, n, seed, sweep=False):
        # the bf16 form (cv_panel): bf16 panels (2 B a value), X read in f32
        # and rounded on the card; held to the plain version in f64 on the
        # same bf16 operands; the library yardstick is torch.sparse.mm on
        # the bf16 values as an f32 CSR, times X rounded to bf16, in f32
        a = DevicePanels.from_csr(csr, bk=128, device=DEVICE).as_bf16()
        x = rand((a.shape[1], n), seed)
        y = torch.empty((a.shape[0], n), device=DEVICE)
        deq = cv_to_csr(csr_to_cv(csr, "bf16"))
        xq = x.to(torch.bfloat16).to(torch.float32)
        g = panel_grid(a, n)
        # the walk: each tile steps through the live (slot, slice) pairs of
        # its slice, step columns of bk at a time, against a walk of every
        # real panel of the band in every slice
        live = int(a.slice_ptr[-1])
        slices = -(-a.band_rows // g.rows)
        col_tiles = -(-n // g.cols)
        per_slot = -(-a.bk // g.step) * col_tiles
        live_flops = 2.0 * live * g.rows * a.bk * n
        note = (f"R={a.band_rows} bands={a.bands} {g} live_steps="
                f"{live * per_slot} of {a.num_panels * slices * per_slot} "
                f"({live} of {a.num_panels * slices} (panel, slice) pairs) "
                f"tensor_floor_ms={live_flops / BF16_FLOPS_PER_S * 1e3:.6f} "
                f"(bf16, the live slices' dense work)")
        if sweep:
            note += " device_ms_by_cluster " + " ".join(
                f"{c}:{device_ms(lambda c=c: panel_launch(a, x, y, c)):.6f}"
                for c in (1, 2, 4, 8))
        return (panel_spmm_bf16, panel_spmm_plain, (a, x), (a, x.double()),
                torch.sparse.mm, (csr_tensor(deq), xq),
                csr.nnz * (2 + 4) + nbytes(x) + 4 * a.shape[0] * n,
                2.0 * csr.nnz * n, REL_TOL, note + " library=torch.sparse.mm"
                "(f32 CSR of the bf16 values, bf16-rounded X)",
                BF16_FLOPS_PER_S)

    def sddmm_case(m, bm, d, seed, sweep=False, bk=128, pad_multiple=1,
                   mk=None):
        # reads Q, K and the mask's column indices; writes one value a
        # mask nnz; K of mk rows where given (fewer than the mask's
        # columns: zeros past them)
        a = DeviceBSR.from_csr(m, bm=bm, bk=bk, pad_multiple=pad_multiple,
                               device=DEVICE)
        q = rand((m.shape[0], d), seed)
        k = rand((m.shape[1] if mk is None else mk, d), seed + 1)
        nb, bm, bk = a.blocks.shape
        out = torch.empty((nb, bm, bk), device=DEVICE)

        def at_cluster(c):
            _build.check(_build.library().spgrid_bsr_sddmm(
                a.block_rows.data_ptr(), a.block_cols.data_ptr(),
                a.blocks.data_ptr(), q.data_ptr(), k.data_ptr(),
                out.data_ptr(), nb, bm, bk, q.shape[0], k.shape[0], d, c,
                torch.cuda.current_stream().cuda_stream), "bsr_sddmm")

        # the library call takes K of the mask's columns: zeros past mk
        k_lib = torch.zeros((m.shape[1], d), device=DEVICE)
        k_lib[:k.shape[0]] = k
        return (bsr_sddmm, bsr_sddmm_plain, (a, q, k),
                (a, q.double(), k.double()),
                lambda s, q_, kt: torch.sparse.sampled_addmm(s, q_, kt,
                                                             beta=0.0),
                (csr_tensor(m), q, k_lib.t().contiguous()),
                m.nnz * (4 + 4) + nbytes(q, k), 2.0 * m.nnz * d, REL_TOL,
                block_note(sddmm_grid(a),
                           2.0 * a.num_blocks * bm * bk * d,
                           at_cluster if sweep else None))

    def layout_line(name, csr, a, units, count):
        print(f"phase 1 layout: {name} of {csr.name} ({csr.nnz} nnz): "
              f"{count} {units}, utilization {a.utilization:.4f}", flush=True)

    def bsrc_case(csr, n, seed, bm=128, band_rows=2048):
        a = DeviceBSRCol.from_csr(csr, bm=bm, bk=128, band_rows=band_rows,
                                  device=DEVICE)
        print(f"phase 1 layout: bsrc of {csr.name} ({csr.nnz} nnz): "
              f"{a.num_blocks} blocks of {bm}x128 in {a.bands} bands of "
              f"{a.band_rows} rows, at most {a.max_nb} a band", flush=True)
        ctas, tile, rows = launch_grid(a, n)
        tensor_ms = (3 * 2.0 * a.num_blocks * a.bm * a.bk * n
                     / TF32_FLOPS_PER_S * 1e3)
        note = (f"grid={ctas} CTAs column_tile={tile} row_slice={rows} "
                f"tensor_floor_ms={tensor_ms:.6f} (3xTF32)")
        return spmm_case(bsr_spmm_cstat, bsr_spmm_cstat_plain, a, csr, n,
                         seed) + (REL_TOL, note)

    def dgell_case(csr, n, seed, sweep=False):
        """The slab the kernel's rule picks on this card, its slab count,
        the bytes it moves from device memory if each slab of X stays in
        L2 (X and Y once, the ELL arrays and the tail once a slab) and, on
        a main-path case, the device ms at each slab width."""
        a = DeviceDGELL.from_csr(csr, device=DEVICE)
        print(f"phase 1 layout: dgell of {csr.name} ({csr.nnz} nnz): "
              f"{a.slots} slots a row, {a.tail_rows.numel()} nnz in the "
              f"tail", flush=True)
        case = spmm_case(dgell_spmm, dgell_spmm_plain, a, csr, n, seed)
        x = case[2][1]
        m, k = a.shape
        shape = dgell_shape(k, n, 0, n % 4 == 0)
        per_slab = nbytes(a.cols, a.values, a.tail_cols, a.tail_vals,
                          a.tail_ptr)
        note = (f"slab={shape.slab} slabs={shape.slabs} rows_a_cta="
                f"{shape.rows} lanes_a_row={shape.lanes} hbm_bytes="
                f"{nbytes(x) + 4 * m * n + shape.slabs * per_slab} (X and Y "
                f"once, ELL and tail once a slab)")
        if sweep:
            y = torch.empty((m, n), device=DEVICE)
            note += " device_ms_by_slab " + " ".join(
                f"{c}:{device_ms(dgell_launch, a, x, y, c):.6f}"
                for c in sorted({16, 32, 64, 128, n}))
        return case + (REL_TOL, note)

    # The live-slot stream kernels: what they read of the layout (the
    # stream) beside the padded pieces, and their grid: CTAs of S =
    # slots_per_cta live slots, the wrappers' default for this card.
    sms = (torch.cuda.get_device_properties(0).multi_processor_count
           if DEVICE == "cuda" else 132)

    def stream_note(a, layout_s):
        per_cta = default_slots_per_cta(a.num_slots, sms)
        padded = nbytes(a.values, a.cols, a.piece_w) + (
            nbytes(a.sel, a.starts, a.ends) if hasattr(a, "sel") else 0)
        return (f"stream_bytes={a.stream_nbytes} padded_bytes={padded} "
                f"live_slots={a.num_slots} grid={-(-a.num_slots // per_cta)} "
                f"CTAs S={per_cta} layout_build_s={layout_s:.3f} (host: "
                f"pieces, stream, copy to the card)")

    def timed_layout(cls, csr):
        t0 = time.perf_counter()
        a = cls.from_csr(csr, device=DEVICE)
        return a, time.perf_counter() - t0

    def wpack_case(csr, seed):
        a, layout_s = timed_layout(DeviceWPACK, csr)
        layout_line("wpack", csr, a, f"groups of 8 pieces (wsel {a.wsel})",
                    a.num_groups)
        return spmv_case(wpack_spmv, wpack_spmv_plain, a, csr, seed,
                         a.cols.element_size()) + (
            REL_TOL, stream_note(a, layout_s))

    def wrow_v2_case(csr, seed):
        a, layout_s = timed_layout(DeviceWROW, csr)
        layout_line("wrow", csr, a, "groups of 8 pieces of 128 slots",
                    a.num_groups)
        return spmv_case(wrow_spmv_v2, wrow_spmv_plain, a, csr, seed,
                         a.cols.element_size()) + (
            REL_TOL, stream_note(a, layout_s))

    # The slot SpMMs walk the row-ordered live-slot stream: what they read
    # of the layout beside its padded arrays and the walk's shape (CTAs of 8
    # rows, column slabs of 128 C, U slots in flight).
    row_layouts = {}

    def row_layout(cls, csr):
        if (cls, id(csr)) not in row_layouts:
            a, layout_s = timed_layout(cls, csr)
            if cls is DeviceWCOO:
                layout_line("wcoo", csr, a, "chunks of 128 slots",
                            len(a.chunk_window))
            else:
                layout_line("wcoo_bands", csr, a, "groups of 8x128 slots",
                            len(a.block_groups))
            row_layouts[cls, id(csr)] = a, layout_s
        return row_layouts[cls, id(csr)]

    def rows_case(cls, kernel, plain, csr, n, seed):
        a, layout_s = row_layout(cls, csr)
        grid_x, grid_y, c, u = walk_shape(a.shape[0], n)
        note = (f"stream_bytes={a.stream_nbytes} "
                f"padded_bytes={a.nbytes - a.stream_nbytes} "
                f"live_slots={a.num_slots} grid={grid_x}x{grid_y} CTAs "
                f"C={c} U={u} long_rows={len(a.long_rows)} "
                f"form={'float4' if n % 4 == 0 else 'scalar'} "
                f"layout_build_s={layout_s:.3f} (host: padded layout, "
                f"stream, copy to the card)")
        return spmm_case(kernel, plain, a, csr, n, seed,
                         a.cols.element_size()) + (REL_TOL, note)

    wcoo_case = functools.partial(rows_case, DeviceWCOO, wcoo_spmm,
                                  wcoo_spmm_plain)
    bands_case = functools.partial(rows_case, DeviceWCOOBands,
                                   wcoo_spmm_aligned, wcoo_spmm_aligned_plain)

    # wcoo_spmv reads the row-ordered live-slot stream in row tiles of at
    # most TILE_SLOTS slots, a CTA a tile: what it reads beside the padded
    # groups, its tiles and, on the main-path case, the device ms at each
    # TILE_SLOTS.
    def wcoo_spmv_case(csr, seed, sweep=False):
        a, layout_s = timed_layout(DeviceWCOOAligned, csr)
        layout_line("wcoo_aligned", csr, a, "groups of 8x128 slots",
                    a.num_groups)
        case = spmv_case(wcoo_spmv, wcoo_spmv_plain, a, csr, seed,
                         a.cols.element_size())
        note = (f"stream_bytes={a.stream_nbytes + nbytes(a.tile_row)} "
                f"padded_bytes={nbytes(a.cols, a.values, a.g_sw, a.block_ptr)}"
                f" live_slots={a.num_slots} tile_slots={a.tile_slots} "
                f"grid={a.tiles} CTAs of 256 threads longest_row="
                f"{int(torch.diff(a.row_slot).max()) if csr.m else 0} "
                f"layout_build_s={layout_s:.3f} (host: groups, stream, "
                f"tiles, copy to the card)")
        if sweep:
            x, y = case[2][1], torch.empty((a.shape[0],), device=DEVICE)
            tiled = [a.tiled(t) for t in TILE_CHOICES]
            note += " device_ms_by_tile_slots(CTAs) " + " ".join(
                f"{b.tile_slots}:{device_ms(wcoo_spmv_launch, b, x, y):.6f}"
                f"({b.tiles})" for b in tiled)
        return case + (REL_TOL, note)

    # WROW v1 reads the row-ordered stream, a CTA a 128-row target block.
    def row_stream_s(a):
        """Host seconds of the row stream's build alone: ``row_stream`` on
        the layout's piece-ordered stream, as ``from_arrays`` calls it."""
        block = torch.repeat_interleave(
            torch.arange(a.blocks), torch.diff(a.block_slot.cpu().long()))
        rows = (block * 128 + (a.slot_rows.cpu().long() & 127)).numpy()
        cols, vals = a.slot_cols.cpu().numpy(), a.slot_vals.cpu().numpy()
        t0 = time.perf_counter()
        row_stream(rows, cols, vals, *a.shape)
        return time.perf_counter() - t0

    def wrow_case(csr, seed):
        a, layout_s = timed_layout(DeviceWROW, csr)
        layout_line("wrow", csr, a, "groups of 8 pieces of 128 slots",
                    a.num_groups)
        note = (f"row_stream_bytes={a.row_nbytes} padded_bytes="
                f"{nbytes(a.values, a.cols, a.piece_w, a.block_ptr)} "
                f"live_slots={a.num_slots} grid={a.blocks} CTAs of 128 rows "
                f"layout_build_s={layout_s:.3f} (host: pieces, both streams, "
                f"copy to the card; the row stream alone "
                f"{row_stream_s(a):.3f})")
        return spmv_case(wrow_spmv, wrow_spmv_plain, a, csr, seed,
                         a.cols.element_size()) + (REL_TOL, note)

    # the card's launch floor: an empty kernel, timed as every row is
    floor_ms = device_ms(launch_floor, DEVICE)
    print(f"phase 1 launch floor: empty kernel (1 CTA of 32 threads) "
          f"device_ms={floor_ms:.6f}", flush=True)
    path_names = {DIRECT: "direct", STAGED: "staged"}

    # The probe kernels. A gather needs each gathered element or row read
    # once (at most the index's count, distinct rows for dma_gather), the
    # index and the output; the shuffle chain its three tiles and one add
    # an element a step; an ablation variant its nnz's values (and columns
    # where it reads them), the x entries it reads and the y it writes.
    def lanegather_case(src, idx, axis):
        """Also: the card's plan for the rule (path, CTAs) and for the
        staged path (tile, CTAs); each path held to the plain version bit
        for bit, and its device ms beside the launch floor."""
        s, i = (torch.from_numpy(v).to(DEVICE) for v in (src, idx))
        shape = (*s.shape, *i.shape, axis)
        note = f"source_bytes={nbytes(s)}"
        if DEVICE == "cuda":
            rule, staged = card_plan(*shape), card_plan(*shape, STAGED)
            note = (f"rule={path_names[rule.path]} ctas={rule.ctas} "
                    f"staged_tile={staged.tile} staged_ctas={staged.ctas} "
                    + note)
            want = lanegather_plain(s, i, axis)
            out = torch.empty_like(want)
            times = []
            for path in (DIRECT, STAGED):
                out.fill_(float("nan"))
                lane_launch(s, i, out, axis, path)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise RuntimeError(f"lanegather {path_names[path]} path "
                                       f"differs from its plain version at "
                                       f"{shape}")
                t = device_ms(lane_launch, s, i, out, axis, path)
                times.append(f"{path_names[path]}:{t:.6f}")
            note += (" both paths equal the plain version; device_ms_by_path "
                     + " ".join(times) + f" floor:{floor_ms:.6f}")
        return (lanegather, lanegather_plain, (s, i, axis), (s, i, axis),
                torch.take_along_dim, (s, i.long(), axis),
                4 * min(s.numel(), i.numel()) + 8 * i.numel(), 0.0, 0.0,
                note)

    def gather_x(k, n, seed):
        x = np.random.default_rng(seed).standard_normal((k, n))
        return torch.from_numpy(x.astype(np.float32)).to(DEVICE)

    def dma_case(x, steps, G, seed, sweep=False):
        """The ring the rule picks (S stages of R rows, the CTAs launched)
        and, on the main-path case, the device ms and rate over the bound's
        bytes at each ring of S 2, 4, 6 and R 8, 16, 32 that the kernel
        takes."""
        k, n = x.shape
        idx2 = torch.from_numpy(np.random.default_rng(seed).integers(
            0, k, (steps, G)).astype(np.int32)).to(DEVICE)
        distinct = torch.unique(idx2).numel()
        bytes_moved = 4 * n * (distinct + steps * G) + nbytes(idx2)
        out = torch.empty((steps * G, n), device=DEVICE)
        if n % 4:
            note = f"4-byte path, grid={steps} CTAs (a CTA a step)"
        else:
            ring = ring_shape(n, steps, G)
            note = (f"bulk path, ring S={ring.stages} R={ring.chunk_rows} "
                    f"grid={ring.ctas} CTAs")
        if sweep:
            def takes(s_, r_):
                try:
                    ring_shape(n, steps, G, s_, r_)
                except RuntimeError:    # the ring does not fit
                    return False
                return True

            def point(s_, r_):
                t = device_ms(gather_launch, x, idx2, out, s_, r_)
                return f"S{s_}R{r_}:{t:.6f}({bytes_moved / t / 1e9:.3f}TB/s)"
            note += " device_ms_by_ring " + " ".join(
                point(s_, r_) for s_ in (2, 4, 6) for r_ in (8, 16, 32)
                if takes(s_, r_))
        return (dma_gather, lambda x_, i_, _g: dma_gather_plain(x_, i_),
                (x, idx2, G), (x, idx2, G), torch.index_select,
                (x, 0, idx2.reshape(-1)), bytes_moved, 0.0, 0.0, note)

    def shuffle_case(rows, reps, seed, step=False):
        """The chain on ``rows`` rows, a CTA of one warp a row; with
        ``step``, the device time a step: the difference of the device
        times at 64 and 256 steps over the 192 more, in ns and in cycles of
        the SM clock that nvidia-smi reads after it."""
        rng = np.random.default_rng(seed)
        src = torch.from_numpy(rng.standard_normal((rows, 128)).astype(
            np.float32)).to(DEVICE)
        idx = torch.from_numpy(rng.integers(0, 128, (rows, 128)).astype(
            np.int32)).to(DEVICE)
        note = f"grid={rows} CTAs of one warp (a row each)"
        if step:
            t64, t256 = (device_ms(shuffle_bench, src, idx, r)
                         for r in (64, 256))
            per_ns = (t256 - t64) / 192 * 1e6
            clock = sm_clock_mhz() if DEVICE == "cuda" else None
            note += (f" step_ns={per_ns:.3f} (device ms {t64:.6f} at 64 "
                     f"steps, {t256:.6f} at 256)")
            if clock:
                note += (f" step_cycles={per_ns * clock * 1e-3:.1f} at "
                         f"{clock:.0f} MHz")
        return (shuffle_bench, shuffle_bench_plain, (src, idx, reps),
                (src, idx, reps), None, (), 3 * nbytes(src),
                float(reps * src.numel()), 0.0, note)

    def ablate_case(a, csr, variant, seed):
        m, k = a.shape
        x = rand((k,), seed)
        x_bytes = {"empty": 0, "noload": 4 * min(k, 1024)}.get(variant, 4 * k)
        col_bytes = 0 if variant in ("nogather", "empty") else 1
        y_bytes = 4 * (min(m, 128) if variant in ("normw", "empty") else m)
        library = ((torch.sparse.mm, (csr_tensor(csr), x[:, None]))
                   if variant == "full" else (None, ()))
        # what the walk reads of the layout (the row stream, and the piece
        # byte for noload) beside the padded pieces the old walk read
        stream = a.row_nbytes + (nbytes(a.row_piece)
                                 if variant == "noload" else 0)
        note = (f"stream_bytes={stream} padded_bytes="
                f"{nbytes(a.values, a.cols, a.piece_w, a.block_ptr)} "
                f"live_slots={a.num_slots} grid={a.blocks} CTAs of 128 rows")
        return (spmv_ablate, spmv_ablate_plain, (a, x, variant),
                (a, x.double(), variant), *library,
                csr.nnz * (4 + col_bytes) + x_bytes + y_bytes,
                (1.0 if variant == "empty" else 2.0) * csr.nnz,
                ATOMIC_TOL if variant in ("normw", "empty") else REL_TOL,
                note)

    # A WPACK ablation variant needs, as the product, each nnz's value and
    # column once, x and y; only the full forms have a library call.
    wpack_warps = (4, 8, 16)

    def wpack_ablate_case(a, csr, knobs, seed, sweep=False):
        """Also: the layout's bytes the kernel reads (the live quarters'
        values, columns and sel, piece_w of the pieces it reads, every
        piece_lanes, block_ptr, and for the full forms starts and ends of
        the pieces it reads) beside the padded pieces' bytes of the same
        arrays, W and the CTAs; the kernel at every W held to the f64 plain
        version, and the pad form equal to the roll form; with ``sweep``,
        the device ms at each W."""
        x = rand((a.shape[1],), seed)
        library = ((torch.sparse.mm, (csr_tensor(csr), x[:, None]))
                   if "ablate" not in knobs else (None, ()))
        variant = WPACK_VARIANTS[knobs.get("ablate", ""),
                                 knobs.get("prefix", "direct")]
        full = knobs.get("ablate", "") == ""
        lanes = a.piece_lanes.long()
        read = int((lanes > 0).sum())
        read_bytes = (int(((lanes + 31) // 32).sum()) * 32 * (4 + 1 + 1)
                      + 4 * read + nbytes(a.piece_lanes, a.block_ptr)
                      + (2 * 128 * read if full else 0))
        padded = nbytes(a.values, a.cols, a.sel, a.piece_w, a.block_ptr,
                        *((a.starts, a.ends) if full else ()))
        ref = wpack_spmv_plain(a, x.double(), **knobs)
        y = torch.empty((a.shape[0],), device=DEVICE)
        errs = []
        for w in wpack_warps if DEVICE == "cuda" else ():
            wpack_launch(a, x, y, variant, w)
            torch.cuda.synchronize()
            rel, _ = compare(y, ref)
            if not bool(torch.isfinite(y).all()) or rel > REL_TOL:
                raise RuntimeError(f"wpack_ablate variant {variant} at W {w}"
                                   f": max_rel {rel:.3e} > {REL_TOL}")
            errs.append(f"W{w}:{rel:.3e}")
        if knobs.get("prefix") == "roll":
            pad = wpack_spmv(a, x, **dict(knobs, prefix="pad"))
            if not torch.equal(pad, wpack_spmv(a, x, **knobs)):
                raise RuntimeError(f"wpack_ablate: pad and roll forms of "
                                   f"{knobs} differ")
        note = (f"read_bytes={read_bytes} padded_bytes={padded} "
                f"pieces_read={read} of {a.piece_lanes.numel()} "
                f"W={launch_warps(a) if DEVICE == 'cuda' else '-'} "
                f"grid={a.blocks} CTAs (a warp a piece) "
                f"max_rel_by_W {' '.join(errs)}"
                + (" pad==roll" if knobs.get("prefix") == "roll" else ""))
        if sweep and DEVICE == "cuda":
            note += " device_ms_by_W " + " ".join(
                f"W{w}:{device_ms(wpack_launch, a, x, y, variant, w):.6f}"
                for w in wpack_warps)
        return (lambda a_, x_: wpack_spmv(a_, x_, **knobs),
                lambda a_, x_: wpack_spmv_plain(a_, x_, **knobs), (a, x),
                (a, x.double()), *library,
                csr.nnz * (4 + 1) + nbytes(x) + 4 * a.shape[0], 2.0 * csr.nnz,
                REL_TOL, note)

    # the probe's matrix, a small one, and LINE_S: v1's walk on a band of 5 %
    # of the columns and on fully scattered ones
    ablations = [(DeviceWROW.from_csr(csr, device=DEVICE), csr, bw)
                 for csr, bw in ((ablate, ABLATE[2]),
                                 (ablate_small, ABLATE[2]), (line_s, 0.9))]
    for a, csr, _ in ablations:
        layout_line("wrow", csr, a, "groups of 8 pieces of 128 slots",
                    a.num_groups)
        print(f"phase 1 layout: wrow of {csr.name}: {a.blocks} blocks, at "
              f"most {int(torch.diff(a.row_slot).max())} live slots a row "
              f"(ATOMIC_TOL holds while blocks + that stay below ~1,670)",
              flush=True)
    g_k, g_n, g_steps = GATHER
    x_gather = gather_x(g_k, g_n, 16)

    hyper_label = "MAIN_LINE {}x{} hypersparse".format(*hyper.shape)
    edge_label = "3000x2000 empty row blocks, 250-nnz row, ragged k"
    empty_label = "banded 1000^2 empty target blocks 1-2"
    b_label = "LINE_B {}x{} {} nnz".format(*line_b.shape, line_b.nnz)
    s_label = "LINE_S {}x{} scattered {} nnz".format(*line_s.shape,
                                                     line_s.nnz)
    cases = [
        ("bsr_spmm", "headline 512^2 bm=128 n=512", True,
         lambda: bsr_case(head, 128, 512, 1, sweep=True)),
        ("bsr_spmm", "pipeline weight 512^2 bm=128 n=512", False,
         lambda: bsr_case(wk, 128, 512, 2)),
        ("bsr_spmm", "banded 1000^2 empty block rows bm=8 n=200", False,
         lambda: bsr_case(banded, 8, 200, 3)),
        ("bsr_spmm", "4096^2 50% bm=128 n=512", False,
         lambda: bsr_case(big, 128, 512, 4)),
        ("panel_spmm", "headline 512^2 n=512", True,
         lambda: panel_case(head, 512, 1, sweep=True)),
        ("panel_spmm", "banded 1000^2 empty rows n=200", False,
         lambda: panel_case(banded, 200, 3)),
        ("panel_spmm", "4096^2 50% n=512", False,
         lambda: panel_case(big, 512, 4)),
        ("panel_spmm_bf16", "headline 512^2 n=512", True,
         lambda: panel_bf16_case(head, 512, 1, sweep=True)),
        ("panel_spmm_bf16", f"{b_label} n=512", LIBRARY_TOO,
         lambda: panel_bf16_case(line_b, 512, 12)),
        ("panel_spmm_bf16", "banded 1000^2 empty rows n=200", False,
         lambda: panel_bf16_case(banded, 200, 3)),
        ("panel_spmm_bf16", "4096^2 50% n=512", LIBRARY_TOO,
         lambda: panel_bf16_case(big, 512, 4)),
        ("bsr_sddmm", "pipeline mask 512^2 s=0.9 bm=128 d=512", True,
         lambda: sddmm_case(mask, 128, 512, 5, sweep=True)),
        ("bsr_sddmm", "banded 1000^2 empty block rows bm=8 d=200", False,
         lambda: sddmm_case(banded, 8, 200, 6)),
        ("bsr_sddmm", "4096^2 band_and_random s=0.95 bm=128 d=512", False,
         lambda: sddmm_case(big_mask, 128, 512, 7)),
        ("bsr_sddmm", "banded 1000^2 K of 900 rows (fewer than the mask's "
         "columns) bm=128 d=96", False,
         lambda: sddmm_case(banded, 128, 96, 30, mk=900)),
    ]
    # the planner's other blockings (ops/sddmm_plan.py CANDIDATES): a ragged
    # mask with empty far-band blocks, and one whose m and k are no
    # multiple of 512 with pad blocks (block row mb)
    for bm, bk in SDDMM_BLOCKINGS:
        cases += [
            ("bsr_sddmm", f"4096^2 band_and_decay s=0.95 bm={bm} bk={bk} "
             f"d=512", False,
             functools.partial(sddmm_case, decay_mask, bm, 512, 28, bk=bk)),
            ("bsr_sddmm", f"{RAGGED}^2 band_and_random s=0.9 pad blocks "
             f"bm={bm} bk={bk} d=512", False,
             functools.partial(sddmm_case, ragged_mask, bm, 512, 29, bk=bk,
                               pad_multiple=8)),
        ]
    cases += [
        ("wcoo_spmm", f"{hyper_label} n=512", True,
         lambda: wcoo_case(hyper, 512, 8)),
        ("wcoo_spmm", f"{edge_label} n=200", False,
         lambda: wcoo_case(edge, 200, 9)),
        ("wcoo_spmm", f"{hyper_label} n=77 (scalar form)", False,
         lambda: wcoo_case(hyper, 77, 23)),
        ("wcoo_spmm", f"{empty_label} n=128", False,
         lambda: wcoo_case(empty_blocks, 128, 24)),
        ("wcoo_spmm_aligned", f"{hyper_label} n=512", True,
         lambda: bands_case(hyper, 512, 8)),
        ("wcoo_spmm_aligned", f"{edge_label} n=200", False,
         lambda: bands_case(edge, 200, 9)),
        ("wcoo_spmm_aligned", f"{hyper_label} n=77 (scalar form)", False,
         lambda: bands_case(hyper, 77, 23)),
        ("wcoo_spmm_aligned", f"{empty_label} n=128", False,
         lambda: bands_case(empty_blocks, 128, 24)),
        ("wrow_spmv", f"{hyper_label} n=1", True,
         lambda: wrow_case(hyper, 10)),
        ("wrow_spmv", f"{edge_label} n=1", False,
         lambda: wrow_case(edge, 11)),
        ("wrow_spmv", f"{s_label} n=1", LIBRARY_TOO,
         lambda: wrow_case(line_s, 14)),
        ("wcoo_spmv", f"{hyper_label} n=1", True,
         lambda: wcoo_spmv_case(hyper, 10, sweep=True)),
        ("wcoo_spmv", f"{edge_label} n=1", False,
         lambda: wcoo_spmv_case(edge, 11)),
        ("wcoo_spmv", "1000x3200 a 3000-slot row, 400 empty rows n=1", False,
         lambda: wcoo_spmv_case(long_row_matrix(), 27)),
        ("bsr_spmm_cstat", f"{b_label} n=512", True,
         lambda: bsrc_case(line_b, 512, 12)),
        ("bsr_spmm_cstat", "headline 512^2 one band n=512", False,
         lambda: bsrc_case(head, 512, 1)),
        ("bsr_spmm_cstat", "banded 1000^2 empty block rows bm=8 R=256 n=200",
         False, lambda: bsrc_case(banded, 200, 3, bm=8, band_rows=256)),
        ("bsr_spmm_cstat", "4096^2 50% n=512", False,
         lambda: bsrc_case(big, 512, 4)),
        ("dgell", f"{s_label} n=512", True,
         lambda: dgell_case(line_s, 512, 13, sweep=True)),
        ("dgell", f"{s_label} n=100 (ragged last slab)", False,
         lambda: dgell_case(line_s, 100, 25)),
        ("dgell", f"{edge_label} n=200", False,
         lambda: dgell_case(edge, 200, 9)),
        ("dgell", f"{edge_label} n=77 (scalar form)", False,
         lambda: dgell_case(edge, 77, 26)),
        ("wpack_spmv", f"{s_label} n=1", True,
         lambda: wpack_case(line_s, 14)),
        ("wpack_spmv", f"{edge_label} n=1", False,
         lambda: wpack_case(edge, 11)),
        ("wrow_spmv_v2", f"{s_label} n=1", True,
         lambda: wrow_v2_case(line_s, 14)),
        ("wrow_spmv_v2", f"{edge_label} n=1", False,
         lambda: wrow_v2_case(edge, 11)),
    ]
    # the stream kernels' own edges: one block over many ranges, empty
    # target blocks, and the CLI slice's matrix
    for label, csr, seed in (
            ("4096^2 straddling band (262K slots in one block)", straddle, 22),
            (empty_label, empty_blocks, 3),
            (hyper_label, hyper, 10)):
        cases += [("wpack_spmv", f"{label} n=1", False,
                   functools.partial(wpack_case, csr, seed)),
                  ("wrow_spmv_v2", f"{label} n=1", False,
                   functools.partial(wrow_v2_case, csr, seed))]
        if csr is not hyper:       # v1's MAIN_LINE case is above
            cases.append(("wrow_spmv", f"{label} n=1", False,
                          functools.partial(wrow_case, csr, seed)))
    for i, (form, src, idx, axis) in enumerate(
            forms(np.random.default_rng(0))):
        cases.append(("lanegather", form, i == 0,
                      functools.partial(lanegather_case, src, idx, axis)))
    for G in (64, 256):
        cases.append(("dma_gather", f"X {g_k}x{g_n} {g_steps} steps G={G}",
                      G == 64,
                      functools.partial(dma_case, x_gather, g_steps, G, 17,
                                        sweep=G == 64)))
    cases.append(("dma_gather", "X 300x201 (4-byte copies) 3 steps G=6",
                  False, lambda: dma_case(gather_x(300, 201, 18), 3, 6, 19)))
    for rows in (256, 1):
        for reps in (64, 256):
            cases.append(("shuffle_bench", f"({rows},128) reps={reps}",
                          rows == 256 and reps == 256,
                          functools.partial(shuffle_case, rows, reps, 20,
                                            step=reps == 256)))
    for a, csr, bw in ablations:
        for variant in VARIANTS:
            cases.append((
                "spmv_ablate", "{}x{} bw={} {} nnz {}".format(
                    *csr.shape, bw, csr.nnz, variant),
                csr is ablate and variant == "full",
                functools.partial(ablate_case, a, csr, variant, 21)))
    wpack_layouts = ((DeviceWPACK.from_csr(wpack_ab, device=DEVICE),
                      wpack_ab),
                     (DeviceWPACK.from_csr(edge, 1, device=DEVICE), edge),
                     (DeviceWPACK.from_csr(edge, 4, device=DEVICE), edge))
    for a, csr in wpack_layouts:
        layout_line("wpack", csr, a, f"groups of 8 pieces (wsel {a.wsel})",
                    a.num_groups)
        for tag, knobs in FORMS[:-1]:      # full/direct is wpack_spmv's case
            cases.append((
                "wpack_ablate", "{}x{} wsel {} {}".format(*csr.shape, a.wsel,
                                                           tag),
                csr is wpack_ab and tag == "full/roll",
                functools.partial(wpack_ablate_case, a, csr, knobs, 14,
                                  sweep=True)))
    # a grid between the probe's 782 blocks and the edge's 24: MAIN_LINE's
    # 512, where the rule takes 8 warps a CTA on 132 SMs
    cases.append(("wpack_ablate", f"{hyper_label} full/roll", False,
                  lambda: wpack_ablate_case(
                      DeviceWPACK.from_csr(hyper, device=DEVICE), hyper,
                      dict(FORMS)["full/roll"], 14, sweep=True)))
    main_path, failed = {}, []
    for name, label, on_path, make in cases:
        (kernel, plain, args, args64, library, lib_args, bytes_moved,
         flops, *tail) = make()
        tol = tail[0] if tail else REL_TOL
        note = f"{tail[1]} " if len(tail) > 1 else ""
        rate = tail[2] if len(tail) > 2 else F32_FLOPS_PER_S
        out = kernel(*args)
        torch.cuda.synchronize()
        ref = plain(*args64)
        if out.shape != ref.shape:
            raise RuntimeError(f"{name} [{label}]: shape {tuple(out.shape)}, "
                               f"plain {tuple(ref.shape)}")
        rel, err = compare(out, ref)
        del ref
        k_ms, p_ms = ms(kernel, *args), ms(plain, *args)
        lib_ms = None if library is None else ms(library, *lib_args)
        dev_ms = device_ms(kernel, *args)
        # the main-path case's library call in device time too, where it
        # can be captured in a graph: the factor rule-2 work is judged by
        lib_dev = (library_device_ms(library, *lib_args)
                   if on_path and library is not None else None)
        b_ms, b_by = bound(bytes_moved, flops, rate)
        ok = bool(torch.isfinite(out).all()) and rel <= tol
        print(f"phase 1 kernels: {name} [{label}] max_rel={rel:.3e} "
              f"(tol {tol:g}) max_abs={err:.3e} kernel_ms={k_ms:.6f} "
              f"kernel_device_ms={dev_ms:.6f} plain_ms={p_ms:.6f} "
              f"library_ms={show_ms(lib_ms)} "
              f"library_device_ms={show_ms(lib_dev)} "
              f"bound_ms={b_ms:.6f} ({b_by}) {note}"
              f"{'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(f"{name} [{label}]")
        if on_path is True:
            main_path[name] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                               "bound_ms": b_ms, "bound_by": b_by,
                               "library_ms": lib_ms}
        del out, args, args64, lib_args
    if failed:
        raise RuntimeError(f"kernel disagrees with its plain version: {failed}")
    return main_path


def phase_headline() -> None:
    from spgrid_torch.bench.headline import headline_line, run_headline
    rows = run_headline(DEVICE)
    for r in rows:
        print(f"phase 2 headline: {r['kernel']} gflops={r['gflops']:.3f} "
              f"time_s={r['time']:.9f} iters={r['iters']} "
              f"errors_passed={r['errors_passed']} mape={r['mape']:.3e}",
              flush=True)
    failed = [r["kernel"] for r in rows if not r["errors_passed"]]
    if failed:
        raise RuntimeError(f"headline gate failed for {failed}")
    print(json.dumps(headline_line(rows, torch.cuda.get_device_name(0))),
          flush=True)


def phase_flagship() -> None:
    from spgrid_torch.bench.harness import run_pipeline
    from spgrid_torch.core.config import BenchConfig
    from spgrid_torch.core.metrics import error_metrics
    from spgrid_torch.entry import entry, flagship_csrs
    from spgrid_torch.ops.attention import gold_pipeline
    from spgrid_torch.ops.kernels import launch_counts

    fn, (attn, x) = entry(DEVICE)
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = fn(attn, x)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    after = launch_counts()
    moved = {k: after[k] - before[k] for k in after}
    if moved["bsr_spmm"] != 4 or moved["bsr_sddmm"] != 1:
        raise RuntimeError(f"one step launched {moved}; expected 4 bsr_spmm "
                           f"and 1 bsr_sddmm")
    wk, wq, wv, mask = flagship_csrs()
    y_host = y.cpu().numpy()
    if y_host.shape != (wk.m, x.shape[1]) or not np.isfinite(y_host).all():
        raise RuntimeError(f"flagship output shape {y_host.shape} or "
                           f"non-finite values")
    gate = error_metrics(gold_pipeline(wk, wq, wv, mask, x.cpu().numpy()),
                         y_host, epsilon=1e-3)
    print(f"phase 3 flagship: entry step (first call) {step_s * 1e3:.3f} ms "
          f"launches {moved} max_rel_diff={gate.max_rel_diff:.3e} "
          f"{'PASS' if gate.passed else 'FAIL'}", flush=True)
    if not gate.passed:
        raise RuntimeError("flagship step failed gold_pipeline at eps 1e-3")

    row = run_pipeline(wk, wq, wv, mask, BenchConfig(), device=DEVICE)
    print(f"phase 3 flagship: run_pipeline step_time_s={row['time']:.9f} "
          f"gflops={row['gflops']:.3f} K={row['gflops_spmm_K']:.3f} "
          f"Q={row['gflops_spmm_Q']:.3f} V={row['gflops_spmm_V']:.3f} "
          f"S={row['gflops_sddmm']:.3f} Y={row['gflops_final_spmm']:.3f} "
          f"errors_passed={row['errors_passed']}", flush=True)
    if not row["errors_passed"]:
        raise RuntimeError("run_pipeline failed gold_pipeline at eps 1e-3")


def gate_line(r, config=None) -> str:
    """A row's gate: its class and where it ran (the config's ``oracle``;
    the CLI's is the environment's, 'auto' by default, at the row's
    dtype)."""
    from spgrid_torch.bench.harness import gate_site, gold_class
    from spgrid_torch.core.config import BenchConfig
    config = config or BenchConfig.from_env(dtype=r.get("dtype") or "float32")
    site = gate_site(int(r["csr_m"]), int(r["input_columns"]), config,
                     torch.device(DEVICE))
    return f"gate={gold_class(r['fmt'])} on the {site}"


def cli_rows(phase: str, runs) -> list:
    """``python -m spgrid_torch.bench`` (its ``main``) once for each
    (source, kernels, n) of ``runs`` into one CSV; a source is a parameter
    line or the CLI's arguments that name the matrix (``--matrix``, and
    ``--generate`` with ``--reorder``). Every row must pass its gate.
    Returns the rows."""
    from spgrid_torch.bench.cli import main as cli_main
    from spgrid_torch.ops.kernels import launch_counts

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rows.csv")
        for source, kernels, n in runs:
            args = (["--generate", source] if isinstance(source, str)
                    else list(source))
            before = launch_counts()
            code = cli_main(args + ["--kernels", kernels, "--num-cols", n,
                                    "--out", out, "--platform", DEVICE])
            if code != 0:
                raise RuntimeError(f"the CLI exited {code} on {kernels}")
            # each run's launches by kernel: the split of a kernel's count
            # over its cases
            moved = {k: c - before[k] for k, c in launch_counts().items()
                     if c != before[k]}
            print(f"{phase} launches: {' '.join(args[:2])[:60]} "
                  f"{kernels} n={n}: {moved}", flush=True)
        rows = read_csv(out)
    for r in rows:
        print(f"{phase}: {r['matrix_name']} {r['kernel']} "
              f"n={r['input_columns']} "
              f"nnz={r['csr_nnz']} gflops={r['gflops']} time_s={r['time']} "
              f"iters={r['iters']} gbytes_per_s={r['gbytes_per_s']} "
              f"sol_time={r['sol_time']} max_ae={r['max_ae']} "
              f"fmt={r['fmt']} {gate_line(r)} "
              f"errors_passed={r['errors_passed']}", flush=True)
    want = sum(len(kernels.split(",")) for _, kernels, _ in runs)
    if len(rows) != want or not all(r["errors_passed"] == "1" for r in rows):
        raise RuntimeError(f"the CLI wrote {len(rows)} rows, not {want} "
                           f"gated ones")
    return rows


# (line, kernels, n) of the CLI's runs in phases 4 and 5
CLI_RUNS = ((MAIN_LINE, "wcoo_cuda,wcoo_bands_cuda", "512"),
            (MAIN_LINE, "wrow_spmv_cuda,wcoo_spmv_cuda", "1"),
            (MAIN_LINE, "coo,sell,merge,gell,gell16,cv_gell", "512"),
            (LINE_B, "coo,sell,merge,gell", "512"))
SCATTERED_RUNS = ((LINE_B, "bsrc_cuda,bsr_cuda", "512"),
                  (LINE_S, "dgell_cuda", "512"),
                  (LINE_S, "wpack_spmv_cuda,wrow_spmv_cuda", "1"))


def phase_cli() -> None:
    """Phase 4: the CLI on ``MAIN_LINE`` (the slot kernels, and the torch-op
    formats coo, sell, merge and gell in its three modes) and the torch-op
    formats on ``LINE_B``."""
    cli_rows("phase 4 cli", CLI_RUNS)


def phase_scattered_cli() -> None:
    """Phase 5: the CLI on ``LINE_B`` and ``LINE_S``, then the WROW v1/v2
    A/B on ``LINE_S`` as ``scripts/exp_wrow_v2.py`` runs it: x standard
    normal, each variant's max |y - gold| over max |gold| below 1e-4
    against the host f64 product."""
    from spgrid_torch.core.metrics import gold_spmm_fast
    from spgrid_torch.core.timing import time_kernel
    from spgrid_torch.ops.kernels.wrow_spmv import DeviceWROW, wrow_spmv

    cli_rows("phase 5 cli", SCATTERED_RUNS)
    csr = line_matrix(LINE_S)
    a = DeviceWROW.from_csr(csr, device=DEVICE)
    x = np.random.default_rng(0).standard_normal(csr.k).astype(np.float32)
    gold = gold_spmm_fast(csr.row_ptr, csr.col_idx, csr.values, x)
    xd = torch.from_numpy(x).to(DEVICE)
    failed = []
    for variant in ("v1", "v2"):
        y = wrow_spmv(a, xd, variant=variant).cpu().numpy()
        err = np.abs(y - gold).max() / max(np.abs(gold).max(), 1e-30)
        t = time_kernel(lambda v=variant: wrow_spmv(a, xd, variant=v),
                        device=DEVICE, warmup_iters=5, min_time_s=TIME_S,
                        min_iters=20).time_per_iter_s
        dev = device_ms(lambda v=variant: wrow_spmv(a, xd, variant=v))
        ok = bool(np.isfinite(y).all()) and err < 1e-4
        print(f"phase 5 wrow A/B: {variant} m={csr.m} nnz={csr.nnz} "
              f"groups={a.num_groups} util={a.utilization:.3f} "
              f"max_rel~{err:.2e} ms={t * 1e3:.6f} device_ms={dev:.6f} "
              f"gflops={2.0 * csr.nnz / t / 1e9:.3f} "
              f"{'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(variant)
    if failed:
        raise RuntimeError(f"WROW A/B failed for {failed}")


def phase_probes() -> None:
    """Phase 6: the probe drivers' ``main`` at the JAX scripts' default
    sizes (``ABLATE``, ``GATHER``, ``WPACK_ABLATE``); each must exit 0."""
    from spgrid_torch.scripts import (
        exp_lanegather, exp_pallas_gather, exp_spmv_ablate, exp_wpack_ablate)
    k, n, steps = GATHER
    runs = (("exp_spmv_ablate", exp_spmv_ablate.main,
             [str(v) for v in ABLATE]),
            ("exp_pallas_gather", exp_pallas_gather.main,
             ["--k", str(k), "--n", str(n), "--steps", str(steps)]),
            ("exp_lanegather", exp_lanegather.main, []),
            ("exp_wpack_ablate", exp_wpack_ablate.main,
             [str(v) for v in WPACK_ABLATE]))
    for name, main, argv in runs:
        argv = argv + ["--platform", DEVICE]
        print(f"phase 6 probes: python -m spgrid_torch.scripts.{name} "
              f"{' '.join(argv)}", flush=True)
        code = main(argv)
        if code != 0:
            raise RuntimeError(f"{name} exited {code}")


def phase_eager_ab() -> None:
    """Phase 8 (``--eager-ab``): ``run_spmm`` on the headline rows of phase
    2 and the CLI rows of phases 4 and 5 under the eager protocol, without
    the gates those phases held; one line of seconds a call by row."""
    import dataclasses
    from spgrid_torch.bench.harness import run_spmm
    from spgrid_torch.bench.headline import (
        KERNELS, headline_config, headline_matrix)
    from spgrid_torch.core.config import BenchConfig

    runs = [(headline_matrix(), kernel,
             dataclasses.replace(headline_config(), timing_protocol="eager"))
            for kernel in KERNELS]
    matrices = {}
    for line, kernels, n in CLI_RUNS + SCATTERED_RUNS:
        if line not in matrices:
            matrices[line] = line_matrix(line)
        csr = matrices[line]
        config = BenchConfig.from_env(num_cols=int(n),
                                      timing_protocol="eager")
        runs += [(csr, kernel, config) for kernel in kernels.split(",")]
    eager = {}
    for csr, kernel, config in runs:
        row = run_spmm(csr, kernel, config, device=DEVICE,
                       check_accuracy=False)
        eager[f"{csr.m}x{csr.k} {kernel} n={config.num_cols}"] = row["time"]
    print(f"phase 8 eager A/B: time_s {json.dumps(eager)}", flush=True)


# The dispatch phase's matrices: the headline's DLMC twin, LINE_B,
# MAIN_LINE, the mac_econ twin the JAX package ran rbh on
# (scripts/exp_reorder.py:61) and its scattered class centrepiece
# r3_scat_393k (:43), each at n = 512. Rows whose f32 result passes 32 MB
# are gated on the card (``oracle="auto"``): the host's f64 gates of
# r3_scat_393k's 393215 x 512 rows took 228 s of the phase (PERF.md).
MAC_ECON = ("206500 206500 6.16653 4.43586 normal random 0.00191 6.13529 "
            "0.17669 0.33051 14")
R3_SCAT = "393215 393215 5 1.6667 normal random 0.5 0 0.5 0.75 14"
DISPATCH_LINES = (("headline", None), ("LINE_B", LINE_B),
                  ("MAIN_LINE", MAIN_LINE), ("mac_econ_fwd500_twin", MAC_ECON),
                  ("r3_scat_393k", R3_SCAT))
DISPATCH_ROWS: list = []     # the dispatch path's rows, for the calibration
DISPATCH_N = 512
DISPATCH_TIME_S = 0.1   # the rows' minimum timed seconds
# the calibration's sizes: the copy's bytes, the matmul's side, the rows
# gathered from a 32 MB and a 512 MB X of 2 KB rows, the GELL slot sum's
# rows (8 slots of 2 KB)
CALIBRATION = dict(copy_bytes=1 << 30, matmul=8192, gathered=1 << 18,
                   x_small=1 << 14, x_big=1 << 18, combine_rows=1 << 16)


def dispatch_kernels(label: str, f) -> list:
    """Every AUTO candidate the cost model finds applicable (the port's
    names), then auto and autotune; auto_tol on MAIN_LINE and gemm_bound
    on the headline's twin."""
    from spgrid_torch.ops import costmodel
    from spgrid_torch.ops.dispatch import PORT_NAME
    kernels = [PORT_NAME[c] for c in costmodel.AUTO_CANDIDATES
               if np.isfinite(costmodel.estimate_spmm_time(f, c,
                                                           DISPATCH_N))]
    kernels += ["auto", "autotune"]
    if label == "MAIN_LINE":
        kernels.append("auto_tol")
    if label == "headline":
        kernels.append("gemm_bound")
    return kernels


def rbh_line(csr) -> str:
    """rbh's split on ``csr`` at the committed constants: its SplitStats,
    residual format and the block part's coverage blocks."""
    from spgrid_torch.ops.rbh import DeviceRBH
    t0 = time.perf_counter()
    a = DeviceRBH.from_csr(csr, n_hint=DISPATCH_N, device=DEVICE)
    st = a.stats
    return (f"method={st.method} threshold={st.threshold} "
            f"hi_frac={st.hi_frac:.4f} hi_blocks={st.hi_blocks} "
            f"hi_fill={st.hi_fill:.5f} hi_nnz={st.hi_nnz} "
            f"lo_nnz={st.lo_nnz} residual={a.res_fmt} "
            f"coverage_blocks={a.coverage_blocks} "
            f"inspect_s={time.perf_counter() - t0:.2f}")


def dispatch_rows() -> list:
    """(b): ``run_spmm`` on each matrix of ``DISPATCH_LINES`` for each of
    its ``dispatch_kernels``; every row must pass its gate. Prints rbh's
    split, each row's predicted time beside its measured one, and auto's
    and autotune's picks."""
    from spgrid_torch.bench.harness import run_spmm
    from spgrid_torch.bench.headline import headline_matrix
    from spgrid_torch.core.config import BenchConfig
    from spgrid_torch.features import matrix_features
    from spgrid_torch.ops import costmodel

    config = BenchConfig.from_env(num_cols=DISPATCH_N,
                                  min_time_s=DISPATCH_TIME_S, warmup_iters=3)
    rows = []
    for label, line in DISPATCH_LINES:
        t0 = time.perf_counter()
        csr = headline_matrix() if line is None else line_matrix(line)
        f = matrix_features(csr)
        csr._spgrid_torch_feats = f      # the harness's cache
        print(f"phase 7 dispatch: {label} {csr.m}x{csr.k} nnz={csr.nnz} "
              f"host_s={time.perf_counter() - t0:.1f} rbh {rbh_line(csr)}",
              flush=True)
        for kernel in dispatch_kernels(label, f):
            row = run_spmm(csr, kernel, config, device=DEVICE)
            pred = costmodel.estimate_spmm_time(f, row["fmt"], DISPATCH_N)
            print(f"phase 7 dispatch: {label} {kernel} fmt={row['fmt']} "
                  f"time_s={row['time']:.9f} predicted_s={pred:.9f} "
                  f"measured/predicted={row['time'] / pred:.3f} "
                  f"gflops={row['gflops']:.3f} max_ae={row['max_ae']:.3e} "
                  f"{gate_line(row, config)} "
                  f"errors_passed={row['errors_passed']}", flush=True)
            if not row["errors_passed"]:
                raise RuntimeError(f"dispatch row {label} {kernel} "
                                   f"({row['fmt']}) failed its gate")
            rows.append(dict(row, label=label))
        picks = {r["kernel"]: r["fmt"] for r in rows
                 if r["label"] == label and r["kernel"] in (
                     "auto", "autotune", "auto_tol")}
        print(f"phase 7 dispatch: {label} picks {json.dumps(picks)} "
              f"matrix_s={time.perf_counter() - t0:.1f}", flush=True)
    return rows


def two_term_fit(a1, b1, t1, a2, b2, t2):
    """(c_a, c_b) >= 0 with c_a a + c_b b = t on both rows: the 2 x 2
    solution where both terms come out non-negative, else the one-term
    least-squares fit that is."""
    det = a1 * b2 - a2 * b1
    if det:
        ca, cb = (t1 * b2 - t2 * b1) / det, (a1 * t2 - a2 * t1) / det
        if ca >= 0 and cb >= 0:
            return ca, cb
    one_a = (a1 * t1 + a2 * t2) / (a1 * a1 + a2 * a2)
    one_b = (b1 * t1 + b2 * t2) / (b1 * b1 + b2 * b2)
    err_a = (t1 - one_a * a1) ** 2 + (t2 - one_a * a2) ** 2
    err_b = (t1 - one_b * b1) ** 2 + (t2 - one_b * b2) ** 2
    return (max(one_a, 0.0), 0.0) if err_a <= err_b else (0.0,
                                                          max(one_b, 0.0))


def block_part(blocks_per_row: int, mb: int = 64):
    """A DeviceBSR of ``mb`` block rows of ``blocks_per_row`` dense 128^2
    blocks each (columns spread over 64 block columns)."""
    from spgrid_torch.ops.layouts import DeviceBSR
    rng = np.random.default_rng(blocks_per_row)
    rows = np.repeat(np.arange(mb, dtype=np.int32), blocks_per_row)
    cols = np.concatenate([np.sort(rng.choice(64, blocks_per_row,
                                              replace=False))
                           for _ in range(mb)]).astype(np.int32)
    blocks = rng.random((rows.size, 128, 128)).astype(np.float32) + 0.5
    starts = np.arange(0, rows.size + 1, blocks_per_row, dtype=np.int32)
    return DeviceBSR.from_arrays(rows, cols, starts, blocks,
                                 (mb * 128, 64 * 128), rows.size * 16384,
                                 rows.size, device=DEVICE)


def calibrate(rows) -> dict:
    """(a): each ``H100Constants`` field measured on the card, every time
    by graph replay (``device_ms``)."""
    from spgrid_torch.bench.headline import headline_matrix
    from spgrid_torch.ops import costmodel
    from spgrid_torch.ops.dense import full_f32
    from spgrid_torch.ops.kernels.bsr_spmm import bsr_spmm
    from spgrid_torch.ops.kernels.lanegather import launch_floor
    from spgrid_torch.ops.kernels.wcoo_spmm_aligned import (
        DeviceWCOOBands, wcoo_spmm_aligned)
    from spgrid_torch.ops.layouts import DeviceCOO
    from spgrid_torch.ops.xla import segment_sum
    from spgrid_torch.features import matrix_features

    n = DISPATCH_N
    cal = CALIBRATION
    got = {}
    src = torch.empty(cal["copy_bytes"] // 4, device=DEVICE).fill_(1.0)
    dst = torch.empty_like(src)
    got["eff_bw"] = 2 * cal["copy_bytes"] / (device_ms(
        dst.copy_, src, calls=5, replays=10) * 1e-3)
    del src, dst
    full_f32()
    side = cal["matmul"]
    for field, dtype in (("mxu_f32", torch.float32),
                         ("mxu_bf16", torch.bfloat16)):
        a = rand((side, side), 1).to(dtype)
        b = rand((side, side), 2).to(dtype)
        ms = device_ms(torch.matmul, a, b, calls=3, replays=3)
        got[field] = 2 * side ** 3 / (ms * 1e-3)
    del a, b
    for field, k in (("gather_fast", cal["x_small"]),
                     ("gather_slow", cal["x_big"])):
        x = rand((k, n), 3)
        idx = torch.randint(0, k, (cal["gathered"],), device=DEVICE)
        ms = device_ms(x.index_select, 0, idx, calls=4, replays=10)
        got[field] = cal["gathered"] / (ms * 1e-3)
    del x, idx
    g = torch.ones((cal["combine_rows"], 8, n), device=DEVICE)
    vals = torch.ones((cal["combine_rows"], 8, 1), device=DEVICE)
    out = torch.empty((cal["combine_rows"], n), device=DEVICE)
    ms = device_ms(lambda: torch.sum(g.mul_(vals), dim=1, out=out),
                   calls=5, replays=10)
    got["combine_bw"] = (3 * g.numel() + out.numel()) * 4 / (ms * 1e-3)
    del g, vals, out
    few, many = block_part(1), block_part(16)
    x = rand((64 * 128, n), 4)
    t_few = device_ms(bsr_spmm, few, x) * 1e-3
    t_many = device_ms(bsr_spmm, many, x) * 1e-3
    slope = (t_many - t_few) / (many.num_blocks - few.num_blocks)
    term = max(128 * n * 4 / got["eff_bw"],
               2.0 * 128 * 128 * n / got["mxu_f32"])
    got["grid_step"] = max(slope - term, 0.0)
    print(f"phase 7 calibration: bsr_cuda {few.num_blocks} blocks "
          f"{t_few * 1e3:.6f} ms, {many.num_blocks} blocks "
          f"{t_many * 1e3:.6f} ms: {slope * 1e9:.2f} ns a block, the "
          f"product/copy term {term * 1e9:.2f} ns", flush=True)
    del few, many, x
    got["dispatch"] = device_ms(launch_floor, DEVICE) * 1e-3
    fit = []
    for line in (MAIN_LINE, LINE_B):
        csr = line_matrix(line)
        f = matrix_features(csr)
        a = DeviceWCOOBands.from_csr(csr, device=DEVICE)
        x = rand((csr.k, n), 5)
        t = device_ms(wcoo_spmm_aligned, a, x) * 1e-3
        fit.append((costmodel._wcoo_bands_slots(f), float(csr.nnz),
                    t - csr.m * n * 4 / got["eff_bw"]))
        print(f"phase 7 calibration: wcoo_bands_cuda {csr.m}x{csr.k} "
              f"{t * 1e3:.6f} ms, predicted slots {fit[-1][0]:.0f}, "
              f"nnz {csr.nnz}", flush=True)
    (s1, z1, t1), (s2, z2, t2) = fit
    got["wcoo_slot"], got["wcoo_nnz"] = two_term_fit(s1, z1, t1, s2, z2, t2)
    csr = line_matrix(MAIN_LINE)
    coo = DeviceCOO.from_csr(csr, device=DEVICE)
    x = rand((csr.k, n), 6)
    prods = x.index_select(0, coo.cols[:csr.nnz]).mul_(
        coo.values[:csr.nnz, None])
    ms = device_ms(segment_sum, prods, coo.row_ptr)
    got["scoo_scatter"] = ms * 1e-3 / csr.nnz
    del coo, x, prods
    mac = [r for r in rows if r["label"] == "mac_econ_fwd500_twin"
           and r["kernel"] in ("sell", "gell")]
    got["residual_nnz"] = (min(r["time"] for r in mac) / mac[0]["csr_nnz"]
                           * (512.0 / n))
    committed = dataclasses.asdict(costmodel.C)
    for field, value in got.items():
        print(f"phase 7 calibration: {field} measured={value:.6g} "
              f"committed={committed[field]:.6g}", flush=True)
    return got


def phase_dispatch() -> None:
    """Phase 7, the dispatch path: (b) the dispatch rows, then
    ``fit_constants`` over the fixed formats' rows and
    ``dispatch_accuracy`` over the matrices. The rows are kept in
    ``DISPATCH_ROWS`` for ``phase_calibration``."""
    from spgrid_torch.ops import costmodel, rbh
    from spgrid_torch.ops.dispatch import FORMATS
    from spgrid_torch.viz.dataset import dispatch_accuracy

    t0 = time.perf_counter()
    committed = costmodel.C
    print(f"phase 7 dispatch: auto_threshold(512)={rbh.auto_threshold(512)} "
          f"at the committed constants", flush=True)
    rows = dispatch_rows()
    DISPATCH_ROWS[:] = rows
    fixed = [r for r in rows if r["kernel"] in FORMATS]
    fudge_before = dict(committed.fudge)
    fitted = costmodel.fit_constants(fixed, min_rows=3)
    print(f"phase 7 fit: ratios {json.dumps(fitted)} fudge "
          f"{json.dumps(fudge_before)} -> {json.dumps(committed.fudge)}",
          flush=True)
    committed.fudge.clear()
    committed.fudge.update(fudge_before)
    acc, records = dispatch_accuracy(
        [r for r in rows if r["kernel"] in FORMATS or r["kernel"] == "auto"],
        tol=0.10, include_lossy=False)
    print(f"phase 7 dispatch_accuracy: {acc:.3f} over {len(records)} "
          f"matrices {json.dumps(records)}", flush=True)
    print(f"phase 7 dispatch: {len(rows)} rows, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def phase_calibration() -> None:
    """Phase 7, after its path's launches are read: (a) the calibration of
    ``H100Constants`` beside the committed values, and ``auto_threshold``
    at the measured ones."""
    from spgrid_torch.ops import costmodel, rbh

    t0 = time.perf_counter()
    committed = costmodel.C
    measured = calibrate(DISPATCH_ROWS)
    if all(np.isfinite(v) for v in measured.values()):
        costmodel.C = dataclasses.replace(committed, **measured)
        print(f"phase 7 calibration: auto_threshold(512)="
              f"{rbh.auto_threshold(512)} at the measured constants",
              flush=True)
        costmodel.C = committed
    print(f"phase 7 calibration: H100Constants {json.dumps(measured)} "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


PIPELINE_SPARSITY = 0.9     # the mask of phase 9's --pipeline rows


def read_csv(path) -> list:
    import csv
    with open(path) as f:
        return list(csv.DictReader(f))


def gated(phase: str, rows, eps: float) -> None:
    """Print each row with its gate; raise unless every row passed."""
    for r in rows:
        print(f"{phase}: {r['matrix_name']} {r['kernel']} fmt={r['fmt']} "
              f"n={r['input_columns']} nnz={r['csr_nnz']} "
              f"time_s={r['time']} gflops={r['gflops']} "
              f"max_ae={r['max_ae']} mape={r['mape']} gate eps={eps:g} "
              f"errors_passed={r['errors_passed']}", flush=True)
    failed = [r["matrix_name"] for r in rows if r["errors_passed"] != "1"]
    if failed or not rows:
        raise RuntimeError(f"{phase}: rows {failed} failed their gates "
                           f"({len(rows)} rows)")


def study_lines(tmp: str) -> None:
    """Phase 9's study: ``sddmm_study.main`` at its full grid into ``tmp``,
    both precisions (the 'high' arm on the 3-pass bf16 form); for each
    point the nnz, the 128^2 occupancy, the plan, the predicted speedup
    over 128^2 beside the measured one at each precision, and each
    blocking's device µs (graph replay, at highest) beside
    ``_est_time``'s; every row gated at 1e-4."""
    from spgrid_torch.scripts import sddmm_study
    code = sddmm_study.main(["--out-dir", tmp, "--platform", DEVICE])
    if code != 0:
        raise RuntimeError(f"sddmm_study exited {code}")
    occ = read_csv(os.path.join(tmp, "sddmm_occupancy.csv"))
    sweep = read_csv(os.path.join(tmp, "sddmm_blockings.csv"))
    ab = {(r["mask_type"], r["sparsity"], r["precision"]): r
          for r in read_csv(os.path.join(tmp, "sddmm_planner_ab.csv"))}
    for o in occ:
        point = (o["mask_type"], o["sparsity"])
        times = [r for r in sweep if (r["mask_type"], r["sparsity"]) == point]
        plan = next(r for r in times if r["plan"] == "True")
        blockings = " ".join(
            f"{r['bm']}x{r['bk']}:{float(r['time_s']) * 1e6:.3f}"
            f"({float(r['est_time_s']) * 1e6:.3f})" for r in times)
        print(f"phase 9 study: {o['mask_type']} sp={o['sparsity']} "
              f"nnz={o['nnz']} occupancy_128={o['occupancy_128']} "
              f"plan={o['bm']}x{o['bk']} est_speedup_vs_128="
              f"{o['est_speedup_vs_128']} measured_speedup (highest, high)="
              f"{ab[point + ('highest',)]['measured_speedup']}, "
              f"{ab[point + ('high',)]['measured_speedup']} device_us(est_us) "
              f"{blockings} plan_fastest={plan['fastest']} plan_vs_fastest="
              f"{float(plan['vs_fastest']):.4f}", flush=True)
    rows = read_csv(os.path.join(tmp, "sddmm_study.csv"))
    want = len(sddmm_study.PRECISIONS) * (
        len(occ) + sum(o["bm"] + "x" + o["bk"] != "128x128" for o in occ))
    if len(occ) != 8 or len(rows) != want:
        raise RuntimeError(f"the study wrote {len(occ)} points and "
                           f"{len(rows)} rows, not 8 and {want}")
    gated("phase 9 study", rows, 1e-4)
    pipe = read_csv(os.path.join(tmp, "pipeline.csv"))
    if len(pipe) != 6:
        raise RuntimeError(f"the study wrote {len(pipe)} pipeline rows")
    gated("phase 9 study pipeline", pipe, 1e-3)


def cli_mode_rows(tmp: str, args, want: dict, eps: float,
                  phase: str = "phase 9", extra=()) -> None:
    """The CLI's ``--sddmm`` or ``--pipeline`` (and ``extra`` arguments)
    with and without ``--xla-only``: one gated row each, of the kernel and
    fmt ``want`` says (a fmt prefix)."""
    from spgrid_torch.bench.cli import main as cli_main
    from spgrid_torch.scripts.sddmm_study import N
    for xla in (False, True):
        out = os.path.join(tmp, f"cli_{args[0][2:]}_{int(xla)}.csv")
        code = cli_main(args + list(extra) + [
            "--num-cols", str(N), "--out", out, "--platform", DEVICE]
            + (["--xla-only"] if xla else []))
        if code != 0:
            raise RuntimeError(f"the CLI exited {code} on {args} xla={xla}")
        rows = read_csv(out)
        kernel, fmt = want[xla]
        if (len(rows) != 1 or rows[0]["kernel"] != kernel
                or not rows[0]["fmt"].startswith(fmt)):
            got = [(r["kernel"], r["fmt"]) for r in rows]
            raise RuntimeError(f"the CLI wrote {got}, not one {kernel} "
                               f"{fmt} row")
        gated(f"{phase} cli {' '.join(args[:1])}"
              f"{' --xla-only' if xla else ''}", rows, eps)


def phase_sddmm() -> None:
    """Phase 9, SDDMM and the CLI's modes: the SDDMM study, then the CLI's
    ``--sddmm`` at 4096 and ``--pipeline`` on three DLMC twins written as
    .smtx, each with and without ``--xla-only``."""
    from spgrid_torch.io import write_smtx
    from spgrid_torch.scripts.sddmm_study import (
        LENGTH, PIPELINE_LENGTH, weight)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        study_lines(tmp)
        cli_mode_rows(tmp, ["--sddmm", str(LENGTH)],
                      {False: ("sddmm_cuda", "bsr_pallas_"),
                       True: ("sddmm_xla", "coo")}, 1e-4)
        paths = []
        for seed in (1, 2, 3):
            paths.append(os.path.join(tmp, f"w{seed}.smtx"))
            write_smtx(paths[-1], weight(PIPELINE_LENGTH, seed))
        cli_mode_rows(tmp, ["--pipeline", *paths, "--sparsity",
                            str(PIPELINE_SPARSITY)],
                      {False: ("pipeline_cuda", "bsr"),
                       True: ("pipeline_xla", "bsr")}, 1e-3)
    print(f"phase 9 sddmm: {time.perf_counter() - t0:.1f} s", flush=True)


# Phase 10: the JAX CLI's remaining SpMM formats at n = 512 (the torch-op
# formats on MAIN_LINE and LINE_B, the bf16 panel kernel on the headline
# twin and LINE_B, ldu on a symmetric pattern read from .mtx, each order
# of --reorder on LINE_B with bsr_cuda), timed for at least FORMATS_TIME_S
# (phase 11d's rows too)
TORCH_OPS = "ell,csc,cv_bf16,cv_int8,scoo,csr_xla_coo,ell_xla"
FORMATS_TIME_S = "0.1"
LDU_SIDE = 8192          # the symmetric matrix's side: LINE_B's
LDU_DENSITY = 0.006      # ~50 nnz a row, as LINE_B's
LOG10_SAMPLE = 1 << 22   # values phase 10 takes log10 of on both sides


def symmetric_matrix(m=None, density=LDU_DENSITY, seed=19):
    """m x m (default ``LDU_SIDE``) with a symmetric pattern and unequal
    values (entry (i, j) and (j, i) differ), a full diagonal: the LDU
    format's class."""
    from spgrid_torch.formats.csr import COOMatrix, coo_to_csr
    m = LDU_SIDE if m is None else m
    rng = np.random.default_rng(seed)
    draws = int(m * m * density)        # about half land above the diagonal
    i, j = rng.integers(0, m, draws), rng.integers(0, m, draws)
    keep = i < j
    i, j = i[keep], j[keep]
    rows = np.concatenate([i, j, np.arange(m)])
    cols = np.concatenate([j, i, np.arange(m)])
    vals = (rng.random(len(rows)) + 0.5).astype(np.float32)
    return coo_to_csr(COOMatrix(rows, cols, vals, (m, m), "symmetric"),
                      sum_duplicates=True)


def both_gates(label, csr, kernel) -> None:
    """One row of ``kernel`` on ``csr`` at n = 512, gated on the host and on
    the card: the metrics side by side; the run fails where they differ by
    more than ``device_oracle.disagreements``' bounds."""
    from spgrid_torch.bench import harness
    from spgrid_torch.core.config import BenchConfig
    from spgrid_torch.core.device_oracle import disagreements
    from spgrid_torch.ops import dispatch

    n = 512
    fmt = harness.KERNELS[kernel]
    x, xd = harness._cached_x(csr, n, "float32", BenchConfig.seed,
                              torch.device(DEVICE))
    test = dispatch.spmm_fn(fmt)(dispatch.build(csr, fmt, device=DEVICE), xd)
    gates, secs = {}, {}
    for site in ("host", "device"):
        t0 = time.perf_counter()
        gates[site] = harness.gate(csr, fmt, test, x, xd, BenchConfig(
            num_cols=n, oracle=site), DEVICE)
        torch.cuda.synchronize()
        secs[site] = time.perf_counter() - t0
    h, d = gates["host"], gates["device"]
    fields = ("mae", "max_ae", "mse", "mape", "smape", "lnQ_error", "mlare",
              "gmare", "max_rel_diff")
    side = " ".join(f"{f}={getattr(h, f)!r}/{getattr(d, f)!r}"
                    for f in fields)
    bad = disagreements(h, d)
    print(f"phase 10 gates: {label} {kernel} gate={harness.gold_class(fmt)} "
          f"host/device {side} passed={h.passed}/{d.passed} "
          f"host_s={secs['host']:.2f} device_s={secs['device']:.2f} "
          f"{'AGREE' if not bad else 'DIFFER ' + ','.join(bad)}",
          flush=True)
    if bad or not h.passed:
        raise RuntimeError(f"phase 10: {kernel} on {label}: the gates "
                           f"differ in {bad} or failed")


@contextlib.contextmanager
def env_set(name: str, value: str):
    """The environment variable ``name`` set to ``value`` inside the block,
    restored after it."""
    before = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if before is None:
            del os.environ[name]
        else:
            os.environ[name] = before


def rows_timed_for(seconds: str):
    """The CLI's rows timed for at least ``seconds`` (``SPGRID_MIN_TIME_S``)
    inside the block."""
    return env_set("SPGRID_MIN_TIME_S", seconds)


def phase_formats() -> None:
    """Phase 10, the remaining formats: the CLI at n = 512 on every format
    the JAX CLI names that earlier phases do not run, each row gated and
    printed with its gate class and site; then one row of each gate class
    (exact, gell16, cv_int8, cv_panel) gated on both sides."""
    from spgrid_torch.bench.headline import headline_matrix
    from spgrid_torch.io import write_mtx, write_smtx

    t0 = time.perf_counter()
    with rows_timed_for(FORMATS_TIME_S):
        with tempfile.TemporaryDirectory() as tmp:
            head = os.path.join(tmp, "dlmc_twin_512.smtx")
            write_smtx(head, headline_matrix())
            sym = os.path.join(tmp, f"symmetric_{LDU_SIDE}.mtx")
            write_mtx(sym, symmetric_matrix())
            cli_rows("phase 10 formats", (
                (MAIN_LINE, TORCH_OPS, "512"),
                (LINE_B, TORCH_OPS, "512"),
                (["--matrix", head], "cv_panel_cuda", "512"),
                (LINE_B, "cv_panel_cuda", "512"),
                (["--matrix", sym], "ldu", "512"),
                *((["--generate", LINE_B, "--reorder", order], "bsr_cuda",
                   "512") for order in ("rcm", "shuffle", "degsort"))))
    hyper, line_b = line_matrix(MAIN_LINE), line_matrix(LINE_B)
    for label, csr, kernel in (("MAIN_LINE", hyper, "coo"),
                               ("MAIN_LINE", hyper, "gell16"),
                               ("MAIN_LINE", hyper, "cv_int8"),
                               ("LINE_B", line_b, "cv_panel_cuda")):
        both_gates(label, csr, kernel)
    log10_line(hyper)
    print(f"phase 10 formats: {time.perf_counter() - t0:.1f} s", flush=True)


def log10_line(csr) -> None:
    """How often the card's f64 log10 and numpy's differ, on the values
    lnQ_error takes the log of: ``csr``'s gold at n = 512 (the exact class,
    ``LOG10_SAMPLE`` values) and those values rounded to f32."""
    from spgrid_torch.bench import harness
    from spgrid_torch.core.config import BenchConfig
    gold = harness._cached_device_oracle(csr, "coo", DEVICE).gold(
        harness._cached_x(csr, 512, "float32", BenchConfig.seed,
                          torch.device(DEVICE))[1])
    a = gold.reshape(-1)[:LOG10_SAMPLE].abs().clamp(min=1e-4)
    parts = []
    for name, v in (("gold", a), ("f32", a.float().double())):
        card = torch.log10(v).cpu().numpy()
        host = np.log10(v.cpu().numpy())
        parts.append(f"{name} {int((card != host).sum())} of {v.numel()}")
    print(f"phase 10 log10: card and numpy differ on {', '.join(parts)} "
          f"values (numpy {np.__version__})", flush=True)


# Phase 11: the dtype axis. The bf16 forms are held to their plain versions
# (f32 sums rounded once to bf16, on the same bf16 operands) within 1 bf16
# ulp of the plain value, 2^(e - 7) for a value in [2^e, 2^(e + 1)), where
# |plain| > BF16_FLOOR; below it within BF16_FLOOR absolutely (the operands
# are positive, so only empty rows' exact zeros lie there).
BF16_FLOOR = 1e-6
HEADLINE_LINE = "512 512 256 32 normal random 1.0 0 0.05 0.05 14"
DTYPE_SDDMM = (4096, 0.95, 512)   # mask side, sparsity, d of 11a's SDDMM
# the 3-pass form against its plain version (each pass summed exactly in
# f64): the tensor cores' truncating accumulate over a step of 64 bf16
# products, relative to the largest |value|
HIGH_TOL = 1e-6
# the leg's jobs run here (a comma list of tags; None: all twelve): the
# matrices that run each of the leg's kernels, the bf16 forms' included,
# and band_98k (1b's slowest against its library call); mid_16k_d2pct and
# dense_2k_d20pct, whose kernels the twin's rows repeat, are held by 11a
# (LEG_SHAPES) and left out here for the run's time
BF16_LEG_JOBS = "dlmc_twin_512_0.5,band_98k,scat_131k,wideband_196k"
# the leg's matrices on which 11a holds the forms the leg runs there (the
# twin is the headline case above)
LEG_SHAPES = (("mid_16k_d2pct", ("bsr", "panel")), ("band_98k", ("bsr",)),
              ("dense_2k_d20pct", ("bsr", "panel")),
              ("wideband_196k", ("bands",)))
# the redesigned forms (the bf16 row walk, the wsel-1 form a warp a piece;
# the 3-pass SDDMM on split planes and a TMA-fed tile; dgell's 16-byte bf16
# vector; the bf16 SDDMM's persistent TMA-fed tile; the bands' 16-byte bf16
# walk over L2-resident slabs): the device ms of the forms they replaced on
# their 11a cases, on an H100 80GB HBM3 at 700 W (PERF.md §6, rows 9b,
# 10b, 3c, 11b, 3b and 6b), printed beside this run's
BEFORE_DEVICE_MS = {("wrow_spmv_v2_bf16", "LINE_S n=1"): 0.031140,
                    ("wpack_spmv_bf16", "LINE_S n=1"): 0.030914,
                    ("wpack_spmv_bf16_prefix",
                     "headline 512^2 n=1 (wsel 1)"): 0.016672,
                    ("bsr_sddmm_bf16x3",
                     "{}^2 band_and_decay s={} d={} f32".format(
                         *DTYPE_SDDMM)): 0.257578,
                    ("dgell_bf16", "LINE_S n=512"): 0.625249,
                    ("bsr_sddmm_bf16",
                     "{}^2 band_and_random s={} d={}".format(
                         *DTYPE_SDDMM)): 0.083276,
                    ("wcoo_spmm_aligned_bf16",
                     "bf16 leg wideband_196k n=512"): 0.345944,
                    ("wcoo_spmm_aligned_bf16", "MAIN_LINE n=512"): 0.088678}
# 11b's slab sweep on its 11a case (LINE_S, n = 512): each slab in the
# 16-byte and the 8-byte vector form
DGELL_SWEEP = (64, 128, 256, 512)
# 6b's slab sweep on its 11a cases (MAIN_LINE and the leg's wideband_196k,
# n = 512): each slab in the 16-byte and the 8-byte form
BANDS_SWEEP = (64, 128, 256, 512)
# the row walks' other ranges of live slots a CTA in 11a (the rule's is
# 2,048 on LINE_S)
SPMV_RANGES = (1024, 4096)
# the JAX package's f64 sweep's rows (its CPU run), which 11c must match
JAX_F64_CSV = "benchmark_results/cpu-f64/f64_correctness.csv"


def bf16_compare(out: torch.Tensor, ref: torch.Tensor):
    """(largest difference in ulps of ref where |ref| > BF16_FLOOR, largest
    |difference|, whether both bounds hold and out is finite)."""
    o, r = out.double(), ref.double()
    diff = (o - r).abs()
    big = r.abs() > BF16_FLOOR
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(BF16_FLOOR)))
                     - 7)
    ulps = torch.where(big, diff / ulp, torch.zeros_like(diff)).max().item()
    ok = (bool(torch.isfinite(o).all()) and ulps <= 1.0
          and bool((diff[~big] <= BF16_FLOOR).all()))
    return ulps, diff.max().item(), ok


def ptxas_report(kernel: str) -> str:
    """ptxas's registers and spills (the build's nvcc.log) for the first
    kernel whose mangled name holds ``kernel``."""
    from spgrid_torch.ops.kernels import _build
    log = _build.build_dir() / "nvcc.log"
    if not log.exists():
        return "not built"
    found, report = False, []
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            if found:
                break
            found = kernel in line
        elif found and ("registers" in line or "spill" in line):
            report.append(line.split(":", 1)[-1].strip())
    return "; ".join(report) or f"no entry {kernel}"


def misaligned2(t: torch.Tensor) -> torch.Tensor:
    """A copy of bf16 ``t`` whose data lies 2 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def offset8(t: torch.Tensor) -> torch.Tensor:
    """A copy of bf16 ``t`` whose data lies 8 bytes past a 16-byte
    boundary (the allocator's blocks start on 512 bytes)."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = buf[4:4 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def library_on(fn, bf16_args, f32_args):
    """(args, which): the library call's operands in bf16 where the card's
    torch takes them, else its f32 form on the bf16 values."""
    try:
        fn(*bf16_args)
        torch.cuda.synchronize()
        return bf16_args, "bf16"
    except (RuntimeError, NotImplementedError, TypeError) as e:
        torch.cuda.synchronize()
        return f32_args, f"f32 form on the bf16 values ({str(e)[:60]})"


def phase_dtype_kernels() -> dict:
    """Phase 11a: the bf16 forms and the 3-pass SDDMM form against their
    plain versions on the card, on the same inputs (``bsr_spmm_bf16`` and
    ``panel_spmm_bf16_xy`` on the headline twin and LINE_B at n = 512,
    ``bsr_sddmm_bf16`` on a 4096^2 band_and_random mask at sparsity 0.95,
    d = 512, ``wcoo_spmm_aligned_bf16`` on MAIN_LINE at n = 512; the last
    forms as the module says; and each form on the bf16 leg's matrices it
    runs on in 11b, ``LEG_SHAPES``; the SpMV forms at n = 1 as the module
    says), each within 1 ulp (the 3-pass form within ``HIGH_TOL``; bit for
    bit on the rows a form sums in its plain version's order) and the same
    bits on two calls, with its device ms by graph replay (eager in
    brackets), the plain version's ms, the library call's
    (``torch.sparse.mm``, ``torch.sparse.sampled_addmm``; bf16 where the
    card's torch takes it, f32 for dgell's f32 values and the 3-pass form)
    and its bound: the nnz's values and indices, the dense operands and the
    output, each once in its type, or 2 flops a nnz a column (three times
    that for the 3-pass form) at 989 TFLOP/s. 1b's cases print its route
    split and are held again under each forced route; then the route sweep
    (``route_sweep``). Runs before the paths' counts are reset: these
    launches are not the main path's. Returns, per form, the
    numbers of its main-path case (the twin for A and B, the leg's
    ``wideband_196k`` for D)."""
    from spgrid_torch.bench.harness import make_x, x_tensor
    from spgrid_torch.core.timing import time_kernel
    from spgrid_torch.gen import create_mask
    from spgrid_torch.ops.kernels.bsr_spmm import bsr_spmm, bsr_spmm_plain
    from spgrid_torch.ops.kernels.bsr_spmm import launch as bsr_launch
    from spgrid_torch.ops.kernels.bsr_spmm import launch_grid as bsr_grid
    from spgrid_torch.ops.kernels.panel_spmm import (
        DevicePanels, panel_spmm, panel_spmm_plain)
    from spgrid_torch.ops.kernels.panel_spmm import launch_grid as panel_grid
    from spgrid_torch.ops.kernels.bsr_spmm_cstat import (
        DeviceBSRCol, bsr_spmm_cstat, bsr_spmm_cstat_plain)
    from spgrid_torch.ops.kernels.bsr_spmm_cstat import (
        launch_grid as bsrc_grid)
    from spgrid_torch.ops.kernels.dgell import (
        DeviceDGELL, dgell_rows_plain, dgell_spmm)
    from spgrid_torch.ops.kernels.dgell import launch as dgell_launch
    from spgrid_torch.ops.kernels.dgell import launch_plan as dgell_plan
    from spgrid_torch.ops.kernels.dgell import launch_shape as dgell_shape
    from spgrid_torch.ops.kernels.sddmm import (
        bf16_shape, bsr_sddmm, bsr_sddmm_bf16x3_plain, bsr_sddmm_plain,
        split_launch, split_planes, split_planes_plain, x3_shape)
    from spgrid_torch.ops.kernels.sddmm import (
        copy_launch as sddmm_copy_launch)
    from spgrid_torch.ops.kernels.wcoo_spmm import (
        DeviceWCOO, wcoo_spmm, wcoo_spmm_plain)
    from spgrid_torch.ops.kernels.wcoo_spmm_aligned import (
        DeviceWCOOBands, wcoo_spmm_aligned, wcoo_spmm_aligned_plain)
    from spgrid_torch.ops.kernels.wcoo_spmm_aligned import (
        launch as bands_launch)
    from spgrid_torch.ops.kernels.wcoo_spmm_aligned import (
        launch_shape as bands_shape)
    from spgrid_torch.ops.kernels.wcoo_spmv import (
        DeviceWCOOAligned, wcoo_spmv, wcoo_spmv_plain)
    from spgrid_torch.ops.kernels.slot_stream import default_slots_per_cta
    from spgrid_torch.ops.kernels.wpack_spmv import (
        GROUPS_PER_CTA, DeviceWPACK, launch_prefix_bf16,
        prefix_groups_per_cta, wpack_spmv, wpack_spmv_plain)
    from spgrid_torch.ops.kernels.wrow_spmv import (
        DeviceWROW, wrow_spmv, wrow_spmv_plain, wrow_spmv_v2)
    from spgrid_torch.ops.layouts import (
        DeviceBSR, block_entries, bsr_arrays)
    from spgrid_torch.scripts.run_bf16_leg import JOBS as LEG_JOBS
    from spgrid_torch.scripts.run_bf16_leg import job_matrix

    def ms(fn, *args):
        return time_kernel(fn, *args, device=DEVICE, warmup_iters=5,
                           min_time_s=TIME_S, min_iters=20
                           ).time_per_iter_s * 1e3

    def xb(k, n, seed):
        return x_tensor(make_x(k, n, "bfloat16", seed), "bfloat16", DEVICE)

    def spmm_case(kind, csr, n, seed):
        x = xb(csr.k, n, seed)
        value = 2       # bytes a value: bf16, but dgell's f32 values
        exact = None
        variants = ()
        lib_f32 = (csr_tensor(csr), x.float())
        if kind == "bsrc":
            a = DeviceBSRCol.from_csr(csr, device=DEVICE)
            fn, plain = bsr_spmm_cstat, bsr_spmm_cstat_plain
            note = (f"R={a.band_rows} bands={a.bands} max_nb={a.max_nb} "
                    f"launch (CTAs, cols, rows)={bsrc_grid(a, n)}")
            index = 4
        elif kind == "wcoo":
            a = DeviceWCOO.from_csr(csr, device=DEVICE)
            fn, plain = wcoo_spmm, wcoo_spmm_plain
            note = (f"live_slots={a.num_slots} "
                    f"long_rows={len(a.long_rows)}")
            index = 4
        elif kind == "dgell":
            a = DeviceDGELL.from_csr(csr, device=DEVICE)
            # the plain version in the kernel's order: its FMA chain's bits
            fn, plain = dgell_spmm, dgell_rows_plain
            exact = torch.ones(csr.m, dtype=torch.bool, device=DEVICE)
            shape = dgell_shape(csr.k, n, vec=2, dtype=torch.bfloat16)
            per_lane = -(-shape.slab // 8) // shape.lanes or 1
            u = dgell_plan(csr.k, n, l2_bytes, 8)[1]
            note = (f"slots={a.slots} tail={a.tail_rows.numel()} {shape} "
                    f"U={u} ptxas=[" + ptxas_report(
                        f"dgell_kernelILi{shape.lanes}ELi{per_lane}ELi8E")
                    + "] " + dgell_sweep(a, x))
            value, index = 4, 4
        elif kind == "bsr":
            # the host arrays once; the layout under the chosen route, then
            # under each forced route (held and timed as variants)
            t0 = time.perf_counter()
            arrays = bsr_arrays(csr, 128, 128)
            entries = block_entries(csr, arrays[0], arrays[1], 128, 128)
            a = DeviceBSR.from_arrays(*arrays[:4], csr.shape, csr.nnz,
                                      arrays[4], device=DEVICE,
                                      dtype="bfloat16", entries=entries)
            build_s = time.perf_counter() - t0
            fn, plain = bsr_spmm, bsr_spmm_plain
            grid = bsr_grid(a, n)
            note = f"{grid} {a.route} layout_build_s={build_s:.3f}"
            if 0 < grid.tiles <= 256:
                # the tile at each cluster size (the rule's PT_SHARE)
                y = torch.empty((csr.m, n), dtype=x.dtype, device=DEVICE)
                note += " device_ms_by_cluster " + " ".join(
                    f"{c}:{device_ms(bsr_launch, a, x, y, c):.6f}"
                    for c in (1, 2, 4, 8))
            variants = []
            for mode in ("tile", "entry"):
                forced = rerouted(a, arrays, entries, mode)
                variants.append((f"route={mode} forced", fn, (forced, x),
                                 str(forced.route)))
            index = 4
        elif kind == "panel":
            a = DevicePanels.from_csr(csr, bk=128, device=DEVICE)
            fn, plain = panel_spmm, panel_spmm_plain
            note = (f"R={a.band_rows} bands={a.bands} "
                    f"{panel_grid(a, n, x.dtype)} "
                    f"live (panel, slice) pairs {int(a.slice_ptr[-1])}")
            index = 4
        else:
            a = DeviceWCOOBands.from_csr(csr, device=DEVICE)
            fn, plain = wcoo_spmm_aligned, wcoo_spmm_aligned_plain
            # the plain version sums as the walk does: its bits, every row
            exact = torch.ones(csr.m, dtype=torch.bool, device=DEVICE)
            rule = bands_shape(n, 2)
            note = (f"live_slots={a.num_slots} long_rows={len(a.long_rows)} "
                    f"rule={rule} ptxas=[" + ptxas_report(
                        f"walk16ILi{rule.lanes}ELi"
                        f"{max(1, -(-rule.slab // 8) // rule.lanes)}E")
                    + "] " + bands_sweep(a, x))
            index = a.cols.element_size()
        if kind == "dgell":   # the values are f32: the f32 product
            lib, which = lib_f32, "f32 values, X widened"
        else:
            lib, which = library_on(
                torch.sparse.mm, (csr_tensor(csr, torch.bfloat16), x),
                lib_f32)
        return (fn, plain, (a, x), torch.sparse.mm, lib, which,
                csr.nnz * (value + index) + 2 * (csr.k + csr.m) * n,
                2.0 * csr.nnz * n, note, exact, variants)

    def sddmm_case():
        length, sparsity, d = DTYPE_SDDMM
        mask = create_mask("band_and_random", length, sparsity, seed=14,
                           dtype="bfloat16")
        a = DeviceBSR.from_csr(mask, bm=128, bk=128, device=DEVICE)
        q, k = xb(length, d, 41), xb(length, d, 42)
        lib, which = library_on(
            lambda s, q_, kt: torch.sparse.sampled_addmm(s, q_, kt,
                                                         beta=0.0),
            (csr_tensor(mask, torch.bfloat16), q, k.t().contiguous()),
            (csr_tensor(mask), q.float(), k.float().t().contiguous()))
        shape, _ = bf16_shape(a, q, k)
        nb, bm, bk = a.blocks.shape
        # the dense blocks' floor: the bf16 mask blocks in and out, Q and K
        # once; and their dense work at 989 TFLOP/s
        dense_ms = (2 * 2 * nb * bm * bk + 2 * 2 * length * d) / (
            HBM_BYTES_PER_S) * 1e3
        work_ms = 2.0 * a.num_blocks * bm * bk * d / BF16_FLOPS_PER_S * 1e3
        # Q and K 2 bytes off 16: the copy pass writes them padded into
        # scratch before the tile, timed alone too
        qo, ko = misaligned2(q), misaligned2(k)
        _, copy_bytes = bf16_shape(a, qo, ko)
        scratch = torch.empty(copy_bytes, dtype=torch.uint8, device=DEVICE)
        copy_ms = device_ms(sddmm_copy_launch, qo, ko, scratch)
        walk = (f"persistent walk: {shape.ctas} CTAs, one an SM"
                if shape.persistent else
                f"a cluster of {shape.cluster} a tile")
        note = (f"{shape} ({walk}) tile=128x128 stages={shape.stages} "
                f"ptxas=[{ptxas_report('bsr_sddmm_bf16_kernel')}] "
                f"copy_pass=none (TMA reads Q and K as they lie) "
                f"dense_block_floor_ms={dense_ms:.6f} "
                f"dense_work_floor_ms={work_ms:.6f} "
                f"blocks={a.num_blocks} nnz={mask.nnz}")
        variants = [("Q and K 2 bytes off 16 (the copy pass)", bsr_sddmm,
                     (a, qo, ko), f"copy_pass_bytes={copy_bytes} "
                     f"copy_pass_device_ms={copy_ms:.6f}")]
        return (bsr_sddmm, bsr_sddmm_plain, (a, q, k),
                lambda s, q_, kt: torch.sparse.sampled_addmm(s, q_, kt,
                                                             beta=0.0),
                lib, which, mask.nnz * (2 + 4) + 2 * 2 * length * d,
                2.0 * mask.nnz * d, note, None, variants)

    def dgell_sweep(a, x):
        """11b at each slab of DGELL_SWEEP in its 16-byte form (X and Y on
        16 bytes) and its 8-byte form (copies of them 8 bytes off): device
        ms, each held bit for bit against the row-order plain version into
        a Y filled with NaN, the same bits twice."""
        ref = dgell_rows_plain(a, x)
        points = []
        for form, xf in (("16B", x), ("8B", offset8(x))):
            y = torch.empty((a.shape[0], x.shape[1]), dtype=x.dtype,
                            device=DEVICE)
            y = y if form == "16B" else offset8(y)
            again = torch.full_like(y, float("nan"))
            for c in DGELL_SWEEP:
                y.fill_(float("nan"))
                again.fill_(float("nan"))
                dgell_launch(a, xf, y, c)
                dgell_launch(a, xf, again, c)
                torch.cuda.synchronize()
                ok = torch.equal(y, ref) and torch.equal(y, again)
                points.append(f"{form}:{c}:"
                              f"{device_ms(dgell_launch, a, xf, y, c):.6f}"
                              f":{'bits' if ok else 'FAIL'}")
                if not ok:
                    failed.append(f"dgell_bf16 [{form} slab {c}]")
        return "device_ms_by_form_slab " + " ".join(points)

    def bands_sweep(a, x):
        """6b at each slab of BANDS_SWEEP in its 16-byte form (X and Y on
        16 bytes) and its 8-byte form (copies 8 bytes off): device ms, each
        held bit for bit against the plain version (which sums as the walk
        does) into a Y filled with NaN, the same bits twice."""
        ref = wcoo_spmm_aligned_plain(a, x)
        points = []
        for form, xf in (("16B", x), ("8B", offset8(x))):
            y = torch.empty((a.shape[0], x.shape[1]), dtype=x.dtype,
                            device=DEVICE)
            y = y if form == "16B" else offset8(y)
            again = torch.full_like(y, float("nan"))
            for c in BANDS_SWEEP:
                y.fill_(float("nan"))
                again.fill_(float("nan"))
                bands_launch(a, xf, y, c)
                bands_launch(a, xf, again, c)
                torch.cuda.synchronize()
                ok = torch.equal(y, ref) and torch.equal(y, again)
                points.append(f"{form}:{c}:"
                              f"{device_ms(bands_launch, a, xf, y, c):.6f}"
                              f":{'bits' if ok else 'FAIL'}")
                if not ok:
                    failed.append(f"wcoo_spmm_aligned_bf16 [{form} slab "
                                  f"{c}]")
        return "device_ms_by_form_slab " + " ".join(points)

    def sddmm_high_case():
        """The 3-pass form on f32 operands: a band_and_decay mask, as the
        f32 form's phase-1 case, at DTYPE_SDDMM's shape; its split pass
        alone too (its planes held element for element against the plain
        split), and the tile's registers. Bound: the f32 mask's values in
        and out and their indices, Q and K once, or three bf16 passes at
        989 TFLOP/s."""
        length, sparsity, d = DTYPE_SDDMM
        mask = create_mask("band_and_decay", length, sparsity, seed=14)
        a = DeviceBSR.from_csr(mask, bm=128, bk=128, device=DEVICE)
        q = x_tensor(make_x(length, d, "float32", 51), "float32", DEVICE)
        k = x_tensor(make_x(length, d, "float32", 52), "float32", DEVICE)
        library = (lambda s_, q_, kt: torch.sparse.sampled_addmm(
            s_, q_, kt, beta=0.0))
        kernel = functools.partial(bsr_sddmm, precision="high")
        shape, scratch_bytes = x3_shape(a, length, length, d)
        scratch = torch.empty(scratch_bytes, dtype=torch.uint8,
                              device=DEVICE)
        split_launch(q, k, scratch)
        planes_equal = all(
            torch.equal(got, want) for got, want in zip(
                split_planes(scratch, length, length, d),
                split_planes_plain(q, k)))
        if not planes_equal:
            failed.append("bsr_sddmm_bf16x3 [split planes]")
        split_ms = device_ms(split_launch, q, k, scratch)
        whole_ms = device_ms(kernel, a, q, k)
        return (kernel, bsr_sddmm_bf16x3_plain, (a, q, k), library,
                (csr_tensor(mask), q, k.t().contiguous()), "f32",
                mask.nnz * (4 + 4 + 4) + 2 * 4 * length * d,
                3 * 2.0 * mask.nnz * d,
                f"{shape} blocks={a.num_blocks} nnz={mask.nnz} "
                f"scratch_bytes={scratch_bytes} split_planes_equal="
                f"{planes_equal} split_device_ms={split_ms:.6f} (share "
                f"{split_ms / whole_ms:.3f} of {whole_ms:.6f}) tile_ptxas=["
                f"{ptxas_report('bsr_sddmm_bf16x3_kernel')}]", None)

    def spmv_case(kind, csr, seed):
        """A bf16 SpMV form's case: its layout, x (k,), what the form must
        read of the layout (its stream; at wsel 1 each piece's live lanes,
        starts and ends) beside x and y, the rows on which it sums
        in its plain version's order and must give its bits (None: none),
        and the form at its knobs' other values (the row walks at
        ``SPMV_RANGES``, the wsel-1 form at every count of groups a
        CTA)."""
        x = xb(csr.k, 1, seed)[:, 0].contiguous()
        t0 = time.perf_counter()
        exact = None
        variants = []
        if kind == "wcoo":
            a = DeviceWCOOAligned.from_csr(csr, device=DEVICE)
            fn, plain = wcoo_spmv, wcoo_spmv_plain
            read = a.stream_nbytes + nbytes(a.tile_row)
            # every row but those longer than a tile (a tree of partials)
            exact = torch.diff(a.row_slot.long()) <= a.tile_slots
            note = f"tiles={a.tiles} groups={a.num_groups}"
        elif kind == "wpack":
            a = DeviceWPACK.from_csr(csr, device=DEVICE)
            fn, plain = wpack_spmv, wpack_spmv_plain
            if a.wsel == 1:
                lanes = a.piece_lanes.long()
                read = (int(lanes.sum()) * 3 + int((lanes > 0).sum()) * 256
                        + nbytes(a.piece_lanes, a.piece_w, a.block_ptr))
                rule = prefix_groups_per_cta(a.num_groups, sms)
                note = f"wsel=1 groups={a.num_groups} groups_per_cta={rule}"
                variants = [(f"groups_per_cta={g}", prefix_at(g), (a, x), "")
                            for g in GROUPS_PER_CTA]
            else:
                read = a.row_nbytes
                note = (f"wsel={a.wsel} groups={a.num_groups} slots_per_cta="
                        f"{default_slots_per_cta(a.num_slots, sms)}")
                variants = [(f"slots_per_cta={r}", functools.partial(
                    wpack_spmv, slots_per_cta=r), (a, x), "")
                    for r in SPMV_RANGES]
        else:
            a = DeviceWROW.from_csr(csr, device=DEVICE)
            variant = "v2" if kind == "wrow_v2" else "v1"
            fn = functools.partial(wrow_spmv, variant=variant)
            plain = functools.partial(wrow_spmv_plain, variant=variant)
            # both read the row stream (v2 without its group marks)
            read = a.row_nbytes
            note = f"groups={a.num_groups}"
            if variant == "v1":
                note += f" group_starts={int((a.row_cols < 0).sum())}"
                exact = torch.ones(csr.m, dtype=torch.bool, device=DEVICE)
            else:
                note += (f" slots_per_cta="
                         f"{default_slots_per_cta(a.num_slots, sms)}")
                variants = [(f"slots_per_cta={r}", functools.partial(
                    wrow_spmv_v2, slots_per_cta=r), (a, x), "")
                    for r in SPMV_RANGES]
        note += (f" live_slots={a.num_slots} read_bytes={read} "
                 f"layout_build_s={time.perf_counter() - t0:.3f}")
        lib, which = library_on(
            torch.sparse.mm, (csr_tensor(csr, torch.bfloat16), x[:, None]),
            (csr_tensor(csr), x.float()[:, None]))
        return (fn, plain, (a, x), torch.sparse.mm, lib, which,
                read + 2 * (csr.k + csr.m), 2.0 * csr.nnz, note, exact,
                variants)

    def prefix_at(groups_per_cta):
        """The wsel-1 form at ``groups_per_cta`` groups a CTA, uncounted."""
        def call(a, x):
            y = torch.empty((a.shape[0],), dtype=torch.bfloat16,
                            device=x.device)
            launch_prefix_bf16(a, x, y, groups_per_cta)
            return y
        return call

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    l2_bytes = torch.cuda.get_device_properties(0).L2_cache_size
    failed = []
    head = line_matrix(HEADLINE_LINE).astype("bfloat16")
    line_b = line_matrix(LINE_B).astype("bfloat16")
    hyper = line_matrix(MAIN_LINE).astype("bfloat16")
    scattered = line_matrix(LINE_S).astype("bfloat16")
    leg = {tag: p for tag, p, _ in LEG_JOBS}
    cases = [
        ("bsr_spmm_bf16", "headline 512^2 n=512", True,
         lambda: spmm_case("bsr", head, 512, 43)),
        ("bsr_spmm_bf16", "LINE_B n=512", False,
         lambda: spmm_case("bsr", line_b, 512, 44)),
        ("panel_spmm_bf16_xy", "headline 512^2 n=512", True,
         lambda: spmm_case("panel", head, 512, 43)),
        ("panel_spmm_bf16_xy", "LINE_B n=512", False,
         lambda: spmm_case("panel", line_b, 512, 44)),
        ("bsr_sddmm_bf16", "{}^2 band_and_random s={} d={}".format(
            *DTYPE_SDDMM), True, sddmm_case),
        ("wcoo_spmm_aligned_bf16", "MAIN_LINE n=512", False,
         lambda: spmm_case("bands", hyper, 512, 45)),
        # the last forms (11d's and phase 9's rows): the 3-pass SDDMM on
        # f32 operands, and the bf16 forms of rows 4, 5 and 11
        ("bsr_sddmm_bf16x3", "{}^2 band_and_decay s={} d={} f32".format(
            *DTYPE_SDDMM), True, sddmm_high_case),
        ("bsr_spmm_cstat_bf16", "LINE_B n=512", True,
         lambda: spmm_case("bsrc", line_b, 512, 44)),
        ("wcoo_spmm_bf16", "MAIN_LINE n=512", True,
         lambda: spmm_case("wcoo", hyper, 512, 45)),
        ("dgell_bf16", "LINE_S n=512", True,
         lambda: spmm_case("dgell", scattered, 512, 48)),
        # the SpMV path at bf16 (11d's rows): MAIN_LINE and LINE_S, and the
        # twin, which WPACK packs at wsel 1
        ("wrow_spmv_bf16", "MAIN_LINE n=1", True,
         lambda: spmv_case("wrow", hyper, 47)),
        ("wcoo_spmv_bf16", "MAIN_LINE n=1", True,
         lambda: spmv_case("wcoo", hyper, 47)),
        ("wrow_spmv_bf16", "LINE_S n=1", False,
         lambda: spmv_case("wrow", scattered, 48)),
        ("wrow_spmv_v2_bf16", "LINE_S n=1", True,
         lambda: spmv_case("wrow_v2", scattered, 48)),
        ("wpack_spmv_bf16", "LINE_S n=1", True,
         lambda: spmv_case("wpack", scattered, 48)),
        ("wpack_spmv_bf16_prefix", "headline 512^2 n=1 (wsel 1)", True,
         lambda: spmv_case("wpack", head, 49)),
    ]
    # the bf16 leg's own matrices (11b), at the shapes it gives each form
    for tag, kinds in LEG_SHAPES:
        for kind in kinds:
            cases.append((
                {"bsr": "bsr_spmm_bf16", "panel": "panel_spmm_bf16_xy",
                 "bands": "wcoo_spmm_aligned_bf16"}[kind],
                f"bf16 leg {tag} n=512", kind == "bands",
                lambda tag=tag, kind=kind: spmm_case(
                    kind, job_matrix(tag, leg[tag]).astype("bfloat16"), 512,
                    46)))
    main_path = {}
    for name, label, on_path, make in cases:
        made = make()
        (kernel, plain, args, library, lib_args, which, bytes_moved, flops,
         note, exact) = made[:10]
        variants = made[10] if len(made) > 10 else ()
        out = kernel(*args)
        again = kernel(*args)
        torch.cuda.synchronize()
        same = torch.equal(out, again)
        ref = plain(*args)
        if out.dtype == torch.float32:
            # the 3-pass form: within HIGH_TOL of its plain version's f32
            err = (out - ref).abs().max().item()
            rel = err / max(ref.abs().max().item(), 1e-30)
            ok = bool(torch.isfinite(out).all()) and rel <= HIGH_TOL
            tol = f"max_rel={rel:.3e} (tol {HIGH_TOL:g} of max |plain|)"
        else:
            ulps, err, ok = bf16_compare(out, ref)
            ok = ok and out.dtype == torch.bfloat16
            tol = (f"max_ulps={ulps:.3f} (tol 1 ulp; {BF16_FLOOR:g} "
                   f"absolute below it)")
        ok = ok and same
        if exact is not None:
            # rows summed in the plain version's order: its bits
            same_rows = (out[exact] == ref[exact]).reshape(
                int(exact.sum()), -1).all(dim=1)
            equal = int(same_rows.sum())
            note += f" bit_equal_rows={equal}/{int(exact.sum())}"
            ok = ok and equal == int(exact.sum())
        dev_ms, k_ms, p_ms = (device_ms(kernel, *args), ms(kernel, *args),
                              ms(plain, *args))
        lib_ms = ms(library, *lib_args)
        lib_dev = library_device_ms(library, *lib_args)
        b_ms, b_by = bound(bytes_moved, flops, BF16_FLOPS_PER_S)
        if (name, label) in BEFORE_DEVICE_MS:
            note += (f" before_device_ms="
                     f"{BEFORE_DEVICE_MS[name, label]:.6f}")
        print(f"phase 11 kernels: {name} [{label}] {tol} "
              f"max_abs={err:.3e} same_bits_twice={same} "
              f"device_ms={dev_ms:.6f} (eager {k_ms:.6f}) "
              f"plain_ms={p_ms:.6f} library_ms={lib_ms:.6f} "
              f"library_device_ms={show_ms(lib_dev)} (library {which}) "
              f"bound_ms={b_ms:.6f} ({b_by}) {note} "
              f"{'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(f"{name} [{label}]")
        for tag, v_fn, v_args, v_note in variants:
            # the same function on another layout of the same matrix (1b
            # under a forced route) or at another split of its work (the
            # SpMV forms' knobs): 1 ulp of the plain version, the same bits
            # twice
            v_out, v_again = v_fn(*v_args), v_fn(*v_args)
            torch.cuda.synchronize()
            v_ulps, v_err, v_ok = bf16_compare(v_out, plain(*v_args))
            v_ok = v_ok and torch.equal(v_out, v_again)
            print(f"phase 11 kernels: {name} [{label}] {tag} "
                  f"max_ulps={v_ulps:.3f} max_abs={v_err:.3e} "
                  f"same_bits_twice={torch.equal(v_out, v_again)} "
                  f"device_ms={device_ms(v_fn, *v_args):.6f} "
                  f"{v_note} {'PASS' if v_ok else 'FAIL'}",
                  flush=True)
            if not v_ok:
                failed.append(f"{name} [{label}] {tag}")
            del v_out, v_again, v_args
        if on_path:
            main_path[name] = {"max_abs_err": err, "ms": k_ms,
                               "plain_ms": p_ms, "bound_ms": b_ms,
                               "bound_by": b_by, "library_ms": lib_ms}
        del out, again, args, lib_args, variants
    failed += route_sweep()
    if failed:
        raise RuntimeError(f"bf16 form disagrees with its plain version: "
                           f"{failed}")
    return main_path


# 11a's sweep of 1b's two routes: one ROUTE_SWEEP_SIDE^2 matrix at each
# count of entries a 128^2 block (every block present, uniform random
# entries), n = 512; ENTRY_ROUTE_MAX in csrc/bsr_spmm.cu comes from it
ROUTE_SWEEP_SIDE = 8192
ROUTE_SWEEP = (8, 32, 64, 128, 192, 224, 256, 512)


def rerouted(a, arrays, entries, route: str):
    """The bf16 layout ``a`` (built from the host ``arrays`` of
    ``bsr_arrays``, ``entries`` its nonzeros) under another route, on the
    same device blocks: 1b's forced routes, for the A/B."""
    from spgrid_torch.ops.layouts import route_blocks
    return dataclasses.replace(a, route=route_blocks(
        arrays[0], arrays[1], arrays[3], a.mb, a.shape, route,
        device=a.blocks.device, dtype="bfloat16", entries=entries))


def sweep_matrix(side: int, per_block: int, seed: int):
    """A side^2 bf16 matrix of about ``per_block`` entries in each 128^2
    block, uniform random, values in [0.5, 1.5)."""
    from spgrid_torch.formats.csr import COOMatrix, coo_to_csr
    rng = np.random.default_rng(seed)
    flat = np.unique(rng.integers(0, side * side,
                                  side * side * per_block // (128 * 128)))
    vals = (rng.random(len(flat)) + 0.5).astype(np.float32)
    return coo_to_csr(COOMatrix(flat // side, flat % side, vals,
                                (side, side), f"sweep_{per_block}"),
                      sum_duplicates=False).astype("bfloat16")


def route_sweep() -> list:
    """Phase 11a's route sweep: ``bsr_spmm_bf16`` on ``sweep_matrix`` at
    each ``ROUTE_SWEEP`` count, n = 512, both routes forced, each held to
    the plain version (1 ulp) and timed (device ms by graph replay), with
    the route the threshold picks. Returns the points that failed."""
    from spgrid_torch.bench.harness import make_x, x_tensor
    from spgrid_torch.ops.kernels.bsr_spmm import bsr_spmm, bsr_spmm_plain
    from spgrid_torch.ops.layouts import (
        ENTRY_ROUTE_MAX, DeviceBSR, block_entries, bsr_arrays)
    x = x_tensor(make_x(ROUTE_SWEEP_SIDE, 512, "bfloat16", 53), "bfloat16",
                 DEVICE)
    failed = []
    for per_block in ROUTE_SWEEP:
        csr = sweep_matrix(ROUTE_SWEEP_SIDE, per_block, 54)
        arrays = bsr_arrays(csr, 128, 128)
        entries = block_entries(csr, arrays[0], arrays[1], 128, 128)
        auto = DeviceBSR.from_arrays(*arrays[:4], csr.shape, csr.nnz,
                                     arrays[4], device=DEVICE,
                                     dtype="bfloat16", entries=entries)
        times, oks = {}, []
        for route in ("entry", "tile", "auto"):
            a = rerouted(auto, arrays, entries, route)
            out = bsr_spmm(a, x)
            _, _, ok = bf16_compare(out, bsr_spmm_plain(a, x))
            oks.append(ok)
            times[route] = device_ms(bsr_spmm, a, x)
            chosen = a.route
        ok = all(oks)
        print(f"phase 11 route sweep: {ROUTE_SWEEP_SIDE}^2 n=512 "
              f"entries_a_block={csr.nnz / (ROUTE_SWEEP_SIDE / 128) ** 2:.1f}"
              f" nnz={csr.nnz} entry_ms={times['entry']:.6f} "
              f"tile_ms={times['tile']:.6f} auto_ms={times['auto']:.6f} "
              f"(threshold {ENTRY_ROUTE_MAX}: {chosen}) "
              f"{'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(f"route sweep {per_block}")
    return failed


def phase_dtype_legs() -> None:
    """Phase 11b and 11c: the bf16 leg (``run_bf16_leg``: ``BF16_LEG_JOBS``
    at full width, n = 512, every row gated at 3e-2, then its pipeline row)
    and the f64 sweep (``run_f64_sweep`` on the card, each row gated at
    1e-10 on the host: the rows of the JAX package's sweep, ``JAX_F64_CSV``,
    whose ELL layout refuses the skewed matrix as the port's does), with
    each part's seconds."""
    from spgrid_torch.scripts import run_bf16_leg, run_f64_sweep
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = os.path.join(tmp, "bf16_leg.csv")
        jobs = ([] if BF16_LEG_JOBS is None else ["--jobs", BF16_LEG_JOBS])
        code = run_bf16_leg.main(["--out", out, "--platform", DEVICE] + jobs)
        rows = read_csv(out)
        gated("phase 11 bf16 leg", rows, 3e-2)
        tags = (BF16_LEG_JOBS.split(",") if BF16_LEG_JOBS
                else [tag for tag, _, _ in run_bf16_leg.JOBS])
        want = 1 + sum(len(k) for tag, _, k in run_bf16_leg.JOBS
                       if tag in tags)
        if code != 0 or len(rows) != want:
            raise RuntimeError(f"run_bf16_leg exited {code} with {len(rows)} "
                               f"rows, not {want}")
        print(f"phase 11 bf16 leg: {len(rows)} rows, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        out = os.path.join(tmp, "f64.csv")
        code = run_f64_sweep.main(["--out", out, "--platform", DEVICE])
        rows = read_csv(out)
        gated("phase 11 f64 sweep", rows, 1e-10)
        want = {(r["matrix_name"], r["kernel"]) for r in read_csv(
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         JAX_F64_CSV))}
        got = {(r["matrix_name"], r["kernel"]) for r in rows}
        if code != 0 or got != want:
            raise RuntimeError(f"run_f64_sweep exited {code}; rows not the "
                               f"JAX sweep's: {sorted(got ^ want)}")
        print(f"phase 11 f64 sweep: {len(rows)} rows, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def bf16_wrow_ab() -> None:
    """Phase 11d's WROW v1/v2 A/B at bf16 on LINE_S (phase 5's at f32):
    each variant gated at 3e-2 against the host f64 product of the bf16
    matrix and x, with its device ms; v2 runs on no CLI format."""
    from spgrid_torch.bench.harness import make_x, x_tensor
    from spgrid_torch.core.metrics import error_metrics, gold_spmm_fast
    from spgrid_torch.ops.kernels.wrow_spmv import DeviceWROW, wrow_spmv

    from spgrid_torch.ops.kernels import launch_counts

    csr = line_matrix(LINE_S).astype("bfloat16")
    a = DeviceWROW.from_csr(csr, device=DEVICE)
    x = make_x(csr.k, 1, "bfloat16", 0)[:, 0]
    xd = x_tensor(x, "bfloat16", DEVICE)
    gold = gold_spmm_fast(csr.row_ptr, csr.col_idx, csr.values, x)
    failed = []
    before = launch_counts()
    for variant in ("v1", "v2"):
        y = wrow_spmv(a, xd, variant=variant).float().cpu().numpy()
        m = error_metrics(gold, y, epsilon=3e-2)
        dev = device_ms(lambda v=variant: wrow_spmv(a, xd, variant=v))
        print(f"phase 11 wrow A/B bf16: {variant} m={csr.m} nnz={csr.nnz} "
              f"max_ae={m.max_ae:.3e} mape={m.mape:.3e} device_ms={dev:.6f} "
              f"{'PASS' if m.passed else 'FAIL'}", flush=True)
        if not m.passed:
            failed.append(variant)
    print("phase 11 wrow A/B bf16 launches: " + str(
        {k: c - before[k] for k, c in launch_counts().items()
         if c != before[k]}), flush=True)
    if failed:
        raise RuntimeError(f"WROW bf16 A/B failed for {failed}")


def high_spmm_refused() -> None:
    """An SpMM row at matmul precision 'high' (the environment's): the CLI
    exits 2 naming ROADMAP.md, before anything runs at another
    precision."""
    from spgrid_torch.bench.cli import main as cli_main
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            code = cli_main(["--generate", HEADLINE_LINE, "--kernels",
                             "bsr_cuda", "--num-cols", "512", "--platform",
                             DEVICE])
        except SystemExit as e:
            code = e.code
    if code != 2 or "ROADMAP" not in err.getvalue():
        raise RuntimeError(f"an SpMM row at matmul precision 'high' exited "
                           f"{code}, not 2 naming ROADMAP.md: "
                           f"{err.getvalue()[-300:]}")
    print(f"phase 11 high: an SpMM row at 'high' exits {code}: "
          f"{err.getvalue().strip().splitlines()[-1]}", flush=True)


def phase_dtype_cli() -> None:
    """Phase 11d: the CLI at bf16 (dense, bsr_cuda and panel_cuda on the
    headline twin, n = 512; the SpMV path at n = 1: wrow_spmv_cuda,
    wcoo_spmv_cuda and auto on MAIN_LINE, where auto must run wrow_spmv,
    and wpack_spmv_cuda and wrow_spmv_cuda on LINE_S, wpack_spmv_cuda at
    wsel 1 on the twin; bsrc_cuda on LINE_B, wcoo_cuda on MAIN_LINE and
    dgell_cuda on LINE_S at n = 512; then the WROW v1/v2 A/B; ``--sddmm
    4096`` and ``--pipeline`` on three twins written as .smtx, each with
    and without ``--xla-only``), at f64 (csr_xla_coo on the twin at n = 1)
    and at matmul precision 'high' (``--sddmm 4096`` with and without
    ``--xla-only``, and an SpMM row that must exit 2), every row gated and
    timed for at least ``FORMATS_TIME_S``."""
    from spgrid_torch.io import write_smtx
    from spgrid_torch.scripts.sddmm_study import (
        LENGTH, PIPELINE_LENGTH, weight)
    with rows_timed_for(FORMATS_TIME_S):
        rows = cli_rows("phase 11 cli", (
            (["--generate", HEADLINE_LINE, "--dtype", "bfloat16"],
             "dense,bsr_cuda,panel_cuda", "512"),
            (["--generate", HEADLINE_LINE, "--dtype", "float64"],
             "csr_xla_coo", "1"),
            (["--generate", MAIN_LINE, "--dtype", "bfloat16"],
             "wrow_spmv_cuda,wcoo_spmv_cuda,auto", "1"),
            (["--generate", LINE_S, "--dtype", "bfloat16"],
             "wpack_spmv_cuda,wrow_spmv_cuda", "1"),
            # the twin, which WPACK packs at wsel 1
            (["--generate", HEADLINE_LINE, "--dtype", "bfloat16"],
             "wpack_spmv_cuda", "1"),
            # the last kernel forms at bf16, on the f32 forms' CLI matrices
            (["--generate", LINE_B, "--dtype", "bfloat16"], "bsrc_cuda",
             "512"),
            (["--generate", MAIN_LINE, "--dtype", "bfloat16"], "wcoo_cuda",
             "512"),
            (["--generate", LINE_S, "--dtype", "bfloat16"], "dgell_cuda",
             "512")))
        auto = [r["fmt"] for r in rows if r["kernel"] == "auto"]
        if auto != ["wrow_spmv"]:
            raise RuntimeError(f"auto at bf16 and n = 1 on MAIN_LINE ran "
                               f"{auto}, not wrow_spmv (the JAX package's "
                               f"pick)")
        bf16_wrow_ab()
        with tempfile.TemporaryDirectory() as tmp:
            cli_mode_rows(tmp, ["--sddmm", str(LENGTH)],
                          {False: ("sddmm_cuda", "bsr_pallas_"),
                           True: ("sddmm_xla", "coo")}, 3e-2, "phase 11",
                          ["--dtype", "bfloat16"])
            with env_set("SPGRID_MATMUL_PRECISION", "high"), \
                    tempfile.TemporaryDirectory() as tmp_high:
                # f32 at matmul precision 'high': the 3-pass SDDMM form
                cli_mode_rows(tmp_high, ["--sddmm", str(LENGTH)],
                              {False: ("sddmm_cuda", "bsr_pallas_"),
                               True: ("sddmm_xla", "coo")}, 1e-4,
                              "phase 11 high")
                high_spmm_refused()
            paths = []
            for seed in (1, 2, 3):
                paths.append(os.path.join(tmp, f"w{seed}.smtx"))
                write_smtx(paths[-1], weight(PIPELINE_LENGTH, seed))
            cli_mode_rows(tmp, ["--pipeline", *paths, "--sparsity",
                                str(PIPELINE_SPARSITY)],
                          {False: ("pipeline_cuda", "bsr"),
                           True: ("pipeline_xla", "bsr")}, 3e-2, "phase 11",
                          ["--dtype", "bfloat16"])


# kernel -> (source, the Pallas kernel it replaces)
SOURCES = {
    "bsr_spmm": ("spgrid_torch/csrc/bsr_spmm.cu",
                 "spgrid/ops/pallas/bsr_spmm.py:44"),
    "panel_spmm": ("spgrid_torch/csrc/panel_spmm.cu",
                   "spgrid/ops/pallas/panel_spmm.py:126"),
    # the same Pallas body with bf16 panels (cv_panel, its :133-138)
    "panel_spmm_bf16": ("spgrid_torch/csrc/panel_spmm.cu",
                        "spgrid/ops/pallas/panel_spmm.py:126"),
    "bsr_sddmm": ("spgrid_torch/csrc/sddmm.cu",
                  "spgrid/ops/pallas/sddmm.py:31"),
    "wcoo_spmm": ("spgrid_torch/csrc/wcoo_spmm.cu",
                  "spgrid/ops/pallas/wcoo_spmm.py:39"),
    "wcoo_spmm_aligned": ("spgrid_torch/csrc/wcoo_bands.cu",
                          "spgrid/ops/pallas/wcoo_spmm_aligned.py:174"),
    "wrow_spmv": ("spgrid_torch/csrc/wrow_spmv.cu",
                  "spgrid/ops/pallas/wrow_spmv.py:167"),
    "wcoo_spmv": ("spgrid_torch/csrc/wcoo_spmv.cu",
                  "spgrid/ops/pallas/wcoo_spmv.py:40"),
    "bsr_spmm_cstat": ("spgrid_torch/csrc/bsr_spmm_cstat.cu",
                       "spgrid/ops/pallas/bsr_spmm_cstat.py:127"),
    "dgell": ("spgrid_torch/csrc/dgell.cu", "spgrid/ops/pallas/dgell.py:141"),
    "wpack_spmv": ("spgrid_torch/csrc/wpack_spmv.cu",
                   "spgrid/ops/pallas/wpack_spmv.py:238"),
    "wrow_spmv_v2": ("spgrid_torch/csrc/wrow_spmv_v2.cu",
                     "spgrid/ops/pallas/wrow_spmv.py:226"),
    "lanegather": ("spgrid_torch/csrc/lanegather.cu",
                   "scripts/exp_lanegather.py:47"),
    "dma_gather": ("spgrid_torch/csrc/pallas_gather.cu",
                   "scripts/exp_pallas_gather.py:28"),
    "shuffle_bench": ("spgrid_torch/csrc/pallas_gather.cu",
                      "scripts/exp_pallas_gather.py:78"),
    "spmv_ablate": ("spgrid_torch/csrc/spmv_ablate.cu",
                    "scripts/exp_spmv_ablate.py:41"),
    "wpack_ablate": ("spgrid_torch/csrc/wpack_spmv.cu",
                     "spgrid/ops/pallas/wpack_spmv.py:272"),
    # the bf16 forms of the Pallas kernels at dtype bf16
    "bsr_spmm_bf16": ("spgrid_torch/csrc/bsr_spmm.cu",
                      "spgrid/ops/pallas/bsr_spmm.py:44"),
    "panel_spmm_bf16_xy": ("spgrid_torch/csrc/panel_spmm.cu",
                           "spgrid/ops/pallas/panel_spmm.py:126"),
    "bsr_sddmm_bf16": ("spgrid_torch/csrc/sddmm.cu",
                       "spgrid/ops/pallas/sddmm.py:31"),
    "wcoo_spmm_aligned_bf16": ("spgrid_torch/csrc/wcoo_bands.cu",
                               "spgrid/ops/pallas/wcoo_spmm_aligned.py:174"),
    "wrow_spmv_bf16": ("spgrid_torch/csrc/wrow_spmv.cu",
                       "spgrid/ops/pallas/wrow_spmv.py:167"),
    "wrow_spmv_v2_bf16": ("spgrid_torch/csrc/wrow_spmv_v2.cu",
                          "spgrid/ops/pallas/wrow_spmv.py:226"),
    "wcoo_spmv_bf16": ("spgrid_torch/csrc/wcoo_spmv.cu",
                       "spgrid/ops/pallas/wcoo_spmv.py:40"),
    "wpack_spmv_bf16": ("spgrid_torch/csrc/wpack_spmv.cu",
                        "spgrid/ops/pallas/wpack_spmv.py:238"),
    # the same body at wsel 1, where it rounds its bf16 lane prefix
    "wpack_spmv_bf16_prefix": ("spgrid_torch/csrc/wpack_spmv.cu",
                               "spgrid/ops/pallas/wpack_spmv.py:238"),
    # the SDDMM body's dot at matmul precision 'high' (3-pass bf16)
    "bsr_sddmm_bf16x3": ("spgrid_torch/csrc/sddmm.cu",
                         "spgrid/ops/pallas/sddmm.py:31"),
    "bsr_spmm_cstat_bf16": ("spgrid_torch/csrc/bsr_spmm_cstat.cu",
                            "spgrid/ops/pallas/bsr_spmm_cstat.py:127"),
    "wcoo_spmm_bf16": ("spgrid_torch/csrc/wcoo_spmm.cu",
                       "spgrid/ops/pallas/wcoo_spmm.py:39"),
    "dgell_bf16": ("spgrid_torch/csrc/dgell.cu",
                   "spgrid/ops/pallas/dgell.py:141"),
}
# each path, with the kernels it must launch
PATHS = (
    ("headline and flagship", (phase_headline, phase_flagship),
     ("bsr_spmm", "panel_spmm", "bsr_sddmm")),
    ("CLI", (phase_cli,),
     ("wcoo_spmm", "wcoo_spmm_aligned", "wrow_spmv", "wcoo_spmv")),
    ("scattered and block-grid CLI", (phase_scattered_cli,),
     ("bsr_spmm_cstat", "dgell", "wpack_spmv", "wrow_spmv_v2")),
    ("probes", (phase_probes,),
     ("lanegather", "dma_gather", "shuffle_bench", "spmv_ablate",
      "wpack_ablate")),
    ("dispatch", (phase_dispatch,), ("bsr_spmm", "panel_spmm")),
    ("SDDMM and the CLI's modes", (phase_sddmm,),
     ("bsr_sddmm", "bsr_spmm", "bsr_sddmm_bf16x3")),
    ("remaining formats", (phase_formats,), ("panel_spmm_bf16", "bsr_spmm")),
    ("dtypes", (phase_dtype_legs, phase_dtype_cli),
     ("bsr_spmm_bf16", "panel_spmm_bf16_xy", "bsr_sddmm_bf16",
      "wcoo_spmm_aligned_bf16", "wrow_spmv_bf16", "wrow_spmv_v2_bf16",
      "wcoo_spmv_bf16", "wpack_spmv_bf16", "wpack_spmv_bf16_prefix",
      "bsr_spmm_cstat_bf16", "wcoo_spmm_bf16", "dgell_bf16",
      "bsr_sddmm_bf16x3")),
)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "the port's smoke run needs a CUDA device")
    from spgrid_torch.ops.kernels import _build, launch_counts, \
        reset_launch_counts

    print(card_line(), flush=True)
    print(f"phase 0 torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    log = (_build.build_dir() / "nvcc.log").read_text()
    print(f"phase 0 build: {time.perf_counter() - t0:.1f} s "
          f"({_build.build_dir()})", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"phase 0 ptxas: {line.strip()}", flush=True)
        elif "Compiling entry function" in line:
            entry = line.split("'")[1]
            print(f"phase 0 ptxas: entry {entry}", flush=True)

    t0 = time.perf_counter()
    main_path = phase_kernels()
    print(f"phase 1 kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    main_path.update(phase_dtype_kernels())
    print(f"phase 11 kernels: {time.perf_counter() - t0:.1f} s", flush=True)

    launches = {}
    for path, phases, kernels in PATHS:
        reset_launch_counts()
        for phase in phases:
            t0 = time.perf_counter()
            phase()
            print(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
        counts = launch_counts()
        never = [k for k in kernels if counts[k] == 0]
        if never:
            raise RuntimeError(f"kernels never launched on the {path} path: "
                               f"{never}")
        print(f"launches on the {path} path: {counts}", flush=True)
        from spgrid_torch.ops.kernels.bsr_spmm import bsr_spmm_bf16
        if counts["bsr_spmm_bf16"]:
            # 1b's two kernels: a call runs one or both
            print(f"bsr_spmm_bf16 kernels on the {path} path: tile "
                  f"{bsr_spmm_bf16.tile_launches} entry "
                  f"{bsr_spmm_bf16.entry_launches}", flush=True)
        for k in kernels:
            launches[k] = launches.get(k, 0) + counts[k]
    phase_calibration()
    if "--eager-ab" in sys.argv[1:]:
        phase_eager_ab()

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                **main_path[name]}
               for name, (src, replaces) in SOURCES.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
