"""Analytic per-format SpMM time models and cost-based format selection on
the H100: the port's copy of ``spgrid/ops/costmodel.py``.

The formulas (``_dense_time`` .. ``_rbh_time``), ``estimate_spmm_time``,
``AUTO_CANDIDATES``, ``CV_TOLERANCE``, ``tolerant_candidates`` and
``select_format_cost`` are the JAX package's, verbatim (pinned by ``tests/test_torch_hostcopy.py``), so a test
that installs the JAX package's constants gets the JAX package's estimates.
Two things differ:

- the constants, ``H100Constants``: the JAX fields, each measured on the
  card (``chip_smoke.py``'s dispatch phase), plus ``residual_nnz``, the
  gather residual's cost a nnz at n = 512 that the JAX package writes as a
  literal in ``_rbh_time`` and ``rbh.py``; ``fudge`` is fitted by
  ``fit_constants`` over the port's own rows;
- ``prediction_records`` and ``fit_constants`` take an iterable of row
  dicts (the harness's rows, or ``csv.DictReader`` over a results CSV): the
  card's machine has no pandas.

Format names are the JAX package's (``bsr_pallas``, ``panel_pallas``, ...),
as the CSV's ``fmt`` column writes them; ``ops/dispatch.py`` maps them to
the port's. Every formula reads the module-level ``C`` when it is called.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from spgrid_torch.features.structural import MatrixFeatures


@dataclasses.dataclass
class H100Constants:
    """Machine constants of the H100, measured by ``chip_smoke.py``'s
    dispatch phase (each field's measurement in its comment)."""

    # Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit
    # (nvidia-smi), by chip_smoke.py's dispatch phase; every time by
    # CUDA-graph replay.
    eff_bw: float = 2.421e12       # streaming bytes/s: a 1 GiB f32 copy,
                                   # bytes read + written over its time
    mxu_f32: float = 51.69e12      # f32 matmul flops/s, TF32 off:
                                   # 8192^3 torch.matmul
    mxu_bf16: float = 867.5e12     # bf16 matmul flops/s: 8192^3 torch.matmul
    gather_fast: float = 0.8638e9  # rows/s, 2 KB rows by index_select
                                   # from a 32 MB X (inside the 50 MB L2)
    gather_slow: float = 0.7293e9  # rows/s, the same from a 512 MB X
    combine_bw: float = 2.626e12   # multiply + reduce bytes/s: the GELL
                                   # slot product and sum at n = 512,
                                   # 3 passes over the gathered rows + Y
    grid_step: float = 0.0         # per-block cost of bsr_cuda at n = 512
                                   # beyond the product term: its slope
                                   # over the block count (305 ns a block)
                                   # less the f32 product term (325 ns at
                                   # mxu_f32), clipped at 0: the 3xTF32
                                   # tensor-core tile beats mxu_f32
    dispatch: float = 1.037e-6     # fixed cost a call: an empty kernel's
                                   # device time
    wcoo_slot: float = 0.0         # wcoo_bands_cuda's time a predicted slot
    wcoo_nnz: float = 0.1757e-9    # and a nnz: the non-negative fit on its
                                   # MAIN_LINE and LINE_B times (the 2 x 2
                                   # solve gave a negative slot term)
    scoo_scatter: float = 0.9599e-9  # the sorted run sum (xla.segment_sum)
                                    # a nnz at n = 512: COO's row sums on
                                    # MAIN_LINE
    residual_nnz: float = 4.820e-9  # gather residual a nnz at n = 512: the
                                    # faster of sell and gell on the
                                    # mac_econ twin
    # per-format multiplicative corrections: fit_constants (min_rows=3)
    # over the dispatch phase's fixed-format rows at the constants above
    # (fudge times the median measured / predicted time a format; the
    # same card and limit), first from an empty fudge, then refitted once
    # after coo, merge and gell's tail moved to segment sums; dense and
    # panel_pallas had 2 rows each
    fudge: dict = dataclasses.field(default_factory=lambda: {
        "bsr_pallas": 1.264, "gell": 1.688, "coo": 0.8980, "merge": 0.7180,
        "sell": 1.560, "rbh": 0.7639})


C = H100Constants()


def _dense_time(f: MatrixFeatures, n: int, flops_rate: float) -> float:
    flops = 2.0 * f.m * f.n * n
    bytes_ = 4.0 * (f.m * f.n + f.n * n + f.m * n)
    return max(flops / flops_rate, bytes_ / C.eff_bw)


def _bsr_occupied_blocks(f: MatrixFeatures, clustering_cap: bool = False
                         ) -> float:
    """Estimated occupied 128x128 blocks — shared by _bsr_time and the
    bsr applicability gate (ADVICE r4: one copy, not two that drift).

    Base model: Poisson fill over the band's candidate blocks.
    clustering_cap (ADVICE r4, GATE ONLY): uniform fill overestimates
    occupancy for clustered structure — entries arrive in
    ~(1+avg_num_neighbours)-long column segments repeated over ~1/(1-crs)
    adjacent rows, so each occupied block expects at least that many
    entries; occupied <= nnz / that.  The cap's direction is right for
    the 2GB inapplicability gate (never exclude a runnable clustered
    matrix) but r5 validation showed it WORSENS the time model's ranking
    (medAPE 31 -> 40: local clusters are rarely block-aligned), so
    _bsr_time keeps the uncapped estimate."""
    mb = max(f.m / 128.0, 1.0)
    kb = max(f.n / 128.0, 1.0)
    # blocks that can hold nnz: banded matrices restrict to the band.
    # The band is row bandwidth PLUS diagonal wander (r5: narrow rows
    # scattered across a wide placement range — avg_bw 10 cols but
    # centers spread over ~6k — occupied ~1 block per row-run, 15x the
    # row-bandwidth-only estimate; avg_dd_scaled is the wander feature)
    band = f.avg_bw + 4.0 * getattr(f, "avg_dd_scaled", 0.0) * f.n
    band_kb = min(kb, (band + 256.0) / 128.0)
    cand = mb * band_kb
    lam = f.nnz / max(cand, 1e-9)          # nnz per candidate block
    occ = cand * (1.0 - math.exp(-lam / 1.0))
    if not clustering_cap:
        return occ
    seg = 1.0 + max(f.avg_num_neighbours, 0.0)
    run = 1.0 / max(1.0 - min(f.cross_row_similarity, 1.0), 1.0 / 128.0)
    per_occ = max(1.0, lam, min(seg, 128.0) * min(run, 128.0))
    return min(occ, f.nnz / per_occ)


def _bsr_time(f: MatrixFeatures, n: int) -> float:
    """128x128-block Pallas kernel: per occupied block one x-tile DMA +
    one (128,128)@(128,n) matmul + a grid step."""
    occ = _bsr_occupied_blocks(f)
    per_block = max(
        128.0 * n * 4 / C.eff_bw,          # x-tile DMA
        2.0 * 128 * 128 * n / C.mxu_f32,   # f32 block matmul
    ) + C.grid_step
    return occ * per_block + f.m * n * 4 / C.eff_bw


def _panel_time(f: MatrixFeatures, n: int) -> float:
    """Vertical 2048x128 panels: occupied panels run a dense matmul."""
    panels = max(f.m / 2048.0, 1.0) * max(f.n / 128.0, 1.0)
    lam = f.nnz / max(panels, 1e-9)
    occ_frac = 1.0 - math.exp(-lam)
    occupied_area = occ_frac * f.m * f.n
    flops = 2.0 * occupied_area * n
    bytes_ = occupied_area * 4 + occ_frac * panels * (128.0 * n * 4)
    return max(flops / C.mxu_f32, bytes_ / C.eff_bw) \
        + occ_frac * panels * C.grid_step


def _gell_windowable(f: MatrixFeatures, bpe: float = 4.0) -> bool:
    """Can row chunks gather from <=63MB X windows?  Approximated from
    the measured bandwidth stats (chunk col span ~ avg_bw + chunk).  The
    cap is source BYTES at n=512 (gell._plan_windows), so bf16-source
    modes (bpe=2) window bands twice as wide."""
    span_cap = (63 << 20) / (bpe * 512.0)
    return f.avg_bw + 2.0 * f.std_bw + 1024 <= span_cap


def _full_src_rate(src_bytes: float) -> float:
    """Gather rows/s from a full (unwindowed) X of `src_bytes`.

    The measured cliff is not a step at 64MB (r5 fix: merge/sell rows at
    k~34k, src 66MB, ran ~2x faster than the step model said — ratio 0.55
    vs the skew rows' ~1.0): interpolate fast*(64MB/src)^0.9 between the
    two measured anchors (200 Mrow/s under 64MB, 55 Mrow/s at ~270MB+)."""
    cap = float(1 << 26)
    if src_bytes <= cap:
        return C.gather_fast
    return max(C.gather_slow, C.gather_fast * (cap / src_bytes) ** 0.9)


def _unfloored_src_rate(src_bytes: float) -> float:
    """_full_src_rate without the gather_slow floor: giant sources (>>270MB,
    e.g. the (k, n) f32 X at k ~ 1M) keep degrading past the floor — the
    r5 rbh rows at k = 393k-1M measured 1.3-1.9x under the floored model
    and land on the smooth power law."""
    cap = float(1 << 26)
    if src_bytes <= cap:
        return C.gather_fast
    return C.gather_fast * (cap / src_bytes) ** 0.9


def _gather_rate(f: MatrixFeatures, n: int, bytes_per_elem: float) -> float:
    src = f.n * n * bytes_per_elem
    if _gell_windowable(f, bytes_per_elem):
        # windowed gather-reuse credit (ROADMAP r5 item 1): when each
        # source row inside a window is hit many times (nnz per source
        # row = avg_nnz * m/k >= ~16), the take runs up to ~1.5x the flat
        # windowed rate — measured on the dense-ish windowed medium rows
        # (49152/40-per-row rows at ratio 0.51-0.53 under the flat model;
        # refit med/p90 APE 25.4/122 -> 22.8/66 with the credit)
        per_src = f.avg_nnz_per_row * f.m / max(f.n, 1)
        if per_src >= 16.0:
            return C.gather_fast * 1.5
        return C.gather_fast
    return _full_src_rate(src)


def _gell_slots_tail(f: MatrixFeatures) -> tuple:
    """(slots, estimated tail nnz) matching GELLMatrix.__init__: slots =
    ceil(1.25*avg) (widened to max when max <= slots+2 holds everything);
    tail = the skew-boosted row's overflow (gen/artificial.py realizes
    skew by boosting ONE row to avg*(1+skew) nnz) + a normal-approximation
    expected per-row overflow E[(deg-slots)+] from (avg, std)."""
    slots = max(1.0, math.ceil(f.avg_nnz_per_row * 1.25))
    mx = min(f.avg_nnz_per_row * (1.0 + max(f.skew, 0.0)), float(f.n))
    if mx <= slots + 2:
        return max(1.0, mx), 0.0
    tail = max(0.0, mx - slots)
    mu, sd = f.avg_nnz_per_row, max(f.std_nnz_per_row, 1e-9)
    z = (slots - mu) / sd
    phi = math.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    cdf = 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))
    tail += max(0.0, sd * phi - (slots - mu) * (1.0 - cdf)) * f.m
    return slots, min(tail, 0.9 * f.nnz)


def _gell_time(f: MatrixFeatures, n: int, mode: str) -> float:
    """Gather-ELL (ops/gell.py): windowed row gather + slot combine.

    Rate model from the round-2 measurement campaign: gather throughput
    is rows/s bounded, ~4x higher when the gather source is <64MB —
    which windowing achieves for column-local matrices.  r5 additions
    (ROADMAP item 1): windowed gather-reuse credit (see _gather_rate) and
    a tail term — tail nnz (skew-boosted row + distribution overflow,
    _gell_slots_tail) gather from the FULL f32 X (gell.py::_add_tail
    takes from x, never a window) at the unfloored smooth rate."""
    slots, tail = _gell_slots_tail(f)
    rows_g = f.m * slots
    if mode == "bf16":
        bpe, planes = 2.0, 1
    elif mode == "split16":
        bpe, planes = 2.0, 2
    elif mode == "split24":
        bpe, planes = 2.0, 3
    else:
        bpe, planes = 4.0, 1
    convert = 0.0 if mode == "f32" else f.n * n * (4.0 + bpe * planes) \
        / C.eff_bw
    # gather throughput is ROWS/S bounded: split16 concatenates [hi|lo]
    # into one 2n-wide bf16 source (ONE take); only split24 pays a second
    # take for its lo plane.  Source bytes/elem-of-n (the cliff/window
    # quantity) is therefore 4 for f32/split modes and 2 only for bf16 —
    # bf16 mode windows bands twice as wide.
    takes = 2.0 if mode == "split24" else 1.0
    src_bpe = 2.0 if mode == "bf16" else 4.0
    gather = takes * rows_g / _gather_rate(f, n, src_bpe)
    if mode == "f32":
        # windowed f32 now combines on the MXU too (WIN_F32_COMBINE,
        # 6-pass HIGHEST): the gathered intermediate reads back at
        # streaming rate; the direct (small-k) path keeps the VPU combine
        # but is gather-dominated there
        combine = (rows_g * n * 4.0 + f.m * n * 4.0) / C.eff_bw \
            + 6.0 * 16.0 * rows_g * n / C.mxu_bf16
    else:
        # MXU block-diagonal combine (windowed r3 / chunked r2 paths):
        # the gathered intermediate is written once and streamed back
        # into the matmul at full bandwidth; flops are ~free on the MXU
        nv = 3 if mode == "split24" else 2
        g_bytes = planes * rows_g * n * bpe * 2.0 + f.m * n * 4.0
        mxu = 16.0 * rows_g * n * planes * nv / C.mxu_bf16
        combine = g_bytes / C.eff_bw + mxu
    t_tail = tail / _unfloored_src_rate(f.n * n * 4.0) \
        + tail * n * 4.0 * 2.0 / C.eff_bw
    return convert + gather + combine + t_tail


def _ell_time(f: MatrixFeatures, n: int) -> float:
    width = max(f.max_nnz_per_row, 1)
    # the stock XLA ELL path never windows AND measures the full slow
    # rate already just past the cliff (its padded (m, width) gather
    # pattern — unlike merge/sell whose smooth interpolation fits);
    # keep the step model here (r5: smooth made ell medAPE worse)
    rate = C.gather_fast if f.n * n * 4 <= (1 << 26) else C.gather_slow
    return f.m * width / rate \
        + (f.m * width * n * 4 + f.m * n * 4) / C.combine_bw


def _coo_time(f: MatrixFeatures, n: int) -> float:
    rate = _full_src_rate(f.n * n * 4.0)
    return f.nnz / rate \
        + (3.0 * f.nnz * n * 4 + f.m * n * 4) / C.combine_bw


def _wcoo_bands_slots(f: MatrixFeatures) -> float:
    """Predicted aligned-slot count (spgrid.formats.wcoo layout).

    A slot sub-row holds one (128-row block, 128-col window) pair with
    lane = row % 128, so the slot count is

        slots = sum over occupied (block, window) pairs of
                (max entries any row has in that window) * 128

    modeled with Poisson fills: lambda per (block, window) =
    avg_nnz * 128^2 / bw; occupied fraction = 1 - exp(-lambda); sub-rows
    per occupied pair ~ expected max of 128 Poisson(lambda/128) draws.
    The round-2 flat 28 ns/nnz model missed exactly this: at wide bands
    with low fill, occupancy stays ~1 while lane utilization collapses
    (measured: 112 ns/nnz at bw 20.5k vs 26-31 ns/nnz at bw ~1k, the
    r2 refresh art_393215 row vs the r1 banded sweep)."""
    bw = max(f.avg_bw, 256.0)
    blocks = max(f.m / 128.0, 1.0)
    windows = max(bw / 128.0, 1.0)
    lam_bw = f.avg_nnz_per_row * 128.0 * 128.0 / bw   # nnz per (b, w) pair
    occupied = blocks * windows * (1.0 - math.exp(-lam_bw / 1.0))
    lam_rw = lam_bw / 128.0                           # per (row, window)
    # expected max of 128 Poisson(lam_rw): ~lam + 3*sqrt(lam) + 1.5 covers
    # the small-lam (max ~2-4) and large-lam (max -> lam) ends adequately
    sub_rows = lam_rw + 3.0 * math.sqrt(max(lam_rw, 1e-9)) + 1.5
    return occupied * sub_rows * 128.0


def _wcoo_bands_time(f: MatrixFeatures, n: int) -> float:
    """Aligned-slot Pallas kernel: slot-stream + per-nnz VPU terms.

    Calibrated on the two measured anchors (see _wcoo_bands_slots):
    c_slot ~ 1.7 ns/slot, c_nnz ~ 20 ns/nnz reproduce both the narrow-band
    26-31 ns/nnz and the wide-band 112 ns/nnz rows within ~20%."""
    slots = _wcoo_bands_slots(f)
    return slots * C.wcoo_slot + f.nnz * C.wcoo_nnz \
        + f.m * n * 4 / C.eff_bw


def _scoo_time(f: MatrixFeatures, n: int) -> float:
    """Column-windowed COO (ops/scoo.py): every gather runs at the fast
    (<64MB-source) rate; the combine is an in-place sorted scatter-add.

    Padded entry count: blocks are (R=32k rows, W=32k cols); per-block
    population ~ Poisson(mu), padded to the max block, approximated
    mu + 3*sqrt(mu) + skew allowance."""
    R = W = 1 << 15
    nb = max(math.ceil(f.m / R), 1)
    ns = max(math.ceil(f.n / W), 1)
    mu = f.nnz / (nb * ns)
    # banded matrices concentrate entries in diagonal blocks: the max
    # block then carries ~ns/band_blocks times the mean
    band_ns = min(ns, max(f.avg_bw / W, 1.0 / ns))
    conc = min(ns / max(band_ns, 1e-9), ns)
    e_pad = mu * conc + 3.0 * math.sqrt(max(mu * conc, 1.0)) + 8
    nnz_pad = nb * ns * e_pad
    gather = nnz_pad / C.gather_fast
    combine = nnz_pad * C.scoo_scatter
    stream = (f.m * n * 4.0 + nnz_pad * n * 4.0) / C.eff_bw
    return gather + combine + stream


def _merge_time(f: MatrixFeatures, n: int) -> float:
    """Merge-path equal-nnz blocks (ops/merge.py): per nnz the kernel pays
    a 128-tall one-hot MXU product (2*128*n flops), the one-hot + gathered
    operand traffic (~5KB), and an unsorted segment-sum over B*128 strip
    rows — skew-proof by construction, never cheap (VERDICT r2 weak #6
    asked for the honest model + measurement)."""
    T = 512.0
    blocks = max(f.nnz / T, f.m / 128.0, 1.0)
    # merge always gathers from the FULL X (never windowed), so the
    # gell-only windowed fast-gather credit of _gather_rate does not
    # apply — smooth full-source cliff (see _full_src_rate)
    gather = f.nnz / _full_src_rate(f.n * n * 4.0)
    mxu = blocks * 2.0 * 128.0 * T * n / C.mxu_f32
    onehot_bytes = blocks * 128.0 * T * 4.0 * 2.0
    g_bytes = blocks * T * n * 4.0 * 2.0
    seg_bytes = blocks * 128.0 * n * 4.0 * 2.0 + f.m * n * 4.0
    return gather + mxu         + (onehot_bytes + g_bytes + seg_bytes) / C.eff_bw


def _sell_time(f: MatrixFeatures, n: int) -> float:
    """SELL-C-sigma SpMM (ops/xla.py::spmm_sell): sigma-sorting keeps slot
    padding small, but the gather source is the full X (never windowed)
    and the permutation costs two extra (m, n) scatter passes.

    Skew term (r5 fix, VERDICT r4 weak #1): measured sell rows run
    1.3-1.7x slower than the flat model at skew >= ~100 (medium_study +
    newkernels rows) — skewed degree spreads the width buckets, so the
    widest slices pad more and the per-bucket dispatch multiplies;
    merge is skew-proof by construction and the flat model ranked them
    as equals inside the scattered class."""
    slots = 1.1 * f.nnz + 32.0 * f.m / 8.0
    rate = _full_src_rate(f.n * n * 4.0)
    skew_pen = 1.0 + 0.125 * math.log10(1.0 + max(f.skew, 0.0))
    return skew_pen * (slots / rate
                       + (slots * n * 4.0 + 3.0 * f.m * n * 4.0)
                       / C.combine_bw)


def _rbh_time(f: MatrixFeatures, n: int) -> float:
    """Reorder-block hybrid (ops/rbh.py): per-call X column-perm gather +
    MXU block passes over the clustered fraction + gather residual.

    Clusterability model calibrated on the r5 measured splits
    (reorder_amortization.csv): the inspect step packs hi_frac ~
    0.74 * crs of the nnz (measured 0.554/0.75, 0.22/0.30, 0.196/...)
    into blocks of fill c ~ 90 * run^0.42 nnz (measured 163 at run=4,
    113 at run=1.43, 92 at run=1.05), where run = 1/(1-crs) is the
    column-reuse row-run length; the residual is the non-local tail.

    r5b recalibration on the 33 measured medium-study rbh rows (med/p90
    APE 52.7/98.6 -> 20.7/65.6):
    - density branch: when the UNCLUSTERED expected block fill
      density*128^2 already clears the admission threshold (~32 nnz,
      rbh.auto_threshold ballpark), the inspector keeps essentially every
      block (hi_frac -> 1) regardless of crs — the dense-ish rows
      (dens*16384 = 137-3353) measured 14-100x under the crs-only model.
    - boosted-row densification: the skew-boosted row (gen realizes skew
      as ONE row of avg*(1+skew) nnz) has ~128*b/k nnz per 128-col window;
      past the threshold it densifies into ~k/128 blocks instead of
      riding the 29ns/nnz residual.
    - MAX_HI_BLOCKS budget (rbh.py: 2GB / 64KB = 32768 blocks) caps the
      dense split; the spill returns to the residual.
    - per-block cost x0.6: vertically-adjacent blocks in one column
      window share the (128, n) x-tile DMA, so the worst-case per-block
      DMA accounting overcharges clustered splits (fitted).
    - perm gather at the UNFLOORED smooth rate: k = 393k-1M rows from a
      0.8-2GB source measured past the 55 Mrow/s floor."""
    run = 1.0 / max(1.0 - min(f.cross_row_similarity, 0.999), 1.0 / 128.0)
    clus_fill = 90.0 * min(run, 128.0) ** 0.42
    base_fill = f.density * 16384.0
    thresh = 32.0
    if base_fill >= thresh:
        hi_frac, c = 1.0, max(base_fill, clus_fill)
    else:
        hi_frac, c = min(1.0, 0.74 * f.cross_row_similarity), clus_fill
    hi_nnz = hi_frac * f.nnz
    extra_blocks = 0.0
    boost = min(f.avg_nnz_per_row * (1.0 + max(f.skew, 0.0)), float(f.n))
    if f.skew > 0 and boost > 4.0 * f.avg_nnz_per_row \
            and 128.0 * boost / max(f.n, 1) >= thresh:
        hi_nnz += boost * (1.0 - hi_frac)
        extra_blocks = f.n / 128.0
    blocks = hi_nnz / max(c, 1.0) + extra_blocks
    max_blocks = float((2 << 30) // (128 * 128 * 4))
    if blocks > max_blocks:
        hi_nnz -= (blocks - max_blocks) * c
        blocks = max_blocks
    per_block = max(128.0 * n * 4 / C.eff_bw,
                    2.0 * 128 * 128 * n / C.mxu_f32) + C.grid_step
    perm = f.n / _unfloored_src_rate(f.n * n * 4.0)
    res = (f.nnz - hi_nnz) * C.residual_nnz * (n / 512.0)
    stream = f.m * n * 4.0 / C.eff_bw
    return perm + blocks * per_block * 0.6 + res + stream


def _fudged(fmt: str, t: float) -> float:
    return t * C.fudge.get(fmt, 1.0)


def estimate_spmm_time(f: MatrixFeatures, fmt: str, n: int) -> float:
    """Seconds for one SpMM call of `fmt` on a matrix with features `f`.

    Returns +inf for formats that are inapplicable (would OOM / wrong n).
    """
    if fmt == "dense":
        if f.m * f.n * 4 > (1 << 31):
            return math.inf
        return _fudged(fmt, _dense_time(f, n, C.mxu_f32)) + C.dispatch
    if fmt in ("bsr_pallas", "bsr"):
        # occupied blocks materialize DENSELY (128x128x4B each): a
        # scattered 137k-row matrix occupies ~nnz blocks -> ~190GB and
        # the conversion wedges the host (r4 medium-study stall) — the
        # format is inapplicable long before the time model says slow
        if _bsr_occupied_blocks(f, clustering_cap=True) * 128 * 128 * 4 \
                > (1 << 31):
            return math.inf
        return _fudged(fmt, _bsr_time(f, n)) + C.dispatch
    if fmt in ("panel_pallas", "cv_panel"):
        est_panel_bytes = min(1.0, f.density * 2048 * 128) * f.m * f.n * 4
        if est_panel_bytes > (1 << 31):
            return math.inf
        return _fudged(fmt, _panel_time(f, n)) + C.dispatch
    if fmt == "gell":
        return _fudged(fmt, _gell_time(f, n, "f32")) + C.dispatch
    if fmt == "gell16":
        return _fudged(fmt, _gell_time(f, n, "split16")) + C.dispatch
    if fmt == "cv_gell":
        return _fudged(fmt, _gell_time(f, n, "bf16")) + C.dispatch
    if fmt == "ell":
        slots_est = f.m * max(f.max_nnz_per_row, 1)
        if slots_est > 32 * max(f.nnz, 1) and slots_est * 8 > (64 << 20):
            return math.inf
        return _fudged(fmt, _ell_time(f, n)) + C.dispatch
    if fmt == "coo":
        return _fudged(fmt, _coo_time(f, n)) + C.dispatch
    if fmt == "wcoo_bands":
        if f.avg_bw_scaled >= 0.25:
            return math.inf          # slot packing collapses unbanded
        return _fudged(fmt, _wcoo_bands_time(f, n)) + C.dispatch
    if fmt == "scoo":
        return _fudged(fmt, _scoo_time(f, n)) + C.dispatch
    if fmt == "merge":
        return _fudged(fmt, _merge_time(f, n)) + C.dispatch
    if fmt == "sell":
        return _fudged(fmt, _sell_time(f, n)) + C.dispatch
    if fmt == "rbh":
        # densified-block budget: the hybrid caps itself at 2GB of blocks
        # (rbh.MAX_HI_BLOCKS), so it is always *runnable*; inapplicable
        # only where there is nothing to cluster (no reuse signal)
        if f.cross_row_similarity <= 0.0 and f.avg_num_neighbours <= 0.0:
            return math.inf
        return _fudged(fmt, _rbh_time(f, n)) + C.dispatch
    return math.inf


# Default candidate set for f32-exact cost-based auto dispatch (CV modes
# trade accuracy and are opted into explicitly).  Round-4 admissions,
# decided on the newkernels grid + skew rows (newkernels_r3.csv) via
# scripts/refit_costmodel.py validation tables:
# - merge ADMITTED: model medAPE 10.1% (6 rows); wins every skew row
#   (37.1 vs gell's 21.2 GF at skew=1e5 — the mawi-class regime the
#   reference covers with merge-based SpMV, spmv_kernel_merge.cpp:61-65).
# - sell ADMITTED: wins scat_393k (34.7 GF, best f32-exact row of the
#   class) and the mid-density medium-study head-to-head (44.5 vs 28.1);
#   medAPE 33% pre-refit, re-centered by the fitted 0.670 fudge.
# - scoo stays OUT: measured (7 rows) and loses every head-to-head in
#   its target class (11-27 GF vs sell/merge/gell 28-37).
# - wcoo_bands stays OUT: fill-aware slot model FAILS validation
#   (medAPE 44.6%, p90 143% across the bw range — far over the ~30%
#   admission bar; see refit output).
# - ell DROPPED r5: its model fails the 30% bar (medAPE 37.7% on 11
#   rows) and the format is functionally dominated by gell (= ELL +
#   window plan + skew tail); a failing model in AUTO can only mis-steal
#   gell's rows.  Still available as an explicit kernel.
# - rbh ADMITTED r5: measured on 12 class rows (reorder_rbh.csv +
#   bf16 leg) — wins scat_524k (+43% over the prior class best), the
#   skew grid (40.0/39.8/37.5 vs merge's 35.9/36.2/37.1), ties
#   scat_393k, and carries the mac_econ twin at 118-138 GF (past the
#   105-GFLOPS MKL-IE bar); model medAPE 17.8% (under the 30% bar),
#   fitted fudge 1.051.
AUTO_CANDIDATES = ("dense", "bsr_pallas", "panel_pallas", "gell",
                   "coo", "merge", "sell", "rbh")


def _finite_or_zero(v) -> float:
    try:
        v = float(v)
    except (TypeError, ValueError):
        return 0.0
    return v if math.isfinite(v) else 0.0

def _num(v) -> float:
    """A row's field as a float: nan for a missing or empty one."""
    if v is None or v == "":
        return math.nan
    return float(v)


_NEED = ("fmt", "time", "csr_m", "csr_k", "csr_nnz", "input_columns",
         "avg_nnz_per_row", "std_nnz_per_row", "avg_bw_scaled",
         "std_bw_scaled", "skew")


def prediction_records(rows) -> list:
    """Per-row measured-vs-predicted model validation records.

    For every oracle-passing fixed-kernel row of ``rows`` (dicts keyed by
    the CSV columns, as the harness returns them or ``csv.DictReader``
    reads them) with full feature columns, reconstruct the MatrixFeatures
    the dispatcher would see and evaluate the analytic model: the JAX
    package's ``prediction_records`` over a list of dicts, with its
    filters (no record when a needed column is absent from every row; rows
    whose ``errors_passed`` is not 1, where any row has that column; rows
    with a non-finite needed field). Returns dicts with fmt, matrix_name,
    n, measured/predicted time, their ratio, and the structure features
    the models key on.
    """
    rows = list(rows)
    if any(all(c not in r for r in rows) for c in _NEED):
        return []
    if any("errors_passed" in r for r in rows):
        rows = [r for r in rows if _num(r.get("errors_passed")) == 1]
    records: list = []
    for r in rows:
        if any(not math.isfinite(_num(r.get(c))) for c in _NEED
               if c != "fmt"):
            continue          # pipeline/sddmm rows lack feature columns
        fmt = r["fmt"]
        m, k = int(_num(r["csr_m"])), int(_num(r["csr_k"]))
        nnz = int(_num(r["csr_nnz"]))
        n = int(_num(r["input_columns"]))
        avg, skew = _num(r["avg_nnz_per_row"]), _num(r["skew"])
        bw = _num(r["avg_bw_scaled"]) * k
        f = MatrixFeatures(
            name="", m=m, n=k, nnz=nnz, density=nnz / max(m * k, 1),
            mem_footprint=0.0, mem_range="",
            avg_nnz_per_row=avg, std_nnz_per_row=_num(r["std_nnz_per_row"]),
            min_nnz_per_row=0, max_nnz_per_row=int(avg * (1 + skew)),
            avg_bw=bw, std_bw=_num(r["std_bw_scaled"]) * k,
            avg_bw_scaled=_num(r["avg_bw_scaled"]),
            std_bw_scaled=_num(r["std_bw_scaled"]),
            avg_sc=0.0, std_sc=0.0, avg_sc_scaled=0.0, std_sc_scaled=0.0,
            skew=skew,
            avg_num_neighbours=_finite_or_zero(r.get("avg_num_neighbours")),
            cross_row_similarity=_finite_or_zero(
                r.get("cross_row_similarity")))
        pred = estimate_spmm_time(f, fmt, n)
        t = _num(r["time"])
        if math.isfinite(pred) and pred > 0 and t > 0:
            records.append(dict(
                fmt=fmt, matrix_name=r.get("matrix_name", ""), n=n, time=t,
                pred=pred, ratio=t / pred, m=m, nnz=nnz,
                avg_bw_scaled=_num(r["avg_bw_scaled"]), skew=skew,
                source=r.get("source", "")))
    return records


def fit_constants(rows, *, min_rows: int = 3) -> dict:
    """Refit per-format corrections from measured rows (the JAX package's
    ``fit_constants`` over row dicts). For each format with >= min_rows
    oracle-passing rows, the median measured/predicted time ratio becomes a
    multiplicative correction applied by estimate_spmm_time. Returns the
    fitted corrections (also installed into the live constants, on top of
    any existing correction)."""
    ratios: dict = {}
    for rec in prediction_records(rows):
        ratios.setdefault(rec["fmt"], []).append(rec["ratio"])
    fitted = {fmt: float(np.median(v)) for fmt, v in ratios.items()
              if len(v) >= min_rows}
    for fmt, rr in fitted.items():
        C.fudge[fmt] = C.fudge.get(fmt, 1.0) * rr
    return fitted


# Value-compressed candidates for tolerance-enabled dispatch (r5): the
# reference's value-compression study (lib/bitstream.c, CV modes) is an
# explicit accuracy trade — offered only when the caller states a
# tolerance at or above the bf16-X representation error (~2^-8).
CV_TOLERANCE = 4e-3


def tolerant_candidates(f: MatrixFeatures, n: int) -> tuple:
    cands = ["cv_panel"]
    # cv_gell regime gate (ROADMAP r4 item 4): the giant-m windowed rows
    # (m >= ~200k, bf16-windowable band) mispredict 2.5-4.7x — exclude
    # exactly that regime so the least-validated model cannot steer
    # tolerance dispatch where it is known to be wrong
    if not (f.m >= 200_000 and _gell_windowable(f, 2.0)):
        cands.append("cv_gell")
    return tuple(cands)


def select_format_cost(f: MatrixFeatures, n: int = 512,
                       candidates=AUTO_CANDIDATES,
                       tolerance: float = 0.0) -> str:
    """argmin of the analytic time models over applicable formats.

    tolerance >= CV_TOLERANCE additionally offers the value-compressed
    kernels (the accuracy bar is then the dequantized gold, see
    bench/harness.py oracle classes)."""
    cands = tuple(candidates)
    if tolerance >= CV_TOLERANCE:
        cands = cands + tolerant_candidates(f, n)
    best, best_t = None, math.inf
    for fmt in cands:
        t = estimate_spmm_time(f, fmt, n)
        if t < best_t:
            best, best_t = fmt, t
    if best is None:
        return "coo"
    return best
