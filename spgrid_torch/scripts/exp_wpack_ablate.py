"""Probe: where the time of a WPACK SpMV group goes on the card.

    python -m spgrid_torch.scripts.exp_wpack_ablate [m avg bw]
        [--platform cpu]

The port of ``scripts/exp_wpack_ablate.py``, on the same matrix
(``artificial_matrix_generation(m, m, avg, round(avg / 3, 4), "normal", 14,
"random", bw, 0, 0.05, 0.05)``, by default 100000 20 0.05) and the same x
(``default_rng(0).random(m) + 0.5``). It prints WROW v1 (the baseline),
the WPACK layout (utilization, wsel, groups), then one line for each form
of the WPACK group body (``wpack_spmv(a, x, ablate=, prefix=)``):

    noseg          the products summed over the pieces, no segment reduce
    nogather/pad   + the lane prefix, by a shared-memory scan
    nogather/roll  + the lane prefix, by warp shuffles
    full/pad       + the two boundary reads: P[end] - (P - p)[start]
    full/roll      the same with the shuffle prefix
    full/direct    the card's own design: each row's segment summed

Each line gives the time a call (the median of ``REPEATS`` runs, with the
spread), the time a group and the rate on 2 · nnz flops; the lines of WROW
v1 and of the three full forms also give ``max |y - gold| / max |gold|``
against the host f64 product. The exit code is 1 if one of those misses
the product by more than ``TOL``. noseg and nogather are wrong by design.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from spgrid_torch.core.metrics import gold_spmm_fast
from spgrid_torch.gen import artificial_matrix_generation
from spgrid_torch.ops.kernels.wpack_spmv import DeviceWPACK, wpack_spmv
from spgrid_torch.ops.kernels.wrow_spmv import DeviceWROW, wrow_spmv
from spgrid_torch.scripts import device_of, parser, timed

TOL = 1e-5
# tag -> wpack_spmv's knobs
FORMS = (("noseg", dict(ablate="noseg")),
         ("nogather/pad", dict(ablate="nogather", prefix="pad")),
         ("nogather/roll", dict(ablate="nogather", prefix="roll")),
         ("full/pad", dict(prefix="pad")),
         ("full/roll", dict(prefix="roll")),
         ("full/direct", dict(prefix="direct")))


def wpack_matrix(m: int, avg: float, bw: float):
    """The probe's m x m matrix: ``avg`` nnz a row (std avg / 3 to 4
    places), random placement in a band of ``bw``, seed 14."""
    return artificial_matrix_generation(
        m, m, avg, round(avg / 3, 4), "normal", 14, "random", bw, 0, 0.05,
        0.05, name=f"synth_{m}_a{avg:g}_b{bw:g}")


def main(argv=None) -> int:
    ap = parser("spgrid_torch.scripts.exp_wpack_ablate",
                "WPACK SpMV group-body ablation")
    ap.add_argument("m", nargs="?", type=int, default=100000)
    ap.add_argument("avg", nargs="?", type=float, default=20.0)
    ap.add_argument("bw", nargs="?", type=float, default=0.05)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    device = device_of(ap.prog, args.platform)
    if device is None:
        return 1
    csr = wpack_matrix(args.m, args.avg, args.bw)
    x = (np.random.default_rng(0).random(csr.k) + 0.5).astype(np.float32)
    xd = torch.from_numpy(x).to(device)
    gold = gold_spmm_fast(csr.row_ptr, csr.col_idx, csr.values, x)
    flops = 2.0 * csr.nnz
    missed = []

    def line(tag, fn, a, groups, check):
        t, spread = timed(fn, a, xd, device=device)
        text = (f"{tag:13s} {t * 1e6:9.2f} us  {t / groups * 1e9:7.3f} "
                f"ns/group  {flops / t / 1e9:7.2f} GF  (spread {spread:.1%})")
        if check:
            y = fn(a, xd).cpu().numpy()
            err = np.abs(y - gold).max() / max(np.abs(gold).max(), 1e-30)
            ok = bool(np.isfinite(y).all()) and err <= TOL
            text += f"  max_rel~{err:.1e}{'' if ok else ' FAIL'}"
            if not ok:
                missed.append(tag)
        print(text, flush=True)

    wr = DeviceWROW.from_csr(csr, device=device)
    print(f"m={csr.m} nnz={csr.nnz}", flush=True)
    line("wrow v1", wrow_spmv, wr, wr.num_groups, True)
    del wr
    wp = DeviceWPACK.from_csr(csr, device=device)
    print(f"wpack: util {wp.utilization:.3f} wsel {wp.wsel} groups "
          f"{wp.num_groups}", flush=True)
    for tag, knobs in FORMS:
        line(tag, lambda a, v, kw=knobs: wpack_spmv(a, v, **kw), wp,
             wp.num_groups, tag.startswith("full"))
    if missed:
        print(f"{ap.prog}: {missed} miss the f64 product by more than {TOL}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
