"""Probe: where the time of a WROW SpMV group goes on the card.

    python -m spgrid_torch.scripts.exp_spmv_ablate [m avg bw]
        [--platform cpu]

The port of ``scripts/exp_spmv_ablate.py``, on the same matrix
(``artificial_matrix_generation(m, m, avg, avg / 3, "normal", seed=14,
placement="random", bw=bw)``, by default 100000 20 0.05) and the same x
(``default_rng(0).standard_normal(m)``). It prints the WROW layout and the
production ``wrow_spmv`` (v1) against the host f64 product, as
``max |y - gold| / max |gold|``, then one line a variant of the
``spmv_ablate`` kernel, each WROW v1's own row walk (its row-ordered
live-slot stream, ``csrc/wrow_rows.cuh``) with one stage deleted: its time,
its rate on 2 · nnz flops and its time a group of the padded layout.

    full      v1's kernel: the stream, the staged x gather, FMA, y write
    nogather  x read at 128 w + t, not at the slot's column
    noload    x read at 128 r + c: 1,024 fixed entries, no x traffic
    normw     every block's sum added to y[0:128] (v1 writes y once)
    empty     the values summed: streaming the slots and nothing else

``full`` less ``noload`` is the time v1 spends gathering x.

The exit code is 1 if v1 misses the f64 product by 1e-4 or more.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from spgrid_torch.core.metrics import gold_spmm_fast
from spgrid_torch.gen import artificial_matrix_generation
from spgrid_torch.ops.kernels.spmv_ablate import VARIANTS, spmv_ablate
from spgrid_torch.ops.kernels.wrow_spmv import DeviceWROW, wrow_spmv
from spgrid_torch.scripts import device_of, parser, timed


def ablate_matrix(m: int, avg: float, bw: float):
    """The probe's m x m matrix: ``avg`` nnz a row (std avg / 3), random
    placement in a band of ``bw``, seed 14."""
    return artificial_matrix_generation(m, m, avg, avg / 3, "normal",
                                        seed=14, placement="random", bw=bw)


def main(argv=None) -> int:
    ap = parser("spgrid_torch.scripts.exp_spmv_ablate",
                "WROW SpMV group-body ablation")
    ap.add_argument("m", nargs="?", type=int, default=100000)
    ap.add_argument("avg", nargs="?", type=float, default=20.0)
    ap.add_argument("bw", nargs="?", type=float, default=0.05)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    device = device_of(ap.prog, args.platform)
    if device is None:
        return 1
    m = args.m
    csr = ablate_matrix(m, args.avg, args.bw)
    a = DeviceWROW.from_csr(csr, device=device)
    x = np.random.default_rng(0).standard_normal(m).astype(np.float32)
    xd = torch.from_numpy(x).to(device)
    y = wrow_spmv(a, xd).cpu().numpy()
    gold = gold_spmm_fast(csr.row_ptr, csr.col_idx, csr.values, x)
    err = np.abs(y - gold).max() / max(np.abs(gold).max(), 1e-30)
    flops = 2.0 * csr.nnz
    G = a.num_groups
    print(f"m={m} nnz={csr.nnz} groups={G} util={a.utilization:.3f} "
          f"max_rel~{err:.1e}", flush=True)
    for variant in VARIANTS:
        t, spread = timed(spmv_ablate, a, xd, variant, device=device)
        print(f"{variant:9s} {t * 1e6:9.1f}us  {flops / t / 1e9:7.1f} GF  "
              f"{t / G * 1e9:6.2f} ns/group  (spread {spread:.1%})",
              flush=True)
    if not (np.isfinite(y).all() and err < 1e-4):
        print(f"{ap.prog}: wrow_spmv misses the f64 product by {err:.1e}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
