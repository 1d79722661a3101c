"""Probe: how fast the card gathers scattered rows, and how long a chain of
dependent in-row gathers takes a step.

    python -m spgrid_torch.scripts.exp_pallas_gather [xla] [dma] [shuffle]
        [--platform cpu] [--k K] [--n N] [--steps S]

The port of ``scripts/exp_pallas_gather.py``, with its selectors (all three
when none is given), sizes and ``default_rng(0)`` draws:

- ``xla``: the library baseline, ``torch.index_select`` (the one place the
  port calls it, as the JAX probe calls ``jnp.take``), gathering 64 · S
  rows of X (K, N) f32; by default 24,576 rows of a 134 MB X, past the
  50 MB L2.
- ``dma``: the ``dma_gather`` kernel (one asynchronous copy a row into
  shared memory) at G = 64 and 256 rows a step, S steps.
- ``shuffle``: the ``shuffle_bench`` kernel, a chain of 64 and of 256
  dependent gathers plus 1.0 on a (256, 128) tile; the difference of the
  two times over the 192 extra steps is the time a step without the launch,
  printed in ns and in cycles of the SM clock that nvidia-smi reads.

Rates count 2 · rows · N · 4 bytes (each row read and written), as the JAX
probe counts them, beside the 3.35 TB/s of the H100's device memory. Each
gather is checked against ``x[idx]`` and each chain against its plain
version (exactly); the exit code is 1 if one differs.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from spgrid_torch.ops.kernels.pallas_gather import (
    LANE, dma_gather, shuffle_bench, shuffle_bench_plain,
)
from spgrid_torch.scripts import device_of, parser, sm_clock_mhz, timed

SELECTORS = ("xla", "dma", "shuffle")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
GS = (64, 256)
REPS = (64, 256)


def rate_line(label: str, t: float, spread: float, nrows: int,
              n: int) -> str:
    by = nrows * n * 4 * 2
    return (f"{label}: {t * 1e6:9.1f}us (spread {spread:.1%}) "
            f"{nrows / t / 1e6:8.1f} Mrow/s {by / t / 1e9:7.1f} GB/s "
            f"= {by / t / HBM_BYTES_PER_S:.1%} of 3.35 TB/s")


def main(argv=None) -> int:
    ap = parser("spgrid_torch.scripts.exp_pallas_gather",
                "row-gather and chained-gather probes")
    ap.add_argument("which", nargs="*", metavar="{xla,dma,shuffle}",
                    help="probes to run (default: all)")
    ap.add_argument("--k", type=int, default=65536, help="rows of X")
    ap.add_argument("--n", type=int, default=512, help="columns of X")
    ap.add_argument("--steps", type=int, default=384,
                    help="gather steps (64 rows a step for xla)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    unknown = [w for w in args.which if w not in SELECTORS]
    if unknown:
        ap.error(f"unknown probe(s) {unknown}; choose from {SELECTORS}")
    which = args.which or SELECTORS
    device = device_of(ap.prog, args.platform)
    if device is None:
        return 1

    rng = np.random.default_rng(0)
    k, n, nsteps = args.k, args.n, args.steps
    X = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)
                         ).to(device)
    bad = []

    if "xla" in which:
        nrows = 64 * nsteps
        idx = torch.from_numpy(rng.integers(0, k, nrows).astype(np.int32)
                               ).to(device)
        t, spread = timed(torch.index_select, X, 0, idx, device=device)
        print(rate_line(f"index_select {X.numel() * 4 / 1e6:.0f}MB-src", t,
                        spread, nrows, n), flush=True)

    if "dma" in which:
        for G in GS:
            idx = rng.integers(0, k, (nsteps, G)).astype(np.int32)
            pad = (-nsteps) % 8
            idx2 = torch.from_numpy(np.pad(idx, ((0, pad), (0, 0)))
                                    ).to(device)
            out = dma_gather(X, idx2, G)
            exact = torch.equal(out, X[idx2.reshape(-1).long()])
            t, spread = timed(dma_gather, X, idx2, G, device=device)
            print(rate_line(f"dma-gather G={G}", t, spread, G * nsteps, n)
                  + f" exact={exact}", flush=True)
            if not exact:
                bad.append(f"dma_gather G={G}")

    if "shuffle" in which:
        src = torch.from_numpy(rng.standard_normal((256, LANE)).astype(
            np.float32)).to(device)
        idx = torch.from_numpy(rng.integers(0, LANE, (256, LANE)).astype(
            np.int32)).to(device)
        ts = {}
        for reps in REPS:
            exact = torch.equal(shuffle_bench(src, idx, reps),
                                shuffle_bench_plain(src, idx, reps))
            ts[reps], spread = timed(shuffle_bench, src, idx, reps,
                                     device=device)
            print(f"shuffle chain reps={reps}: {ts[reps] * 1e6:9.2f}us "
                  f"(spread {spread:.1%}) exact={exact}", flush=True)
            if not exact:
                bad.append(f"shuffle_bench reps={reps}")
        per = (ts[REPS[1]] - ts[REPS[0]]) / (REPS[1] - REPS[0])
        line = f"per shuffle+add (256,128): {per * 1e9:.1f} ns"
        clock = sm_clock_mhz() if device.type == "cuda" else None
        if clock:
            line += (f" = {per * clock * 1e6:.1f} SM cycles at {clock:.0f} "
                     f"MHz (the SM clock read after the run)")
        print(line, flush=True)

    if bad:
        print(f"{ap.prog}: differs from x[idx] or the plain version: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
