"""Probe: the six gather forms of ``scripts/exp_lanegather.py`` through the
port's ``lanegather`` kernel, each checked against numpy.

    python -m spgrid_torch.scripts.exp_lanegather [--platform cpu]

The forms, shapes and ``default_rng(0)`` draws are the JAX probe's:
gathers along axis 1 at (8, 128), (8, 512), from an (8, 3328) source with
an (8, 128) index and at (128, 128) with one index row broadcast; a gather
along axis 0 from (512, 128) with an (8, 128) index; and a stack of 8
dynamically indexed rows, which is an axis-0 gather whose index repeats
``i[0, r]`` along row r. Each form prints ``OK`` or ``FAIL`` and then
``correct:`` (exact equality with ``np.take_along_axis``: a gather is a
copy). The exit code is 1 if any form fails or is not correct.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from spgrid_torch.ops.kernels.lanegather import lanegather
from spgrid_torch.scripts import device_of, parser


def forms(rng: np.random.Generator) -> list:
    """(name, src f32, idx int32, axis) of each form, drawn from ``rng`` in
    the JAX probe's order."""
    def normal(shape):
        return rng.standard_normal(shape).astype(np.float32)

    def ints(high, shape):
        return rng.integers(0, high, shape).astype(np.int32)

    src, idx = normal((8, 128)), ints(128, (8, 128))
    src5, idx5 = normal((8, 512)), ints(512, (8, 512))
    srcw, idxw = normal((8, 3328)), ints(3328, (8, 128))
    srcb = normal((128, 128))
    idxb = np.ascontiguousarray(
        np.broadcast_to(rng.integers(0, 128, (1, 128)), (128, 128)),
        dtype=np.int32)
    srcs, idxs = normal((512, 128)), ints(512, (8, 128))
    idxr = ints(512, (8, 128))
    rows = np.repeat(idxr[0, :8, None], 128, axis=1)
    return [
        ("take_along_axis lanes (8,128)", src, idx, 1),
        ("take_along_axis lanes (8,512)", src5, idx5, 1),
        ("take_along_axis lanes src(8,3328) idx128", srcw, idxw, 1),
        ("take_along_axis lanes (128,128) bcast idx", srcb, idxb, 1),
        ("take_along_axis sublanes src(512,128) idx(8,128)", srcs, idxs, 0),
        ("stack of 8 dynamic rows", srcs, rows, 0),
    ]


def main(argv=None) -> int:
    ap = parser("spgrid_torch.scripts.exp_lanegather",
                "gather forms through the lanegather kernel")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    device = device_of(ap.prog, args.platform)
    if device is None:
        return 1
    bad = 0
    for name, src, idx, axis in forms(np.random.default_rng(0)):
        try:
            out = lanegather(torch.from_numpy(src).to(device),
                             torch.from_numpy(idx).to(device), axis)
            got = out.cpu().numpy()
            print(f"{name:48s} OK", flush=True)
        except Exception as e:  # noqa: BLE001 - the probe reports each form
            msg = str(e).replace("\n", " ")[:150]
            print(f"{name:48s} FAIL {type(e).__name__}: {msg}", flush=True)
            bad += 1
            continue
        correct = np.array_equal(got, np.take_along_axis(src, idx, axis))
        print("   correct:", correct, flush=True)
        bad += not correct
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
