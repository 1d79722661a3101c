"""Feature-extraction CLI of the port — the counterpart of
``python -m spgrid.features``, with the same flags and output:

    python -m spgrid_torch.features matrix.mtx [more.mtx ...] [--twin] [--values]
    python -m spgrid_torch.features --generate "<11-field param line>"
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="spgrid_torch.features")
    ap.add_argument("matrices", nargs="*", help=".mtx/.smtx paths")
    ap.add_argument("--generate", help="11-field artificial parameter line")
    ap.add_argument("--twin", action="store_true",
                    help="also print the twin-parameter line")
    ap.add_argument("--values", action="store_true",
                    help="also print value-distribution features")
    ap.add_argument("--json", action="store_true", help="JSON output")
    args = ap.parse_args(argv)

    from spgrid_torch.features import (
        matrix_features, twin_params, value_features,
    )

    csrs = []
    if args.generate:
        from spgrid_torch.gen import GenParams, artificial_matrix_generation
        csrs.append(artificial_matrix_generation(
            **GenParams.from_line(args.generate).kwargs()))
    if args.matrices:
        from spgrid_torch.io import read_matrix
        csrs.extend(read_matrix(p) for p in args.matrices)
    if not csrs:
        ap.error("need matrix paths or --generate")

    for csr in csrs:
        f = matrix_features(csr)
        if args.json:
            row = f.as_row()
            if args.values:
                row["values"] = value_features(csr.values).as_row()
            if args.twin:
                row["twin"] = twin_params(csr)
            print(json.dumps(row))
        else:
            for k, v in f.as_row().items():
                print(f"{k}: {v}")
            if args.values:
                for k, v in value_features(csr.values).as_row().items():
                    print(f"value_{k}: {v}")
            if args.twin:
                print(f"twin: {twin_params(csr)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
