"""Generator parameter lines: the port's own copy of ``GenParams`` and
``read_param_file`` from ``spgrid/gen/params.py``.

A line holds 11 fields: ``nr_rows nr_cols avg_nnz std_nnz distribution
placement bw skew neigh cross_row_sim seed``.
"""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class GenParams:
    """One generator invocation = one 11-field parameter line."""

    nr_rows: int
    nr_cols: int
    avg_nnz_per_row: float
    std_nnz_per_row: float
    distribution: str
    placement: str
    bw: float
    skew: float
    avg_num_neighbours: float
    cross_row_similarity: float
    seed: int

    def to_line(self) -> str:
        def num(x: float) -> str:
            return f"{x:g}"
        return " ".join([
            str(self.nr_rows), str(self.nr_cols),
            num(self.avg_nnz_per_row), num(self.std_nnz_per_row),
            self.distribution, self.placement,
            num(self.bw), num(self.skew),
            num(self.avg_num_neighbours), num(self.cross_row_similarity),
            str(self.seed),
        ])

    @classmethod
    def from_line(cls, line: str) -> "GenParams":
        p = line.split()
        if len(p) < 11:
            raise ValueError(f"expected 11 fields, got {len(p)}: {line!r}")
        return cls(
            nr_rows=int(p[0]), nr_cols=int(p[1]),
            avg_nnz_per_row=float(p[2]), std_nnz_per_row=float(p[3]),
            distribution=p[4], placement=p[5],
            bw=float(p[6]), skew=float(p[7]),
            avg_num_neighbours=float(p[8]), cross_row_similarity=float(p[9]),
            seed=int(float(p[10])),
        )

    def kwargs(self) -> dict:
        return dataclasses.asdict(self)


def read_param_file(path: str) -> List[GenParams]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                out.append(GenParams.from_line(line))
    return out
