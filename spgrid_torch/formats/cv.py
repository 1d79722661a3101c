"""Compressed-value (CV) sparse matrices: CSR whose values are stored as
bf16, or as int8 with one f32 scale a row (absmax / 127).

The port's own copy of ``spgrid/formats/cv.py`` (pinned to it by
``tests/test_torch_hostcopy.py``), with one difference: numpy has no bf16
type without ``ml_dtypes``, which the machine with the card lacks, so bf16
values are held as their 16-bit patterns (``np.uint16``), rounded from f32
by torch (to nearest, ties to even, as ``ml_dtypes`` rounds:
``formats.csr.bf16_bits``, which a bf16 ``CSRMatrix`` shares).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from spgrid_torch.formats.csr import CSRMatrix, bf16_bits, bf16_values

MODES = ("bf16", "int8")


@dataclasses.dataclass
class CVMatrix:
    """CSR with compressed values.

    ``qvalues`` holds bf16 bit patterns (mode 'bf16', ``np.uint16``) or
    int8 quantized values (mode 'int8'); ``scales`` holds one f32 per row
    (absmax/127), empty for bf16. ``mem_footprint`` counts the compressed
    value bytes, the indices, the row pointer and the scales.
    """

    row_ptr: np.ndarray    # (m+1,) int32
    col_idx: np.ndarray    # (nnz,) int32
    qvalues: np.ndarray    # (nnz,) uint16 (bf16 bits) | int8
    scales: np.ndarray     # (m,) float32 (int8 mode; empty for bf16)
    shape: Tuple[int, int]
    mode: str
    name: str = "cv"

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def k(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.row_ptr[-1])

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    @property
    def mem_footprint(self) -> int:
        ib = self.col_idx.dtype.itemsize
        vb = self.qvalues.dtype.itemsize
        return (self.nnz * (vb + ib) + (self.m + 1) * ib
                + self.scales.nbytes)


def csr_to_cv(csr: CSRMatrix, mode: str = "int8") -> CVMatrix:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    vals = csr.values.astype(np.float32)
    if mode == "bf16":
        q = bf16_bits(vals)
        scales = np.zeros(0, dtype=np.float32)
    else:
        absmax = np.zeros(csr.m, dtype=np.float32)
        rows = np.repeat(np.arange(csr.m), csr.degrees)
        np.maximum.at(absmax, rows, np.abs(vals))
        scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.rint(vals / scales[rows]), -127, 127).astype(np.int8)
    return CVMatrix(csr.row_ptr.copy(), csr.col_idx.copy(), q, scales,
                    csr.shape, mode, csr.name)


def cv_to_csr(cv: CVMatrix) -> CSRMatrix:
    """Dequantize back to f32 CSR (lossy round-trip)."""
    if cv.mode == "bf16":
        vals = bf16_values(cv.qvalues)
    else:
        rows = np.repeat(np.arange(cv.m), cv.degrees)
        vals = cv.qvalues.astype(np.float32) * cv.scales[rows]
    return CSRMatrix(cv.row_ptr.copy(), cv.col_idx.copy(), vals, cv.shape,
                     cv.name)
