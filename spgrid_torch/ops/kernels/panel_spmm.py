"""Vertical-panel SpMM: Y = A @ X with A in DevicePanels layout.

Counterpart of ``spgrid/ops/pallas/panel_spmm.py``; the CUDA kernels are
``spgrid_torch/csrc/panel_spmm.cu``'s two forms: f32 panels (``panel_pallas``)
and bf16 panels (``cv_panel``: ``DevicePanels.as_bf16``, bf16 panels times
X rounded to bf16, f32 sums, as the Pallas kernel multiplies bf16 panels at
precision "default"). ``panel_spmm`` launches the form its panels take for
CUDA tensors (``panel_spmm_bf16`` counts the bf16 form's launches) and
takes ``panel_spmm_plain`` only for CPU tensors.

The kernel runs the tensor-core tile of ``csrc/block_mma.cuh`` as
``bsr_spmm`` does, a band being a row of blocks whose blocks are its panel
slots: one tile a (band, 128-row slice of it, 64 columns of X), its
contraction (the band's real panels, 32 columns a step) split across a
cluster where the tiles alone would leave the card idle (``launch_grid``
reports the launch). The bf16 form walks and launches the same way, with
one mma.sync bf16 product a step in place of three TF32 ones.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from spgrid_torch.formats.csr import CSRMatrix
from spgrid_torch.ops.kernels import _build, check_operands
from spgrid_torch.ops.dense import full_f32
from spgrid_torch.ops.kernels.block_mma import LaunchShape, query
from spgrid_torch.ops.layouts import round_up


def panel_arrays(csr: CSRMatrix, bk: int = 128, band_rows: int = 2048,
                 max_bytes: int = 4 << 30):
    """Host arrays of the panel layout, as ``spgrid.ops.pallas.panel_spmm.
    DevicePanels.from_csr`` builds them: (block_cols, panels, counts,
    num_panels, R, bands, max_p). ``counts[band]`` is the band's number of
    real panels; its slots past that are pad slots."""
    m, k = csr.shape
    R = min(band_rows, round_up(max(m, 8), 8))
    bands = -(-m // R)
    kb = -(-k // bk)
    rows = np.repeat(np.arange(m, dtype=np.int64), csr.degrees)
    cols = csr.col_idx.astype(np.int64)
    key = (rows // R) * kb + cols // bk
    uniq, inv = np.unique(key, return_inverse=True)
    num_panels = len(uniq)
    est = num_panels * R * bk * csr.values.dtype.itemsize
    if est > max_bytes:
        raise ValueError(
            f"panels would need ~{est/2**30:.1f} GiB "
            f"({num_panels} nonempty (R={R}, bk={bk}) panels); "
            f"matrix too scattered for the panel layout")
    u_band = uniq // kb
    u_col = (uniq % kb).astype(np.int32)
    counts = np.bincount(u_band, minlength=bands)
    max_p = max(int(counts.max(initial=1)), 1)
    starts = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(num_panels) - starts[u_band] + u_band * max_p

    pcols = np.zeros(bands * max_p, dtype=np.int32)
    panels = np.zeros((bands * max_p, R, bk), dtype=csr.values.dtype)
    pcols[slot] = u_col
    panels[slot[inv], rows % R, cols % bk] = csr.values
    # pad slots repeat the band's last real column
    for b in range(bands):
        s, e = starts[b], starts[b + 1]
        last = int(u_col[e - 1]) if e > s else 0
        pcols[b * max_p + (e - s): (b + 1) * max_p] = last
    return (pcols, panels, counts.astype(np.int32), num_panels, R, bands,
            max_p)


@dataclasses.dataclass
class DevicePanels:
    """Nonempty (band, block-col) vertical panels, band-major col-sorted.

    Bands are padded to ``max_p`` panel slots; pad slots repeat the previous
    slot's column and hold zero panels. ``counts`` holds each band's number
    of real panels, so the kernel skips the pad slots."""

    block_cols: torch.Tensor    # (bands*max_p,) int32
    panels: torch.Tensor        # (bands*max_p, R, bk)
    counts: torch.Tensor        # (bands,) int32
    shape: Tuple[int, int]
    nnz: int
    num_panels: int             # true panel count
    band_rows: int              # R
    bands: int
    max_p: int

    @property
    def bk(self) -> int:
        return self.panels.shape[2]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.block_cols, self.panels, self.counts))

    def as_bf16(self) -> "DevicePanels":
        """The same layout with its panels rounded to bf16 (to nearest, ties
        to even: ``cv_panel``'s panels)."""
        return dataclasses.replace(self, panels=self.panels.to(
            torch.bfloat16))

    @classmethod
    def from_csr(cls, csr: CSRMatrix, bk: int = 128, band_rows: int = 2048,
                 max_bytes: int = 4 << 30, *, device) -> "DevicePanels":
        pcols, panels, counts, num_panels, R, bands, max_p = panel_arrays(
            csr, bk, band_rows, max_bytes)
        return cls(
            block_cols=torch.from_numpy(pcols).to(device),
            panels=torch.from_numpy(panels).to(device),
            counts=torch.from_numpy(counts).to(device),
            shape=csr.shape, nnz=csr.nnz, num_panels=num_panels,
            band_rows=R, bands=bands, max_p=max_p)


def _check(a: DevicePanels, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] != a.shape[1]:
        raise ValueError(f"x must be ({a.shape[1]}, n), got {tuple(x.shape)}")
    if a.panels.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"panel_spmm: panels must be f32 or bf16, got "
                        f"{a.panels.dtype}")
    check_operands("panel_spmm", x.device, x=(x, torch.float32),
                   panels=(a.panels, a.panels.dtype),
                   block_cols=(a.block_cols, torch.int32),
                   counts=(a.counts, torch.int32))


def launch_grid(a: DevicePanels, n: int) -> LaunchShape:
    """The kernel's launch for ``a`` at n columns of X on the card ``a`` lies
    on, as ``spgrid_panel_spmm`` makes it (the cluster depends on the card's
    SM count)."""
    with torch.cuda.device(a.panels.device):
        return query("spgrid_panel_spmm_shape", "panel_spmm", a.bands,
                     a.band_rows, n)


def launch(a: DevicePanels, x: torch.Tensor, y: torch.Tensor,
           cluster: int = 0) -> None:
    """One launch of the form ``a``'s panels take into ``y`` (m, n) at a
    given cluster (0: the launch rule), uncounted: for sweeps and tests."""
    m, k = a.shape
    n = x.shape[1]
    entry = ("spgrid_panel_spmm_bf16" if a.panels.dtype == torch.bfloat16
             else "spgrid_panel_spmm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(_build.library(), entry)(
            a.counts.data_ptr(), a.block_cols.data_ptr(),
            a.panels.data_ptr(), x.data_ptr(), y.data_ptr(),
            a.bands, a.max_p, a.band_rows, a.bk, m, k, n, cluster, stream)
    _build.check(code, entry[len("spgrid_"):])


def panel_spmm(a: DevicePanels, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) f32 = A @ X for f32 X (k, n); bf16 panels go to
    ``panel_spmm_bf16``."""
    _check(a, x)
    if a.panels.dtype == torch.bfloat16:
        return panel_spmm_bf16(a, x)
    if x.device.type == "cpu":
        return panel_spmm_plain(a, x)
    if x.device.type != "cuda":
        raise ValueError(f"panel_spmm: no kernel for device {x.device}")
    y = torch.empty((a.shape[0], x.shape[1]), dtype=torch.float32,
                    device=x.device)
    if y.numel() == 0:
        return y
    launch(a, x, y)
    panel_spmm.launches += 1
    return y


panel_spmm.launches = 0


def panel_spmm_bf16(a: DevicePanels, x: torch.Tensor) -> torch.Tensor:
    """Y (m, n) f32 = A @ round_bf16(X) for bf16 panels and f32 X (k, n):
    the bf16 form's kernel (``cv_panel``)."""
    _check(a, x)
    if a.panels.dtype != torch.bfloat16:
        raise TypeError("panel_spmm_bf16: panels must be bf16 "
                        "(DevicePanels.as_bf16)")
    if x.device.type == "cpu":
        return panel_spmm_plain(a, x)
    if x.device.type != "cuda":
        raise ValueError(f"panel_spmm_bf16: no kernel for device {x.device}")
    y = torch.empty((a.shape[0], x.shape[1]), dtype=torch.float32,
                    device=x.device)
    if y.numel() == 0:
        return y
    launch(a, x, y)
    panel_spmm_bf16.launches += 1
    return y


panel_spmm_bf16.launches = 0


def panel_spmm_plain(a: DevicePanels, x: torch.Tensor) -> torch.Tensor:
    """The same product in plain torch, in x's dtype (TF32 off): gather the
    X tile of every slot, one batched matmul over the slots, ``index_add_``
    into the bands (pad slots add zero panels). For bf16 panels X is
    rounded to bf16 first, and both are widened to x's dtype."""
    full_f32()
    m, k = a.shape
    n = x.shape[1]
    bk, R = a.bk, a.band_rows
    kb = -(-k // bk)
    xp = torch.zeros((kb * bk, n), dtype=x.dtype, device=x.device)
    xp[:k] = (x.to(torch.bfloat16).to(x.dtype)
              if a.panels.dtype == torch.bfloat16 else x)
    xt = xp.view(kb, bk, n)[a.block_cols.long()]              # (S, bk, n)
    prod = torch.bmm(a.panels.to(x.dtype), xt)                # (S, R, n)
    band = torch.arange(a.bands, device=x.device).repeat_interleave(a.max_p)
    out = torch.zeros((a.bands, R, n), dtype=x.dtype, device=x.device)
    out.index_add_(0, band, prod)
    return out.reshape(a.bands * R, n)[:m]
