"""The launch shape of the block kernels' shared tensor-core tile.

``bsr_spmm``, ``panel_spmm`` and ``bsr_sddmm`` run on the tile of
``spgrid_torch/csrc/block_mma.cuh``: a CTA of two warpgroups owns a tile of
outputs and multiplies in 3xTF32 on the tensor cores, a step of the
contraction at a time, through a ``cp.async`` ring. Where the grid of tiles
would leave most of the card idle, each tile's contraction is split across a
thread-block cluster of CTAs, whose partial tiles are summed in rank order
through distributed shared memory. The C side picks the cluster from the
grid and the card's SM count (``cluster_for``); ``query`` reads what it
picks, for reports and tests.
"""

from __future__ import annotations

import ctypes
import dataclasses

from spgrid_torch.ops.kernels import _build


@dataclasses.dataclass(frozen=True)
class LaunchShape:
    """A launch of the tile: ``tiles`` output tiles of ``rows`` x ``cols``,
    each computed by a cluster of ``cluster`` CTAs, ``step`` of the
    contraction a step through a ring of ``stages`` steps; ``grid``, where
    not 0, the CTAs of a persistent launch, each walking several tiles."""

    tiles: int
    cluster: int
    rows: int
    cols: int
    step: int
    stages: int
    grid: int = 0

    @property
    def ctas(self) -> int:
        return self.grid or self.tiles * self.cluster

    @property
    def persistent(self) -> bool:
        return self.ctas < self.tiles * self.cluster

    def __str__(self) -> str:
        walk = (f", persistent: {self.tiles / self.ctas:.2f} tiles a CTA"
                if self.persistent else "")
        return (f"grid={self.ctas} CTAs ({self.tiles} tiles of {self.rows}x"
                f"{self.cols} x cluster {self.cluster}{walk}) ring="
                f"{self.stages} steps of {self.step}")


def query(entry: str, kernel: str, *sizes: int) -> LaunchShape:
    """The launch that the C shape query ``entry`` reports for ``sizes`` on
    the current card."""
    shape = (ctypes.c_int * 6)()
    _build.check(getattr(_build.library(), entry)(
        *sizes, ctypes.addressof(shape)), kernel)
    return LaunchShape(*shape)
