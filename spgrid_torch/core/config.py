"""Benchmark configuration: the fields of ``spgrid.core.config.BenchConfig``
that the port reads, with the same defaults."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class BenchConfig:
    """Configuration of one benchmark run.

      num_cols      — dense-operand width ``n`` for SpMM/SDDMM
      dtype         — 'float32' (the port's kernels are f32 only so far)
      warmup_iters  — launches before the timed loop
      min_time_s    — the timed loop runs at least this long on the device
      min_iters     — and at least this many launches
      sparsity      — attention-mask density of kept entries
      band_size     — half-width of the mask's dense diagonal band
      sparse_attention_type — 'band_and_random' | 'band_and_decay'
      seed          — seed of the host dense operand (``make_x``)
    """

    num_cols: int = 512
    dtype: str = "float32"

    warmup_iters: int = 10
    min_time_s: float = 0.5
    min_iters: int = 32

    sparsity: float = 0.9
    band_size: int = 64
    sparse_attention_type: str = "band_and_random"

    seed: int = 14

    @property
    def epsilon(self) -> float:
        return {"float32": 1e-7, "float64": 1e-10, "bfloat16": 3e-2}[self.dtype]
