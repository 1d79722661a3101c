"""Benchmark configuration: the fields of ``spgrid.core.config.BenchConfig``
that the port reads, with the same defaults and the same environment
variables."""

from __future__ import annotations

import dataclasses
import os

# Reference names honored as ``NAME`` or ``SPGRID_NAME``, as in the JAX
# package; every field is also read from ``SPGRID_<FIELD>``.
_ENV_ALIASES = {"NUM_COLS": "num_cols", "BAND_SIZE": "band_size",
                "SPARSITY": "sparsity",
                "SPARSE_ATTENTION_TYPE": "sparse_attention_type"}
TIMING_PROTOCOLS = ("graph", "eager")
DTYPES = ("float32", "bfloat16", "float64")
ORACLES = ("auto", "host", "device")
# the matmul precisions the port runs: 'auto' (the dtype's own), 'highest'
# (f32 and f64), 'high' (3-pass bf16 on f32 operands: the SDDMM kernel's
# form) and 'default' (bf16)
MATMUL_PRECISIONS = ("auto", "highest", "high", "default")


@dataclasses.dataclass
class BenchConfig:
    """Configuration of one benchmark run.

      num_cols      — dense-operand width ``n`` for SpMM/SDDMM
      dtype         — 'float32', 'bfloat16' or 'float64': the values of A
                      and X, and Y's type. bf16 rows sum in f32 and round
                      once (the hand-written kernels' bf16 forms, the torch
                      ops in f32), gated at 3e-2; f64 rows run the torch ops
                      and ``dense`` in f64 on the card, gated at 1e-10 on the
                      host. A format with no form at a dtype raises
                      (``ops.dispatch.DTYPE_FORMATS``).
      warmup_iters  — launches before the timed loop
      min_time_s    — the timed loop runs at least this long on the device
      min_iters     — and at least this many launches
      sparsity      — attention-mask density of kept entries
      band_size     — half-width of the mask's dense diagonal band
      sparse_attention_type — 'band_and_random' | 'band_and_decay'
      matmul_precision — the JAX field: 'auto' is 'highest' at f32 and
                      f64 and 'default' at bf16 (``precision``). At f32
                      'highest' is what the kernels do (3xTF32 tiles, cuBLAS
                      with TF32 off); 'high' is the TPU's 3-pass bf16 (a =
                      a_hi + a_lo, each part bf16, a_hi b_hi + a_hi b_lo +
                      a_lo b_hi summed in f32), which only the SDDMM has a
                      form at (``bsr_sddmm_bf16x3``): ``run_spmm`` and
                      ``run_pipeline`` refuse any precision but the dtype's
                      own, naming ROADMAP.md.
      seed          — seed of the host dense operand (``make_x``)
      timing_protocol — how the harness times a call on the card:
                      'graph' (calls captured in a CUDA graph and replayed,
                      so the time is the device's alone, as the JAX
                      harness's fused chained loop measures it) or 'eager'
                      (CUDA events around eager calls, so a call shorter
                      than the host's enqueue reads the enqueue). On the
                      CPU the harness times eager calls on the host clock
                      whatever this says. The JAX field's 'dynamic' and
                      'static' choose how a jitted loop counts its trips,
                      which has no counterpart on the card.
      oracle        — where a row's f64 gate runs: 'host' (the definition,
                      ``core.metrics``), 'device' (``core.device_oracle``,
                      on the result's device) or 'auto' (the device's gate
                      on the card when the (m, n) f32 result passes 32 MB,
                      the host's otherwise and on the CPU, as the JAX
                      harness places its oracle). The JAX fields
                      ``x_source`` and ``device_x``, which make X on the
                      TPU, have no counterpart: X is ``make_x``'s, made on
                      the host and uploaded once.
    """

    num_cols: int = 512
    dtype: str = "float32"

    warmup_iters: int = 10
    min_time_s: float = 0.5
    min_iters: int = 32
    timing_protocol: str = "graph"

    sparsity: float = 0.9
    band_size: int = 64
    sparse_attention_type: str = "band_and_random"

    matmul_precision: str = "auto"

    seed: int = 14
    oracle: str = "auto"

    def __post_init__(self):
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}, got "
                             f"{self.dtype!r}")
        if self.timing_protocol not in TIMING_PROTOCOLS:
            raise ValueError(f"timing_protocol must be one of "
                             f"{TIMING_PROTOCOLS}, got "
                             f"{self.timing_protocol!r}")
        if self.oracle not in ORACLES:
            raise ValueError(f"oracle must be one of {ORACLES}, got "
                             f"{self.oracle!r}")
        if self.matmul_precision not in MATMUL_PRECISIONS:
            raise ValueError(f"matmul_precision must be one of "
                             f"{MATMUL_PRECISIONS}, got "
                             f"{self.matmul_precision!r}")

    @property
    def epsilon(self) -> float:
        return {"float32": 1e-7, "float64": 1e-10, "bfloat16": 3e-2}[self.dtype]

    @property
    def precision(self) -> str:
        """The matmul precision in effect: ``matmul_precision``, or for
        'auto' the dtype's own ('default' at bf16, 'highest' otherwise)."""
        if self.matmul_precision != "auto":
            return self.matmul_precision
        return own_precision(self.dtype)

    @classmethod
    def from_env(cls, **overrides) -> "BenchConfig":
        """A config from the environment, as ``spgrid.core.config.
        BenchConfig.from_env`` reads it, then ``overrides``."""
        types = {f.name: f.type for f in dataclasses.fields(cls)}
        kwargs = {}
        for env_name, field in _ENV_ALIASES.items():
            for name in ("SPGRID_" + env_name, env_name):
                if name in os.environ:
                    kwargs[field] = os.environ[name]
                    break
        for field in types:
            if "SPGRID_" + field.upper() in os.environ:
                kwargs[field] = os.environ["SPGRID_" + field.upper()]
        kwargs = {f: _coerce(types[f], v) for f, v in kwargs.items()}
        return cls(**{**kwargs, **overrides})


def own_precision(dtype: str) -> str:
    """The precision a dtype's rows run at: 'default' at bf16, 'highest'
    at f32 and f64."""
    return "default" if dtype == "bfloat16" else "highest"


def _coerce(annotation, value: str):
    ann = str(annotation)
    if "int" in ann:
        return int(value)
    if "float" in ann:
        return float(value)
    return value
