"""spgrid_torch — the spgrid benchmark framework on PyTorch and CUDA (NVIDIA H100).

The JAX package ``spgrid`` stays the reference: every layout and kernel here
is held against its counterpart there on the same host data. The port shares
spgrid's numpy host layer (``spgrid.gen``, ``spgrid.formats``), which imports
without JAX, and never imports JAX itself.

Layer map (mirrors ``spgrid``):
    spgrid_torch.core     — config, error metrics and f64 oracle, roofline,
                            CUDA-event timing
    spgrid_torch.ops      — device layouts, dense matmul, the hand-written CUDA
                            kernels (``ops.kernels``, sources in ``csrc/``),
                            the sparse-attention pipeline, dispatch, and
                            conversion from the JAX layouts
    spgrid_torch.bench    — harness (build → time → gate → row) and the
                            headline (``python -m spgrid_torch.bench.headline``)
    spgrid_torch.entry    — the flagship pipeline step

Importing the package loads nothing heavy; kernels are built with nvcc on
their first launch.
"""

__version__ = "0.1.0"
