"""spgrid_torch — the spgrid benchmark framework on PyTorch and CUDA (NVIDIA H100).

The JAX package ``spgrid`` stays the reference: every layout and kernel here
is held against its counterpart there on the same host data. The port
imports nothing of it and never imports JAX: it keeps its own numpy copies
of the host layer it needs (``spgrid_torch.gen``, ``.formats``, ``.io``,
``bench.schema``), which take the JAX package's ``CSRMatrix`` too.

Layer map (mirrors ``spgrid``):
    spgrid_torch.formats  — CSR/COO, BSR and the WCOO packers (numpy)
    spgrid_torch.gen      — matrix generator, masks, parameter lines (numpy)
    spgrid_torch.io       — .mtx / .smtx readers (numpy)
    spgrid_torch.core     — config, error metrics and f64 oracle, roofline,
                            CUDA-event timing
    spgrid_torch.ops      — device layouts, dense matmul, the hand-written CUDA
                            kernels (``ops.kernels``, sources in ``csrc/``),
                            the sparse-attention pipeline, dispatch, and
                            conversion from the JAX layouts
    spgrid_torch.bench    — harness (build → time → gate → row), sweep and
                            CLI (``python -m spgrid_torch.bench``), CSV
                            schema, and the headline
                            (``python -m spgrid_torch.bench.headline``)
    spgrid_torch.entry    — the flagship pipeline step

Importing the package loads nothing heavy; kernels are built with nvcc on
their first launch.
"""

__version__ = "0.1.0"
