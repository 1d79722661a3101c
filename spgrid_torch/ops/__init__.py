"""Sparse operators of the port: layouts, dense matmul, the CUDA kernels
(``ops.kernels``), the attention pipeline, dispatch and conversion."""
