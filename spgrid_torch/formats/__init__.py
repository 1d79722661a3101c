"""Host formats (numpy): the port's own copies of the JAX package's CSR, BSR,
WCOO and SELL-C-sigma packers."""
