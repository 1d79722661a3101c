"""Host formats (numpy): the port's own copies of the JAX package's CSR, BSR,
WCOO, SELL-C-sigma, ELL, CSC, LDU and compressed-value packers."""
