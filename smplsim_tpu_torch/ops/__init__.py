"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: `linalg.chol_solve`, `cho_factor_solve`, `solve_lower` and
`cholesky`, and `qp.newton_qp` (with its differentiable `qp.newton_qp_ad`)."""
