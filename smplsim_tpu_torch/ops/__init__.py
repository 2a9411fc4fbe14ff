"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: `linalg.chol_solve` and `qp.newton_qp`."""
