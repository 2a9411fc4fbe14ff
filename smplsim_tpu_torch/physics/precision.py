"""Full-float32 matrix products for the physics and the motion math.

The JAX package sets `jax_default_matmul_precision="float32"` at import, so
that its small dense contractions (the CRBA, the contact Jacobians, the
Delassus operator, the motion FK) are never truncated. PyTorch's switch is
process-wide: a trainer that calls `torch.set_float32_matmul_precision("high")`
or sets `torch.backends.cuda.matmul.fp32_precision = "tf32"` for its nets
would also move every cuBLAS product of the physics to TF32. So the port
pins the precision where its physics and motion math run, and nowhere else:
the nets (learning/nets.py) follow the caller's setting.

    @ieee_fp32()
    def control_step(...): ...

    with ieee_fp32():
        ...

The pin reads, sets and restores through one API, the per-backend
`fp32_precision` of the matrix products (cuBLAS and oneDNN): "ieee" inside,
the caller's values back on exit, also when the body raises. The legacy
getter `torch.get_float32_matmul_precision()` raises once the process has
used that API, so the pin never calls it; the setting it reads is left as
the caller made it.
"""
from __future__ import annotations

import contextlib

import torch


def _matmul_backends() -> tuple:
    return (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)


@contextlib.contextmanager
def ieee_fp32():
    """Run the block (or the decorated function) with full-float32 matrix
    products, then restore the caller's setting."""
    backends = _matmul_backends()
    prev = [b.fp32_precision for b in backends]
    for b in backends:
        b.fp32_precision = "ieee"
    try:
        yield
    finally:
        for b, p in zip(backends, prev):
            b.fp32_precision = p
