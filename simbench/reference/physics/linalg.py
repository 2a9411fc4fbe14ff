"""The physics' linear algebra with the plain forms in place of the
kernels and of their derivative rules (the reference takes no derivative)."""
from simbench.reference.ops.linalg import (cho_factor_solve, cho_solve, cholesky,  # noqa: F401
                                           tri_solve_lower)
