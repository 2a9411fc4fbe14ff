"""The yardstick's arithmetic: published peaks of the card, the least time
of the SPD factor + solves a control step needs, and the dense work of a
whole control step. Everything is counted from shapes, never from what a
kernel does.
"""
from __future__ import annotations

# NVIDIA H100 SXM, published dense peaks at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "float64": 34e12}


def chol_solve_bytes(B: int, n: int, m: int, diag: bool, itemsize: int) -> float:
    """Bytes one batched SPD factor + solve must move: the lower triangle
    of A read once, b read and x written once, the diagonal read once."""
    return itemsize * B * (n * (n + 1) / 2 + 2 * n * m + (n if diag else 0))


def chol_solve_flops(B: int, n: int, m: int) -> float:
    """Operations of the Cholesky factor (n^3/3) and the two triangular
    solves of m columns (2 n^2 m) for each of B systems."""
    return B * (n ** 3 / 3 + 2 * n * n * m)


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the card can take: the larger of the byte and the
    operation bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def control_step_solves(B: int, nv: int, rows: int, substeps: int) -> list:
    """(B, n, m, diag) of each SPD factor + solve one uhc_pd control step
    needs: per substep the stable-PD solve (m = 1 with the diagonal shift)
    and the fused smooth + Delassus solve (m = 1 + rows)."""
    return [(B, nv, 1, True), (B, nv, 1 + rows, False)] * substeps


def control_step_solve_bound_s(B: int, nv: int, rows: int, substeps: int, dtype: str,
                               itemsize: int) -> float:
    return sum(bound_s(chol_solve_bytes(b, n, m, d, itemsize), chol_solve_flops(b, n, m), dtype)
               for b, n, m, d in control_step_solves(B, nv, rows, substeps))


def control_step_solve_flops(B: int, nv: int, rows: int, substeps: int) -> float:
    return sum(chol_solve_flops(b, n, m) for b, n, m, _ in control_step_solves(B, nv, rows, substeps))


def mass_matrix_flops(B: int, nv: int) -> float:
    """Operations of the joint-space inertia from the composite inertias:
    each of the n(n+1)/2 distinct entries is a 6-vector product (12
    operations), for each of B systems."""
    return B * 6.0 * nv * (nv + 1)


def delassus_flops(B: int, nv: int, rows: int) -> float:
    """Operations of the Delassus matrix J (M^-1 J^T) of `rows` constraint
    rows once M^-1 J^T is solved (counted with the solves): 2 rows^2 n for
    each of B systems."""
    return B * 2.0 * rows * rows * nv


def control_step_flops(B: int, nv: int, rows: int, substeps: int) -> float:
    """The dense work a uhc_pd control step needs whatever implements it,
    per substep: the inertia, the SPD factor + solves (control_step_solves)
    and the Delassus product. Kinematics, bias forces, collision, the
    QP's iterations and the elementwise work are not counted, so this is
    a lower bound of the step's operations."""
    per = mass_matrix_flops(B, nv) + delassus_flops(B, nv, rows)
    return control_step_solve_flops(B, nv, rows, substeps) + substeps * per
