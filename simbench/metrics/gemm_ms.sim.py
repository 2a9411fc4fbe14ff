"""Device ms per step_autoreset in matrix-product kernels (cuBLAS gemm and
gemv, CUTLASS: kernels/gemm/*.json), in the traced units."""
from simbench import trace


def read(s):
    if s.get("tag") != "sim":
        return None
    ops = trace.select(s["device_ops"], "gemm")
    return 1e3 * sum(v[0] for v in ops.values()) / s["units"] if ops else None
