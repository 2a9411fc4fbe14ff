"""The port pins full-float32 matrix products around its physics; the
reference leaves the precision to its caller, so that the same code runs
as the reference (float64) and as the lower-precision control (float32
with TF32 products)."""
import contextlib


@contextlib.contextmanager
def ieee_fp32():
    yield
