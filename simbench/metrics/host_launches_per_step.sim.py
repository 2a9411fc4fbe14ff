"""Host-side CUDA runtime and driver calls that put work on the device
(kernels/launch/*.json), per step_autoreset, in the traced units."""
from simbench import trace


def read(s):
    if s.get("tag") != "sim":
        return None
    calls = trace.select(s["runtime"], "launch")
    return sum(calls.values()) / s["units"] if calls else None
