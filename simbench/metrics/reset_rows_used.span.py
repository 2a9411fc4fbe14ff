"""Share (%) of the rows a step_autoreset's reset computes that it keeps:
the port's counters env.rows_finished (rows done at the step) over
env.rows_reset (rows the reset computed), over the traced units. None where
the program has no such counters or no smplsim.env.step_autoreset span."""
from smplsim_tpu_torch.utils import profiler

ROOT = "smplsim.env.step_autoreset"


def read(s):
    if s.get("tag") != "sim" or not hasattr(profiler, "span_table"):
        return None
    c = profiler.counters()
    if ROOT not in profiler.span_table() or not c.get("env.rows_reset") \
            or "env.rows_finished" not in c:
        return None
    return 100.0 * c["env.rows_finished"] / c["env.rows_reset"]
