"""Host ms per step_autoreset inside the reset it runs on the whole batch
(the port's span smplsim.env.step_autoreset/smplsim.env.reset, from
smplsim_tpu_torch.utils.profiler's span table, which fills while the traced
units run under the profiler). None where the program has no such span."""
from smplsim_tpu_torch.utils import profiler

ROOT = "smplsim.env.step_autoreset"


def read(s):
    if s.get("tag") != "sim":
        return None
    table = profiler.span_table() if hasattr(profiler, "span_table") else {}
    unit, reset = table.get(ROOT), table.get(ROOT + "/smplsim.env.reset")
    if unit is None or reset is None:
        return None
    return 1e3 * reset["host_s"] / unit["count"]
