"""The contact solver's host ms per step_autoreset: every
smplsim.physics.solve span (the row selection, Kernel A, the Delassus
product, Kernel B and the scatter) under smplsim.env.step_autoreset. Read
from the port's span table (smplsim_tpu_torch.utils.profiler), which fills
while the traced units run under the profiler; None where the program has
no such span."""
from smplsim_tpu_torch.utils import profiler

ROOT = "smplsim.env.step_autoreset"
NAME = "smplsim.physics.solve"


def read(s):
    if s.get("tag") != "sim":
        return None
    table = profiler.span_table() if hasattr(profiler, "span_table") else {}
    unit = table.get(ROOT)
    inside = [r["host_s"] for p, r in table.items()
              if p.startswith(ROOT + "/") and p.rsplit("/", 1)[-1] == NAME
              and NAME not in p.split("/")[:-1]]
    if unit is None or not inside:
        return None
    return 1e3 * sum(inside) / unit["count"]
