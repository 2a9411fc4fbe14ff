"""The PPO update's host ms per iteration in its minibatch steps: every
smplsim.learning.minibatch span (one policy step and one value step)
under smplsim.learning.update, over the traced updates. Read from the
port's span table (smplsim_tpu_torch.utils.profiler), which fills while
the traced update runs under the profiler; None where the program has no
such span."""
from smplsim_tpu_torch.utils import profiler

ROOT = "smplsim.learning.update"
NAME = "smplsim.learning.minibatch"


def read(s):
    if s.get("tag") != "train":
        return None
    table = profiler.span_table() if hasattr(profiler, "span_table") else {}
    unit = table.get(ROOT)
    inside = [r["host_s"] for p, r in table.items()
              if p.startswith(ROOT + "/") and p.rsplit("/", 1)[-1] == NAME]
    if unit is None or not inside:
        return None
    return 1e3 * sum(inside) / unit["count"]
