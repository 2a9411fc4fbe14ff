"""Smoke-run a task env with zero actions (port of examples/env_humanoid_test.py).

    python examples/env_humanoid_test_torch.py env=speed steps=100 [device=cpu]
"""
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from smplsim_tpu_torch.agents.config import RunConfig, parse_cli_overrides  # noqa: E402
from smplsim_tpu_torch.envs.tasks import TASKS  # noqa: E402
from smplsim_tpu_torch.models import registry  # noqa: E402


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kv = dict(a.split("=", 1) for a in argv if a.startswith(("steps=", "device=")))
    steps = int(kv.get("steps", 100))
    device = kv.get("device", "cuda")
    cfg = parse_cli_overrides(RunConfig(), [a for a in argv
                                            if not a.startswith(("steps=", "device="))])
    model = registry.default_humanoid(device=device)
    env = TASKS[cfg.task](model, cfg.env)
    st = env.reset(1, torch.Generator(device=device).manual_seed(cfg.seed))
    a = torch.zeros(1, env.action_size, device=device)
    total_r = torch.zeros((), dtype=model.dtype, device=device)
    t0 = time.perf_counter()
    for _ in range(steps):
        st = env.step_autoreset(st, a)
        total_r += st.reward[0]
    finite = bool(torch.isfinite(st.obs).all())    # reads the device: the steps are done
    dt = time.perf_counter() - t0
    print(f"{cfg.task}: {steps} steps, mean reward {float(total_r) / steps:.4f}, "
          f"{steps / dt:.1f} steps/s, obs finite: {finite}")


if __name__ == "__main__":
    main()
