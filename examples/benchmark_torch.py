"""Throughput benchmark across batch sizes (port of examples/benchmark.py):
HumanoidSpeed at float32, uniform random actions in [-1, 1], one warm-up
rollout (which builds the kernels on a first run), then one timed rollout.
Prints one JSON line per batch; times are taken after
torch.cuda.synchronize().

    python examples/benchmark_torch.py batches=256,1024,4096 steps=16 [device=cpu]
"""
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from smplsim_tpu_torch.envs import HumanoidSpeed  # noqa: E402
from smplsim_tpu_torch.models import registry  # noqa: E402


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bench(batch: int, steps: int, device="cuda") -> dict:
    model = registry.default_humanoid(dtype=torch.float32, device=device)
    env = HumanoidSpeed(model)
    sync(device)
    t0 = time.perf_counter()
    states = env.reset(batch, torch.Generator(device=device).manual_seed(0))
    sync(device)
    reset_time = time.perf_counter() - t0

    def rollout(states, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        for _ in range(steps):
            a = 2.0 * torch.rand((batch, env.action_size), generator=gen, device=device) - 1.0
            states = env.step_autoreset(states, a)
        return states

    states = rollout(states, 1)
    sync(device)
    t0 = time.perf_counter()
    states = rollout(states, 2)
    sync(device)
    dt = time.perf_counter() - t0
    return {
        "batch": batch,
        "reset_s": round(reset_time, 3),
        "step_ms": round(dt / steps * 1000, 2),
        "sps": round(batch * steps / dt, 1),
    }


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    batches = [256, 1024]
    steps = 8
    device = "cuda"
    for a in argv:
        if a.startswith("batches="):
            batches = [int(x) for x in a.split("=")[1].split(",")]
        if a.startswith("steps="):
            steps = int(a.split("=")[1])
        if a.startswith("device="):
            device = a.split("=")[1]
    for b in batches:
        print(json.dumps(bench(b, steps, device)))


if __name__ == "__main__":
    main()
