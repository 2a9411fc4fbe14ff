"""Isaac-path throughput harness: NvHumanoid through the gym vector facade
(port of examples/nv_benchmark.py): random actions, reset and step time,
env-steps/s.

Usage: python examples/nv_benchmark_torch.py [envs=2048] [steps=16] [obs_v=1] [device=cpu]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from smplsim_tpu_torch.envs import GymVectEnv, NvConfig, NvHumanoid  # noqa: E402
from smplsim_tpu_torch.models import registry  # noqa: E402


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kv = dict(a.split("=", 1) for a in argv)
    num_envs = int(kv.get("envs", 2048))
    steps = int(kv.get("steps", 16))
    obs_v = int(kv.get("obs_v", 1))
    device = kv.get("device", "cuda")

    model = registry.default_humanoid(dtype=torch.float32, device=device)
    env = NvHumanoid(model, NvConfig(obs_v=obs_v))
    venv = GymVectEnv(env, num_envs=num_envs)

    t0 = time.perf_counter()
    obs, _ = venv.reset(seed=0)
    t_reset = time.perf_counter() - t0
    print(f"reset: {t_reset:.2f}s (includes the kernel build on a first run)  obs {obs.shape}")

    rng = np.random.default_rng(0)
    act = rng.uniform(-1, 1, (num_envs, env.action_size)).astype(np.float32)
    # warm-up step; each step returns numpy, so the device has finished it
    venv.step(act)

    t0 = time.perf_counter()
    for _ in range(steps):
        obs, rew, term, trunc, info = venv.step(act)
    dt = time.perf_counter() - t0
    sps = steps * num_envs / dt
    print(f"step avg: {dt / steps * 1e3:.1f} ms   throughput: {sps:,.0f} env-steps/s")
    print(f"reward mean {rew.mean():.3f}  terminated {term.mean():.3f}")


if __name__ == "__main__":
    main()
