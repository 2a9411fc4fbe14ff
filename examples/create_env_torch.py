"""Create and step the legacy dm-control-style locomotion env (port of
examples/create_env.py): HumanoidMove (180 Hz physics / 30 Hz control,
dm_control tolerance-shaped reward) stepped as one batch, with an optional
offline GIF of env 0.

    python examples/create_env_torch.py [--envs 16] [--steps 50] [--gif out.gif] [--device cpu]
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=16)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--move-speed", type=float, default=0.0)
    ap.add_argument("--gif", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from smplsim_tpu_torch.envs import HumanoidMove, MoveConfig
    from smplsim_tpu_torch.models import registry

    model = registry.default_humanoid(dtype=torch.float32, device=args.device)
    # the legacy dm-style path runs 180 Hz physics / 30 Hz control;
    # retime the baked 450 Hz model accordingly
    model = dataclasses.replace(model, timestep=torch.full_like(model.timestep, 1.0 / 180.0))
    env = HumanoidMove(model, MoveConfig(move_speed=args.move_speed))
    print(f"obs size: {env.obs_size}  action size: {env.action_size}")

    states = env.reset(args.envs, torch.Generator(device=args.device).manual_seed(0))
    qpos_hist = []
    rng = np.random.RandomState(0)
    for t in range(args.steps):
        a = torch.as_tensor(rng.uniform(-0.3, 0.3, (args.envs, env.action_size)),
                            dtype=torch.float32, device=args.device)
        states = env.step_autoreset(states, a)
        qpos_hist.append(states.phys.qpos[0])
        if t % 10 == 0:
            print(f"t={t:3d} reward mean={float(states.reward.mean()):.3f} "
                  f"done={int(states.done.sum())}")

    if args.gif:
        from smplsim_tpu_torch.render import render_rollout

        render_rollout(model, torch.stack(qpos_hist), args.gif, fps=30)
        print(f"wrote {args.gif}")


if __name__ == "__main__":
    main()
