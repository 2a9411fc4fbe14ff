"""Offline rollout rendering (port of examples/viewer_render.py): random
actions through the speed env on the device, the episode written to an
animated GIF/MP4 by the geom-level offline renderer
(smplsim_tpu_torch/render.py, needs matplotlib and imageio: without them the
script says so and writes nothing), the same artifact
`run_policy(render_path=...)` produces after training.

    python examples/viewer_render_torch.py out.gif [--steps 90] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="rollout.gif")
    ap.add_argument("--steps", type=int, default=90)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from smplsim_tpu_torch.envs import HumanoidSpeed
    from smplsim_tpu_torch.models import registry
    from smplsim_tpu_torch.render import render_rollout

    model = registry.default_humanoid(dtype=torch.float32, device=args.device)
    env = HumanoidSpeed(model)
    state = env.reset(1, torch.Generator(device=args.device).manual_seed(0))
    rng = np.random.RandomState(0)
    traj = []
    for _ in range(args.steps):
        a = torch.as_tensor(rng.uniform(-0.3, 0.3, (1, env.action_size)),
                            dtype=torch.float32, device=args.device)
        state = env.step_autoreset(state, a)
        traj.append(state.phys.qpos[0])
    try:
        render_rollout(model, torch.stack(traj), args.out, fps=30)
    except ImportError as e:             # drawing needs matplotlib and imageio
        print(f"not drawn ({e}): {len(traj)} frames stepped on {model.device}")
        return
    print(f"wrote {args.out} ({len(traj)} frames)")


if __name__ == "__main__":
    main()
