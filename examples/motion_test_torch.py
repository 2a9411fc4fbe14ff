"""Kinematic motion playback through the env (port of examples/motion_test.py).

A short synthetic clip (a squat + arm swing; AMASS data is licensed and not
bundled) replayed through HumanoidPlayback: each env step teleports to the
next frame. Optionally renders an offline GIF.

    python examples/motion_test_torch.py [--gif motion.gif] [--frames 60] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def synthetic_clip(model, T=60, fps=30.0):
    """qpos/qvel arrays for a squat + arm-swing clip (no licensed data)."""
    nq, nv = model.nq, model.nv
    t = np.linspace(0, 2 * np.pi, T)
    qpos = np.tile(model.qpos0.detach().cpu().numpy(), (T, 1))
    qpos[:, 2] = 0.92 - 0.12 * (1 - np.cos(t)) / 2          # squat
    names = list(model.body_names)
    for side in ("L", "R"):
        b = names.index(f"{side}_Shoulder")
        dof = 6 + 3 * (b - 1)
        qpos[:, 1 + dof] = 0.8 * np.sin(t) * (1 if side == "L" else -1)
    qvel = np.zeros((T, nv))
    qvel[1:, :3] = (qpos[1:, :3] - qpos[:-1, :3]) * fps
    return qpos, qvel


class ClipLib:
    """Minimal motion-lib shim: HumanoidPlayback reads qpos, qvel,
    length_starts, the frame counts and the clip count."""

    def __init__(self, qpos, qvel, device):
        self.qpos = torch.as_tensor(qpos, dtype=torch.float32, device=device)
        self.qvel = torch.as_tensor(qvel, dtype=torch.float32, device=device)
        self.length_starts = torch.zeros(1, dtype=torch.int32, device=device)
        self._motion_num_frames = torch.tensor([qpos.shape[0]], dtype=torch.int32,
                                               device=device)

    def num_current_motions(self):
        return 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gif", default=None)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from smplsim_tpu_torch.envs.legacy import HumanoidPlayback
    from smplsim_tpu_torch.models import registry

    model = registry.default_humanoid(dtype=torch.float32, device=args.device)
    qpos, qvel = synthetic_clip(model, args.frames)

    env = HumanoidPlayback(model, ClipLib(qpos, qvel, args.device))
    state = env.reset(1, torch.Generator(device=args.device).manual_seed(0))
    zeros = torch.zeros(1, env.action_size, device=args.device)
    frames = []
    for t in range(args.frames):
        state = env.step(state, zeros)
        frames.append(state.phys.qpos[0])
        if t % 15 == 0:
            print(f"frame {t:3d}: root z={float(state.phys.qpos[0, 2]):.3f}")
    print(f"played {len(frames)} frames through HumanoidPlayback")

    if args.gif:
        from smplsim_tpu_torch.render import render_rollout

        render_rollout(model, torch.stack(frames), args.gif, fps=30)
        print(f"wrote {args.gif}")


if __name__ == "__main__":
    main()
