"""Render a motion as a skeleton animation (port of examples/vis_motion.py).

Without AMASS data this plays the baked humanoid's kinematic tree through a
procedural walk-like pose sweep; with a motion pkl it renders the clip. The
poses are computed on the device; the drawing needs matplotlib and imageio
(without them the script says so and writes nothing).

Usage:
    python examples/vis_motion_torch.py [motion=path/to/clip.pkl] [out=motion.gif] [device=cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from smplsim_tpu_torch import transforms as Tr  # noqa: E402
from smplsim_tpu_torch.models import registry  # noqa: E402
from smplsim_tpu_torch.poselib import SkeletonMotion, SkeletonTree  # noqa: E402
from smplsim_tpu_torch.poselib.visualization import (  # noqa: E402
    animate_skeleton_motion,
    plot_skeleton_motion_frames,
)


def procedural_motion(tree: SkeletonTree, T=60, fps=30, device="cuda"):
    """Sinusoidal hip/knee swing on the baked skeleton, float64."""
    J = len(tree)
    t = np.linspace(0, 2 * np.pi, T)
    aa = np.zeros((T, J, 3))
    for name, axis, amp, phase in [
        ("L_Hip", 0, 0.6, 0.0), ("R_Hip", 0, 0.6, np.pi),
        ("L_Knee", 0, 0.8, np.pi / 2), ("R_Knee", 0, 0.8, 3 * np.pi / 2),
        ("L_Shoulder", 2, 0.4, np.pi), ("R_Shoulder", 2, 0.4, 0.0),
    ]:
        if name in tree:
            aa[:, tree.index(name), axis] = amp * np.sin(t + phase)
    quat = Tr.exp_map_to_quat(torch.as_tensor(aa, device=device))
    # stand the (non-upright-built) SMPL body up: root = the base rotation
    base = torch.full((4,), 0.5, dtype=torch.float64, device=device)
    quat[:, 0] = Tr.quat_mul(base, quat[:, 0])
    root_t = torch.zeros((T, 3), dtype=torch.float64, device=device)
    root_t[:, 2] = 0.95
    return SkeletonMotion(tree, quat, root_t, fps=fps)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kv = dict(a.split("=", 1) for a in argv)
    out = kv.get("out", "motion.gif")
    device = kv.get("device", "cuda")

    model = registry.default_humanoid(dtype=torch.float64, device=device)
    tree = SkeletonTree.from_robot_model(model)

    if "motion" in kv:
        import joblib

        from smplsim_tpu_torch.motion.joint_names import smpl_to_mujoco_perm

        data = joblib.load(kv["motion"])
        clip = data[next(iter(data))] if isinstance(data, dict) else data
        aa = np.asarray(clip["pose_aa"]).reshape(-1, 24, 3)
        quat = Tr.exp_map_to_quat(torch.as_tensor(aa, device=device))
        # SMPL order -> tree (mujoco) order
        quat = quat[:, np.asarray(smpl_to_mujoco_perm("smpl"))]
        motion = SkeletonMotion(
            tree, quat, torch.as_tensor(np.asarray(clip["trans"]), device=device),
            fps=int(clip.get("fps", 30)))
    else:
        motion = procedural_motion(tree, device=device)

    grid = out.rsplit(".", 1)[0] + "_frames.png"
    try:
        plot_skeleton_motion_frames(motion, path=grid)
    except ImportError as e:             # drawing needs matplotlib and imageio
        print(f"not drawn ({e}): {motion.local_rotation.shape[0]} frames computed on "
              f"{motion.local_rotation.device}")
        return
    print(f"wrote {grid}")
    animate_skeleton_motion(motion, out, stride=2)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
