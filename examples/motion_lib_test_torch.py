"""Motion-library load + playback smoke (port of examples/motion_lib_test.py).

With real AMASS data:   python examples/motion_lib_test_torch.py motion_file=path.pkl
Without (default):      synthesizes a smooth random motion and replays it.
Both take device=cpu to run on the CPU.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from smplsim_tpu_torch.envs.legacy import HumanoidPlayback  # noqa: E402
from smplsim_tpu_torch.models import registry  # noqa: E402
from smplsim_tpu_torch.motion import HumanoidBatchFK, MotionLib, MotionLibConfig  # noqa: E402


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kv = dict(a.split("=", 1) for a in argv)
    motion_file = kv.get("motion_file")
    device = kv.get("device", "cuda")
    model = registry.default_humanoid(device=device)
    fk = HumanoidBatchFK.from_robot_model(model, filter_vel=False)
    if motion_file:
        lib = MotionLib(fk, MotionLibConfig(motion_file=motion_file))
    else:
        rng = np.random.RandomState(0)
        T = 60
        pose = rng.randn(T, fk.num_joints, 3).cumsum(0) * 0.01
        trans = np.tile([0, 0, 1.0], (T, 1))
        lib = MotionLib(
            fk, MotionLibConfig(randomize_heading=False),
            motion_dict={"synthetic": {"pose_aa": pose, "trans": trans, "fps": 30.0}},
        )
    lib.load_motions()
    print(f"loaded {lib.num_current_motions()} motions, "
          f"{lib.get_total_length():.2f}s total, {lib.gts.shape[0]} frames")

    env = HumanoidPlayback(model, lib)
    st = env.reset(1, torch.Generator(device=device).manual_seed(0))
    for _ in range(20):
        st = env.step(st, torch.zeros(1, env.action_size, device=device))
    print("playback 20 frames ok; root height:", float(st.phys.qpos[0, 2]))

    state = lib.get_motion_state(torch.zeros(4, dtype=torch.int32, device=device),
                                 torch.linspace(0.0, 1.0, 4, device=device))
    print("sampled blended states:", {k: tuple(v.shape) for k, v in state.items()})


if __name__ == "__main__":
    main()
