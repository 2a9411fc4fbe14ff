"""Robot configuration (port of the RobotConfig dataclass of
smplsim_tpu/models/builder.py). The builder itself, which makes a model
from an SMPL body, is not ported yet: the port loads the baked humanoid
(models/registry.py)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RobotConfig:
    """Mirrors the reference robot_cfg (humanoid_env.py:221-239 +
    data/cfg/robot/smpl_humanoid.yaml)."""

    model: str = "smpl"
    mesh: bool = False
    upright_start: bool = False
    rel_joint_lm: bool = False       # has_jt_limit
    remove_toe: bool = False
    freeze_hand: bool = False
    real_weight: bool = True
    real_weight_porpotion_capsules: bool = True
    real_weight_porpotion_boxes: bool = True
    big_ankle: bool = True
    box_body: bool = True
    replace_feet: bool = True
    create_vel_sensors: bool = False
    sim_timestep_inv: int = 450
