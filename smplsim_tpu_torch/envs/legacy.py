"""The dm-control-style locomotion task, batched (port of
smplsim_tpu/envs/legacy.py's HumanoidMove).

The reference's third env generation runs at 180 Hz physics and 30 Hz
control (6 substeps per control step). Its reward composes dm_control
`tolerance` terms: the head's height (standing), the chest's uprightness,
a small-control term and the chest subtree's centre-of-mass velocity
(stay still at move_speed 0, else move at least move_speed). The model's
timestep must be 1/sim_timestep_inv, as for every env.

The motion playback env (HumanoidPlayback) needs the motion library and is
not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smplsim_tpu_torch.envs.base import EnvConfig, HumanoidEnv
from smplsim_tpu_torch.physics import kinematics
from smplsim_tpu_torch.physics.algebra import cross
from smplsim_tpu_torch.physics.topology import tree_masks
from smplsim_tpu_torch.utils.tolerance import tolerance


@dataclasses.dataclass(frozen=True)
class MoveConfig(EnvConfig):
    """180 Hz physics, 6 substeps: 30 Hz control."""

    sim_timestep_inv: int = 180
    control_frequency_inv: int = 6
    move_speed: float = 0.0
    stand_height_frac: float = 0.86
    full_height: float = 1.66         # mean-neutral body height


class HumanoidMove(HumanoidEnv):
    """Stand, or walk at move_speed, under the shaped reward."""

    def __init__(self, model, config: MoveConfig | None = None, **qp):
        super().__init__(model, config or MoveConfig(), **qp)
        self._head = model.body_names.index("Head")
        self._chest = model.body_names.index("Chest")
        desc = np.asarray(tree_masks(model.parents)["subtree_body"], dtype=np.float64)
        m = model.body_mass.detach().cpu().numpy().astype(np.float64)
        sub = desc[self._chest] * m        # (J,) or (N,J) for a stacked model
        self._chest_subtree_w = torch.as_tensor(sub / sub.sum(-1, keepdims=True),
                                                dtype=model.dtype, device=model.device)

    def reward(self, task, phys, kin, action):
        cfg: MoveConfig = self.config
        stand_height = cfg.full_height * cfg.stand_height_frac
        standing = tolerance(kin.xpos[:, self._head, 2], bounds=(stand_height, float("inf")),
                             margin=stand_height / 4)
        # the world z of the chest's y axis
        upright = tolerance(kin.xmat[:, self._chest, 2, 1], bounds=(0.9, float("inf")),
                            sigmoid="linear", margin=1.9, value_at_margin=0)
        small_control = tolerance(action, margin=1, value_at_margin=0,
                                  sigmoid="quadratic").mean(1)
        small_control = (4 + small_control) / 5

        # the chest subtree's COM velocity (MuJoCo's subtree_linvel): the
        # mass-weighted mean of the bodies' COM velocities
        V = kinematics.body_twists(self.model, kin, phys.qvel)         # (B,J,6)
        com_lin = V[..., 3:] + cross(V[..., :3], kin.com)
        com_vel = (self._chest_subtree_w[..., None] * com_lin).sum(1)  # (B,3)
        stand_reward = standing * upright
        if cfg.move_speed == 0:
            dont_move = tolerance(com_vel[:, :2], margin=2).mean(1)
            return small_control * stand_reward * dont_move
        move = tolerance(torch.linalg.norm(com_vel[:, :2], dim=1),
                         bounds=(cfg.move_speed, float("inf")), margin=cfg.move_speed,
                         value_at_margin=0, sigmoid="linear")
        return small_control * stand_reward * (5 * move + 1) / 6
