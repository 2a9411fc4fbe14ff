"""The speed task, batched (port of SpeedConfig, SpeedTask and
HumanoidSpeed in smplsim_tpu/envs/tasks.py).

Run at a commanded speed along +x: reward = exp(-0.25 ((v_x - v*)^2 +
0.1 v_y^2)) with v the root displacement over the control step divided by
its duration; task obs = the heading-local +x direction (2) and the target
speed (1). The target is resampled every 100-199 control steps; a resample
is drawn for every env each step and kept where it is due.
"""
from __future__ import annotations

import dataclasses

import torch

from smplsim_tpu_torch import transforms as T
from smplsim_tpu_torch.envs.base import EnvConfig, HumanoidEnv


@dataclasses.dataclass(frozen=True)
class SpeedConfig(EnvConfig):
    tar_speed_min: float = 0.0
    tar_speed_max: float = 5.0
    speed_change_steps_min: int = 100
    speed_change_steps_max: int = 200


@dataclasses.dataclass
class SpeedTask:
    tar_speed: torch.Tensor      # (B,)
    change_step: torch.Tensor    # (B,) int32: resample when cur_t reaches it
    prev_root_pos: torch.Tensor  # (B,3) root position before the physics


class HumanoidSpeed(HumanoidEnv):
    def __init__(self, model, config: SpeedConfig | None = None, **qp):
        super().__init__(model, config or SpeedConfig(), **qp)

    @property
    def task_obs_size(self) -> int:
        return 3

    def init_task(self, batch: int) -> SpeedTask:
        m = self.model
        return SpeedTask(
            tar_speed=torch.zeros(batch, dtype=m.dtype, device=m.device),
            change_step=torch.zeros(batch, dtype=torch.int32, device=m.device),
            prev_root_pos=torch.zeros((batch, 3), dtype=m.dtype, device=m.device))

    def _sample(self, generator, task: SpeedTask, cur_t) -> SpeedTask:
        cfg: SpeedConfig = self.config
        B = cur_t.shape[0]
        u = torch.rand(B, generator=generator, dtype=task.tar_speed.dtype,
                       device=cur_t.device)
        speed = cfg.tar_speed_min + (cfg.tar_speed_max - cfg.tar_speed_min) * u
        steps = torch.randint(cfg.speed_change_steps_min, cfg.speed_change_steps_max,
                              (B,), generator=generator, device=cur_t.device)
        return dataclasses.replace(task, tar_speed=speed,
                                   change_step=(cur_t + steps).to(torch.int32))

    def reset_task(self, generator, task, cur_t):
        return self._sample(generator, task, cur_t)

    def update_task(self, generator, task: SpeedTask, cur_t):
        fresh = self._sample(generator, task, cur_t)
        due = cur_t >= task.change_step
        return dataclasses.replace(
            task, tar_speed=torch.where(due, fresh.tar_speed, task.tar_speed),
            change_step=torch.where(due, fresh.change_step, task.change_step))

    def pre_physics(self, task: SpeedTask, phys, kin):
        return dataclasses.replace(task, prev_root_pos=kin.xpos[:, 0])

    def task_obs(self, task: SpeedTask, phys, kin):
        root_rot = phys.qpos[:, 3:7]
        if not self.upright_start:
            root_rot = T.remove_base_rot(root_rot, self.model.humanoid_type)
        heading_inv = T.calc_heading_quat_inv(root_rot)
        x = torch.zeros_like(phys.qpos[:, :3])
        x[:, 0] = 1.0
        local_dir = T.quat_rotate(heading_inv, x)[:, :2]
        return torch.cat([local_dir, task.tar_speed[:, None]], dim=1)

    def reward(self, task: SpeedTask, phys, kin, action):
        root_vel = (kin.xpos[:, 0] - task.prev_root_pos) / self.config.dt
        tar_err = task.tar_speed - root_vel[:, 0]
        tangent = root_vel[:, 1]
        return torch.exp(-0.25 * (tar_err * tar_err + 0.1 * tangent * tangent))
