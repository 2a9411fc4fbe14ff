"""Goal-conditioned tasks, batched (port of smplsim_tpu/envs/tasks.py):
speed, getup and reach.

Each task keeps its state in EnvState.task, one row per env. A target that
is resampled every N-M control steps is drawn for every env each step and
kept where it is due.

  * speed: run at a commanded speed along +x; reward = exp(-0.25 ((v_x -
    v*)^2 + 0.1 v_y^2)) with v the root displacement over the control step
    divided by its duration; task obs = the heading-local +x direction (2)
    and the target speed (1).
  * getup: from the Fall init, reach a commanded root height; reward =
    exp(-4 (h* - h)^2); task obs = h* (1); termination is suppressed for
    recovery_steps control steps after each reset.
  * reach: bring one body (R_Hand) to a random point; reward =
    exp(-4 |p_body - p*|^2); task obs = the target relative to the root in
    the heading frame (3).
"""
from __future__ import annotations

import dataclasses

import torch

from simbench.reference import transforms as T
from simbench.reference.envs import base
from simbench.reference.envs.base import EnvConfig, HumanoidEnv


def _heading_inv(root_rot: torch.Tensor, upright_start: bool, humanoid_type: str):
    """(B,4) quaternion that removes the root's yaw (and the SMPL base
    rotation of a model not built upright)."""
    if not upright_start:
        root_rot = T.remove_base_rot(root_rot, humanoid_type)
    return T.calc_heading_quat_inv(root_rot)


def _where_due(due: torch.Tensor, fresh, task, names):
    """task with the fields `names` taken from fresh where due (B,)."""
    pick = lambda a, b: torch.where(due.reshape(due.shape + (1,) * (a.dim() - 1)), a, b)
    return dataclasses.replace(task, **{n: pick(getattr(fresh, n), getattr(task, n))
                                        for n in names})


# ================================================================ speed
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
        u = torch.rand(B, generator=generator, dtype=base.DRAW_DTYPE,
                       device=cur_t.device).to(task.tar_speed.dtype)
        speed = cfg.tar_speed_min + (cfg.tar_speed_max - cfg.tar_speed_min) * u
        steps = torch.randint(cfg.speed_change_steps_min, cfg.speed_change_steps_max,
                              (B,), generator=generator, device=cur_t.device)
        return dataclasses.replace(task, tar_speed=speed,
                                   change_step=(cur_t + steps).to(torch.int32))

    def reset_task(self, generator, task, cur_t):
        return self._sample(generator, task, cur_t)

    def update_task(self, generator, task: SpeedTask, cur_t):
        return _where_due(cur_t >= task.change_step, self._sample(generator, task, cur_t),
                          task, ("tar_speed", "change_step"))

    def pre_physics(self, task: SpeedTask, phys, kin):
        return dataclasses.replace(task, prev_root_pos=kin.xpos[:, 0])

    def task_obs(self, task: SpeedTask, phys, kin):
        heading_inv = _heading_inv(phys.qpos[:, 3:7], self.upright_start,
                                   self.model.humanoid_type)
        x = torch.zeros_like(phys.qpos[:, :3])
        x[:, 0] = 1.0
        local_dir = T.quat_rotate(heading_inv, x)[:, :2]
        return torch.cat([local_dir, task.tar_speed[:, None]], dim=1)

    def reward(self, task: SpeedTask, phys, kin, action):
        root_vel = (kin.xpos[:, 0] - task.prev_root_pos) / self.config.dt
        tar_err = task.tar_speed - root_vel[:, 0]
        tangent = root_vel[:, 1]
        return torch.exp(-0.25 * (tar_err * tar_err + 0.1 * tangent * tangent))


# ================================================================ getup
@dataclasses.dataclass(frozen=True)
class GetupConfig(EnvConfig):
    state_init: str = "Fall"
    recovery_steps: int = 60
    tar_height_min: float = 0.5
    tar_height_max: float = 1.2
    height_change_steps_min: int = 100
    height_change_steps_max: int = 200


@dataclasses.dataclass
class GetupTask:
    tar_height: torch.Tensor        # (B,)
    change_step: torch.Tensor       # (B,) int32
    recovery_counter: torch.Tensor  # (B,) int32: no termination while > 0


class HumanoidGetup(HumanoidEnv):
    """Recover from a fall to a commanded root height. The recovery counter
    is set by reset_task, kept by update_task (also on a resample) and
    counted down by task_termination, which suppresses termination while it
    is > 0."""

    def __init__(self, model, config: GetupConfig | None = None, **qp):
        super().__init__(model, config or GetupConfig(), **qp)

    @property
    def task_obs_size(self) -> int:
        return 1

    def init_task(self, batch: int) -> GetupTask:
        m = self.model
        zi = torch.zeros(batch, dtype=torch.int32, device=m.device)
        return GetupTask(tar_height=torch.zeros(batch, dtype=m.dtype, device=m.device),
                         change_step=zi, recovery_counter=zi)

    def _sample(self, generator, task: GetupTask, cur_t) -> GetupTask:
        cfg: GetupConfig = self.config
        B = cur_t.shape[0]
        u = torch.rand(B, generator=generator, dtype=base.DRAW_DTYPE,
                       device=cur_t.device).to(task.tar_height.dtype)
        height = cfg.tar_height_min + (cfg.tar_height_max - cfg.tar_height_min) * u
        steps = torch.randint(cfg.height_change_steps_min, cfg.height_change_steps_max,
                              (B,), generator=generator, device=cur_t.device)
        return dataclasses.replace(task, tar_height=height,
                                   change_step=(cur_t + steps).to(torch.int32))

    def reset_task(self, generator, task, cur_t):
        task = self._sample(generator, task, cur_t)
        return dataclasses.replace(task, recovery_counter=torch.full_like(
            task.recovery_counter, self.config.recovery_steps))

    def update_task(self, generator, task: GetupTask, cur_t):
        return _where_due(cur_t >= task.change_step, self._sample(generator, task, cur_t),
                          task, ("tar_height", "change_step"))

    def task_obs(self, task: GetupTask, phys, kin):
        return task.tar_height[:, None]

    def reward(self, task: GetupTask, phys, kin, action):
        diff = task.tar_height - kin.xpos[:, 0, 2]
        return torch.exp(-4.0 * diff * diff)

    def task_termination(self, task: GetupTask, terminated):
        recovering = task.recovery_counter > 0
        task = dataclasses.replace(task, recovery_counter=(task.recovery_counter - 1).clamp_min(0))
        return task, terminated & ~recovering


# ================================================================ reach
@dataclasses.dataclass(frozen=True)
class ReachConfig(EnvConfig):
    reach_body_name: str = "R_Hand"
    tar_dist_max: float = 1.0
    tar_height_min: float = 0.2
    tar_height_max: float = 2.0
    tar_change_steps_min: int = 50
    tar_change_steps_max: int = 100


@dataclasses.dataclass
class ReachTask:
    tar_pos: torch.Tensor      # (B,3) world target
    change_step: torch.Tensor  # (B,) int32


class HumanoidReach(HumanoidEnv):
    def __init__(self, model, config: ReachConfig | None = None, **qp):
        super().__init__(model, config or ReachConfig(), **qp)
        self._reach_body = model.body_names.index(self.config.reach_body_name)

    @property
    def task_obs_size(self) -> int:
        return 3

    def init_task(self, batch: int) -> ReachTask:
        m = self.model
        return ReachTask(tar_pos=torch.zeros((batch, 3), dtype=m.dtype, device=m.device),
                         change_step=torch.zeros(batch, dtype=torch.int32, device=m.device))

    def _sample(self, generator, task: ReachTask, cur_t) -> ReachTask:
        cfg: ReachConfig = self.config
        B = cur_t.shape[0]
        u = torch.rand((B, 3), generator=generator, dtype=base.DRAW_DTYPE,
                       device=cur_t.device).to(task.tar_pos.dtype)
        xy = cfg.tar_dist_max * (2.0 * u[:, :2] - 1.0)
        z = (cfg.tar_height_max - cfg.tar_height_min) * u[:, 2:] + cfg.tar_height_min
        steps = torch.randint(cfg.tar_change_steps_min, cfg.tar_change_steps_max,
                              (B,), generator=generator, device=cur_t.device)
        return dataclasses.replace(task, tar_pos=torch.cat([xy, z], 1),
                                   change_step=(cur_t + steps).to(torch.int32))

    def reset_task(self, generator, task, cur_t):
        return self._sample(generator, task, cur_t)

    def update_task(self, generator, task: ReachTask, cur_t):
        return _where_due(cur_t >= task.change_step, self._sample(generator, task, cur_t),
                          task, ("tar_pos", "change_step"))

    def task_obs(self, task: ReachTask, phys, kin):
        heading_inv = _heading_inv(phys.qpos[:, 3:7], self.upright_start,
                                   self.model.humanoid_type)
        return T.quat_rotate(heading_inv, task.tar_pos - phys.qpos[:, 0:3])

    def reward(self, task: ReachTask, phys, kin, action):
        diff = task.tar_pos - kin.xpos[:, self._reach_body]
        return torch.exp(-4.0 * (diff * diff).sum(1))


TASKS = {
    "HumanoidEnv": HumanoidEnv,
    "HumanoidSpeed": HumanoidSpeed,
    "HumanoidGetup": HumanoidGetup,
    "HumanoidReach": HumanoidReach,
}
