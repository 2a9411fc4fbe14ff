"""Semi-implicit Euler integration (MuJoCo's default integrator), batched.

Port of smplsim_tpu/physics/integrator.py."""
from __future__ import annotations

import torch

from simbench.reference import transforms as T


def euler_step(qpos: torch.Tensor, qvel: torch.Tensor, qacc: torch.Tensor, dt):
    """Velocity first, then position with the new velocity (the free root's
    quaternion advances by its body-frame angular velocity). dt is the
    model's timestep: a float, a () tensor, or (B,) of a stacked model."""
    if isinstance(dt, torch.Tensor):
        dt = dt[..., None]
    qvel_new = qvel + dt * qacc
    pos = qpos[:, 0:3] + dt * qvel_new[:, 0:3]
    quat = T.quat_integrate(qpos[:, 3:7], qvel_new[:, 3:6], dt)
    hinge = qpos[:, 7:] + dt * qvel_new[:, 6:]
    return torch.cat([pos, quat, hinge], dim=1), qvel_new
