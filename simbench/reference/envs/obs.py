"""Proprioceptive observations, batched (port of smplsim_tpu/envs/obs.py:
v1 and v2).

Heading-invariant: positions, rotations and velocities are expressed in the
frame that removes the root yaw (and the SMPL base rotation when the model
was not built upright).
"""
from __future__ import annotations

import torch

from simbench.reference import transforms as T


def compute_self_obs_v1(qvel: torch.Tensor, body_pos: torch.Tensor,
                        body_rot: torch.Tensor, upright_start: bool,
                        root_height_obs: bool, humanoid_type: str = "smpl") -> torch.Tensor:
    """Obs v1 (B, n): root height, local body positions, 6-D body rotations,
    local root linear and angular velocity, hinge rates. body_pos (B,J,3),
    body_rot (B,J,4) wxyz, qvel (B,nv)."""
    B, J, _ = body_pos.shape
    root_pos = body_pos[:, 0]
    root_rot = body_rot[:, 0]
    if not upright_start:
        root_rot = T.remove_base_rot(root_rot, humanoid_type)
    heading_inv = T.calc_heading_quat_inv(root_rot)                 # (B,4)

    parts = []
    if root_height_obs:
        parts.append(root_pos[:, 2:3])
    h = heading_inv[:, None, :].expand(B, J, 4)
    local_body_pos = T.quat_rotate(h, body_pos - root_pos[:, None, :])
    parts.append(local_body_pos[:, 1:].reshape(B, -1))
    parts.append(T.quat_to_tan_norm(T.quat_mul(h, body_rot)).reshape(B, -1))
    parts.append(T.quat_rotate(heading_inv, qvel[:, 0:3]))
    parts.append(T.quat_rotate(heading_inv, qvel[:, 3:6]))
    parts.append(qvel[:, 6:])
    return torch.cat(parts, dim=1)


def compute_self_obs_v2(body_pos: torch.Tensor, body_rot: torch.Tensor,
                        body_vel: torch.Tensor, body_ang_vel: torch.Tensor,
                        upright_start: bool, root_height_obs: bool,
                        humanoid_type: str = "smpl") -> torch.Tensor:
    """Obs v2 (B, n): root height, then per body the local position, 6-D
    rotation, linear and angular velocity. body_pos, body_vel and
    body_ang_vel (B,J,3) in the world frame, body_rot (B,J,4) wxyz."""
    B, J, _ = body_pos.shape
    root_pos = body_pos[:, 0]
    root_rot = body_rot[:, 0]
    if not upright_start:
        root_rot = T.remove_base_rot(root_rot, humanoid_type)
    h = T.calc_heading_quat_inv(root_rot)[:, None, :].expand(B, J, 4)

    parts = []
    if root_height_obs:
        parts.append(root_pos[:, 2:3])
    parts.append(T.quat_rotate(h, body_pos - root_pos[:, None, :])[:, 1:].reshape(B, -1))
    parts.append(T.quat_to_tan_norm(T.quat_mul(h, body_rot)).reshape(B, -1))
    parts.append(T.quat_rotate(h, body_vel).reshape(B, -1))
    parts.append(T.quat_rotate(h, body_ang_vel).reshape(B, -1))
    return torch.cat(parts, dim=1)


def self_obs_size(nbody: int, self_obs_v: int, root_height_obs: bool,
                  has_shape_obs: bool = False) -> int:
    """Width of compute_self_obs_v1 / _v2 (plus 10 shape entries)."""
    n = 1 if root_height_obs else 0
    if self_obs_v == 1:
        n += (nbody - 1) * 3 + nbody * 6 + 3 + 3 + (nbody - 1) * 3
    elif self_obs_v == 2:
        n += (nbody - 1) * 3 + nbody * (6 + 3 + 3)
    else:
        raise NotImplementedError(f"self_obs_v {self_obs_v}")
    return n + (10 if has_shape_obs else 0)
