"""Batched mocap forward kinematics: SMPL pose (axis-angle) -> MuJoCo-ordered
global body states and (qpos, qvel) trajectories (port of
smplsim_tpu/motion/fk.py).

`HumanoidBatchFK.fk_batch` takes a batch of clips, batch first: the chain FK
over the mujoco-ordered tree from exponential-map joint rotations, the
finite-difference linear velocity with the 'nearest' Gaussian filter along
time, the quaternion-difference angular velocity, dof_pos as intrinsic-XYZ
euler angles with the temporal continuity fix, and the qpos / qvel assembly
(qvel = [global root linear velocity, root-frame angular velocity, dof
velocities]).

Beyond the JAX function it takes a padded batch of clips of different
lengths and frame rates (`dt=` (B,), `lengths=` (B,); by default every clip
has all T frames and the step self.dt): the filter reads frame
clamp(t + k, 0, T_i - 1), the velocities' last frame repeats frame
T_i - 2's, the angular velocity is zero at frame T_i - 1, and the
continuity fix, causal over time, runs once over all clips. So one call
gives every clip what a call on that clip alone gives; the frames past a
clip's end hold finite values that nothing reads. The motion library loads
its clips this way (motion_lib.py).
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from smplsim_tpu_torch import transforms as T
from smplsim_tpu_torch.motion import joint_names as JN
from smplsim_tpu_torch.physics.precision import ieee_fp32


def _full_lengths(x: torch.Tensor) -> torch.Tensor:
    """Every clip of x (B, T, ...) has all T frames."""
    return torch.full((x.shape[0],), x.shape[1], dtype=torch.long, device=x.device)


def _take_time(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, T, A, C) at frames idx (B, T') along axis 1, per row."""
    return torch.gather(x, 1, idx[:, :, None, None].expand(idx.shape + x.shape[2:]))


def gaussian_filter1d_time(x: torch.Tensor, sigma: float = 2.0,
                           lengths: torch.Tensor | None = None) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter1d along axis 1 (time) of x (B, T, A, C),
    mode 'nearest', radius int(4 sigma + 0.5). Clip i's edge is its frame
    lengths[i] - 1 (default T - 1)."""
    radius = int(4.0 * sigma + 0.5)
    t = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k = torch.as_tensor(k / k.sum(), dtype=x.dtype, device=x.device)
    if lengths is None:
        lengths = _full_lengths(x)
    last = lengths.to(x.device).long()[:, None] - 1
    frames = torch.arange(x.shape[1], device=x.device)[None]
    out = None
    for i, s in enumerate(range(-radius, radius + 1)):
        term = k[i] * _take_time(x, torch.minimum((frames + s).clamp_min(0), last))
        out = term if out is None else out + term
    return out


def _flip(d: torch.Tensor) -> torch.Tensor:
    """The other intrinsic-XYZ euler triple of the same rotation, wrapped."""
    return T.normalize_angle(torch.stack(
        [math.pi + d[..., 0], math.pi - d[..., 1], math.pi + d[..., 2]], -1))


def fix_continuous_dof(dof: torch.Tensor) -> torch.Tensor:
    """Temporal euler-angle continuity fix, (..., T, J, 3) -> same shape.

    Sequential over time: where a joint's euler triple jumps by >= 3 rad
    (summed over its three angles) from the previous (fixed) frame, take
    the alternative triple (pi + x, pi - y, pi + z, wrapped); tried twice
    per frame. Both flips of every frame are computed at once, so the time
    loop only selects."""
    a0 = dof
    a1 = _flip(a0)
    a2 = _flip(a1)
    prev = dof[..., 0, :, :]
    frames = [prev]
    for t in range(1, dof.shape[-3]):
        c0, c1, c2 = a0[..., t, :, :], a1[..., t, :, :], a2[..., t, :, :]
        need = ((c0 - prev).abs().sum(-1) >= 3.0)[..., None]
        cur, alt = torch.where(need, c1, c0), torch.where(need, c2, c1)
        need = ((cur - prev).abs().sum(-1) >= 3.0)[..., None]
        prev = torch.where(need, alt, cur)
        frames.append(prev)
    return torch.stack(frames, dim=-3)


class HumanoidBatchFK:
    """FK over the mujoco-ordered humanoid tree with SMPL-ordered inputs.

    The offsets are rounded to 5 decimals, as the JAX package's are; they
    are cast to the input's dtype and device at each call."""

    def __init__(
        self,
        offsets,                      # (J,3) mujoco-ordered local offsets
        parents,                      # mujoco-ordered parents
        humanoid_type: str = "smpl",
        dt: float = 1.0 / 30.0,
        filter_vel: bool = True,
        device: str | torch.device = "cuda",
    ):
        if isinstance(offsets, torch.Tensor):
            offsets = offsets.detach().cpu().numpy()
        self.offsets = np.round(np.asarray(offsets, dtype=np.float64), 5)
        self.parents = tuple(int(p) for p in parents)
        self.humanoid_type = humanoid_type
        self.dt = dt
        self.filter_vel = filter_vel
        self.device = torch.device(device)
        self.smpl_2_mujoco = JN.smpl_to_mujoco_perm(humanoid_type)
        self.mujoco_2_smpl = JN.mujoco_to_smpl_perm(humanoid_type)
        self.num_joints = len(self.parents)
        self._off_cache: dict = {}

    @classmethod
    def from_robot_model(cls, model, **kw):
        """Offsets and parents of a RobotModel (body_pos is the zero-pose
        joint offset table); on the model's device unless `device=`."""
        kw.setdefault("device", model.device)
        return cls(model.body_pos.detach().cpu().numpy(), model.parents,
                   humanoid_type=model.humanoid_type, **kw)

    def offsets_as(self, dtype: torch.dtype, device) -> torch.Tensor:
        key = (dtype, torch.device(device))
        if key not in self._off_cache:
            self._off_cache[key] = torch.as_tensor(self.offsets, dtype=dtype, device=device)
        return self._off_cache[key]

    # ------------------------------------------------------------------
    @ieee_fp32()
    def fk_batch(
        self,
        pose_aa: torch.Tensor,   # (B,T,J,3) SMPL-ordered axis angle
        trans: torch.Tensor,     # (B,T,3)
        count_offset: bool = True,
        return_full: bool = False,
        *,
        dt: torch.Tensor | None = None,
        lengths: torch.Tensor | None = None,
    ) -> dict[str, Any]:
        """World body positions and rotations; with return_full also the
        velocities, dof_pos / dof_vels and qpos / qvel. dt (B,) replaces
        self.dt per clip; lengths (B,) marks a padded batch (module doc)."""
        B, Tn, J, _ = pose_aa.shape
        dtype, dev = pose_aa.dtype, pose_aa.device
        off = self.offsets_as(dtype, dev)
        pose_quat = T.exp_map_to_quat(pose_aa)              # (B,T,J,4) wxyz
        if count_offset:
            trans = trans + off[0]
        quat_mj = pose_quat[:, :, list(self.smpl_2_mujoco)]  # mujoco order

        wpos, wquat = self._forward(quat_mj, trans, off)
        out: dict[str, Any] = {"global_translation": wpos, "global_rotation": wquat}
        if not return_full:
            return out

        out_fps = int(1.0 / self.dt) if dt is None else None
        if dt is None:
            dt = torch.full((B,), self.dt, dtype=dtype, device=dev)
        if lengths is None:
            lengths = _full_lengths(pose_aa)
        step = torch.as_tensor(dt, dtype=dtype, device=dev).reshape(B, 1, 1, 1)
        linvel = self._velocity(wpos, step, lengths)
        angvel = self._angular_velocity(wquat, step, lengths)
        out["global_velocity"] = linvel
        out["global_angular_velocity"] = angvel
        out["global_root_velocity"] = linvel[..., 0, :]
        out["global_root_angular_velocity"] = angvel[..., 0, :]
        out["local_rotation"] = pose_quat

        dof = fix_continuous_dof(T.quat_to_euler_xyz(quat_mj[..., 1:, :]))  # (B,T,J-1,3)
        out["dof_pos"] = dof
        out["dof_vels"] = _last_held(_forward_diff(dof, step), lengths)
        if out_fps is not None:
            out["fps"] = out_fps

        out["qpos"] = torch.cat([trans, quat_mj[..., 0, :], dof.reshape(B, Tn, -1)], dim=-1)
        # the root's angular velocity in its own frame: R^T w, as products
        # and sums (no matrix product)
        R = T.quat_to_matrix(wquat[..., 0, :])               # (B,T,3,3)
        w = out["global_root_angular_velocity"]
        local_root_ang = torch.stack([R[..., 0, j] * w[..., 0] + R[..., 1, j] * w[..., 1]
                                      + R[..., 2, j] * w[..., 2] for j in range(3)], -1)
        out["qvel"] = torch.cat([out["global_root_velocity"], local_root_ang,
                                 out["dof_vels"].reshape(B, Tn, -1)], dim=-1)
        return out

    # ------------------------------------------------------------------
    def _forward(self, quat_mj: torch.Tensor, trans: torch.Tensor, off: torch.Tensor):
        """Chain FK: local quats (B,T,J,4) + root pos (B,T,3) -> world."""
        pos = [trans]
        rot = [quat_mj[..., 0, :]]
        for b in range(1, self.num_joints):
            p = self.parents[b]
            pos.append(pos[p] + T.quat_rotate(rot[p], off[b]))
            rot.append(T.quat_mul(rot[p], quat_mj[..., b, :]))
        return torch.stack(pos, dim=-2), torch.stack(rot, dim=-2)

    def _velocity(self, p: torch.Tensor, step: torch.Tensor, lengths) -> torch.Tensor:
        v = _last_held(_forward_diff(p, step), lengths)
        if self.filter_vel:
            v = gaussian_filter1d_time(v, lengths=lengths)
        return v

    def _angular_velocity(self, q: torch.Tensor, step: torch.Tensor, lengths) -> torch.Tensor:
        # w[t] = angle-axis(q[t+1] q[t]^-1) / dt for t < T-1, zero at the last frame
        dq = T.quat_unit(T.quat_mul(q[:, 1:], T.quat_conjugate(q[:, :-1])))
        angle, axis = T.quat_to_angle_axis(dq)
        w = axis * angle[..., None] / step
        w = torch.cat([w, torch.zeros_like(w[:, :1])], dim=1)
        t = torch.arange(w.shape[1], device=w.device)
        last = (lengths.to(w.device).long() - 1)[:, None]
        w = torch.where((t[None] < last)[:, :, None, None], w, torch.zeros_like(w))
        if self.filter_vel:
            w = gaussian_filter1d_time(w, lengths=lengths)
        return w

    # ------------------------------------------------------------------
    def qpos_to_pose_aa(self, qpos: torch.Tensor):
        """(N, nq) -> (root_pos (N,3), pose_aa (N,J,3) SMPL-ordered)."""
        root_pos = qpos[:, :3] - self.offsets_as(qpos.dtype, qpos.device)[0]
        root_aa = T.quat_to_exp_map(qpos[:, 3:7])[:, None]
        dof = qpos[:, 7:].reshape(qpos.shape[0], -1, 3)
        body_aa = T.quat_to_exp_map(T.euler_xyz_to_quat(dof))
        pose_aa = torch.cat([root_aa, body_aa], dim=1)
        return root_pos, pose_aa[:, list(self.mujoco_2_smpl)]


def _forward_diff(x: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """(x[t+1] - x[t]) / dt along axis 1, the last frame repeated."""
    v = (x[:, 1:] - x[:, :-1]) / step
    return torch.cat([v, v[:, -1:]], dim=1)


def _last_held(v: torch.Tensor, lengths) -> torch.Tensor:
    """Where clip i ends at frame lengths[i] - 1, that frame (and the padding
    after it) takes frame lengths[i] - 2's value."""
    t = torch.arange(v.shape[1], device=v.device)
    idx = torch.minimum(t[None], (lengths.to(v.device).long() - 2).clamp_min(0)[:, None])
    return _take_time(v, idx)
