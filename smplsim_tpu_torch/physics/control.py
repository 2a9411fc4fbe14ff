"""Stable-PD and torque control, batched (port of
smplsim_tpu/physics/control.py).

Stable-PD (the uhc_pd control mode):

    qpos_err = [0_6; q + dt qv - q*]
    qacc = (M + dt diag(Kd))^-1 (-C - Kp qpos_err - Kd qv)
    tau  = -Kp qpos_err[6:] - Kd (qv + dt qacc)[6:], clipped to torque_lim

M includes armature; M and C are the PREVIOUS substep's, as MuJoCo's
mjData.qM and qfrc_bias are when the reference controller reads them.
`stable_pd_torque` is the batched spine's form (one `chol_solve` with the
diagonal shift); `stable_pd_torque_ref` the per-env form of the JAX
package, which factors M + dt diag(kd) with the differentiable
`cho_factor_solve` and is what the reference loop runs under forward AD.

Torque (the torque control mode, the reference's SimpleTorqueController):
tau = clip(action * power_scale * torque_lim, +-torque_lim).
"""
from __future__ import annotations

import torch

from smplsim_tpu_torch.models.spec import RobotModel
from smplsim_tpu_torch.ops import linalg
from smplsim_tpu_torch.physics import linalg as ad_linalg


def pd_target_from_action(model: RobotModel, action: torch.Tensor) -> torch.Tensor:
    """action in [-1,1]^nu -> joint-position setpoint."""
    return action * model.pd_action_scale + model.pd_action_offset


def stable_pd_system(model: RobotModel, C_prev, qpos, qvel, target):
    """The stable-PD solve's right-hand side (B,nv,1), its diagonal shift
    dt*kd (B,nv) and the hinge position error (B,nu)."""
    B, nv = qvel.shape
    dt = model.timestep
    z6 = torch.zeros((B, 6), dtype=qvel.dtype, device=qvel.device)
    kd = torch.cat([z6[0], model.jkd])
    qerr = qpos[:, 7:] + qvel[:, 6:] * dt - target
    rhs = -C_prev - torch.cat([z6, model.jkp * qerr], 1) - kd * qvel
    return rhs[..., None], (kd * dt).expand(B, nv).contiguous(), qerr


def _stable_pd_tau(model: RobotModel, qerr, qvel, qacc):
    tau = -model.jkp * qerr - model.jkd * (qvel[:, 6:] + qacc[:, 6:] * model.timestep)
    return torch.clamp(tau, -model.torque_lim, model.torque_lim)


def stable_pd_torque(model: RobotModel, M_prev, C_prev, qpos, qvel, target):
    """tau (B,nu) from the stale (M, C) and the current state; the
    (M + dt diag(kd)) solve is one fused factor+solve (`linalg.chol_solve`)."""
    rhs, diag, qerr = stable_pd_system(model, C_prev, qpos, qvel, target)
    return _stable_pd_tau(model, qerr, qvel, linalg.chol_solve(M_prev, rhs, diag)[..., 0])


def stable_pd_torque_ref(model: RobotModel, M_prev, C_prev, qpos, qvel, target):
    """tau (B,nu) as `stable_pd_torque`, through one `cho_factor_solve` of
    M_prev + dt diag(kd) (smplsim_tpu/physics/control.py::stable_pd_torque)."""
    rhs, diag, qerr = stable_pd_system(model, C_prev, qpos, qvel, target)
    qacc = ad_linalg.cho_factor_solve(M_prev + torch.diag_embed(diag), rhs)[1][..., 0]
    return _stable_pd_tau(model, qerr, qvel, qacc)


def torque_ctrl(model: RobotModel, action: torch.Tensor,
                power_scale: float = 1.0) -> torch.Tensor:
    """tau (B,nu): the action scaled by power_scale * torque_lim, clipped to
    torque_lim."""
    tau = action * power_scale * model.torque_lim
    return torch.clamp(tau, -model.torque_lim, model.torque_lim)
