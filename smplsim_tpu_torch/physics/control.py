"""Stable-PD and torque control, batched (port of
smplsim_tpu/physics/control.py).

Stable-PD (the uhc_pd control mode):

    qpos_err = [0_6; q + dt qv - q*]
    qacc = (M + dt diag(Kd))^-1 (-C - Kp qpos_err - Kd qv)
    tau  = -Kp qpos_err[6:] - Kd (qv + dt qacc)[6:], clipped to torque_lim

M includes armature; M and C are the PREVIOUS substep's, as MuJoCo's
mjData.qM and qfrc_bias are when the reference controller reads them.
`stable_pd_torque` is the batched spine's form (one `chol_solve` with the
diagonal shift, or the articulated-body solve); `stable_pd_torque_ref` the
per-env form of the JAX package, which factors M + dt diag(kd) with the differentiable
`cho_factor_solve` and is what the reference loop runs under forward AD.

Torque (the torque control mode, the reference's SimpleTorqueController):
tau = clip(action * power_scale * torque_lim, +-torque_lim).

PD/PID (the reference's SimplePID and PIDController): `simple_pid_torque`
carries a PIDState, `pid_torque` an integral; both clamp their output and
integral to torque_lim.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from smplsim_tpu_torch.models.spec import RobotModel
from smplsim_tpu_torch.ops import linalg
from smplsim_tpu_torch.physics import linalg as ad_linalg


def pd_target_from_action(model: RobotModel, action: torch.Tensor) -> torch.Tensor:
    """action in [-1,1]^nu -> joint-position setpoint."""
    return action * model.pd_action_scale + model.pd_action_offset


def stable_pd_system(model: RobotModel, C_prev, qpos, qvel, target,
                     kp_scale: float = 1.0, kd_scale: float = 1.0):
    """The stable-PD solve's right-hand side (B,nv,1), its diagonal shift
    dt*kd*kd_scale (B,nv) and the hinge position error (B,nu)."""
    B, nv = qvel.shape
    dt = model.timestep[..., None]
    z6 = torch.zeros((B, 6), dtype=qvel.dtype, device=qvel.device)
    jkd = model.jkd * kd_scale
    kd = torch.cat([jkd.new_zeros(jkd.shape[:-1] + (6,)), jkd], -1)
    qerr = qpos[:, 7:] + qvel[:, 6:] * dt - target
    rhs = -C_prev - torch.cat([z6, model.jkp * kp_scale * qerr], 1) - kd * qvel
    return rhs[..., None], (kd * dt).expand(B, nv).contiguous(), qerr


def _stable_pd_tau(model: RobotModel, qerr, qvel, qacc, kp_scale, kd_scale):
    tau = (-(model.jkp * kp_scale) * qerr
           - (model.jkd * kd_scale) * (qvel[:, 6:] + qacc[:, 6:] * model.timestep[..., None]))
    return torch.clamp(tau, -model.torque_lim, model.torque_lim)


def stable_pd_torque(model: RobotModel, M_prev, C_prev, qpos, qvel, target,
                     kp_scale: float = 1.0, kd_scale: float = 1.0):
    """tau (B,nu) from the stale (M, C) and the current state, the gains
    scaled by kp_scale and kd_scale. M_prev is the (B,nv,nv) matrix, whose
    (M + dt diag(kd)) solve is one fused factor+solve (`linalg.chol_solve`),
    or a solve closure solve(rhs, diag) -> (M + diag)^-1 rhs
    (substep.aba_solver: the articulated-body route)."""
    rhs, diag, qerr = stable_pd_system(model, C_prev, qpos, qvel, target, kp_scale, kd_scale)
    qacc = (M_prev(rhs, diag) if callable(M_prev)
            else linalg.chol_solve(M_prev, rhs, diag))[..., 0]
    return _stable_pd_tau(model, qerr, qvel, qacc, kp_scale, kd_scale)


def stable_pd_torque_ref(model: RobotModel, M_prev, C_prev, qpos, qvel, target,
                         kp_scale: float = 1.0, kd_scale: float = 1.0):
    """tau (B,nu) as `stable_pd_torque`, through one `cho_factor_solve` of
    M_prev + dt diag(kd) (smplsim_tpu/physics/control.py::stable_pd_torque)."""
    rhs, diag, qerr = stable_pd_system(model, C_prev, qpos, qvel, target, kp_scale, kd_scale)
    qacc = ad_linalg.cho_factor_solve(M_prev + torch.diag_embed(diag), rhs)[1][..., 0]
    return _stable_pd_tau(model, qerr, qvel, qacc, kp_scale, kd_scale)


def torque_ctrl(model: RobotModel, action: torch.Tensor,
                power_scale: float = 1.0) -> torch.Tensor:
    """tau (B,nu): the action scaled by power_scale * torque_lim, clipped to
    torque_lim."""
    tau = action * power_scale * model.torque_lim
    return torch.clamp(tau, -model.torque_lim, model.torque_lim)


class PIDState(NamedTuple):
    """SimplePID's carried state, one row per env."""

    proportional: torch.Tensor  # (B,nu) running P term (proportional on measurement)
    integral: torch.Tensor      # (B,nu)
    last_input: torch.Tensor    # (B,nu) previous feedback (qpos[7:])
    last_error: torch.Tensor    # (B,nu)
    primed: torch.Tensor        # (B,) bool: last_* hold a previous call's values


def simple_pid_init(model: RobotModel, batch: int) -> PIDState:
    """A fresh PIDState for `batch` envs: zeros, not primed."""
    z = torch.zeros((batch, model.nu), dtype=model.dtype, device=model.device)
    return PIDState(z, z, z, z, torch.zeros(batch, dtype=torch.bool, device=model.device))


def simple_pid_torque(model: RobotModel, state: PIDState, qpos, action, jki=None,
                      proportional_on_measurement: bool = False,
                      differential_on_measurement: bool = False):
    """SimplePID law: returns (tau (B,nu), state'). On an env's first call
    (not primed) the input and error differences are zero; the output and
    the integral are clamped to torque_lim (anti-windup)."""
    dt = model.timestep[..., None]
    lim = model.torque_lim
    kp, kd = model.jkp, model.jkd
    ki = torch.zeros_like(kp) if jki is None else jki
    feedback = qpos[:, 7:]
    error = pd_target_from_action(model, action) - feedback
    primed = state.primed[:, None]
    zero = torch.zeros((), dtype=qpos.dtype, device=qpos.device)
    d_input = torch.where(primed, feedback - state.last_input, zero)
    d_error = torch.where(primed, error - state.last_error, zero)
    if proportional_on_measurement:
        proportional = state.proportional - kp * d_input
    else:
        proportional = kp * error
    integral = torch.clamp(state.integral + ki * error * dt, -lim, lim)
    derivative = -kd * d_input / dt if differential_on_measurement else kd * d_error / dt
    tau = torch.clamp(proportional + integral + derivative, -lim, lim)
    return tau, PIDState(proportional, integral, feedback, error,
                         torch.ones_like(state.primed))


def pid_torque(model: RobotModel, qpos, qvel, target, integral, jki=None):
    """PIDController law: returns (tau (B,nu), integral')."""
    lim = model.torque_lim
    err = qpos[:, 7:] - target
    integral = torch.clamp(integral + err * model.timestep[..., None], -lim, lim)
    ki = torch.zeros_like(model.jkp) if jki is None else jki
    tau = -model.jkp * err - model.jkd * qvel[:, 6:] - ki * integral
    return torch.clamp(tau, -lim, lim), integral
