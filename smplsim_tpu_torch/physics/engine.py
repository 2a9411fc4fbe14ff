"""The control step: the entry point of the physics (port of
smplsim_tpu/physics/engine.py, uhc_pd mode, batched).

Stable-PD reads mjData.qM/qfrc_bias at call time, which after an mj_step are
the PREVIOUS substep's values; the loop carries (M, C) with exactly that
lifecycle. The cache a control step returns is (M, C, efc_force): pass it to
the next control step to continue an episode, its last entry warm-starting
the next contact solve; a 2-tuple (M, C) starts cold, None primes with a
fresh forward pass (the reference's mj_forward at reset).
"""
from __future__ import annotations

import dataclasses

import torch

from smplsim_tpu_torch.models.spec import RobotModel
from smplsim_tpu_torch.physics import constraints, dynamics, kinematics
from smplsim_tpu_torch.physics.control import pd_target_from_action
from smplsim_tpu_torch.physics.substep import control_loop


@dataclasses.dataclass
class PhysicsState:
    qpos: torch.Tensor   # (B,nq)
    qvel: torch.Tensor   # (B,nv)


@dataclasses.dataclass
class LeanInfo:
    geom_floor_contact: torch.Tensor  # (B,ngeom) any floor candidate in margin
    nactive_max: torch.Tensor         # (B,) int32 max active rows over substeps
    stalled_any: torch.Tensor         # (B,) a substep's QP missed its tolerance


def pd_cache(model: RobotModel, state: PhysicsState):
    """(M, C) at the current state (mj_forward at reset)."""
    kin = kinematics.fk(model, state.qpos)
    return dynamics.mass_matrix(model, kin), dynamics.bias_forces(model, kin, state.qvel)


def reset_reference(model: RobotModel):
    """(qpos0, qvel0, M, C), each with a batch dim of 1: the target of the
    bad-state reset. Compute once per model."""
    q0 = model.qpos0[None]
    v0 = torch.zeros((1, model.nv), dtype=q0.dtype, device=q0.device)
    M, C = pd_cache(model, PhysicsState(q0, v0))
    return q0, v0, M, C


def control_step(model: RobotModel, state: PhysicsState, action: torch.Tensor,
                 control_freq_inv: int = 15, cache=None, reset_ref=None,
                 qp_iters=None, qp_rows=None, qp_tol=None, keeps=None):
    """One control step of control_freq_inv substeps for a batch.

    action (B,nu) in [-1,1]. qp_iters / qp_rows / qp_tol / keeps override
    SMPLSIM_QP_ITERS / SMPLSIM_QP_ROWS / SMPLSIM_QP_TOL / SMPLSIM_*_KEEP.
    Returns (state', LeanInfo, power (B,), cache' = (M, C, efc_force))."""
    if reset_ref is None:
        reset_ref = reset_reference(model)
    if cache is None:
        cache = pd_cache(model, state)
    if len(cache) == 2:
        M0, C0 = cache
        f_w0 = torch.zeros((state.qpos.shape[0], constraints.NEFC),
                           dtype=state.qpos.dtype, device=state.qpos.device)
    else:
        M0, C0, f_w0 = cache
    K = None if qp_rows is None else min(qp_rows, constraints.NEFC)
    target = pd_target_from_action(model, action)
    q, v, M, C, f_w, power, nact, stall, gfc = control_loop(
        model, state.qpos, state.qvel, M0, C0, f_w0, target, reset_ref,
        control_freq_inv, qp_iters, K, qp_tol, keeps)
    return (PhysicsState(q, v), LeanInfo(gfc, nact, stall), power, (M, C, f_w))
