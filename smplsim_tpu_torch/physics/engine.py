"""The physics entry points, batched (port of smplsim_tpu/physics/engine.py):
`forward` and `step` (mj_forward / mj_step) and `control_step`.

control_step runs in one of three modes. "uhc_pd" (the default) runs the
batched stable-PD spine of physics/substep.py (its dense route, or in
float32 the articulated-body route where SMPLSIM_ABA asks for it).
"torque" (the reference's SimpleTorqueController: tau = clip(action *
power_scale * torque_lim)) and "default" (the action is the joint torque)
run the per-env composition of `forward`: FK, smooth dynamics with one
`cho_factor_solve`, the constraint rows and the Gram-form contact solve
(`solver.solve_constraints_gram`), then semi-implicit Euler and MuJoCo's
mjMAXVAL reset. Their warm start
begins at zero each control step and carries across its substeps; they
return no cache.

In uhc_pd mode, stable-PD reads mjData.qM/qfrc_bias at call time, which after an mj_step are
the PREVIOUS substep's values; the loop carries (M, C) with exactly that
lifecycle. The cache a control step returns is (M, C, efc_force): pass it to
the next control step to continue an episode, its last entry warm-starting
the next contact solve; a 2-tuple (M, C) starts cold, None primes with a
fresh forward pass (the reference's mj_forward at reset).

Every entry point takes a shared or a stacked model (models/spec.py); on a
stacked model of N rows the batch is N and row i runs body i.

Forward-mode AD (torch.autograd.forward_ad): when any tensor input of a
uhc_pd control step, the model's fields included, carries a tangent, it
runs the per-env reference form of the loop (substep.control_loop with
reference=True; the JAX package's engine.py::_uhc_core_ref, which its
custom_jvp differentiates) instead of the batched spine: stable-PD and the
smooth solve through `cho_factor_solve`, the Gram-form contact solve, and
the derivative rules of physics/linalg.py and ops/qp.py, with ext_force
and the projectiles as in the spine. The spine's kernels raise on a
tangent. The torque and default modes run the per-env
composition already. Reverse mode is not implemented.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.autograd import forward_ad

from smplsim_tpu_torch.models.spec import ARRAY_FIELDS, RobotModel
from smplsim_tpu_torch.physics import constraints, dynamics, integrator, kinematics, solver
from smplsim_tpu_torch.physics.control import pd_target_from_action, torque_ctrl
from smplsim_tpu_torch.physics.substep import _bad, control_loop


@dataclasses.dataclass
class PhysicsState:
    qpos: torch.Tensor   # (B,nq)
    qvel: torch.Tensor   # (B,nv)


@dataclasses.dataclass
class LeanInfo:
    geom_floor_contact: torch.Tensor  # (B,ngeom) any floor candidate in margin
    nactive_max: torch.Tensor         # (B,) int32 max active rows over substeps
    stalled_any: torch.Tensor         # (B,) a substep's QP missed its tolerance


@dataclasses.dataclass
class StepInfo:
    kin: kinematics.Kin
    smooth: dynamics.Smooth
    efc: constraints.EFC
    sol: solver.ConstraintSolution
    # over the substeps this info summarizes (the one substep of `step`)
    nactive_max: torch.Tensor | None = None
    stalled_any: torch.Tensor | None = None


def init_state(model: RobotModel, batch: int = 1) -> PhysicsState:
    """`batch` copies of the model's reference pose at rest."""
    qpos = model.qpos0.expand(batch, model.nq).clone()
    return PhysicsState(qpos, torch.zeros((batch, model.nv), dtype=qpos.dtype,
                                          device=qpos.device))


def forward(model: RobotModel, state: PhysicsState, ctrl: torch.Tensor, f_warm=None,
            qp_iters=None, qp_rows=None, qp_tol=None, keeps=None) -> StepInfo:
    """Accelerations and constraint forces at the current state under joint
    torques ctrl (B,nu); f_warm (B,NEFC) warm-starts the contact QP (None:
    cold). The knobs are control_step's."""
    kin = kinematics.fk(model, state.qpos)
    smooth = dynamics.smooth_dynamics(model, kin, state.qvel, ctrl)
    efc = constraints.make_efc(model, kin, state.qpos, state.qvel, keeps)
    K = None if qp_rows is None else min(qp_rows, constraints.NEFC)
    sol = solver.solve_constraints_gram(model, kin.S, smooth, efc, f_warm, qp_iters, K, qp_tol)
    return StepInfo(kin=kin, smooth=smooth, efc=efc, sol=sol)


def step(model: RobotModel, state: PhysicsState, ctrl: torch.Tensor, **knobs):
    """One physics substep (mj_step) under joint torques ctrl (B,nu), cold
    contact start. Returns (state', StepInfo)."""
    info = forward(model, state, ctrl, **knobs)
    info.nactive_max, info.stalled_any = info.sol.nactive, info.sol.stalled
    qpos, qvel = integrator.euler_step(state.qpos, state.qvel, info.sol.qacc, model.timestep)
    return PhysicsState(qpos, qvel), info


def pd_cache(model: RobotModel, state: PhysicsState):
    """(M, C) at the current state (mj_forward at reset)."""
    kin = kinematics.fk(model, state.qpos)
    return dynamics.mass_matrix(model, kin), dynamics.bias_forces(model, kin, state.qvel)


def reset_reference(model: RobotModel):
    """(qpos0, qvel0, M, C): the target of the bad-state reset, with a batch
    dim of 1 for a shared model and of N for a stacked one (each body's
    own). Compute once per model."""
    q0 = model.qpos0.reshape(-1, model.nq)
    v0 = torch.zeros((q0.shape[0], model.nv), dtype=q0.dtype, device=q0.device)
    M, C = pd_cache(model, PhysicsState(q0, v0))
    return q0, v0, M, C


def control_step(model: RobotModel, state: PhysicsState, action: torch.Tensor,
                 control_freq_inv: int = 15, cache=None, reset_ref=None,
                 qp_iters=None, qp_rows=None, qp_tol=None, keeps=None,
                 control_mode: str = "uhc_pd", power_scale: float = 1.0,
                 ext_force=None, proj=None, pd_target_mask=None):
    """One control step of control_freq_inv substeps for a batch.

    action (B,nu) in [-1,1] ("default" mode: joint torques). qp_iters /
    qp_rows / qp_tol / keeps override SMPLSIM_QP_ITERS / SMPLSIM_QP_ROWS /
    SMPLSIM_QP_TOL / SMPLSIM_*_KEEP. Returns (state', LeanInfo, power (B,),
    cache'): cache' = (M, C, efc_force) in uhc_pd mode, None in the others
    (which ignore `cache`).

    The uhc_pd mode takes two perturbation hooks (substep.control_loop):
    ext_force (B,J,3), world forces at the body COMs during every substep,
    and proj = (pos (B,P,3), vel (B,P,3), radius (B,P), inverse mass
    (B,P)), free spheres that collide with the humanoid; with proj the step
    returns a fifth entry, the spheres' (pos, vel). The torque and default
    modes ignore both, as the JAX package's do. pd_target_mask (nu,) or
    (B,nu) multiplies the PD target in uhc_pd mode (freeze_hand / freeze_toe /
    remove_neck zero the target of their joints); the other modes ignore
    it."""
    if reset_ref is None:
        reset_ref = reset_reference(model)
    if control_mode in ("torque", "default"):
        tau = torque_ctrl(model, action, power_scale) if control_mode == "torque" else action
        return _direct_loop(model, state, tau, control_freq_inv, reset_ref,
                            dict(qp_iters=qp_iters, qp_rows=qp_rows, qp_tol=qp_tol, keeps=keeps))
    if control_mode != "uhc_pd":
        raise NotImplementedError(control_mode)
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
    if pd_target_mask is not None:
        target = target * pd_target_mask
    hooks = [t for t in (ext_force, *(proj or ()), pd_target_mask) if t is not None]
    fields = [getattr(model, f) for f in ARRAY_FIELDS]
    tangent = any(forward_ad.unpack_dual(t).tangent is not None
                  for t in (state.qpos, state.qvel, action, M0, C0, f_w0, *reset_ref, *hooks,
                            *fields))
    out = control_loop(
        model, state.qpos, state.qvel, M0, C0, f_w0, target, reset_ref,
        control_freq_inv, qp_iters, K, qp_tol, keeps, reference=tangent,
        ext_force=ext_force, proj=proj)
    q, v, M, C, f_w, power, nact, stall, gfc = out[:9]
    ret = (PhysicsState(q, v), LeanInfo(gfc, nact, stall), power, (M, C, f_w))
    return ret if proj is None else ret + out[9:]


def _direct_loop(model, state, tau, control_freq_inv, reset_ref, knobs):
    """The torque / default control loop: control_freq_inv `forward` substeps
    under the fixed joint torques tau (B,nu)."""
    reset_q, reset_v = reset_ref[:2]
    B = state.qpos.shape[0]
    dtype, dev = state.qpos.dtype, state.qpos.device
    f_w = torch.zeros((B, constraints.NEFC), dtype=dtype, device=dev)
    power = torch.zeros(B, dtype=dtype, device=dev)
    nact = torch.zeros(B, dtype=torch.int32, device=dev)
    stall = torch.zeros(B, dtype=torch.bool, device=dev)
    for _ in range(control_freq_inv):
        info = forward(model, state, tau, f_w, **knobs)
        q2, v2 = integrator.euler_step(state.qpos, state.qvel, info.sol.qacc, model.timestep)
        # MuJoCo's mjMAXVAL reset: restart from the reference pose, drop the
        # warm start, add no power
        bad = _bad(state.qpos) | _bad(state.qvel) | _bad(info.sol.qacc)
        b1 = bad[:, None]
        power = power + torch.where(bad, torch.zeros_like(power),
                                    (tau * state.qvel[:, 6:]).abs().sum(1))
        state = PhysicsState(torch.where(b1, reset_q, q2), torch.where(b1, reset_v, v2))
        f_w = torch.where(b1, torch.zeros_like(f_w), info.sol.efc_force)
        nact = torch.maximum(nact, info.sol.nactive)
        stall = stall | info.sol.stalled
    return state, LeanInfo(info.efc.geom_floor_contact, nact, stall), power, None
