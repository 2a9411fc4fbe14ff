"""The batched uhc_pd control loop: control_freq_inv physics substeps.

Port of smplsim_tpu/physics/substep_lanes.py::uhc_control_lanes on the
dense mass-matrix path (what SMPLSIM_ABA=0 selects there), batch-first.
Each substep:

  1. stable-PD torque against the PREVIOUS substep's (M, C);
  2. FK; 3. CRBA mass matrix and RNEA bias forces;
  4. constraint rows (limits, floor contacts, self-contacts);
  5-7. compact active rows, one fused factor+solve of [qfrc | J^T], the
     contact QP (physics/solver.py);
  8. semi-implicit Euler, and MuJoCo's mjMAXVAL reset of bad states: a row
     with a non-finite or >1e10 entry in q, v or qacc restarts from the
     reset reference (q, v, M, C), drops its warm start and adds no power.

Kernels per substep: two `chol_solve` launches (stable-PD, smooth +
Delassus) and one `newton_qp` launch.

The articulated-body route (substep_lanes.py's, batched form only): with
SMPLSIM_ABA set to anything but 0/false/off, read at each call, a float32
batched loop solves with the mass matrix through physics/aba.py's
O(tree-depth) elimination instead of a dense factor:

  * the smooth + Delassus solve and stable-PD go through `aba_solver`, a
    closure over this substep's kinematics and armature;
  * the next substep's torque is computed at the END of each substep, from
    this substep's kinematics and bias and the integrated state (bad rows
    take the reset torque and their stale pose becomes the reset pose);
  * the first substep's torque comes from the cached M0 through one
    `chol_solve` (m = 1 + diag), the reset torque from the reset pose's
    kinematics through the elimination;
  * one dense CRBA after the loop, at the last substep's stale pose, gives
    the returned M.

Kernels per control step on this route: 1 `chol_solve` and
control_freq_inv `newton_qp`. float64 and the reference form never take it
(the JAX package's rule: its `_aba_enabled` tests the dtype, and its
reference loop has no ABA). DEFAULT: the dense route. The JAX package
defaults to ABA for float32 (SMPLSIM_ABA unset there means on); the port
defaults to dense (unset means off) because its float32 pins and every
chip number up to its ABA port were taken on the dense route, and which
route is faster on the GPU is what chip_smoke.py's phase 22 measures: the
default moves with the benchmark that shows it.

Two perturbation hooks (both forms): `ext_force` (B,J,3), world forces at
the body COMs added to the smooth force of every substep
(dynamics.external_forces), and `proj` = (pos (B,P,3), vel (B,P,3),
radius (B,P), inverse mass (B,P)), free spheres that meet the humanoid in
the projectile rows of make_efc and take the solved contact force back,
equal and opposite, then gravity, semi-implicit Euler and an inelastic
floor clamp (substep_lanes.py's has_proj branch).

With `reference=True` the same loop runs the per-env reference form of
smplsim_tpu/physics/engine.py::_uhc_core_ref, the JAX package's
differentiation path, which
engine.control_step takes under forward-mode AD: stable-PD and the smooth
solve through the differentiable `cho_factor_solve` (Kernel C, twice) and
the Gram-form contact solve (Kernels D, B, D), whose derivative rules add
five Kernel D launches and one Kernel E launch per substep under forward
AD. The two forms agree only to rounding.
"""
from __future__ import annotations

import os

import torch

from smplsim_tpu_torch.physics import aba, constraints, dynamics, integrator, kinematics, solver
from smplsim_tpu_torch.physics import linalg as ad_linalg
from smplsim_tpu_torch.physics.control import stable_pd_torque, stable_pd_torque_ref

MJ_MAXVAL = 1e10


def _bad(x: torch.Tensor) -> torch.Tensor:
    return (~torch.isfinite(x) | (x.abs() > MJ_MAXVAL)).any(1)


def _sphere_step(model, efc, efc_force, p_pos, p_vel, p_rad, p_inv):
    """The spheres' semi-implicit Euler step under the reaction to the
    projectile rows' solved forces and gravity, with the inelastic floor
    clamp. Slots whose sphere is -1 (inactive) act on none."""
    P = p_pos.shape[1]
    ef = efc_force[:, -4 * constraints.MAX_PROJC:].reshape(-1, constraints.MAX_PROJC, 4)
    dirs = efc.W6[:, -constraints.MAX_PROJC:, :, 3:6]                   # (B,K,4,3)
    F_slot = -(ef[..., None] * dirs).sum(2)                              # (B,K,3)
    onehot = (efc.proj_sphere[:, :, None]
              == torch.arange(P, device=p_pos.device)).to(p_pos.dtype)  # (B,K,P)
    F = (onehot[..., None] * F_slot[:, :, None, :]).sum(1)               # (B,P,3)
    dt = model.timestep[..., None, None]
    vel = p_vel + dt * (p_inv[..., None] * F + model.gravity[..., None, :])
    pos = p_pos + dt * vel
    below = pos[..., 2] < p_rad
    vz = torch.where(below, vel[..., 2].clamp_min(0.0), vel[..., 2])
    return (torch.cat([pos[..., :2], torch.maximum(pos[..., 2], p_rad)[..., None]], -1),
            torch.cat([vel[..., :2], vz[..., None]], -1))


def _aba_enabled(dtype) -> bool:
    """The articulated-body route for this call: float32 and SMPLSIM_ABA set
    to anything but 0/false/off (unset: off, the port's default)."""
    return dtype == torch.float32 and \
        os.environ.get("SMPLSIM_ABA", "0") not in ("0", "false", "off")


def aba_solver(model, kin):
    """solve(rhs (B,nv,m), diag (B,nv) | None) -> (M(kin) + armature +
    diag)^-1 rhs by the articulated-body elimination (physics/aba.py):
    the mass matrix of these kinematics is never formed or factored."""
    arm = model.armature.to(kin.S.dtype)

    def solve(rhs, diag=None):
        d = (arm if diag is None else arm + diag).expand(rhs.shape[0], rhs.shape[1])
        return aba.mass_solve(model.parents, kin.S, kin.com, kin.inertia_w, kin.xpos,
                              model.body_mass, d, rhs)
    return solve


def control_loop(model, q, v, M, C, f_w, target, reset_ref, control_freq_inv: int,
                 qp_iters=None, K=None, tol=None, keeps=None, reference: bool = False,
                 ext_force=None, proj=None):
    """Run the substeps from (q, v) with the stale (M, C) and warm start f_w,
    in the batched form (dense, or the articulated-body route where
    `_aba_enabled`) or (`reference`) the per-env reference form, with the
    optional hooks above.

    Returns (q, v, M, C, f_w, power (B,), nactive_max (B,) int32,
    stalled_any (B,), geom_floor_contact (B,ngeom)) after the last substep,
    and with `proj` the spheres' (pos, vel) as a tenth entry."""
    reset_q, reset_v, M_reset, C_reset = reset_ref
    B, nv = v.shape
    dt = model.timestep
    power = torch.zeros(B, dtype=q.dtype, device=q.device)
    nact = torch.zeros(B, dtype=torch.int32, device=q.device)
    stall = torch.zeros(B, dtype=torch.bool, device=q.device)
    gfc = None
    z6 = torch.zeros((B, 6), dtype=q.dtype, device=q.device)
    if proj is not None:
        p_pos, p_vel, p_rad, p_inv = proj
    use_aba = not reference and _aba_enabled(q.dtype)
    if use_aba:
        # the first substep's torque against the cached dense M0 (the one
        # chol_solve of the control step); the reset torque by elimination
        # at the reset pose
        tau = stable_pd_torque(model, M, C, q, v, target)
        rq, rv = reset_q.expand(B, -1), reset_v.expand(B, -1)
        tau_reset = stable_pd_torque(model, aba_solver(model, kinematics.fk(model, rq)),
                                     C_reset.expand(B, -1), rq, rv, target)
        q_stale = q
    for _ in range(control_freq_inv):
        if not use_aba:
            tau = (stable_pd_torque_ref if reference else stable_pd_torque)(
                model, M, C, q, v, target)
        kin = kinematics.fk(model, q)
        M = aba_solver(model, kin) if use_aba else dynamics.mass_matrix(model, kin)
        C = dynamics.bias_forces(model, kin, v)
        qfrc = torch.cat([z6, model.gear * tau], 1) - model.dof_damping * v - C
        if ext_force is not None:
            qfrc = qfrc + dynamics.external_forces(model, kin, ext_force)
        spheres = None if proj is None else (p_pos, p_vel, p_rad, p_inv)
        efc = constraints.make_efc(model, kin, q, v, keeps, spheres)
        if reference:
            chol, qacc_s = ad_linalg.cho_factor_solve(M, qfrc[..., None])
            smooth = dynamics.Smooth(M=M, chol=chol, qfrc_smooth=qfrc, qacc_smooth=qacc_s[..., 0])
            sol = solver.solve_constraints_gram(model, kin.S, smooth, efc, f_w, qp_iters, K, tol)
            qacc, f_w2, nactive, stalled = sol.qacc, sol.efc_force, sol.nactive, sol.stalled
        else:
            qacc, f_w2, nactive, stalled = solver.solve_constraints(
                model, kin.S, M, qfrc, efc, f_w, qp_iters, K, tol)
        q2, v2 = integrator.euler_step(q, v, qacc, dt)
        if proj is not None:
            p_pos, p_vel = _sphere_step(model, efc, f_w2, p_pos, p_vel, p_rad, p_inv)

        bad = _bad(q) | _bad(v) | _bad(qacc)
        b1 = bad[:, None]
        power = power + torch.where(bad, torch.zeros_like(power),
                                    (tau * v[:, 6:]).abs().sum(1))
        if use_aba:
            # the next substep's torque while this substep's (M, C) pair is
            # live: bad rows take the reset torque and stale pose
            tau = torch.where(b1, tau_reset, stable_pd_torque(model, M, C, q2, v2, target))
            q_stale = torch.where(b1, reset_q, q)
        q = torch.where(b1, reset_q, q2)
        v = torch.where(b1, reset_v, v2)
        if not use_aba:
            M = torch.where(b1[..., None], M_reset, M)
        C = torch.where(b1, C_reset, C)
        f_w = torch.where(b1, torch.zeros_like(f_w2), f_w2)
        nact = torch.maximum(nact, nactive)
        stall = stall | stalled
        gfc = efc.geom_floor_contact
    if use_aba:
        # the returned stale M: one dense CRBA at the last substep's pose
        M = dynamics.mass_matrix(model, kinematics.fk(model, q_stale))
    out = (q, v, M, C, f_w, power, nact, stall, gfc)
    return out if proj is None else out + ((p_pos, p_vel),)
