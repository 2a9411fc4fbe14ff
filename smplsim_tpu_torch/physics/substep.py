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

import torch

from smplsim_tpu_torch.physics import constraints, dynamics, integrator, kinematics, solver
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


def control_loop(model, q, v, M, C, f_w, target, reset_ref, control_freq_inv: int,
                 qp_iters=None, K=None, tol=None, keeps=None, reference: bool = False,
                 ext_force=None, proj=None):
    """Run the substeps from (q, v) with the stale (M, C) and warm start f_w,
    in the batched form or (`reference`) the per-env reference form, with
    the optional hooks above.

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
    for _ in range(control_freq_inv):
        tau = (stable_pd_torque_ref if reference else stable_pd_torque)(
            model, M, C, q, v, target)
        kin = kinematics.fk(model, q)
        M = dynamics.mass_matrix(model, kin)
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
        q = torch.where(b1, reset_q, q2)
        v = torch.where(b1, reset_v, v2)
        M = torch.where(b1[..., None], M_reset, M)
        C = torch.where(b1, C_reset, C)
        f_w = torch.where(b1, torch.zeros_like(f_w2), f_w2)
        nact = torch.maximum(nact, nactive)
        stall = stall | stalled
        gfc = efc.geom_floor_contact
    out = (q, v, M, C, f_w, power, nact, stall, gfc)
    return out if proj is None else out + ((p_pos, p_vel),)
