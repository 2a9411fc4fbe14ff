"""Mass matrix and bias forces, batched (CRBA / RNEA about the world origin).

Port of smplsim_tpu/physics/dynamics.py (and its batched twin
dynamics_lanes.py):

  M = anc^T * G + anc * G^T - diag(G) + diag(armature),
      G_ij = S_i . (IC_{b(j)} S_j)
  C_i = S_i . sum_{b in subtree(i)} [I_b a_b + v_b x* (I_b v_b) - f_grav,b]

with IC the composite spatial inertias and a_b the velocity-product
accelerations; the tree recursions are dense products with the static masks
of physics/topology.py.

`smooth_dynamics` (the per-env path's unconstrained step,
smplsim_tpu/physics/dynamics.py::smooth_dynamics) factors M and solves for
the smooth acceleration in one `cho_factor_solve` launch (differentiable:
physics/linalg.py).
"""
from __future__ import annotations

import dataclasses

import torch

from smplsim_tpu_torch.models.spec import RobotModel
from smplsim_tpu_torch.physics import algebra, linalg
from smplsim_tpu_torch.physics.kinematics import Kin
from smplsim_tpu_torch.physics.topology import mask_tensor
from smplsim_tpu_torch.utils.profiler import span


def _mask(model: RobotModel, name: str, like: torch.Tensor) -> torch.Tensor:
    return mask_tensor(model.parents, name, like.dtype, like.device)


@span("smplsim.physics.crba")
def mass_matrix(model: RobotModel, kin: Kin) -> torch.Tensor:
    """(B,nv,nv) joint-space inertia including armature (== mj_fullM)."""
    S = kin.S
    nv = S.shape[1]
    dtype = S.dtype
    I_O = algebra.spatial_inertia(model.body_mass.to(dtype), kin.com, kin.inertia_w)
    IC = torch.einsum("bd,ndij->nbij", _mask(model, "subtree_body", S), I_O)
    dof_body = _mask(model, "dof_body", S)
    F = (IC[:, dof_body] @ S[..., None])[..., 0]                # (B,nv,6)
    G = S @ F.transpose(-1, -2)                                  # (B,nv,nv)
    anc = _mask(model, "dof_prefix", S)
    Gd = torch.diagonal(G, dim1=-2, dim2=-1)
    eye = torch.eye(nv, dtype=dtype, device=S.device)
    M = anc.T * G + anc * G.transpose(-1, -2) - eye * Gd[:, None, :]
    # the transposed operands leave M column-major; the solve kernels take
    # row-major (M is symmetric, so this only moves memory)
    return (M + eye * model.armature.to(dtype)[..., None, :]).contiguous()


@span("smplsim.physics.rnea")
def bias_forces(model: RobotModel, kin: Kin, qvel: torch.Tensor) -> torch.Tensor:
    """(B,nv) Coriolis/centrifugal plus gravity forces (== qfrc_bias)."""
    S = kin.S
    dtype = S.dtype
    Sq = S * qvel[..., None]                                     # (B,nv,6)
    v_dof = _mask(model, "dof_frame", S) @ Sq
    w = algebra.motion_cross(v_dof, Sq)
    body_dof = _mask(model, "body_dof", S)
    a_body = body_dof @ w                                        # (B,J,6)
    V = body_dof @ Sq
    mass = model.body_mass.to(dtype)
    I_O = algebra.spatial_inertia(mass, kin.com, kin.inertia_w)
    IV = (I_O @ V[..., None])[..., 0]
    f = (I_O @ a_body[..., None])[..., 0] + algebra.force_cross(V, IV)
    mg = mass[..., :, None] * model.gravity.to(dtype)[..., None, :]   # (J,3) or (B,J,3)
    f = f - torch.cat([algebra.cross(kin.com, mg), mg.expand_as(kin.com)], dim=-1)
    fC = _mask(model, "dof_subtree_body", S) @ f                 # (B,nv,6)
    return (S * fC).sum(-1)


def external_forces(model: RobotModel, kin: Kin, force: torch.Tensor,
                    torque: torch.Tensor | None = None) -> torch.Tensor:
    """(B,nv) generalized forces of per-body external wrenches (MuJoCo's
    xfrc_applied): force (B,J,3) in the world frame at each body's COM,
    torque (B,J,3) optional. Each wrench about the world origin,
    [c x f + torque; f], is projected onto the dofs of its ancestors through
    the subtree mask that bias_forces uses."""
    tau = torch.zeros_like(force) if torque is None else torque
    w = torch.cat([algebra.cross(kin.com, force) + tau, force], dim=-1)   # (B,J,6)
    fC = _mask(model, "dof_subtree_body", kin.S) @ w                       # (B,nv,6)
    return (kin.S * fC).sum(-1)


def passive_forces(model: RobotModel, qvel: torch.Tensor) -> torch.Tensor:
    """(B,nv) passive joint forces (damping; SMPL models have no springs)."""
    return -model.dof_damping * qvel


def actuator_forces(model: RobotModel, ctrl: torch.Tensor) -> torch.Tensor:
    """(B,nv) generalized forces of the motors: gear * ctrl on each hinge."""
    z6 = torch.zeros((ctrl.shape[0], 6), dtype=ctrl.dtype, device=ctrl.device)
    return torch.cat([z6, model.gear * ctrl], 1)


@dataclasses.dataclass
class Smooth:
    M: torch.Tensor            # (B,nv,nv)
    chol: torch.Tensor         # (B,nv,nv) lower Cholesky factor of M, zeros above
    qfrc_smooth: torch.Tensor  # (B,nv) total smooth force
    qacc_smooth: torch.Tensor  # (B,nv) unconstrained acceleration


def smooth_dynamics(model: RobotModel, kin: Kin, qvel: torch.Tensor,
                    ctrl: torch.Tensor) -> Smooth:
    """M, its factor, the smooth force under actuation ctrl (B,nu) and the
    unconstrained acceleration M^-1 qfrc_smooth."""
    M = mass_matrix(model, kin)
    qfrc = (actuator_forces(model, ctrl) + passive_forces(model, qvel)
            - bias_forces(model, kin, qvel))
    chol, qacc = linalg.cho_factor_solve(M, qfrc[..., None])
    return Smooth(M=M, chol=chol, qfrc_smooth=qfrc, qacc_smooth=qacc[..., 0])
