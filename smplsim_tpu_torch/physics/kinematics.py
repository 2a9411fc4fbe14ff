"""Forward kinematics and dof motion subspaces, batched.

Port of smplsim_tpu/physics/kinematics.py (and its batched twin fk_lanes.py).
qpos (B,nq): [0:3] root position, [3:7] root quaternion (wxyz), then the
intrinsic-XYZ hinge triple of each body. qvel (B,nv): [0:3] world linear
velocity of the root frame origin, [3:6] root angular velocity in the root
BODY frame, then hinge rates.

The model may be shared or stacked (models/spec.py): its fields are read
with the body axis indexed from the right. A shared model's per-body
offsets and rotations multiply every env's parent frame in one product
(BLAS gemv / gemm, as before stacking existed); a stacked model's take a
batched product per env, whose rounding differs from BLAS's in the last
bit, so FK of a stacked model of identical rows equals the shared model's
to a few ulps, not bit for bit (everything downstream of FK reads the
fields identically in both forms).
"""
from __future__ import annotations

import dataclasses

import torch

from smplsim_tpu_torch import transforms as T
from smplsim_tpu_torch.models.spec import RobotModel, check_batch
from smplsim_tpu_torch.physics.algebra import cross
from smplsim_tpu_torch.physics.topology import mask_tensor
from smplsim_tpu_torch.utils.profiler import span


@dataclasses.dataclass
class Kin:
    xpos: torch.Tensor       # (B,J,3) body frame origins, world
    xmat: torch.Tensor       # (B,J,3,3) body orientations, world
    S: torch.Tensor          # (B,nv,6) dof motion subspaces about the origin
    com: torch.Tensor        # (B,J,3) body COM, world
    inertia_w: torch.Tensor  # (B,J,3,3) rotational inertia about the COM, world


@span("smplsim.physics.fk")
def fk(model: RobotModel, qpos: torch.Tensor) -> Kin:
    parents = model.parents
    J = len(parents)
    B = qpos.shape[0]
    check_batch(model, B)
    dtype = qpos.dtype
    body_R_local = T.quat_to_matrix(model.body_quat.to(dtype))   # (J,3,3) or (B,J,3,3)
    body_pos = model.body_pos.to(dtype)

    root_R = T.quat_to_matrix(qpos[:, 3:7])
    hinge = qpos[:, 7:].reshape(B, J - 1, 3)
    ca, sa = torch.cos(hinge), torch.sin(hinge)

    xpos = [qpos[:, 0:3]]
    xmat = [root_R]
    axes = []
    for b in range(1, J):
        p = parents[b]
        Rp = xmat[p]
        # Two forms of one product. A stacked model takes batched products
        # over its (B,) fields; the shared model keeps its gemv/gemm, whose
        # rounding is the one the test below holds against JAX. The state of
        # tests/test_torch_modules.py::test_self_contacts_match_wide_keeps[2]
        # is a knife edge of the narrowphase itself: the JAX package's own
        # per-env self_contacts flips its deep capsule-box contacts under
        # random one-ulp changes of its FK frames (in 62-159 of 200 trials,
        # tests/_torch_fk_ulp_check.py), and a form that makes stacked copies
        # bit for bit the shared model (elementwise products for both) flips
        # that test. So stacked copies of one body agree with the shared
        # model to a few ulps here, not bit for bit.
        if model.stacked:
            pos = xpos[p] + (Rp @ body_pos[:, b, :, None])[..., 0]
            F0 = Rp @ body_R_local[:, b]          # frame before the hinge stack
        else:
            pos = xpos[p] + Rp @ body_pos[b]
            F0 = Rp @ body_R_local[b]
        i = b - 1
        cx, cy, cz = ca[:, i, 0, None], ca[:, i, 1, None], ca[:, i, 2, None]
        sx, sy, sz = sa[:, i, 0, None], sa[:, i, 1, None], sa[:, i, 2, None]
        # F1 = F0 Rx, F2 = F1 Ry, R = F2 Rz as column updates
        F1 = torch.stack([F0[..., 0], F0[..., 1] * cx + F0[..., 2] * sx,
                          -F0[..., 1] * sx + F0[..., 2] * cx], dim=-1)
        F2 = torch.stack([F1[..., 0] * cy - F1[..., 2] * sy, F1[..., 1],
                          F1[..., 0] * sy + F1[..., 2] * cy], dim=-1)
        R = torch.stack([F2[..., 0] * cz + F2[..., 1] * sz,
                         -F2[..., 0] * sz + F2[..., 1] * cz, F2[..., 2]], dim=-1)
        xpos.append(pos)
        xmat.append(R)
        # world hinge axes: x of F0, y of F1, z of F2
        axes.append(torch.stack([F0[..., 0], F1[..., 1], F2[..., 2]], dim=1))

    xpos_t = torch.stack(xpos, dim=1)                  # (B,J,3)
    xmat_t = torch.stack(xmat, dim=1)                  # (B,J,3,3)

    eye = torch.eye(3, dtype=dtype, device=qpos.device).expand(B, 3, 3)
    S_trans = torch.cat([torch.zeros_like(eye), eye], dim=-1)           # (B,3,6)
    rot_axes = root_R.transpose(-1, -2)     # row k: world direction of body axis k
    S_rot = torch.cat([rot_axes, cross(qpos[:, None, 0:3], rot_axes)], dim=-1)
    hinge_axes = torch.cat(axes, dim=1)                                 # (B,nu,3)
    anchors = xpos_t[:, 1:].repeat_interleave(3, dim=1)
    S_hinge = torch.cat([hinge_axes, cross(anchors, hinge_axes)], dim=-1)
    S = torch.cat([S_trans, S_rot, S_hinge], dim=1)                     # (B,nv,6)

    com = xpos_t + (xmat_t @ model.body_ipos.to(dtype)[..., None])[..., 0]
    inertia_w = xmat_t @ model.body_inertia.to(dtype) @ xmat_t.transpose(-1, -2)
    return Kin(xpos=xpos_t, xmat=xmat_t, S=S, com=com, inertia_w=inertia_w)


def body_quats(model: RobotModel, qpos: torch.Tensor) -> torch.Tensor:
    """(B,J,4) world body quaternions."""
    J = model.nbody
    B = qpos.shape[0]
    hinge = qpos[:, 7:].reshape(B, J - 1, 3)
    frame = torch.cat([qpos[:, None, 3:7],
                       model.body_quat[..., 1:, :].to(qpos.dtype).expand(B, J - 1, 4)], dim=1)
    ident = torch.zeros(B, 1, 4, dtype=qpos.dtype, device=qpos.device)
    ident[..., 0] = 1.0
    local = T.quat_mul(frame, torch.cat([ident, T.euler_xyz_to_quat(hinge)], dim=1))
    out = [local[:, 0]]
    for b in range(1, J):
        out.append(T.quat_mul(out[model.parents[b]], local[:, b]))
    return torch.stack(out, dim=1)


def body_twists(model: RobotModel, kin: Kin, qvel: torch.Tensor) -> torch.Tensor:
    """(B,J,6) body twists [omega; v_O] about the world origin."""
    body_dof = mask_tensor(model.parents, "body_dof", kin.S.dtype, kin.S.device)
    return body_dof @ (kin.S * qvel[..., None])


def body_velocities(model: RobotModel, kin: Kin, qvel: torch.Tensor):
    """World linear velocity of each body frame origin and angular velocity,
    (B,J,3) each (MuJoCo's framelinvel / frameangvel sensors on xbody)."""
    V = body_twists(model, kin, qvel)
    w, v0 = V[..., :3], V[..., 3:]
    return v0 + cross(w, kin.xpos), w
