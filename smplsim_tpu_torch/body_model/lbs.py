"""Linear blend skinning for SMPL-family body models, on tensors.

Port of smplsim_tpu/body_model/lbs.py. Standard SMPL math:

    v_shaped = v_template + shapedirs . betas
    J = J_regressor @ v_shaped
    v_posed  = v_shaped + posedirs . (R(theta) - I)        [pose blendshapes]
    verts    = sum_k W[:,k] * (G_k(theta, J) @ v_posed)    [skinning]

(Loper et al., "SMPL: A Skinned Multi-Person Linear Model").
"""
from __future__ import annotations

import torch

from smplsim_tpu_torch import transforms as T


def blend_shapes(betas: torch.Tensor, shape_disps: torch.Tensor) -> torch.Tensor:
    """(B, num_betas) x (V,3,num_betas) -> (B,V,3)."""
    return torch.einsum("bl,vdl->bvd", betas, shape_disps)


def vertices2joints(J_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """(J,V) x (B,V,3) -> (B,J,3)."""
    return torch.einsum("jv,bvd->bjd", J_regressor, vertices)


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor, parents):
    """rot_mats (B,J,3,3) local joint rotations, joints (B,J,3) rest-pose
    joint positions, parents (J,) with parents[0] == -1. Returns
    (posed_joints (B,J,3), rel_transforms (B,J,4,4))."""
    B, J = joints.shape[:2]
    rel = joints.clone()
    rel[:, 1:] -= joints[:, list(parents[1:])]              # local offsets
    local = torch.zeros(rot_mats.shape[:-2] + (4, 4), dtype=joints.dtype, device=joints.device)
    local[..., :3, :3] = rot_mats
    local[..., :3, 3] = rel
    local[..., 3, 3] = 1.0
    chains = [local[:, 0]]
    for j in range(1, J):
        chains.append(chains[parents[j]] @ local[:, j])
    G = torch.stack(chains, dim=1)                          # (B,J,4,4)
    posed_joints = G[..., :3, 3]
    # skinning takes displacements from the rest pose: subtract the rest
    # joint location carried by G
    joints_h = torch.cat([joints, joints.new_zeros((B, J, 1))], -1)
    correction = torch.einsum("bjik,bjk->bji", G, joints_h)
    rel_G = G.clone()
    rel_G[..., :3, 3] -= correction[..., :3]
    return posed_joints, rel_G


def lbs(betas, pose_aa, v_template, shapedirs, posedirs, J_regressor, parents, lbs_weights):
    """betas (B,num_betas), pose_aa (B,J*3) axis-angle with the global
    orientation first, v_template (V,3), shapedirs (V,3,num_betas), posedirs
    ((J-1)*9, V*3) or None to skip the pose blend shapes, J_regressor (J,V),
    parents (J,), lbs_weights (V,J). Returns (vertices (B,V,3), joints
    (B,J,3))."""
    B = betas.shape[0]
    J = len(parents)
    v_shaped = v_template[None] + blend_shapes(betas, shapedirs)
    joints = vertices2joints(J_regressor, v_shaped)

    rot = T.quat_to_matrix(T.exp_map_to_quat(pose_aa.reshape(B, J, 3)))
    if posedirs is not None:
        ident = torch.eye(3, dtype=betas.dtype, device=betas.device)
        pose_feature = (rot[:, 1:] - ident).reshape(B, -1)  # (B,(J-1)*9)
        v_posed = v_shaped + torch.einsum("bp,pv->bv", pose_feature, posedirs).reshape(B, -1, 3)
    else:
        v_posed = v_shaped

    posed_joints, G = batch_rigid_transform(rot, joints, parents)
    T_skin = torch.einsum("vj,bjik->bvik", lbs_weights, G)   # (B,V,4,4)
    v_h = torch.cat([v_posed, v_posed.new_ones(v_posed.shape[:-1] + (1,))], dim=-1)
    verts = torch.einsum("bvik,bvk->bvi", T_skin, v_h)[..., :3]
    return verts, posed_joints
