"""Imitation / motion-tracking metrics, batched (port of
smplsim_tpu/eval/metrics.py).

Global and root-relative MPJPE, Procrustes-aligned MPJPE, velocity and
acceleration errors, the success criterion (global MPJPE < 120 mm), floor
penetration and foot skate, and the root-pose Frobenius error. Inputs are
(..., T, J, 3) positions in meters, time on axis -3: one sequence (T, J, 3)
as in the JAX package, or a leading batch (B, T, J, 3) where JAX callers
`vmap`; outputs in millimeters where the reference reports mm. The
functions with matrix products (p_mpjpe, frobenius_root_error and
compute_metrics_lite, which calls them) run with full-float32 products
(physics/precision.py); the rest are elementwise.
"""
from __future__ import annotations

import torch

from smplsim_tpu_torch.physics.precision import ieee_fp32


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(x, dim=-1)


def mpjpe_global(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(..., T, J, 3) x 2 -> (..., T, J) global per-joint position error [mm]."""
    return _norm(gt - pred) * 1000.0


def mpjpe_local(pred: torch.Tensor, gt: torch.Tensor, root_idx: int = 0) -> torch.Tensor:
    """Root-relative MPJPE [mm]."""
    pred = pred - pred[..., root_idx:root_idx + 1, :]
    gt = gt - gt[..., root_idx:root_idx + 1, :]
    return _norm(gt - pred) * 1000.0


@ieee_fp32()
def p_mpjpe(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Procrustes-aligned MPJPE ("Protocol #2"), (..., J, 3) -> (..., J) in
    the input's units. The SVD's U and V may differ from another library's
    by signs; the aligned error does not."""
    muX = target.mean(-2, keepdim=True)
    muY = predicted.mean(-2, keepdim=True)
    X0 = target - muX
    Y0 = predicted - muY
    normX = torch.sqrt((X0 ** 2).sum((-2, -1), keepdim=True))
    normY = torch.sqrt((Y0 ** 2).sum((-2, -1), keepdim=True))
    X0 = X0 / normX
    Y0 = Y0 / normY
    H = X0.transpose(-1, -2) @ Y0
    U, s, Vt = torch.linalg.svd(H)
    V = Vt.transpose(-1, -2)
    R = V @ U.transpose(-1, -2)
    sign = torch.sign(torch.linalg.det(R))
    V = torch.cat([V[..., :-1], V[..., -1:] * sign[..., None, None]], -1)
    s = torch.cat([s[..., :-1], s[..., -1:] * sign[..., None]], -1)
    R = V @ U.transpose(-1, -2)
    tr = s.sum(-1, keepdim=True)[..., None]
    a = tr * normX / normY
    t = muX - a * (muY @ R)
    aligned = a * (predicted @ R) + t
    return _norm(aligned - target)


def _vel(x: torch.Tensor) -> torch.Tensor:
    return x[..., 1:, :, :] - x[..., :-1, :, :]


def _acc(x: torch.Tensor) -> torch.Tensor:
    return x[..., :-2, :, :] - 2 * x[..., 1:-1, :, :] + x[..., 2:, :, :]


def compute_vel(joints: torch.Tensor) -> torch.Tensor:
    """(..., T, J, 3) -> (..., T-1) mean per-frame joint displacement norm."""
    return _norm(_vel(joints)).mean(-1)


def compute_accel(joints: torch.Tensor) -> torch.Tensor:
    """(..., T, J, 3) -> (..., T-2) mean second-difference norm."""
    return _norm(_acc(joints)).mean(-1)


def compute_error_vel(joints_gt: torch.Tensor, joints_pred: torch.Tensor) -> torch.Tensor:
    return _norm(_vel(joints_pred) - _vel(joints_gt)).mean(-1)


def compute_error_accel(joints_gt: torch.Tensor, joints_pred: torch.Tensor) -> torch.Tensor:
    return _norm(_acc(joints_pred) - _acc(joints_gt)).mean(-1)


def compute_penetration(verts: torch.Tensor, floor_z: float = 0.0) -> torch.Tensor:
    """(..., T, V, 3) -> (..., T) mean penetration depth below the floor [mm]."""
    below = floor_z - verts[..., 2]
    pen = torch.where(below > 0, below, torch.zeros_like(below))
    cnt = (below > 0).sum(-1)
    return torch.where(cnt > 0, pen.sum(-1) / cnt.clamp_min(1),
                       torch.zeros_like(pen[..., 0])) * 1000.0


def compute_skate(verts: torch.Tensor, floor_z: float = 0.0) -> torch.Tensor:
    """(..., T, V, 3) -> (..., T-1) mean horizontal slip of grounded vertices [mm]."""
    z = verts[..., 2]
    grounded = (z[..., :-1, :] <= floor_z) & (z[..., 1:, :] <= floor_z)
    offset = _norm(verts[..., 1:, :, :2] - verts[..., :-1, :, :2])
    cnt = grounded.sum(-1)
    s = torch.where(grounded, offset, torch.zeros_like(offset)).sum(-1)
    return torch.where(cnt > 0, s / cnt.clamp_min(1), torch.zeros_like(s)) * 1000.0


@ieee_fp32()
def frobenius_root_error(x_mats: torch.Tensor, y_mats: torch.Tensor) -> torch.Tensor:
    """Mean over time of || I - X Y^-1 ||_F, (..., T, 4, 4) homogeneous root
    poses -> (...)."""
    eye = torch.eye(4, dtype=x_mats.dtype, device=x_mats.device)
    err = eye - x_mats @ torch.linalg.inv(y_mats)
    return torch.linalg.norm(err, dim=(-2, -1)).mean(-1)


@ieee_fp32()
def compute_metrics_lite(pred_pos: torch.Tensor, gt_pos: torch.Tensor,
                         root_idx: int = 0) -> dict[str, torch.Tensor]:
    """The reference's compute_metrics_lite: (T, J, 3) or (B, T, J, 3)."""
    mg = mpjpe_global(pred_pos, gt_pos)
    vel = compute_error_vel(gt_pos, pred_pos) * 1000.0
    acc = compute_error_accel(gt_pos, pred_pos) * 1000.0
    p_l = pred_pos - pred_pos[..., root_idx:root_idx + 1, :]
    g_l = gt_pos - gt_pos[..., root_idx:root_idx + 1, :]
    ml = _norm(p_l - g_l) * 1000.0
    mpa = p_mpjpe(p_l, g_l) * 1000.0
    return {
        "mpjpe_g": mg,
        "mpjpe_l": ml,
        "mpjpe_pa": mpa,
        "vel_dist": vel,
        "accel_dist": acc,
        "ttr": mg.mean(-1) < 120.0,  # the success criterion
    }
