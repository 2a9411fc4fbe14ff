"""2-D-keypoint pose fitting: differentiable reprojection losses and Adam
(port of smplsim_tpu/motion/fitting.py).

The camera projection of FK'd joints onto OpenPose-style 2-D detections,
with the JAX package's loss family: weighted-L2 reprojection
(`proj_2d_loss`), the camera-ray line loss (`proj_2d_line_loss`), the
root-centered body loss (`proj_2d_body_loss`) and the root-only loss
(`proj_2d_root_loss`). Autograd differentiates the losses through the FK
(its exponential map is exact at zero angles in value and gradient);
`fit` runs torch.optim.Adam with optax.adam's defaults (b1 0.9, b2 0.999,
eps 1e-8) in a loop that stays on the device: nothing is read back until
it returns.

Input vector layout (T, 1, 3 + J*3) = [trans | root aa | body aa], SMPL
joint order. The fitter lives on its FK's device; the camera and targets
are moved there.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from smplsim_tpu_torch.motion.fk import HumanoidBatchFK
from smplsim_tpu_torch.physics.precision import ieee_fp32

# SMPL joint index for each of the 25 OpenPose joints (the standard smpl2op
# map; entries >= 22 have no SMPL joint and are dropped)
SMPL2OP_MAP = np.array(
    [24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7, 25, 26, 27, 28,
     29, 30, 31, 32, 33, 34]
)


def smpl_op_to_op(pred_joints2d: torch.Tensor) -> torch.Tensor:
    """SMPL-subset keypoints -> the OpenPose layout: the neck and mid-hip
    made as midpoints."""
    return torch.cat([
        pred_joints2d[..., [1, 4], :].mean(-2, keepdim=True),
        pred_joints2d[..., 1:7, :],
        pred_joints2d[..., [7, 8, 11], :].mean(-2, keepdim=True),
        pred_joints2d[..., 9:11, :],
        pred_joints2d[..., 12:, :],
    ], dim=-2)


def normalize_screen_coordinates(X: torch.Tensor, w: float = 1920, h: float = 1080):
    """[0,w] x [0,h] -> [-1,1], keeping the aspect."""
    return X / w * 2 - torch.tensor([1.0, h / w], dtype=X.dtype, device=X.device)


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Extrinsics and intrinsics (numpy)."""

    full_R: np.ndarray   # (3,3)
    full_t: np.ndarray   # (3,)
    K: np.ndarray        # (3,3)
    img_w: float = 1920.0
    img_h: float = 1080.0


class PoseFitter:
    """Fit (trans, pose_aa) sequences to per-frame 2-D keypoints."""

    def __init__(self, fk: HumanoidBatchFK, cam: CameraParams,
                 smpl2op_map: np.ndarray | None = None, recency_lambda: float = 0.3):
        self.fk = fk
        self.cam = cam
        self.device = fk.device
        smpl2op_map = SMPL2OP_MAP if smpl2op_map is None else smpl2op_map
        self.openpose_subindex = smpl2op_map < 22
        self.smpl2op_partial = smpl2op_map[self.openpose_subindex]
        self.recency_lambda = recency_lambda
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=self.device)
        self._R, self._t, self._K = as_t(cam.full_R), as_t(cam.full_t), as_t(cam.K)
        self._Kinv = as_t(np.linalg.inv(cam.K))
        # mujoco-ordered world joints -> the SMPL subset of the OpenPose map
        self._joints = torch.as_tensor(
            np.asarray(fk.mujoco_2_smpl)[self.smpl2op_partial], device=self.device)

    # ---------------- targets ----------------
    @ieee_fp32()
    def set_targets(self, tgt_joints_2d, inliers=None):
        """tgt_joints_2d (T, K2, 2) pixel coordinates; inliers bool (T, K2).
        Precomputes the camera rays and the exponential recency weights."""
        tgt = torch.as_tensor(tgt_joints_2d, device=self.device)
        Tn, K2 = tgt.shape[0], tgt.shape[1]
        self.gt_2d = tgt
        self.gt_2d_norm = normalize_screen_coordinates(tgt, self.cam.img_w, self.cam.img_h)
        self.inliers = (torch.ones((Tn, K2), dtype=torch.bool, device=self.device)
                        if inliers is None else torch.as_tensor(inliers, device=self.device).bool())
        rays = torch.cat([tgt, torch.ones((Tn, K2, 1), dtype=tgt.dtype, device=self.device)], 2)
        rays = rays @ self._Kinv.to(tgt.dtype).T
        self.camera_rays = rays / torch.linalg.norm(rays, dim=2, keepdim=True)
        w = torch.exp(-self.recency_lambda * torch.arange(Tn, dtype=torch.float64,
                                                          device=self.device))
        w = (w / w.sum()).to(tgt.dtype)
        self.weighting = w[:, None, None].expand(Tn, K2, 2)

    # ---------------- forward ----------------
    def fk_from_vec(self, input_vec: torch.Tensor) -> torch.Tensor:
        """(T,1,3+J*3) -> mujoco-ordered world body positions (T,J,3)."""
        Tn = input_vec.shape[0]
        vec = input_vec.reshape(Tn, -1)
        trans = vec[:, :3][None]                      # (1,T,3)
        pose_aa = vec[:, 3:].reshape(1, Tn, -1, 3)    # (1,T,J,3) SMPL order
        return self.fk.fk_batch(pose_aa, trans, count_offset=True)["global_translation"][0]

    def proj2d(self, wbpos: torch.Tensor, return_cam_3d: bool = False):
        """Mujoco-ordered world joints -> OpenPose-layout 2-D pixels."""
        dtype = wbpos.dtype
        p3 = wbpos[:, self._joints]                                   # (T,K,3)
        p3 = p3 @ self._R.to(dtype).T + self._t.to(dtype)
        p2 = p3 @ self._K.to(dtype).T
        p2 = smpl_op_to_op(p2[..., :2] / p2[..., 2:])
        return (p2, p3) if return_cam_3d else p2

    # ---------------- losses ----------------
    def _weighted(self, pred, ord: int, normalize: bool):
        if normalize:
            pred = normalize_screen_coordinates(pred, self.cam.img_w, self.cam.img_h)
            gt = self.gt_2d_norm
        else:
            gt = self.gt_2d
        if ord == 1:
            mask = self.inliers[..., None]
            return ((gt - pred).abs() * mask).sum() / mask.sum().clamp_min(1)
        w = self.weighting * self.inliers[..., None]
        return (((gt - pred) ** 2) * w).sum(0).mean()

    @ieee_fp32()
    def proj_2d_loss(self, input_vec, ord: int = 2, normalize: bool = True):
        return self._weighted(self.proj2d(self.fk_from_vec(input_vec)), ord, normalize)

    @ieee_fp32()
    def proj_2d_line_loss(self, input_vec):
        """Squared distance of the camera-frame joints to the detection rays;
        the 3-D joints go through the OpenPose merge as the 2-D targets do."""
        _, p3 = self.proj2d(self.fk_from_vec(input_vec), return_cam_3d=True)
        p3 = smpl_op_to_op(p3)
        return (torch.linalg.cross(p3, p3 - self.camera_rays, dim=-1) ** 2).mean()

    @ieee_fp32()
    def proj_2d_body_loss(self, input_vec, ord: int = 2, normalize: bool = False):
        """Root-centered: the prediction shifted so its mid-hip (joint 7 of
        the OpenPose layout) sits on the target's."""
        pred = self.proj2d(self.fk_from_vec(input_vec))
        pred = pred + (self.gt_2d[..., 7:8, :] - pred[..., 7:8, :])
        return self._weighted(pred, ord, normalize)

    @ieee_fp32()
    def proj_2d_root_loss(self, root_pos_rot):
        """Root-only L1 on the mid-hip keypoint of the first frame."""
        J = self.fk.num_joints
        vec = torch.cat([root_pos_rot.reshape(1, 1, 6),
                         torch.zeros((1, 1, (J - 1) * 3), dtype=root_pos_rot.dtype,
                                     device=root_pos_rot.device)], dim=2)
        pred = self.proj2d(self.fk_from_vec(vec))
        return (self.gt_2d[..., 7:8, :][:1] - pred[..., 7:8, :]).abs().mean()

    # ---------------- optimization ----------------
    @ieee_fp32()
    def fit(self, input_vec0: torch.Tensor, loss: str | Callable = "proj_2d_loss",
            steps: int = 200, lr: float = 0.02):
        """Adam descent on the chosen loss from input_vec0. Returns (vec,
        losses (steps,)): losses[i] is the loss before step i."""
        loss_fn = getattr(self, loss) if isinstance(loss, str) else loss
        vec = input_vec0.detach().clone().to(self.device).requires_grad_(True)
        opt = torch.optim.Adam([vec], lr=lr, betas=(0.9, 0.999), eps=1e-8)
        losses = torch.empty(steps, dtype=vec.dtype, device=vec.device)
        with torch.enable_grad():
            for i in range(steps):
                opt.zero_grad(set_to_none=False)
                val = loss_fn(vec)
                val.backward()
                opt.step()
                losses[i] = val.detach()
        return vec.detach(), losses
