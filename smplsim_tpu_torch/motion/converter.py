"""Cross-model state remapping + SMPL pose normalization (a numpy copy of
smplsim_tpu/motion/converter.py).

`SMPLConverter` remaps
qpos/qvel/body-position arrays between two humanoid RobotModels whose body
sets differ (e.g. SMPL 24-body <-> SMPLH 52-body with hands), and exposes the
per-joint diff-weight/kp/kd/action-scale/torque tables keyed by the target
model's bodies (smpl_mujoco_new.py:88-371). `normalize_smpl_pose` re-headings
an AMASS clip so the subject faces a canonical direction
(smpl_mujoco_new.py:374-401).

Everything here is host-side model/build-time plumbing (numpy), not hot-path:
it reads a RobotModel's body names and sizes only.
"""
from __future__ import annotations

import numpy as np

from smplsim_tpu_torch.models.spec import RobotModel

# per-joint blending weight for imitation losses (smpl_mujoco_new.py:90-117
# smpl; :144-199 smplh/x — fingers weighted 0.3, toes/hands 0)
BODY_WS_SMPL = {
    "Pelvis": 1.0, "L_Hip": 1.0, "L_Knee": 1.0, "L_Ankle": 1.0, "L_Toe": 0.0,
    "R_Hip": 1.0, "R_Knee": 1.0, "R_Ankle": 1.0, "R_Toe": 0.0,
    "Torso": 1.0, "Spine": 1.0, "Chest": 1.0, "Neck": 1.0, "Head": 1.0,
    "L_Thorax": 1.0, "L_Shoulder": 1.0, "L_Elbow": 1.0, "L_Wrist": 1.0,
    "L_Hand": 0.0,
    "R_Thorax": 1.0, "R_Shoulder": 1.0, "R_Elbow": 1.0, "R_Wrist": 1.0,
    "R_Hand": 0.0,
}

# (kp, kd, action_scale, torque_limit) per joint (smpl_mujoco_new.py:118-142)
BODY_PARAMS_SMPL = {
    "L_Hip": [500, 50, 1, 500], "L_Knee": [500, 50, 1, 500],
    "L_Ankle": [400, 40, 1, 500], "L_Toe": [200, 20, 1, 500],
    "R_Hip": [500, 50, 1, 500], "R_Knee": [500, 50, 1, 500],
    "R_Ankle": [400, 40, 1, 500], "R_Toe": [200, 20, 1, 500],
    "Torso": [1000, 100, 1, 500], "Spine": [1000, 100, 1, 500],
    "Chest": [1000, 100, 1, 500],
    "Neck": [100, 10, 1, 250], "Head": [100, 10, 1, 250],
    "L_Thorax": [400, 40, 1, 500], "L_Shoulder": [400, 40, 1, 500],
    "L_Elbow": [300, 30, 1, 150], "L_Wrist": [100, 10, 1, 150],
    "L_Hand": [100, 10, 1, 150],
    "R_Thorax": [400, 40, 1, 150], "R_Shoulder": [400, 40, 1, 250],
    "R_Elbow": [300, 30, 1, 150], "R_Wrist": [100, 10, 1, 150],
    "R_Hand": [100, 10, 1, 150],
}


def _hand_tables():
    ws, params = dict(BODY_WS_SMPL), dict(BODY_PARAMS_SMPL)
    ws.pop("L_Hand"), ws.pop("R_Hand")
    params.pop("L_Hand"), params.pop("R_Hand")
    for side in ("L", "R"):
        for finger in ("Index", "Middle", "Pinky", "Ring", "Thumb"):
            for k in (1, 2, 3):
                ws[f"{side}_{finger}{k}"] = 0.3
                params[f"{side}_{finger}{k}"] = [100, 10, 1, 100]
    return ws, params


BODY_WS_SMPLH, BODY_PARAMS_SMPLH = _hand_tables()


def body_qpos_addr(model: RobotModel) -> dict[str, tuple[int, int]]:
    """Per-body qpos index ranges (utils/mujoco_utils.py get_body_qposaddr:
    freejoint root 0:7, then 3 hinge dofs per body)."""
    out = {model.body_names[0]: (0, 7)}
    for i, n in enumerate(model.body_names[1:]):
        out[n] = (7 + 3 * i, 7 + 3 * i + 3)
    return out


def body_qvel_addr(model: RobotModel) -> dict[str, tuple[int, int]]:
    out = {model.body_names[0]: (0, 6)}
    for i, n in enumerate(model.body_names[1:]):
        out[n] = (6 + 3 * i, 6 + 3 * i + 3)
    return out


class SMPLConverter:
    """Remap state arrays between `model` (source) and `new_model` (target).

    Missing joints in the source are zero-filled; jpos/qpos/qvel subsets pick
    the source joints back out of the target layout
    (smpl_mujoco_new.py:266-343)."""

    def __init__(self, model: RobotModel, new_model: RobotModel,
                 smpl_model: str = "smpl"):
        if smpl_model == "smpl":
            self.body_ws, self.body_params = BODY_WS_SMPL, BODY_PARAMS_SMPL
        elif smpl_model in ("smplh", "smplx"):
            self.body_ws, self.body_params = BODY_WS_SMPLH, BODY_PARAMS_SMPLH
        else:
            raise ValueError(smpl_model)
        self.model, self.new_model = model, new_model
        self.smpl_qpos_addr = body_qpos_addr(model)
        self.smpl_qvel_addr = body_qvel_addr(model)
        self.new_qpos_addr = body_qpos_addr(new_model)
        self.new_qvel_addr = body_qvel_addr(new_model)
        self.smpl_joint_names = list(model.body_names)
        self.new_joint_names = list(new_model.body_names)
        self.smpl_nq, self.new_nq = model.nq, new_model.nq

    # ---------------- remaps ----------------
    def _fwd(self, x, src_addr, dst_addr):
        x = np.asarray(x)
        batched = x.ndim == 2
        cols = []
        for k, (lo, hi) in dst_addr.items():
            if k in src_addr:
                s0, s1 = src_addr[k]
                cols.append(x[..., s0:s1])
            else:
                shape = (x.shape[0], hi - lo) if batched else (hi - lo,)
                cols.append(np.zeros(shape, x.dtype))
        return np.concatenate(cols, axis=-1)

    def qpos_smpl_2_new(self, qpos):
        return self._fwd(qpos, self.smpl_qpos_addr, self.new_qpos_addr)

    def qvel_smpl_2_new(self, qvel):
        return self._fwd(qvel, self.smpl_qvel_addr, self.new_qvel_addr)

    def _subset(self, x, dst_addr):
        idx = np.concatenate([
            np.arange(dst_addr[j][0], dst_addr[j][1])
            for j in self.smpl_joint_names
        ])
        return np.asarray(x)[..., idx]

    def qpos_new_2_smpl(self, qpos):
        return self._subset(qpos, self.new_qpos_addr)

    def qvel_new_2_smpl(self, qvel):
        return self._subset(qvel, self.new_qvel_addr)

    def jpos_new_2_smpl(self, jpos):
        jpos = np.asarray(jpos)
        subset = np.asarray(
            [self.new_joint_names.index(j) for j in self.smpl_joint_names]
        )
        if jpos.ndim == 1 or (jpos.ndim == 2 and jpos.shape[1] == 3):
            return jpos.reshape(-1, 3)[subset]
        return jpos.reshape(jpos.shape[0], -1, 3)[:, subset]

    # ---------------- target-model tables ----------------
    def get_new_qpos_lim(self) -> int:
        return self.new_nq

    def get_new_qvel_lim(self) -> int:
        return self.new_model.nv

    def get_new_body_lim(self) -> int:
        return self.new_model.nbody

    def get_new_diff_weight(self):
        return np.asarray(
            [self.body_ws.get(n, 0.0) for n in self.new_joint_names]
        )

    def _param(self, col, default):
        return np.concatenate([
            [self.body_params[n][col]] * 3 if n in self.body_ws
            else [default] * 3
            for n in self.new_joint_names[1:]
        ])

    def get_new_jkp(self):
        return self._param(0, 50)

    def get_new_jkd(self):
        return self._param(1, 5)

    def get_new_a_scale(self):
        return self._param(2, 1)

    def get_new_torque_limit(self):
        return self._param(3, 200)


# ---------------------------------------------------------------------------
def vertizalize_smpl_root(pose_aa: np.ndarray, root_vec) -> np.ndarray:
    """Overwrite the root axis-angle of every frame (utils helper the
    reference imports; keeps the remaining 69/153 dofs)."""
    out = np.array(pose_aa, dtype=np.float64, copy=True)
    out[..., :3] = np.asarray(root_vec, dtype=np.float64)
    return out


def normalize_smpl_pose(pose_aa, trans=None, random_root=False, rng=None):
    """Face the subject along a canonical heading, re-zero the xy trajectory
    (smpl_mujoco_new.py:374-401). Returns (pose_aa', trans')."""
    from scipy.spatial.transform import Rotation as sRot

    pose_aa = np.asarray(pose_aa, dtype=np.float64)
    root_aa = pose_aa[0, :3]
    root_rot = sRot.from_rotvec(root_aa)
    root_euler = np.asarray(root_rot.as_euler("xyz", degrees=False))
    target_root_euler = root_euler.copy()
    if random_root:
        rng = np.random.default_rng() if rng is None else rng
        target_root_euler[2] = rng.random() * np.pi * 2
    else:
        target_root_euler[2] = -1.57
    target_root_rot = sRot.from_euler("xyz", target_root_euler, degrees=False)
    pose_aa = vertizalize_smpl_root(pose_aa, target_root_rot.as_rotvec())

    if trans is not None:
        trans = np.array(trans, dtype=np.float64, copy=True)
        apply_mat = target_root_rot.as_matrix() @ np.linalg.inv(root_rot.as_matrix())
        trans[:, [0, 1]] -= trans[0, [0, 1]]
        trans[:, 2] = trans[:, 2] - trans[0, 2] + 0.91437225
        trans = (apply_mat @ trans.T).T
    return pose_aa, trans
