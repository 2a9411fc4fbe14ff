"""SMPL/SMPLH/SMPLX/MANO body-model parsers on the port's LBS.

Port of smplsim_tpu/body_model/smpl.py: loads an official model file
(.pkl/.npz) or takes its arrays as a dict, and exposes get_joints_verts
(pose + betas -> verts, joints) and get_offsets (the zero-pose skeleton and
skin the humanoid builder reads). The model data are licensed and not in
the repository. The parser is host work: its tensors are float64 on the
CPU.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from smplsim_tpu_torch.body_model.lbs import lbs
from smplsim_tpu_torch.motion import joint_names as JN

_NUM_JOINTS = {"smpl": 24, "smplh": 52, "smplx": 55, "mano": 16}
_NUM_POSE = {"smpl": 72, "smplh": 156, "smplx": 165, "mano": 48}


def _to_np(x) -> np.ndarray:
    """Array-like (chumpy objects of legacy pkls, scipy sparse) -> float64."""
    if hasattr(x, "r"):
        return np.asarray(x.r, dtype=np.float64)
    if hasattr(x, "toarray"):
        return np.asarray(x.toarray(), dtype=np.float64)
    return np.asarray(x, dtype=np.float64)


def load_smpl_data(path: str) -> dict[str, np.ndarray]:
    """Load an official SMPL-family model file into plain numpy arrays."""
    if path.endswith(".npz"):
        raw = dict(np.load(path, allow_pickle=True))
    else:
        with open(path, "rb") as f:
            raw = pickle.load(f, encoding="latin1")
    return {k: _to_np(raw[k]) for k in
            ("v_template", "shapedirs", "posedirs", "J_regressor", "weights",
             "kintree_table", "f") if k in raw}


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


class SMPLParser:
    """Gender-specific SMPL-family model (the reference's SMPL_Parser API)."""

    def __init__(self, model_path: str | None = None, gender: str = "neutral",
                 model_type: str = "smpl", data: dict[str, np.ndarray] | None = None):
        self.model_type = model_type
        self.gender = gender
        if data is None:
            if model_path is None:
                raise FileNotFoundError("SMPL model path or data required")
            data = load_smpl_data(self._resolve(model_path, gender, model_type))
        J = _NUM_JOINTS[model_type]
        self.v_template = _f64(data["v_template"])
        self.shapedirs = _f64(data["shapedirs"])
        pd = data.get("posedirs")
        if pd is not None:
            pd = np.asarray(pd)
            if pd.ndim == 3:  # (V,3,P) -> (P, V*3)
                pd = pd.reshape(-1, pd.shape[-1]).T
            self.posedirs = _f64(pd)
        else:
            self.posedirs = None
        self.J_regressor = _f64(np.asarray(data["J_regressor"])[:J])
        self.lbs_weights = _f64(np.asarray(data["weights"])[:, :J])
        kt = np.asarray(data["kintree_table"], dtype=np.int64)
        parents = kt[0][:J].copy()
        parents[0] = -1
        self.parents = tuple(int(p) for p in parents)
        # smplx: the 55-joint tree carries the jaw (22) and eyes (23, 24),
        # which the robot drops: its skeleton is the 52 SMPLH-named joints
        # (SMPLX[:22] + SMPLX[25:55] == SMPLH)
        if model_type == "smplx":
            self.parents_to_use = np.concatenate([np.arange(0, 22), np.arange(25, 55)])
        else:
            self.parents_to_use = np.arange(J)
        if model_type == "smpl":
            self.joint_names = list(JN.SMPL_BONE_ORDER_NAMES)
        elif model_type == "mano":
            # hand-only model; the side comes from gender: "left" / "right"
            self.joint_names = list(JN.MANO_LEFT_BONE_ORDER_NAMES if gender == "left"
                                    else JN.MANO_RIGHT_BONE_ORDER_NAMES)
        else:
            self.joint_names = list(JN.SMPLH_BONE_ORDER_NAMES)
        # default ranges +-pi; the elbows x4, and the shoulders x4 for
        # smpl/smplh but not smplx
        self.joint_range = {
            n: np.stack([-np.pi * np.ones(3), np.pi * np.ones(3)], axis=1)
            for n in self.joint_names
        }
        wide = ["L_Elbow", "R_Elbow"]
        if model_type != "smplx":
            wide += ["L_Shoulder", "R_Shoulder"]
        for n in wide:
            if n in self.joint_range:
                self.joint_range[n] = self.joint_range[n] * 4

    @staticmethod
    def _resolve(path, gender, model_type):
        cands = [
            os.path.join(path, f"{model_type.upper()}_{gender.upper()}.pkl"),
            os.path.join(path, model_type, f"{model_type.upper()}_{gender.upper()}.pkl"),
            os.path.join(path, f"{model_type}_{gender}.npz"),
            path,
        ]
        for c in cands:
            if os.path.isfile(c):
                return c
        raise FileNotFoundError(f"no SMPL data under {path} for {gender}")

    def get_joints_verts(self, pose, betas=None, trans=None):
        """pose (B, J*3) axis angle, betas (B, nb), trans (B,3). Returns
        (verts (B,V,3), joints (B,J,3)) in float64. smplx also takes the
        156-dim SMPLH pose layout: the jaw and eyes get zero rotations."""
        pose = _f64(pose)
        pose = pose.reshape(
            -1, _NUM_POSE[self.model_type] if self.model_type == "smpl" else pose.shape[-1])
        if self.model_type == "smplx" and pose.shape[-1] == 156:
            pose = torch.cat([pose[:, :66], pose.new_zeros((pose.shape[0], 9)), pose[:, 66:]], -1)
        B = pose.shape[0]
        nb = self.shapedirs.shape[-1]
        betas = pose.new_zeros((B, nb)) if betas is None else _f64(betas)[:, :nb]
        verts, joints = lbs(betas, pose, self.v_template, self.shapedirs, self.posedirs,
                            self.J_regressor, self.parents, self.lbs_weights)
        if trans is not None:
            trans = _f64(trans)
            verts = verts + trans[:, None]
            joints = joints + trans[:, None]
        return verts, joints

    def get_offsets(self, betas=None, zero_pose=None):
        """Zero-pose skeleton data for the robot builder. Returns (verts
        (V,3), joints (J,3), skin_weights (V,J), joint_names, joint_offsets
        dict, parents dict, channels, joint_range dict), numpy float64."""
        J = len(self.parents)
        if zero_pose is None:
            zero_pose = np.zeros((1, J * 3))
        verts, joints = self.get_joints_verts(zero_pose, betas=betas)
        verts = verts[0].numpy()
        jts_full = joints[0].numpy()
        # the exposed skeleton is the parents_to_use subset; the dropped
        # joints are leaves, so every kept joint's parent is kept
        sub = np.asarray(self.parents_to_use)
        inv = {int(s): i for i, s in enumerate(sub)}
        jts = jts_full[sub]
        joint_offsets = {
            self.joint_names[i]: (jts_full[s] - jts_full[self.parents[s]] if s > 0
                                  else jts_full[s])
            for i, s in enumerate(sub.tolist())
        }
        parents_dict = {
            self.joint_names[i]: (self.joint_names[inv[self.parents[s]]] if s > 0 else None)
            for i, s in enumerate(sub.tolist())
        }
        skin_weights = self.lbs_weights.numpy()[:, sub]
        return (verts, jts, skin_weights, self.joint_names, joint_offsets, parents_dict,
                ["z", "y", "x"], self.joint_range)
