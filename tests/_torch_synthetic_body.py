"""Synthetic SMPL-family model data, numpy only.

A copy of tests/synthetic_body.py that reads the baked humanoid from the
PyTorch port's asset copy with json and gzip, and imports neither JAX nor
torch, so that chip_smoke.py can build its bodies where there is no JAX.
The arrays equal the JAX helper's bit for bit
(tests/test_torch_body_model.py holds them equal).

Official SMPL/SMPLH pkls are licensed and not in the repository, so the
bodies are structurally faithful stand-ins: the 24-joint skeleton of the
baked humanoid; the SMPLH variant replaces the hands with 15-joint
articulated finger chains per side (standard SMPLH kintree). Vertices are
anchor tetrahedra (exact joint regressor support) plus gaussian blobs that
give each joint's skin-weight group a usable convex hull.
"""
import gzip
import json
import os

import numpy as np

_ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "smplsim_tpu_torch", "models", "assets", "smpl_humanoid_neutral.json.gz")
# the bone-order tables of smplsim_tpu_torch/motion/joint_names.py
SMPL_BONE_ORDER_NAMES = [
    "Pelvis", "L_Hip", "R_Hip", "Torso", "L_Knee", "R_Knee", "Spine",
    "L_Ankle", "R_Ankle", "Chest", "L_Toe", "R_Toe", "Neck", "L_Thorax",
    "R_Thorax", "Head", "L_Shoulder", "R_Shoulder", "L_Elbow", "R_Elbow",
    "L_Wrist", "R_Wrist", "L_Hand", "R_Hand",
]
_FINGERS_L = [
    "L_Index1", "L_Index2", "L_Index3", "L_Middle1", "L_Middle2", "L_Middle3",
    "L_Pinky1", "L_Pinky2", "L_Pinky3", "L_Ring1", "L_Ring2", "L_Ring3",
    "L_Thumb1", "L_Thumb2", "L_Thumb3",
]
SMPLH_BONE_ORDER_NAMES = (SMPL_BONE_ORDER_NAMES[:22] + _FINGERS_L
                          + [f.replace("L_", "R_") for f in _FINGERS_L])

_FINGER_ORDER = ["Index", "Middle", "Pinky", "Ring", "Thumb"]


def _base_skeleton():
    """(jpos (24,3), names, parents) of the baked SMPL humanoid, SMPL order."""
    with gzip.open(_ASSET, "rb") as f:
        baked = json.loads(f.read())
    baked_parents = baked["parents"]
    body_pos = np.asarray(baked["body_pos"], dtype=np.float64)
    J = len(baked_parents)
    mj_names = list(baked["body_names"])
    jpos_mj = np.zeros((J, 3))
    for b in range(J):
        p = baked_parents[b]
        jpos_mj[b] = body_pos[b] + (jpos_mj[p] if p >= 0 else 0)
    smpl_names = SMPL_BONE_ORDER_NAMES
    jpos = np.stack([jpos_mj[mj_names.index(n)] for n in smpl_names])
    parents = []
    for i, n in enumerate(smpl_names):
        if i == 0:
            parents.append(-1)
        else:
            p_mj = baked_parents[mj_names.index(n)]
            parents.append(smpl_names.index(mj_names[p_mj]))
    return jpos, smpl_names, parents


def _smplh_skeleton():
    """52-joint SMPLH skeleton: SMPL[:22] + synthesized finger chains."""
    jpos24, names24, parents24 = _base_skeleton()
    names = list(SMPLH_BONE_ORDER_NAMES)
    jpos = np.zeros((52, 3))
    jpos[:22] = jpos24[:22]
    parents = list(parents24[:22])
    for side, wrist, hand in (("L", "L_Wrist", "L_Hand"),
                              ("R", "R_Wrist", "R_Hand")):
        pw = jpos24[names24.index(wrist)]
        dh = jpos24[names24.index(hand)] - pw
        dhn = dh / max(np.linalg.norm(dh), 1e-6)
        # a lateral direction for the finger fan
        perp = np.cross(dhn, [0.0, 0.0, 1.0])
        if np.linalg.norm(perp) < 1e-6:
            perp = np.cross(dhn, [0.0, 1.0, 0.0])
        perp /= np.linalg.norm(perp)
        for fi, finger in enumerate(_FINGER_ORDER):
            base = pw + dh * 0.5 + perp * (fi - 2) * 0.012
            for k in range(3):
                name = f"{side}_{finger}{k + 1}"
                idx = names.index(name)
                jpos[idx] = base + dhn * 0.025 * (k + 1)
                parents.append(
                    names.index(wrist) if k == 0 else names.index(
                        f"{side}_{finger}{k}"
                    )
                )
    return jpos, names, parents


def _smplx_skeleton():
    """55-joint SMPLX skeleton: SMPLH body + jaw/eye leaves after the neck
    block (SMPLX joint order: 0-21 body, 22 Jaw, 23-24 eyes, 25-54 hands)."""
    jpos52, names52, parents52 = _smplh_skeleton()
    head = names52.index("Head")
    head_pos = jpos52[head]
    names = (
        names52[:22]
        + ["Jaw", "L_Eye", "R_Eye"]
        + names52[22:]
    )
    jpos = np.concatenate([
        jpos52[:22],
        head_pos + np.array([[0.0, -0.02, 0.05],
                             [0.03, -0.03, 0.08],
                             [-0.03, -0.03, 0.08]]),
        jpos52[22:],
    ])
    remap = lambda p: p if p < 22 else p + 3
    parents = (
        list(parents52[:22])
        + [head, head, head]
        + [remap(p) for p in parents52[22:]]
    )
    return jpos, names, parents


def make_synthetic_body(rng, model_type: str = "smpl", n_extra: int = 40):
    """SMPL-pkl-shaped data dict for SMPLParser(data=...)."""
    if model_type == "smpl":
        jpos, names, parents = _base_skeleton()
    elif model_type == "smplh":
        jpos, names, parents = _smplh_skeleton()
    elif model_type == "smplx":
        jpos, names, parents = _smplx_skeleton()
    else:
        raise ValueError(model_type)
    J = len(names)
    kintree = np.zeros((2, J), dtype=np.int64)
    kintree[0] = np.asarray(parents)
    kintree[0, 0] = 2**31 - 1  # SMPL pkl convention for the root

    verts, weights = [], []
    for j, n in enumerate(names):
        # fingers get tight blobs so their hulls stay finger-sized
        scale = 0.008 if any(f in n for f in _FINGER_ORDER) else 0.05
        anchors = jpos[j] + 0.2 * scale * np.array(
            [[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]]
        )
        blob = jpos[j] + rng.normal(scale=scale, size=(n_extra, 3))
        verts.append(np.concatenate([anchors, blob]))
        w = np.zeros((4 + n_extra, J))
        w[:, j] = 1.0
        weights.append(w)
    v_template = np.concatenate(verts)
    W = np.concatenate(weights)
    V = v_template.shape[0]
    J_reg = np.zeros((J, V))
    per = 4 + n_extra
    for j in range(J):
        J_reg[j, j * per : j * per + 4] = 0.25
    return {
        "v_template": v_template,
        "shapedirs": rng.normal(scale=0.002, size=(V, 3, 10)),
        "posedirs": rng.normal(scale=0.0005, size=(V, 3, (J - 1) * 9)),
        "J_regressor": J_reg,
        "weights": W,
        "kintree_table": kintree,
    }
