"""Canonical SMPL-family bone-order tables and SMPL<->MuJoCo permutations.

A copy of smplsim_tpu/motion/joint_names.py (plain Python): the name and
parent tables the body-model parser and the builder read. The MuJoCo
orders are depth-first over the generated kinematic tree.
"""

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
_FINGERS_R = [f.replace("L_", "R_") for f in _FINGERS_L]

SMPLH_BONE_ORDER_NAMES = (
    SMPL_BONE_ORDER_NAMES[:22] + _FINGERS_L + _FINGERS_R
)
# SMPLH drops L_Hand/R_Hand and appends 15 finger joints per hand: 52 total
assert len(SMPLH_BONE_ORDER_NAMES) == 52

MANO_LEFT_BONE_ORDER_NAMES = [
    "L_Wrist",
    "L_Index1", "L_Index2", "L_Index3", "L_Middle1", "L_Middle2", "L_Middle3",
    "L_Pinky1", "L_Pinky2", "L_Pinky3", "L_Ring1", "L_Ring2", "L_Ring3",
    "L_Thumb1", "L_Thumb2", "L_Thumb3",
]
MANO_RIGHT_BONE_ORDER_NAMES = [n.replace("L_", "R_") for n in MANO_LEFT_BONE_ORDER_NAMES]

SMPL_MUJOCO_NAMES = [
    "Pelvis", "L_Hip", "L_Knee", "L_Ankle", "L_Toe", "R_Hip", "R_Knee",
    "R_Ankle", "R_Toe", "Torso", "Spine", "Chest", "Neck", "Head",
    "L_Thorax", "L_Shoulder", "L_Elbow", "L_Wrist", "L_Hand",
    "R_Thorax", "R_Shoulder", "R_Elbow", "R_Wrist", "R_Hand",
]

SMPLH_MUJOCO_NAMES = [
    "Pelvis", "L_Hip", "L_Knee", "L_Ankle", "L_Toe", "R_Hip", "R_Knee",
    "R_Ankle", "R_Toe", "Torso", "Spine", "Chest", "Neck", "Head",
    "L_Thorax", "L_Shoulder", "L_Elbow", "L_Wrist",
    "L_Index1", "L_Index2", "L_Index3", "L_Middle1", "L_Middle2", "L_Middle3",
    "L_Pinky1", "L_Pinky2", "L_Pinky3", "L_Ring1", "L_Ring2", "L_Ring3",
    "L_Thumb1", "L_Thumb2", "L_Thumb3",
    "R_Thorax", "R_Shoulder", "R_Elbow", "R_Wrist",
    "R_Index1", "R_Index2", "R_Index3", "R_Middle1", "R_Middle2", "R_Middle3",
    "R_Pinky1", "R_Pinky2", "R_Pinky3", "R_Ring1", "R_Ring2", "R_Ring3",
    "R_Thumb1", "R_Thumb2", "R_Thumb3",
]

# mujoco-order parents for the 52-joint SMPLH tree
# (torch_smpl_humanoid_batch.py:70)
SMPLH_MUJOCO_PARENTS = [
    -1, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 12, 11, 14, 15, 16, 17, 18,
    19, 17, 21, 22, 17, 24, 25, 17, 27, 28, 17, 30, 31, 11, 33, 34, 35, 36,
    37, 38, 36, 40, 41, 36, 43, 44, 36, 46, 47, 36, 49, 50,
]


def smpl_to_mujoco_perm(humanoid_type: str = "smpl"):
    """Permutation p s.t. array[p] converts SMPL order -> MuJoCo order."""
    bone, mj = _tables(humanoid_type)
    return [bone.index(n) for n in mj]


def mujoco_to_smpl_perm(humanoid_type: str = "smpl"):
    bone, mj = _tables(humanoid_type)
    return [mj.index(n) for n in bone]


def _tables(humanoid_type: str):
    if humanoid_type == "smpl":
        return SMPL_BONE_ORDER_NAMES, SMPL_MUJOCO_NAMES
    if humanoid_type in ("smplh", "smplx"):
        return SMPLH_BONE_ORDER_NAMES, SMPLH_MUJOCO_NAMES
    raise ValueError(humanoid_type)
