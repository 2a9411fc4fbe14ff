"""Stable-PD gain tables for the SMPL/SMPLH/SMPLX humanoid joints.

A copy of smplsim_tpu/models/gains.py: per joint (kp, kd, weight,
torque_limit), the reference controller configuration
(smpl_sim/envs/humanoid_env.py:36-110 GAINS["stablepd"]), and the finger
gains of the articulated-hand models (skeleton_local.py:108-163).
"""

STABLEPD_GAINS = {
    "L_Hip": (800.0, 80.0, 1.0, 1000.0),
    "L_Knee": (800.0, 80.0, 1.0, 1000.0),
    "L_Ankle": (800.0, 80.0, 1.0, 1000.0),
    "L_Toe": (500.0, 50.0, 1.0, 500.0),
    "R_Hip": (800.0, 80.0, 1.0, 1000.0),
    "R_Knee": (800.0, 80.0, 1.0, 1000.0),
    "R_Ankle": (800.0, 80.0, 1.0, 1000.0),
    "R_Toe": (500.0, 50.0, 1.0, 500.0),
    "Torso": (1000.0, 100.0, 1.0, 500.0),
    "Spine": (1000.0, 100.0, 1.0, 500.0),
    "Chest": (1000.0, 100.0, 1.0, 500.0),
    "Neck": (500.0, 50.0, 1.0, 250.0),
    "Head": (500.0, 50.0, 1.0, 250.0),
    "L_Thorax": (500.0, 50.0, 1.0, 1000.0),
    "L_Shoulder": (500.0, 50.0, 1.0, 1000.0),
    "L_Elbow": (500.0, 50.0, 1.0, 250.0),
    "L_Wrist": (300.0, 30.0, 1.0, 250.0),
    "L_Hand": (300.0, 30.0, 1.0, 250.0),
    "R_Thorax": (500.0, 50.0, 1.0, 1000.0),
    "R_Shoulder": (500.0, 50.0, 1.0, 1000.0),
    "R_Elbow": (500.0, 50.0, 1.0, 250.0),
    "R_Wrist": (300.0, 30.0, 1.0, 250.0),
    "R_Hand": (300.0, 30.0, 1.0, 250.0),
}

# Finger joints (SMPLH/SMPLX articulated hands), reference GAINS_PHC values.
_FINGER_GAIN = (100.0, 10.0, 1.0, 150.0)
for _side in ("L", "R"):
    for _finger in ("Index", "Middle", "Pinky", "Ring", "Thumb"):
        for _k in (1, 2, 3):
            STABLEPD_GAINS[f"{_side}_{_finger}{_k}"] = _FINGER_GAIN
