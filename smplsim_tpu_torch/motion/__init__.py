"""Motion data of the port: the joint-name tables, the batched mocap FK
(fk.py), the motion library (motion_lib.py), the cross-model converter
(converter.py) and the 2-D pose fitter (fitting.py)."""
from smplsim_tpu_torch.motion import joint_names
from smplsim_tpu_torch.motion.converter import SMPLConverter, normalize_smpl_pose
from smplsim_tpu_torch.motion.fitting import CameraParams, PoseFitter
from smplsim_tpu_torch.motion.fk import HumanoidBatchFK
from smplsim_tpu_torch.motion.motion_lib import (FixHeightMode, MotionLib, MotionLibConfig,
                                                 tables_to_numpy)

__all__ = ["CameraParams", "FixHeightMode", "HumanoidBatchFK", "MotionLib", "MotionLibConfig",
           "PoseFitter", "SMPLConverter", "joint_names", "normalize_smpl_pose",
           "tables_to_numpy"]
