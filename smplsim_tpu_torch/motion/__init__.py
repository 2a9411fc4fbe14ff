"""Motion data tables of the port. Only the joint-name tables are ported so
far (motion_lib, fitting and the converters are not)."""
from smplsim_tpu_torch.motion import joint_names

__all__ = ["joint_names"]
