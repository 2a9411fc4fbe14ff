"""The poselib layer of the port: skeleton trees, states and motions with
retargeting (skeleton.py), and matplotlib drawing (visualization.py)."""
from smplsim_tpu_torch.poselib import visualization
from smplsim_tpu_torch.poselib.skeleton import SkeletonMotion, SkeletonState, SkeletonTree

__all__ = ["SkeletonMotion", "SkeletonState", "SkeletonTree", "visualization"]
