"""Trajectory optimization over the physics step (port of
smplsim_tpu/control): the CEM planner and iLQR."""
from smplsim_tpu_torch.control.cem import CEMConfig, CEMPlanner
from smplsim_tpu_torch.control.ilqr import ILQRConfig, ilqr_plan, jacobians

__all__ = ["CEMConfig", "CEMPlanner", "ILQRConfig", "ilqr_plan", "jacobians"]
