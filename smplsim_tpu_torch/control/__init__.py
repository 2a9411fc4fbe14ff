"""Trajectory optimization over the differentiable physics step (port of
smplsim_tpu/control): iLQR."""
from smplsim_tpu_torch.control.ilqr import ILQRConfig, ilqr_plan, jacobians

__all__ = ["ILQRConfig", "ilqr_plan", "jacobians"]
