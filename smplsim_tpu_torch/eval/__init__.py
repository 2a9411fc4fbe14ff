"""Motion-tracking metrics of the port (eval/metrics.py)."""
from smplsim_tpu_torch.eval.metrics import (compute_accel, compute_error_accel,
                                            compute_error_vel, compute_metrics_lite,
                                            compute_penetration, compute_skate, compute_vel,
                                            frobenius_root_error, mpjpe_global, mpjpe_local,
                                            p_mpjpe)

__all__ = ["compute_accel", "compute_error_accel", "compute_error_vel", "compute_metrics_lite",
           "compute_penetration", "compute_skate", "compute_vel", "frobenius_root_error",
           "mpjpe_global", "mpjpe_local", "p_mpjpe"]
