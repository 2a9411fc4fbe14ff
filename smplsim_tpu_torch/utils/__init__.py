from smplsim_tpu_torch.utils.tolerance import tolerance

__all__ = ["tolerance"]
