"""dm_control-style tolerance reward shaping on tensors (port of
smplsim_tpu/utils/tolerance.py): 1 inside [lower, upper], decaying
sigmoidally outside at a rate set by margin and value_at_margin."""
from __future__ import annotations

import numpy as np
import torch

_DEFAULT_VALUE_AT_MARGIN = 0.1


def _sigmoid(x: torch.Tensor, value_at_1: float, sigmoid: str) -> torch.Tensor:
    if sigmoid in ("cosine", "linear", "quadratic"):
        if not 0 <= value_at_1 < 1:
            raise ValueError(f"value_at_1 must be in [0,1), got {value_at_1}")
    elif not 0 < value_at_1 < 1:
        raise ValueError(f"value_at_1 must be in (0,1), got {value_at_1}")

    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if sigmoid == "gaussian":
        scale = np.sqrt(-2 * np.log(value_at_1))
        return torch.exp(-0.5 * (x * scale) ** 2)
    if sigmoid == "hyperbolic":
        scale = np.arccosh(1 / value_at_1)
        return 1 / torch.cosh(x * scale)
    if sigmoid == "long_tail":
        scale = np.sqrt(1 / value_at_1 - 1)
        return 1 / ((x * scale) ** 2 + 1)
    if sigmoid == "reciprocal":
        scale = 1 / value_at_1 - 1
        return 1 / (x.abs() * scale + 1)
    if sigmoid == "cosine":
        scale = np.arccos(2 * value_at_1 - 1) / np.pi
        sx = x * scale
        return torch.where(sx.abs() < 1, (1 + torch.cos(np.pi * sx)) / 2, zero)
    if sigmoid == "linear":
        sx = x * (1 - value_at_1)
        return torch.where(sx.abs() < 1, 1 - sx, zero)
    if sigmoid == "quadratic":
        sx = x * np.sqrt(1 - value_at_1)
        return torch.where(sx.abs() < 1, 1 - sx ** 2, zero)
    if sigmoid == "tanh_squared":
        scale = np.arctanh(np.sqrt(1 - value_at_1))
        return 1 - torch.tanh(x * scale) ** 2
    raise ValueError(f"unknown sigmoid {sigmoid!r}")


def tolerance(x, bounds=(0.0, 0.0), margin: float = 0.0, sigmoid: str = "gaussian",
              value_at_margin: float = _DEFAULT_VALUE_AT_MARGIN) -> torch.Tensor:
    """1 where lower <= x <= upper; outside, the sigmoid of the distance to
    the nearer bound over margin, value_at_margin at one margin (0 outside
    at margin 0)."""
    lower, upper = bounds
    if lower > upper:
        raise ValueError("lower bound must be <= upper bound")
    if margin < 0:
        raise ValueError("margin must be non-negative")
    x = torch.as_tensor(x)
    one, zero = (torch.full((), v, dtype=x.dtype, device=x.device) for v in (1.0, 0.0))
    in_bounds = (lower <= x) & (x <= upper)
    if margin == 0:
        return torch.where(in_bounds, one, zero)
    d = torch.where(x < lower, lower - x, x - upper) / margin
    return torch.where(in_bounds, one, _sigmoid(d, value_at_margin, sigmoid))
