"""Spatial (6-D) vector algebra about the world origin.

Port of smplsim_tpu/physics/algebra.py. Twists are [omega; v_O], wrenches
[n_O; f], both about the world origin, so the dynamics need no per-joint
coordinate transforms.
"""
from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """(...,3) -> (...,3,3) cross-product matrix."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1).reshape(
        v.shape[:-1] + (3, 3))


def motion_cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product a x b of twists (...,6)."""
    aw, av = a[..., :3], a[..., 3:]
    bw, bv = b[..., :3], b[..., 3:]
    return torch.cat([cross(aw, bw), cross(aw, bv) + cross(av, bw)], dim=-1)


def force_cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product a x* b: twist a, wrench b (...,6)."""
    aw, av = a[..., :3], a[..., 3:]
    bn, bf = b[..., :3], b[..., 3:]
    return torch.cat([cross(aw, bn) + cross(av, bf), cross(aw, bf)], dim=-1)


def spatial_inertia(mass: torch.Tensor, com: torch.Tensor,
                    inertia_com: torch.Tensor) -> torch.Tensor:
    """6x6 spatial inertia about the origin: mass (...,), com (...,3) world
    COM, inertia_com (...,3,3) world rotational inertia about the COM."""
    c = skew(com)
    m = mass[..., None, None]
    top_left = inertia_com + m * (c @ c.transpose(-1, -2))
    top_right = m * c
    bot_left = m * c.transpose(-1, -2)
    eye = torch.eye(3, dtype=com.dtype, device=com.device)
    bot_right = (m * eye).expand(top_left.shape)
    top = torch.cat([top_left, top_right], dim=-1)
    bot = torch.cat([bot_left, bot_right], dim=-1)
    return torch.cat([top, bot], dim=-2)
