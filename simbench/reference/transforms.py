"""Quaternion algebra (wxyz) on tensors with arbitrary leading dims.

Port of smplsim_tpu/transforms.py: convention converters, rotation
matrices, vector rotation, products, axis-angle and exponential maps, the
free-root integration, intrinsic-XYZ euler angles, the heading helpers of
the observations, the 6-D tangent/normal encoding and slerp. Every function
is branch-free (`torch.where`, no data-dependent control flow); the guarded
ones (`exp_map_to_quat`, `quat_to_angle_axis`, `quat_slerp`) keep the JAX
package's double-where form, so their values and gradients at the
thresholds are the JAX package's.
"""
from __future__ import annotations

import torch

_SMPL_BASE_QUAT = (0.5, 0.5, 0.5, 0.5)  # non-upright SMPL base rotation


def wxyz_to_xyzw(q: torch.Tensor) -> torch.Tensor:
    return q[..., [1, 2, 3, 0]]


def xyzw_to_wxyz(q: torch.Tensor) -> torch.Tensor:
    return q[..., [3, 0, 1, 2]]


def normalize(v: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(eps)


def safe_sqrt(v: torch.Tensor) -> torch.Tensor:
    """sqrt(max(v, 1e-18)): the pivot root of matrix_to_quat."""
    return torch.sqrt(v.clamp_min(1e-18))


def quat_identity(shape=(), dtype: torch.dtype = torch.float32,
                  device: str | torch.device = "cuda") -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_unit(q: torch.Tensor) -> torch.Tensor:
    return normalize(q)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v + 2 qw (qv x v) + 2 qv x (qv x v); broadcasts leading dims."""
    qw = q[..., :1]
    qv = q[..., 1:]
    qv, v = torch.broadcast_tensors(qv, v)
    uv = torch.linalg.cross(qv, v, dim=-1)
    uuv = torch.linalg.cross(qv, uv, dim=-1)
    return v + 2.0 * (qw * uv + uuv)


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conjugate(q), v)


def quat_to_angle_axis(q: torch.Tensor, eps: float = 1e-5):
    """(angle (...,), axis (...,3)), the angle wrapped to [-pi, pi]; at
    |xyz| <= eps the angle is 0 and the axis z."""
    sin_half = torch.linalg.norm(q[..., 1:], dim=-1)
    angle = normalize_angle(2.0 * torch.atan2(sin_half, q[..., 0]))
    safe = sin_half > eps
    axis = q[..., 1:] / sin_half.clamp_min(eps)[..., None]
    default = torch.zeros_like(axis)
    default[..., 2] = 1.0
    axis = torch.where(safe[..., None], axis, default)
    angle = torch.where(safe, angle, torch.zeros_like(angle))
    return angle, axis


def quat_to_exp_map(q: torch.Tensor) -> torch.Tensor:
    angle, axis = quat_to_angle_axis(q)
    return angle[..., None] * axis


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(...,4) -> (...,3,3), no normalization."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_from_angle_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    half = 0.5 * angle[..., None]
    return torch.cat([torch.cos(half), normalize(axis) * torch.sin(half)], dim=-1)


def exp_map_to_quat(e: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Axis-angle vector (...,3) -> quaternion, exact at zero angle in value
    and gradient: on the small branch sqrt sees 1, never 0, so the
    derivative the pose fitter takes at exactly-zero joint angles is 0.5 I,
    the series limit, as the JAX package's."""
    sq = (e * e).sum(-1, keepdim=True)
    small = sq <= eps * eps
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    half = 0.5 * angle
    k = torch.where(small, torch.full_like(sq, 0.5), torch.sin(half) / angle)
    cos_half = torch.where(small, torch.ones_like(sq), torch.cos(half))
    return torch.cat([cos_half, e * k], dim=-1)


def quat_integrate(q: torch.Tensor, omega_local: torch.Tensor, dt) -> torch.Tensor:
    """Advance unit q by the body-frame angular velocity over dt."""
    return normalize(quat_mul(q, exp_map_to_quat(omega_local * dt)))


def euler_xyz_to_quat(e: torch.Tensor) -> torch.Tensor:
    """Intrinsic XYZ euler angles -> quaternion qx * qy * qz."""
    c = torch.cos(0.5 * e)
    s = torch.sin(0.5 * e)
    cx, cy, cz = c.unbind(-1)
    sx, sy, sz = s.unbind(-1)
    return torch.stack([
        cx * cy * cz - sx * sy * sz,
        sx * cy * cz + cx * sy * sz,
        cx * sy * cz - sx * cy * sz,
        cx * cy * sz + sx * sy * cz,
    ], dim=-1)


def euler_xyz_to_matrix(e: torch.Tensor) -> torch.Tensor:
    """Intrinsic XYZ euler (...,3) -> (...,3,3): R = Rx(a) Ry(b) Rz(c)."""
    a, b, c = e.unbind(-1)
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    m = torch.stack([
        cb * cc, -cb * sc, sb,
        sa * sb * cc + ca * sc, -sa * sb * sc + ca * cc, -sa * cb,
        -ca * sb * cc + sa * sc, ca * sb * sc + sa * cc, ca * cb,
    ], dim=-1)
    return m.reshape(e.shape[:-1] + (3, 3))


def matrix_to_euler_xyz(m: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> intrinsic XYZ euler angles, the middle one clamped."""
    b = torch.asin(m[..., 0, 2].clamp(-1.0, 1.0))
    a = torch.atan2(-m[..., 1, 2], m[..., 2, 2])
    c = torch.atan2(-m[..., 0, 1], m[..., 0, 0])
    return torch.stack([a, b, c], dim=-1)


def quat_to_euler_xyz(q: torch.Tensor) -> torch.Tensor:
    return matrix_to_euler_xyz(quat_to_matrix(q))


def _unit(shape, k: int, like: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(shape + (3,), dtype=like.dtype, device=like.device)
    out[..., k] = 1.0
    return out


def calc_heading(q: torch.Tensor) -> torch.Tensor:
    """Yaw of the rotated x axis."""
    rot = quat_rotate(q, _unit(q.shape[:-1], 0, q))
    return torch.atan2(rot[..., 1], rot[..., 0])


def calc_heading_quat(q: torch.Tensor) -> torch.Tensor:
    return quat_from_angle_axis(calc_heading(q), _unit(q.shape[:-1], 2, q))


def calc_heading_quat_inv(q: torch.Tensor) -> torch.Tensor:
    return quat_from_angle_axis(-calc_heading(q), _unit(q.shape[:-1], 2, q))


def remove_base_rot(q: torch.Tensor, humanoid_type: str = "smpl") -> torch.Tensor:
    """Undo the SMPL rest-pose base rotation."""
    if humanoid_type in ("smpl", "smplh", "smplx"):
        base = torch.tensor(_SMPL_BASE_QUAT, dtype=q.dtype, device=q.device)
        return quat_mul(q, quat_conjugate(base.expand(q.shape)))
    return q


def quat_to_tan_norm(q: torch.Tensor) -> torch.Tensor:
    """6-D rotation encoding: the rotated x and z axes."""
    tan = quat_rotate(q, _unit(q.shape[:-1], 0, q))
    norm = quat_rotate(q, _unit(q.shape[:-1], 2, q))
    return torch.cat([tan, norm], dim=-1)


def tan_norm_to_matrix(tn: torch.Tensor) -> torch.Tensor:
    """Inverse of quat_to_tan_norm by Gram-Schmidt: (...,6) -> (...,3,3)."""
    tan = normalize(tn[..., 0:3])
    norm = tn[..., 3:6]
    norm = normalize(norm - (norm * tan).sum(-1, keepdim=True) * tan)
    binorm = torch.linalg.cross(norm, tan, dim=-1)
    return torch.stack([tan, binorm, norm], dim=-1)


def normalize_angle(x: torch.Tensor) -> torch.Tensor:
    return torch.atan2(torch.sin(x), torch.cos(x))


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation along the shorter arc; linear (then
    normalized) where sin(half angle) <= 1e-5. t: a number or a tensor of
    q0's rank, or of one less (then it gains a trailing axis)."""
    cos_half = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(cos_half < 0, -q1, q1)
    cos_half = cos_half.abs().clamp(-1.0, 1.0)
    half = torch.acos(cos_half)
    sin_half = torch.sqrt((1.0 - cos_half * cos_half).clamp_min(0.0))
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.dim() < q0.dim():
        t = t[..., None]
    big = sin_half > 1e-5
    den = torch.where(big, sin_half, torch.ones_like(sin_half))
    w0 = torch.where(big, torch.sin((1 - t) * half) / den, 1.0 - t)
    w1 = torch.where(big, torch.sin(t * half) / den, t)
    return normalize(w0 * q0 + w1 * q1)


def quat_diff_angular_velocity(q0: torch.Tensor, q1: torch.Tensor, dt) -> torch.Tensor:
    """World-frame angular velocity taking q0 to q1 over dt (finite
    difference)."""
    return quat_to_exp_map(quat_mul(q1, quat_conjugate(q0))) / dt


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> (...,4) wxyz, w >= 0: of the four Shepperd candidates the
    one with the largest pivot."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22

    def cand(t, *vals):
        return torch.stack(vals, -1) / (2.0 * safe_sqrt(t))[..., None]

    cands = torch.stack([cand(tw, tw, m21 - m12, m02 - m20, m10 - m01),
                         cand(tx, m21 - m12, tx, m01 + m10, m02 + m20),
                         cand(ty, m02 - m20, m01 + m10, ty, m12 + m21),
                         cand(tz, m10 - m01, m02 + m20, m12 + m21, tz)], dim=-2)
    idx = torch.stack([tw, tx, ty, tz], -1).argmax(-1)
    q = cands.gather(-2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    return normalize(torch.where(q[..., :1] < 0, -q, q))
