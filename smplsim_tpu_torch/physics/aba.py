"""Articulated-body solves, batched: x = (M + diag)^-1 rhs in O(tree-depth)
steps, without forming or factoring M.

Port of smplsim_tpu/physics/aba.py, batch-first. The factorization walks
the kinematic tree: all bodies of one depth eliminate at once, so the
sequential depth is about three times the tree depth (27 level steps for
SMPL-24) instead of the nv-long column recurrence of a dense Cholesky
factor. Each level step is a handful of batched (n,6,d) products over the
bodies of the level and the env batch; the level loops are Python loops
over the static schedule of topology.aba_levels, and the body-axis scatters
are `index_add_` (the JAX package's `.at[].add`).

Frames: world-ALIGNED axes with a PER-BODY reference point r_b (the body
frame origin, the joint anchor). The engine's origin-frame formulation
(physics/algebra.py) suits the masked-product CRBA but poisons the
elimination in float32: per-body quantities about a common far origin
carry O(m|c|^2) moment terms that must cancel down to the O(m l^2)
joint-axis inertia, about 1e-2 relative error on random poses. About each
body's own anchor the levers are body-scale and the error stays in the
usual float32 envelope (1e-6..1e-5; tests/test_aba.py pins both dtypes in
the JAX package, tests/test_torch_aba.py the port). Parent<->child
hand-offs are pure translations X(d), d = r_b - r_parent: the axes stay
world-aligned, so there are no rotations.

Algebra (Featherstone ABA, two sweeps; twists [w; v(r)], wrenches [n(r); f]):

  factor (leaves->root):  U_b = IA_b S_b^T,  D_b = S_b U_b + diag_b,
                          IA_par += X(d) (IA_b - U_b D_b^-1 U_b^T) X(d)^T
  solve M x = t:
    inward:   u_b = t_b - S_b p_b,  p_par += X(d) (p_b + U_b D_b^-1 u_b)
    outward:  a_b = X(d)^T a_par;   x_b = D_b^-1 (u_b - U_b^T a_b)
              a_b += S_b^T x_b

Exact in exact arithmetic: the same x as a dense solve with the CRBA M of
dynamics.mass_matrix. Assumes the fixed dof layout of models/spec.py: body
0 carries the 6-dof free root, every other body a 3-dof hinge stack.

Every input takes a shared or a stacked model's fields (body_mass (J,) or
(B,J)); the kinematics are batched.
"""
from __future__ import annotations

import functools

import torch

from smplsim_tpu_torch.physics import algebra
from smplsim_tpu_torch.physics.topology import aba_levels, mask_tensor


@functools.lru_cache(maxsize=32)
def _level_index(parents: tuple[int, ...], device: torch.device):
    """The parent of every body, and per level 1..depth (bodies, bodies - 1,
    their parents), as index tensors on `device`."""
    levels, par = aba_levels(parents)
    as_t = lambda x: torch.as_tensor(x, dtype=torch.long, device=device)
    return as_t(par), [(as_t(b), as_t(b - 1), as_t(par[b])) for b in levels[1:]]


def _inv3(A):
    """(...,3,3) closed-form inverse by the adjugate (no pivoting: the D
    blocks are SPD with joint-inertia-scale diagonals). The adjugate's
    columns are the cross products of A's rows; its entries are the JAX
    package's cofactors term for term."""
    r0, r1, r2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    adj = torch.stack([torch.linalg.cross(r1, r2), torch.linalg.cross(r2, r0),
                       torch.linalg.cross(r0, r1)], dim=-1)
    det = (A[..., :, 0] * adj[..., 0, :]).sum(-1)
    return adj / det[..., None, None]


def _inv6_spd(A):
    """(...,6,6) SPD inverse by 2x2-of-3x3 block elimination."""
    P, Q, S = A[..., :3, :3], A[..., :3, 3:], A[..., 3:, 3:]
    Pinv = _inv3(P)
    Tinv = _inv3(S - Q.transpose(-1, -2) @ Pinv @ Q)       # Schur complement
    PiQ = Pinv @ Q
    tl = Pinv + PiQ @ Tinv @ PiQ.transpose(-1, -2)
    tr = -PiQ @ Tinv
    return torch.cat([torch.cat([tl, tr], -1), torch.cat([tr.transpose(-1, -2), Tinv], -1)], -2)


def _cross(d, a):
    """d (...,3) x a (...,3,m) along axis -2."""
    d, a = torch.broadcast_tensors(d[..., None], a)
    return torch.linalg.cross(d, a, dim=-2)


def _wrench_to_parent(d, w):
    """Shift a wrench [n(r_b); f] to r_p = r_b - d: [n + d x f; f].
    d (...,3), w (...,6,m)."""
    n, f = w[..., :3, :], w[..., 3:, :]
    return torch.cat([n + _cross(d, f), f], dim=-2)


def _twist_to_child(d, a):
    """Shift a twist [w; v(r_p)] to r_b = r_p + d: [w; v - d x w].
    d (...,3), a (...,6,m)."""
    w, v = a[..., :3, :], a[..., 3:, :]
    return torch.cat([w, v - _cross(d, w)], dim=-2)


def _inertia_to_parent(d, I):
    """Shift a spatial inertia from r_b to r_p = r_b - d: X(d) I X(d)^T with
    X(d) = [[1, skew(d)], [0, 1]]. Blocks: A' = A + sB^T - Bs - sCs,
    B' = B + sC, C' = C, s = skew(d)."""
    s = algebra.skew(d)
    A, Bk, C = I[..., :3, :3], I[..., :3, 3:], I[..., 3:, 3:]
    sC = s @ C
    Bp = Bk + sC
    Ap = A + s @ Bk.transpose(-1, -2) - Bk @ s - sC @ s
    return torch.cat([torch.cat([Ap, Bp], -1), torch.cat([Bp.transpose(-1, -2), C], -1)], -2)


def aba_solve(parents: tuple, S_loc, I_loc, r, diag, rhs):
    """Solve (M + diag(diag)) x = rhs without forming M.

    S_loc (B,nv,6): dof subspaces with each row about ITS body's reference
    point r[body] (world-aligned axes). I_loc (B,J,6,6): per-body spatial
    inertias about r[b]. r (B,J,3): per-body reference points (world).
    diag (B,nv): added to M's diagonal (armature, and the stable-PD dt*kd
    term). rhs (B,nv,m).

    Returns x (B,nv,m) = (M + diag)^-1 rhs for the CRBA M without armature
    (pass it in `diag`). `mass_solve` builds S_loc and I_loc from the
    engine's kinematics."""
    par, idx = _level_index(tuple(parents), rhs.device)
    Bn, nv, m = rhs.shape
    J = len(parents)

    S0 = S_loc[:, :6]                                    # (B,6,6) root dofs
    Sr = S_loc[:, 6:].reshape(Bn, J - 1, 3, 6)           # body b -> Sr[:, b-1]
    d0 = torch.diag_embed(diag[:, :6])
    dr = torch.diag_embed(diag[:, 6:].reshape(Bn, J - 1, 3))   # (B,J-1,3,3)
    dvec = r - r[:, par]                                 # (B,J,3); [:, 0] unused

    # ---- factor sweep: leaves -> level 1
    IA = I_loc.clone()
    U, Dinv = [None] * len(idx), [None] * len(idx)
    for k in range(len(idx) - 1, -1, -1):
        b, bm1, pb = idx[k]
        Sb = Sr[:, bm1]                                  # (B,n,3,6)
        IAb = IA[:, b]
        Ub = IAb @ Sb.transpose(-1, -2)                  # (B,n,6,3)
        Dib = _inv3(Sb @ Ub + dr[:, bm1])
        U[k], Dinv[k] = Ub, Dib
        delta = IAb - Ub @ Dib @ Ub.transpose(-1, -2)
        IA.index_add_(1, pb, _inertia_to_parent(dvec[:, b], delta))
    U0 = IA[:, 0] @ S0.transpose(-1, -2)                 # (B,6,6)
    D0inv = _inv6_spd(S0 @ U0 + d0)

    # ---- inward sweep
    tr = rhs[:, 6:].reshape(Bn, J - 1, 3, m)
    p = rhs.new_zeros((Bn, J, 6, m))
    u = [None] * len(idx)
    for k in range(len(idx) - 1, -1, -1):
        b, bm1, pb = idx[k]
        pbk = p[:, b]
        u[k] = tr[:, bm1] - Sr[:, bm1] @ pbk
        pc = pbk + U[k] @ (Dinv[k] @ u[k])
        p.index_add_(1, pb, _wrench_to_parent(dvec[:, b], pc))

    # ---- outward sweep
    x0 = D0inv @ (rhs[:, :6] - S0 @ p[:, 0])            # (B,6,m)
    a = rhs.new_zeros((Bn, J, 6, m))
    a[:, 0] = S0.transpose(-1, -2) @ x0
    xr = rhs.new_zeros((Bn, J - 1, 3, m))
    for k in range(len(idx)):
        b, bm1, pb = idx[k]
        ab = _twist_to_child(dvec[:, b], a[:, pb])       # (B,n,6,m) at r_b
        xb = Dinv[k] @ (u[k] - U[k].transpose(-1, -2) @ ab)
        xr[:, bm1] = xb
        a[:, b] = ab + Sr[:, bm1].transpose(-1, -2) @ xb
    return torch.cat([x0, xr.reshape(Bn, 3 * (J - 1), m)], dim=1)


def mass_solve(parents: tuple, S, com, inertia_w, xpos, body_mass, diag, rhs):
    """(M(kin) + diag)^-1 rhs from the engine's kinematics (kinematics.Kin:
    S (B,nv,6) about the WORLD ORIGIN, com, inertia_w, xpos), re-referenced
    to each body's own anchor xpos[b]. M is invariant under the shift of
    reference points, so the result is the dense solve with
    dynamics.mass_matrix (without its armature, which goes in `diag`) up to
    rounding. body_mass (J,) or (B,J); diag (B,nv); rhs (B,nv,m)."""
    dof_body = mask_tensor(tuple(parents), "dof_body", S.dtype, S.device)
    r_dof = xpos[:, dof_body]                            # (B,nv,3)
    S_loc = torch.cat([S[..., :3], S[..., 3:] + algebra.cross(S[..., :3], r_dof)], dim=-1)
    I_loc = algebra.spatial_inertia(body_mass.to(S.dtype), com - xpos, inertia_w)
    return aba_solve(parents, S_loc, I_loc, xpos, diag, rhs)
