"""Constraint rows: joint limits, floor contacts and self-contacts, batched.

Port of smplsim_tpu/physics/constraints.py with MuJoCo's soft-constraint
semantics: impedance d(r), stiffness and damping
from solref, aref = -B v - K d x, R = (1-d)/d * diagApprox. Everything is
fixed-shape: all candidates are evaluated, the deepest are selected with
`top_k` (first index wins ties, NaN last), inactive rows are masked.

Row layout of the NEFC rows (for warm starts): [MAX_LIMITS limit rows,
4 pyramid rows per floor contact, per self-contact, per projectile slot].
The projectile slots hold the deepest contacts of free spheres (`spheres=`)
with the humanoid's geoms; without spheres they are inactive.

The model may be shared or stacked: its per-geom, per-body and per-dof
fields are indexed from the right and gathered per env (`take`), its world
scalars broadcast over each env's rows.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from smplsim_tpu_torch import transforms as T
from smplsim_tpu_torch.models.spec import GEOM_BOX, GEOM_CAPSULE, GEOM_SPHERE, RobotModel
from smplsim_tpu_torch.physics.algebra import cross
from smplsim_tpu_torch.physics.collision_pairs import (BIG, MAX_SELF, _box_sdf, _geom_world,
                                                       _segment, self_contacts, top_k)
from smplsim_tpu_torch.physics.kinematics import Kin, body_twists

MAX_CONTACTS = 24   # floor contacts kept per env (deepest first)
MAX_LIMITS = 12     # joint-limit rows kept per env
MAX_PROJC = 4       # projectile (free sphere) contact slots
NCON = MAX_CONTACTS + MAX_SELF + MAX_PROJC
NEFC = MAX_LIMITS + 4 * NCON


@dataclasses.dataclass
class EFC:
    """Constraint rows as specs. A contact row's jacobian is
    (W6 S^T) * (body_dof[body2] - body_dof[body1]); the solver builds it only
    for the rows it selects."""

    l_J: torch.Tensor      # (B,MAX_LIMITS,nv) limit rows (sign * dof one-hot)
    l_aref: torch.Tensor   # (B,MAX_LIMITS)
    l_R: torch.Tensor      # (B,MAX_LIMITS)
    W6: torch.Tensor       # (B,NCON,4,6) contact wrench rows [pos x dir; dir]
    body1: torch.Tensor    # (B,NCON) long, -1 = world side
    body2: torch.Tensor    # (B,NCON) long
    aref: torch.Tensor     # (B,NCON,4)
    R: torch.Tensor        # (B,NCON,4)
    active: torch.Tensor   # (B,NEFC) bool
    geom_floor_contact: torch.Tensor  # (B,ngeom) bool: a candidate within margin
    proj_sphere: torch.Tensor  # (B,MAX_PROJC) long: the sphere of each slot, -1 inactive


@functools.lru_cache(maxsize=32)
def _candidate_meta(geom_type: tuple[int, ...]):
    """Static floor candidates: sphere centers, capsule ends, box corners."""
    geom_idx, sign, is_round = [], [], []
    for g, t in enumerate(geom_type):
        if t == GEOM_SPHERE:
            geom_idx.append(g)
            sign.append((0.0, 0.0, 0.0))
            is_round.append(1.0)
        elif t == GEOM_CAPSULE:
            for s in (-1.0, 1.0):
                geom_idx.append(g)
                sign.append((0.0, 0.0, s))
                is_round.append(1.0)
        elif t == GEOM_BOX:
            for sx in (-1.0, 1.0):
                for sy in (-1.0, 1.0):
                    for sz in (-1.0, 1.0):
                        geom_idx.append(g)
                        sign.append((sx, sy, sz))
                        is_round.append(0.0)
        else:
            raise ValueError(f"geom type {t}")
    return (np.asarray(geom_idx, np.int64), np.asarray(sign, np.float64),
            np.asarray(is_round, np.float64))


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] per env: x (n,) shared or (B,n) per env, idx (B,K)."""
    return x.expand(idx.shape[:1] + x.shape[-1:]).gather(1, idx)


def impedance(solimp: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """MuJoCo impedance d(x), x = pos - margin (<= 0 when violated)."""
    dmin, dmax, width, mid, power = solimp.unbind(-1)
    r = torch.clamp(x.abs() / width.clamp_min(1e-12), 0.0, 1.0)
    y_lo = (r / mid) ** (power - 1.0) * r
    y_hi = 1.0 - ((1.0 - r) / (1.0 - mid)) ** (power - 1.0) * (1.0 - r)
    y = torch.where(r <= mid, y_lo, y_hi)
    return torch.clamp(dmin + y * (dmax - dmin), 1e-4, 0.9999)


def solref_kb(solref: torch.Tensor, solimp: torch.Tensor):
    """Stiffness and damping (K, B) from solref (positive convention)."""
    dmax = solimp[..., 1]
    tc, dr = solref[..., 0], solref[..., 1]
    K = 1.0 / (dmax * dmax * tc * tc * dr * dr).clamp_min(1e-12)
    Bd = 2.0 / (dmax * tc).clamp_min(1e-12)
    return K, Bd


def make_frame(n: torch.Tensor):
    """Tangent frame of a contact normal, mju_makeFrame convention: seed y
    while |n_y| < 0.5, else z; t1 = Gram-Schmidt(seed), t2 = n x t1."""
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype, device=n.device)
    seed = torch.where((n[..., 1].abs() >= 0.5)[..., None], ez, ey)
    t1 = seed - (seed * n).sum(-1, keepdim=True) * n
    t1 = t1 / torch.linalg.vector_norm(t1, dim=-1, keepdim=True).clamp_min(1e-12)
    return t1, cross(n, t1)


def _pyramid(normal, t1, t2, mu, pos):
    """Pyramid directions n +- mu t (...,4,3) and wrench rows (...,4,6)."""
    dirs = normal[..., None, :] + torch.stack([t1, -t1, t2, -t2], dim=-2) * mu[..., None, None]
    W6 = torch.cat([cross(pos[..., None, :], dirs), dirs], dim=-1)
    return W6


def _rows(V, W6, body2, body1=None):
    """Row velocities W6 . (V[body2] - V[body1]) (B,C,4); bodies >= 0."""
    take = lambda b: V.gather(1, b[..., None].expand(b.shape + (6,)))
    Vb = take(body2) if body1 is None else take(body2) - take(body1)
    return (W6 * Vb[:, :, None, :]).sum(-1)


def _sphere_rows(model: RobotModel, kin: Kin, V, spheres, cK, cB, solimp):
    """Contact rows of free spheres against the humanoid's geoms: the
    MAX_PROJC deepest of the P x G candidates (sphere-capsule by segment
    distance, sphere-box by the box SDF), pyramid rows with the world
    (body1 = -1) on the sphere's side, the sphere's velocity subtracted in
    the row reference and its inverse mass added to R. spheres = (pos
    (B,P,3), vel (B,P,3), radius (B,P), inverse mass (B,P)).
    Returns (W6, body2, aref, R, active, sphere) over the slots."""
    sp_pos, sp_vel, sp_rad, sp_inv = spheres
    B, P, _ = sp_pos.shape
    G = model.ngeom
    gidx = np.arange(G)
    rad = sp_rad[:, :, None]                                   # (B,P,1)
    c = sp_pos[:, :, None, :]                                  # (B,P,1,3)
    seg_p, seg_q, seg_r, _ = _segment(model, kin, gidx)        # (B,G,3), (G,) or (B,G)
    seg_r = seg_r[..., None, :]                                # over the spheres
    dseg = (seg_q - seg_p)[:, None]                            # (B,1,G,3)
    len2 = (dseg * dseg).sum(-1).clamp_min(1e-12)
    t = torch.clamp(((c - seg_p[:, None]) * dseg).sum(-1) / len2, 0.0, 1.0)
    delta = seg_p[:, None] + t[..., None] * dseg - c           # (B,P,G,3)
    gap = torch.sqrt((delta * delta).sum(-1).clamp_min(1e-18))
    n_seg = delta / gap[..., None]
    dist_seg = gap - seg_r - rad
    pos_seg = c + n_seg * (rad + 0.5 * dist_seg)[..., None]

    bpos, bRot, _ = _geom_world(model, kin, gidx)              # (B,G,3), (B,G,3,3)
    lp = (bRot[:, None].transpose(-1, -2) @ (c - bpos[:, None])[..., None])[..., 0]
    sdf, n_out = _box_sdf(lp, model.geom_size.to(lp.dtype)[..., None, :, :])
    dist_box = sdf - rad
    ploc = lp - (rad + 0.5 * dist_box)[..., None] * n_out
    pos_box = bpos[:, None] + (bRot[:, None] @ ploc[..., None])[..., 0]
    n_box = -(bRot[:, None] @ n_out[..., None])[..., 0]

    is_box = torch.as_tensor([t_ == GEOM_BOX for t_ in model.geom_type], device=lp.device)
    dist = torch.where(is_box, dist_box, dist_seg).reshape(B, P * G)
    pos = torch.where(is_box[..., None], pos_box, pos_seg).reshape(B, P * G, 3)
    nrm = torch.where(is_box[..., None], n_box, n_seg).reshape(B, P * G, 3)
    gm = model.geom_margin.to(lp.dtype)
    margin = gm.repeat((1,) * (gm.dim() - 1) + (P,))           # (P*G,) or (B,P*G)
    cand = dist < margin

    val, idx, _ = top_k(torch.where(cand, -dist, torch.full_like(dist, -BIG)), MAX_PROJC)
    take3 = lambda x: x.gather(1, idx[..., None].expand(B, MAX_PROJC, 3))
    k_dist = dist.gather(1, idx)
    k_active = cand.gather(1, idx) & (val > -BIG / 2)
    k_sphere, k_geom = idx // G, idx % G
    k_body = torch.as_tensor(np.asarray(model.geom_body, np.int64), device=lp.device)[k_geom]
    k_mu = take(model.geom_friction[..., 0].to(lp.dtype).clamp_min(1.0), k_geom)
    k_vel = sp_vel.gather(1, k_sphere[..., None].expand(B, MAX_PROJC, 3))
    k_inv = sp_inv.gather(1, k_sphere)

    k_norm = take3(nrm)
    t1, t2 = make_frame(k_norm)
    W6 = _pyramid(k_norm, t1, t2, k_mu, take3(pos))             # (B,K,4,6)
    # a moving external side: the row velocity is relative to the sphere's
    vel = _rows(V, W6, k_body) - (W6[..., 3:] * k_vel[:, :, None, :]).sum(-1)
    x = k_dist - take(margin, idx)
    imp = impedance(solimp, x)
    aref = -cB[..., None] * vel - (cK * imp * x)[..., None]
    diag = ((take(model.body_invweight0[..., 0].to(lp.dtype), k_body) + k_inv)
            * 2.0 * k_mu ** 2 * (1.0 + k_mu ** 2))
    R = ((1.0 - imp) / imp * diag)[..., None].expand(-1, -1, 4)
    sphere = torch.where(k_active, k_sphere, torch.full_like(k_sphere, -1))
    return W6, k_body, aref, R, k_active, sphere


def make_efc(model: RobotModel, kin: Kin, qpos: torch.Tensor, qvel: torch.Tensor,
             keeps=None, spheres=None) -> EFC:
    """Assemble the fixed-shape constraint rows (limits first, then contacts).
    `keeps` passes the self-collision culls through (collision_pairs);
    `spheres` = (pos, vel, radius, inverse mass) of free spheres, (B,P,...)
    each, fills the projectile slots."""
    dtype, dev = qpos.dtype, qpos.device
    B, nv = qvel.shape
    f = lambda x: x.to(dtype)
    # world scalars as (1,) or (B,1), against each env's rows
    solimp, solref = f(model.floor_solimp)[..., None, :], f(model.floor_solref)[..., None, :]
    cK, cB = solref_kb(solref, solimp)
    V = body_twists(model, kin, qvel)                          # (B,J,6)

    # ---------------- joint limits ----------------
    hinge = qpos[:, 7:]
    lo, hi = f(model.jnt_range[..., 0]), f(model.jnt_range[..., 1])
    dist_lo, dist_hi = hinge - lo, hi - hinge
    lpos = torch.minimum(dist_lo, dist_hi)
    lsign = torch.where(dist_lo < dist_hi, 1.0, -1.0).to(dtype)
    limited = torch.as_tensor(model.jnt_limited, dtype=torch.bool, device=dev)
    lactive_all = (lpos < 0.0) & limited
    lval, lidx, _ = top_k(torch.where(lactive_all, -lpos, torch.full_like(lpos, -BIG)),
                          MAX_LIMITS)
    l_pos = lpos.gather(1, lidx)
    l_sign = lsign.gather(1, lidx)
    l_active = lactive_all.gather(1, lidx) & (lval > -BIG / 2)
    l_imp = impedance(solimp, l_pos)
    l_vel = l_sign * qvel[:, 6:].gather(1, lidx)
    l_aref = -cB * l_vel - cK * l_imp * l_pos
    l_R = (1.0 - l_imp) / l_imp * take(f(model.dof_invweight0[..., 6:]), lidx)
    l_J = torch.nn.functional.one_hot(lidx + 6, nv).to(dtype) * l_sign[..., None]

    # ---------------- floor contacts ----------------
    cgeom_np, sign_np, round_np = _candidate_meta(model.geom_type)
    cgeom = torch.as_tensor(cgeom_np, device=dev)
    cbody_np = np.asarray(model.geom_body, np.int64)[cgeom_np]
    cbody = torch.as_tensor(cbody_np, device=dev)
    g_size = f(model.geom_size)[..., cgeom, :]
    is_cap = torch.as_tensor([model.geom_type[g] == GEOM_CAPSULE for g in cgeom_np],
                             device=dev)
    # capsules keep their half-length in size[1] and run along geom-frame z
    size_eff = torch.cat([g_size[..., :2],
                          torch.where(is_cap, g_size[..., 1], g_size[..., 2])[..., None]], dim=-1)
    g_quat = f(model.geom_quat)[..., cgeom, :]
    offset = f(model.geom_pos)[..., cgeom, :] + T.quat_rotate(
        g_quat, torch.as_tensor(sign_np, dtype=dtype, device=dev) * size_eff)
    R_b = kin.xmat[:, cbody]                                   # (B,P,3,3)
    p_world = kin.xpos[:, cbody] + (R_b @ offset[..., None])[..., 0]
    radius = torch.as_tensor(round_np, dtype=dtype, device=dev) * g_size[..., 0]
    dist = p_world[..., 2] - radius
    incmargin = f(model.geom_margin)[..., cgeom] + f(model.floor_margin)[..., None]
    cand_active = dist < incmargin
    con_pos = torch.stack([p_world[..., 0], p_world[..., 1],
                           p_world[..., 2] - radius - 0.5 * dist], dim=-1)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev)
    axis_w = (R_b @ T.quat_rotate(g_quat, ez)[..., None])[..., 0]
    member = torch.as_tensor(np.arange(model.ngeom)[:, None] == cgeom_np[None, :], device=dev)
    geom_floor_contact = (cand_active[:, None, :] & member).any(-1)

    cval, cidx, _ = top_k(torch.where(cand_active, -dist, torch.full_like(dist, -BIG)),
                          MAX_CONTACTS)
    c_dist = dist.gather(1, cidx)
    c_pos = con_pos.gather(1, cidx[..., None].expand(cidx.shape + (3,)))
    c_active = cand_active.gather(1, cidx) & (cval > -BIG / 2)
    c_margin = take(incmargin, cidx)
    c_cap = is_cap[cidx]
    c_axis = axis_w.gather(1, cidx[..., None].expand(cidx.shape + (3,)))
    c_body = cbody[cidx]
    mu = take(torch.maximum(f(model.geom_friction)[..., cgeom, 0],
                            f(model.floor_friction)[..., 0:1]), cidx)

    # tangent frame on the plane: plane-box/sphere use mju_makeFrame(+z)
    # = (0,1,0), (-1,0,0); plane-capsule aligns t1 with the projected axis
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=dev)
    proj = torch.cat([c_axis[..., :2], torch.zeros_like(c_axis[..., 2:])], dim=-1)
    pnorm = torch.linalg.vector_norm(proj, dim=-1, keepdim=True)
    t1_cap = torch.where(pnorm > 1e-8, proj / pnorm.clamp_min(1e-8), ey)
    t1 = torch.where(c_cap[..., None], t1_cap, ey)
    t2 = torch.where(c_cap[..., None], cross(ez, t1_cap),
                     torch.tensor([-1.0, 0.0, 0.0], dtype=dtype, device=dev))
    W6 = _pyramid(ez.expand_as(t1), t1, t2, mu, c_pos)
    c_vel = _rows(V, W6, c_body)
    c_x = c_dist - c_margin
    c_imp = impedance(solimp, c_x)
    c_aref = -cB[..., None] * c_vel - (cK * c_imp * c_x)[..., None]
    mu_hat = mu.clamp_min(1.0)
    diag_approx = (take(f(model.body_invweight0[..., 0]), c_body)
                   * 2.0 * mu_hat ** 2 * (1.0 + mu_hat ** 2))
    c_R = ((1.0 - c_imp) / c_imp * diag_approx)[..., None].expand(-1, -1, 4)

    # ---------------- body-body (self) contacts ----------------
    sc = self_contacts(model, kin, keeps)
    st1, st2 = make_frame(sc.normal)
    W6_s = _pyramid(sc.normal, st1, st2, sc.friction, sc.pos)
    s_vel = _rows(V, W6_s, sc.body2, sc.body1)
    s_x = sc.dist - sc.margin
    s_imp = impedance(solimp, s_x)
    s_aref = -cB[..., None] * s_vel - (cK * s_imp * s_x)[..., None]
    s_muhat = sc.friction.clamp_min(1.0)
    invw = f(model.body_invweight0[..., 0])
    s_diag = (take(invw, sc.body1) + take(invw, sc.body2)) * 2.0 * s_muhat ** 2 * (1.0 + s_muhat ** 2)
    s_R = ((1.0 - s_imp) / s_imp * s_diag)[..., None].expand(-1, -1, 4)

    # ---------------- projectile (free sphere) contacts ----------------
    minus1 = lambda n: torch.full((B, n), -1, dtype=torch.long, device=dev)
    if spheres is not None:
        W6_p, p_body, p_aref, p_R, p_active, proj_sphere = _sphere_rows(
            model, kin, V, spheres, cK, cB, solimp)
    else:
        zP = lambda *s: torch.zeros((B, MAX_PROJC) + s, dtype=dtype, device=dev)
        W6_p, p_aref, p_R = zP(4, 6), zP(4), zP(4) + 1.0
        p_body, proj_sphere = torch.zeros_like(minus1(MAX_PROJC)), minus1(MAX_PROJC)
        p_active = torch.zeros((B, MAX_PROJC), dtype=torch.bool, device=dev)

    # ---------------- stack and mask ----------------
    aref = torch.cat([c_aref, s_aref, p_aref], dim=1)
    R = torch.cat([c_R, s_R, p_R], dim=1)
    W6_all = torch.cat([W6, W6_s, W6_p], dim=1)
    body1 = torch.cat([minus1(MAX_CONTACTS), sc.body1, minus1(MAX_PROJC)], dim=1)
    body2 = torch.cat([c_body, sc.body2, p_body], dim=1)
    act4 = torch.cat([c_active, sc.active, p_active], dim=1)
    act4 = act4[..., None].expand(-1, -1, 4)
    active = torch.cat([l_active, act4.reshape(B, -1)], dim=1)
    # masking with where, not multiplication: unselected narrowphase slots
    # may hold non-finite values
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    return EFC(
        l_J=torch.where(l_active[..., None], l_J, zero),
        l_aref=torch.where(l_active, l_aref, zero),
        l_R=torch.where(l_active, l_R.clamp_min(1e-10), one),
        W6=torch.where(act4[..., None], W6_all, zero),
        body1=body1, body2=body2,
        aref=torch.where(act4, aref, zero),
        R=torch.where(act4, R.clamp_min(1e-10), one),
        active=active,
        geom_floor_contact=geom_floor_contact,
        proj_sphere=proj_sphere,
    )
