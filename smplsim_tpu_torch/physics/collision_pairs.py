"""Body-body (self-)collision, batched: capsule/sphere/box narrowphase.

Port of the per-env reference semantics of smplsim_tpu/physics/
collision_pairs.py, with the env batch as the leading dim of every tensor.
Pair lists are static (contype/conaffinity, parent-child filtering,
explicit excludes); each family may first be culled to its KEEP pairs of
lowest conservative separation bound, then every pair's narrowphase runs,
and the deepest MAX_SELF candidates are kept:

  * capsule/sphere - capsule/sphere: closest points of the segments, plus
    two slots at the overlap ends of near-parallel segments;
  * capsule/sphere - box: the MuJoCo-exact two-slot routine
    (`capsule_box_contacts`);
  * box - box: the decoded mjc_BoxBox manifold (`_box_box`), 25 candidate
    slots compacted to the deepest 8.

Knobs (the JAX package's, same defaults): SMPLSIM_CC_KEEP, SMPLSIM_CB_KEEP,
SMPLSIM_BB_KEEP. Every selection is `top_k`: descending, first index wins
ties, NaN ranks last.

Every geom's world frame is computed once per call (`geom_frames`: center,
rotation, segment ends, (B,G,...)), and each pair reads its two sides from
those tables by a gather on the geom index; the products are elementwise,
bit for bit the CPU's 3x3 matmul.

The model may be shared or stacked: geom fields are read with the geom axis
indexed from the right, (G,...) or (P,...) shared, (B,G,...) or (B,P,...)
per env.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from smplsim_tpu_torch import transforms as T
from smplsim_tpu_torch.models.spec import GEOM_BOX, GEOM_CAPSULE, GEOM_SPHERE, RobotModel
from smplsim_tpu_torch.physics.algebra import cross
from smplsim_tpu_torch.physics.kinematics import Kin
from smplsim_tpu_torch.utils.profiler import count

MAX_SELF = 12
CC_KEEP = int(os.environ.get("SMPLSIM_CC_KEEP", 24))
CB_KEEP = int(os.environ.get("SMPLSIM_CB_KEEP", 16))
BB_KEEP = int(os.environ.get("SMPLSIM_BB_KEEP", 8))
BIG = 1e9


def top_k(score: torch.Tensor, k: int):
    """Top-k along the last dim with the reference's ranking: descending,
    the first index wins ties, NaN ranks last (as -inf). Returns
    (values, indices, valid); slots beyond the candidate count are invalid,
    point at index 0 and carry -BIG, as are non-finite values."""
    s = torch.where(torch.isnan(score), torch.full_like(score, -float("inf")), score)
    order = torch.sort(s, dim=-1, descending=True, stable=True).indices
    n = s.shape[-1]
    valid = torch.ones(order.shape[:-1] + (min(k, n),), dtype=torch.bool,
                       device=s.device)
    idx = order[..., :k]
    if n < k:
        pad = k - n
        idx = torch.cat([idx, idx.new_zeros(idx.shape[:-1] + (pad,))], dim=-1)
        valid = torch.cat([valid, valid.new_zeros(valid.shape[:-1] + (pad,))], dim=-1)
    vals = s.gather(-1, idx)
    vals = torch.where(valid & torch.isfinite(vals), vals, torch.full_like(vals, -BIG))
    return vals, idx, valid


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B,P,...) -> (B,K,...) along dim 1 by idx (B,K)."""
    shape = idx.shape + x.shape[2:]
    ix = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return x.gather(1, ix)


@dataclasses.dataclass
class SelfContacts:
    dist: torch.Tensor      # (B,S)
    pos: torch.Tensor       # (B,S,3)
    normal: torch.Tensor    # (B,S,3) from geom1 toward geom2
    body1: torch.Tensor     # (B,S) long
    body2: torch.Tensor     # (B,S) long
    friction: torch.Tensor  # (B,S)
    margin: torch.Tensor    # (B,S) includemargin
    active: torch.Tensor    # (B,S) bool


@functools.lru_cache(maxsize=32)
def _pair_lists(parents, geom_body, geom_type, contype, conaffinity, excludes):
    """Static collidable pairs by type family: 'cc' (round-round), 'cb'
    (round-box, round geom first), 'bb' (box-box)."""
    n = len(geom_type)
    exset = set(excludes)

    def body_filter(b1, b2):
        if b1 == b2 or parents[b1] == b2 or parents[b2] == b1:
            return False
        return (min(b1, b2), max(b1, b2)) not in exset

    cc, cb, bb = [], [], []
    for i in range(n):
        for j in range(i + 1, n):
            if not body_filter(geom_body[i], geom_body[j]):
                continue
            if not ((contype[i] & conaffinity[j]) or (contype[j] & conaffinity[i])):
                continue
            round_i = geom_type[i] in (GEOM_CAPSULE, GEOM_SPHERE)
            round_j = geom_type[j] in (GEOM_CAPSULE, GEOM_SPHERE)
            if round_i and round_j:
                cc.append((i, j))
            elif round_i and geom_type[j] == GEOM_BOX:
                cb.append((i, j))
            elif geom_type[i] == GEOM_BOX and round_j:
                cb.append((j, i))
            else:
                bb.append((i, j))
    to_np = lambda x: np.asarray(x, dtype=np.int64).reshape(-1, 2)
    return {"cc": to_np(cc), "cb": to_np(cb), "bb": to_np(bb)}


def pair_lists(model: RobotModel) -> dict:
    """The model's static pairs by family (`_pair_lists`), (P,2) each."""
    contype = model.geom_contype or tuple(7 for _ in model.geom_type)
    conaffinity = model.geom_conaffinity or tuple(1 for _ in model.geom_type)
    return _pair_lists(model.parents, model.geom_body, model.geom_type,
                       contype, conaffinity, model.contact_excludes)


def _dot(a, b):
    return (a * b).sum(-1)


def _norm(a):
    return torch.sqrt((a * a).sum(-1))


def _rotate(R, v):
    """R v for R (...,3,3), v (...,3), as three broadcast multiply-adds: the
    CPU's matmul of a 3x3 sums k = 0, 1, 2 in this order."""
    return R[..., :, 0] * v[..., 0, None] + R[..., :, 1] * v[..., 1, None] \
        + R[..., :, 2] * v[..., 2, None]


def _compose(A, C):
    """A C for (...,3,3) rotations, elementwise as `_rotate`."""
    return A[..., :, 0:1] * C[..., 0:1, :] + A[..., :, 1:2] * C[..., 1:2, :] \
        + A[..., :, 2:3] * C[..., 2:3, :]


@dataclasses.dataclass
class GeomFrames:
    """Every geom's world frame: center and rotation, and the segment ends
    of a capsule (a sphere's are its center, a box's are its center and
    unused). (B,G,...)."""
    pos: torch.Tensor       # (B,G,3)
    rot: torch.Tensor       # (B,G,3,3)
    seg_p: torch.Tensor     # (B,G,3) center - half-length * axis z
    seg_q: torch.Tensor     # (B,G,3) center + half-length * axis z


def geom_frames(model: RobotModel, kin: Kin) -> GeomFrames:
    """World frames of all G geoms from the body frames, once per FK."""
    dtype, dev = kin.xpos.dtype, kin.xpos.device
    body = torch.as_tensor(np.asarray(model.geom_body, np.int64), device=dev)
    Rb = kin.xmat[:, body]
    pos = kin.xpos[:, body] + _rotate(Rb, model.geom_pos.to(dtype))
    rot = _compose(Rb, T.quat_to_matrix(model.geom_quat.to(dtype)))
    is_cap = torch.as_tensor([t == GEOM_CAPSULE for t in model.geom_type], dtype=dtype,
                             device=dev)
    half = (model.geom_size[..., 1].to(dtype) * is_cap)[..., None] * rot[..., :, 2]
    count("rows.geom_frames", len(model.geom_type))
    return GeomFrames(pos, rot, pos - half, pos + half)


def _seg_seg_closest(p1, q1, p2, q2, eps=1e-12):
    """Closest points of segments [p1,q1], [p2,q2] (Ericson 5.1.9)."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    f = _dot(d2, r)
    c = _dot(d1, r)
    b = _dot(d1, d2)
    denom = a * e - b * b
    parallel = denom < eps * a * e + eps
    s = torch.where(parallel, torch.zeros_like(a), torch.clamp(
        (b * f - c * e) / torch.where(parallel, torch.ones_like(denom), denom), 0.0, 1.0))
    t = (b * s + f) / e.clamp_min(eps)
    t_cl = torch.clamp(t, 0.0, 1.0)
    s = torch.clamp((b * t_cl - c) / a.clamp_min(eps), 0.0, 1.0)
    return p1 + s[..., None] * d1, p2 + t_cl[..., None] * d2, parallel


def _box_sdf(p, half):
    """Signed distance and outward normal of a box in its frame, (...,3)."""
    q = p.abs() - half
    outside = q.clamp_min(0.0)
    d_out = torch.linalg.vector_norm(outside, dim=-1)
    dist = d_out + q.amax(-1).clamp_max(0.0)
    sgn = torch.where(p >= 0, 1.0, -1.0).to(p.dtype)
    n_out = sgn * outside / d_out.clamp_min(1e-12)[..., None]
    n_in = sgn * torch.nn.functional.one_hot(q.argmax(-1), 3).to(p.dtype)
    return dist, torch.where((d_out > 0)[..., None], n_out, n_in)


def capsule_box_contacts(lp, lq, half, r):
    """MuJoCo-exact capsule-box narrowphase in the box frame, two slots.

    The primary contact sits at the global minimizer of the box SDF along
    the segment, found exactly over a fixed candidate set (interval ends,
    per-interval quadratic vertices, pairwise crossings). The secondary
    contact (capsule lying along a face) sits at t2 = eta (t_exit (1 + s^2)
    - w_c s) from the capsule center and is emitted only when face-
    dominated and non-degenerate. lp, lq, half (...,3); r (...). Returns
    dist (...,2), pos (...,2,3), normal (...,2,3) (capsule toward box).
    """
    dtype = lp.dtype
    d = lq - lp
    seg_len2 = _dot(d, d)
    ok_d = d.abs() > 1e-12
    safe_d = torch.where(ok_d, d, torch.ones_like(d))
    t_hi = torch.where(ok_d, (half - lp) / safe_d, torch.full_like(d, -1.0))
    t_lo = torch.where(ok_d, (-half - lp) / safe_d, torch.full_like(d, -1.0))
    brk = torch.cat([t_lo, t_hi], dim=-1).clamp(0.0, 1.0)
    zero = torch.zeros_like(brk[..., :1])
    ts = torch.sort(torch.cat([zero, zero + 1.0, brk], dim=-1), dim=-1).values
    ta, tb = ts[..., :-1], ts[..., 1:]
    tm = 0.5 * (ta + tb)

    x_m = lp[..., None, :] + tm[..., :, None] * d[..., None, :]     # (...,7,3)
    sgn = torch.where(x_m >= 0, 1.0, -1.0).to(dtype)
    out = x_m.abs() > half[..., None, :]
    e = lp[..., None, :] - sgn * half[..., None, :]
    dd = d[..., None, :].expand_as(e)
    A2 = torch.where(out, dd ** 2, torch.zeros_like(e)).sum(-1)
    B2 = torch.where(out, dd * e, torch.zeros_like(e)).sum(-1)
    t_vert = torch.where(A2 > 1e-18, -B2 / A2.clamp_min(1e-18), tm)
    t_vert = torch.minimum(torch.maximum(t_vert, ta), tb)

    g = sgn * lp[..., None, :] - half[..., None, :]
    k = sgn * d[..., None, :]
    t_cross = []
    for i, j in ((0, 1), (0, 2), (1, 2)):
        dk = k[..., i] - k[..., j]
        okk = dk.abs() > 1e-14
        tc = torch.where(okk, (g[..., j] - g[..., i]) /
                         torch.where(okk, dk, torch.ones_like(dk)), tm)
        t_cross.append(torch.minimum(torch.maximum(tc, ta), tb))
    t_cross = torch.stack(t_cross, dim=-1).reshape(ta.shape[:-1] + (-1,))

    cand = torch.cat([ts, t_vert, t_cross], dim=-1)                  # (...,36)

    def sdf_at(t):
        pt = lp[..., None, :] + t[..., :, None] * d[..., None, :]
        dist, n = _box_sdf(pt, half[..., None, :])
        return dist, n, pt

    dist_c, _, _ = sdf_at(cand)
    t1 = cand.gather(-1, dist_c.argmin(-1, keepdim=True))
    d1s, n1, p1 = sdf_at(t1)
    d1s, n1, p1 = d1s[..., 0], n1[..., 0, :], p1[..., 0, :]
    dist1 = d1s - r
    nrm1 = -n1
    pos1 = p1 + (r + 0.5 * dist1)[..., None] * nrm1

    # secondary (parallel-to-face) contact
    seg_len = torch.sqrt(seg_len2.clamp_min(1e-24))
    axis = d / seg_len[..., None]
    hl = 0.5 * seg_len
    center = 0.5 * (lp + lq)
    kface = n1.abs().argmax(-1)
    fsgn = torch.sign(n1.gather(-1, kface[..., None])[..., 0])
    fsgn = torch.where(fsgn == 0, torch.ones_like(fsgn), fsgn)
    nhat = fsgn[..., None] * torch.nn.functional.one_hot(kface, 3).to(dtype)
    s_ax = _dot(axis, nhat)
    eta = torch.where(s_ax >= 0, 1.0, -1.0).to(dtype)
    s = s_ax.abs()
    u2d = axis - s_ax[..., None] * nhat
    c2d = torch.sqrt(_dot(u2d, u2d).clamp_min(1e-24))
    dir2d = eta[..., None] * u2d / c2d[..., None]
    h_k = _dot(half, nhat.abs())
    w_c = _dot(center, nhat) - h_k
    p2 = center - _dot(center, nhat)[..., None] * nhat
    face_mask = 1.0 - nhat.abs()
    big_dir = dir2d.abs() > 1e-12
    safe_dir = torch.where(big_dir, dir2d, torch.ones_like(dir2d))
    lpos = torch.where(big_dir & (face_mask > 0.5),
                       (torch.sign(dir2d) * half - p2) / safe_dir,
                       torch.full_like(dir2d, float("inf")))
    L_exit = lpos.amin(-1).clamp_min(0.0)
    t_exit = L_exit / c2d.clamp_min(1e-12)
    t2 = eta * (t_exit * (1.0 + s * s) - w_c * s)
    t2 = torch.minimum(torch.maximum(t2, -hl), hl)
    P2 = center + t2[..., None] * axis
    dist2 = _dot(P2, nhat) - h_k - r
    nrm2 = -nhat
    pos2 = P2 + (r + 0.5 * dist2)[..., None] * nrm2
    n1_dom = n1.abs().amax(-1) / torch.sqrt(_dot(n1, n1).clamp_min(1e-24))
    bad2 = ((c2d < 1e-9) | ~torch.isfinite(L_exit) | (seg_len2 < 1e-20)
            | (n1_dom < 0.9))
    dist2 = torch.where(bad2, torch.full_like(dist2, BIG), dist2)
    return (torch.stack([dist1, dist2], dim=-1),
            torch.stack([pos1, pos2], dim=-2),
            torch.stack([nrm1, nrm2], dim=-2))


_BB_SLOTS = 25
_LOOP = ((-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0))
_PU = ((0, 1, 0, 0), (1, 0, 0, 0), (0, 0, 0, 1), (0, 0, 1, 0))  # adjacent along u
_PV = ((0, 0, 0, 1), (0, 0, 1, 0), (0, 1, 0, 0), (1, 0, 0, 0))  # adjacent along v
_PRIO = (((2.0, 1.0, 3.0, 4.0), (4.0, 3.0, 1.0, 2.0)),
         ((3.0, 4.0, 2.0, 1.0), (4.0, 3.0, 1.0, 2.0)),
         ((4.0, 2.0, 1.0, 3.0), (2.0, 4.0, 3.0, 1.0)))


def _mv(R, v):
    return (R @ v[..., None])[..., 0]


def _mtv(R, v):
    return (R.transpose(-1, -2) @ v[..., None])[..., 0]


def _sign1(x):
    s = torch.sign(x)
    return torch.where(s == 0, torch.ones_like(s), s)


def _box_box(p1, R1, h1, p2, R2, h2, margin):
    """Decoded mjc_BoxBox manifold for each pair, leading dims (...):
    p (...,3), R (...,3,3), h (...,3), margin (...). Returns dist (...,25),
    pos (...,25,3), normal (...,25,3), active (...,25); see
    smplsim_tpu/physics/collision_pairs.py::_box_box_one for the decoding
    notes (SAT in probe order with a relative 1e-12 preference, face and
    edge manifolds, margin and outside-box drops, dedup, the first 8)."""
    dtype, dev = p1.dtype, p1.device
    oh3 = lambda i: torch.nn.functional.one_hot(i, 3).to(dtype)
    t = p2 - p1
    loop = torch.tensor(_LOOP, dtype=dtype, device=dev)

    # ---- SAT over 6 face and 9 edge axes
    fa = torch.cat([R1.transpose(-1, -2), R2.transpose(-1, -2)], dim=-2)  # (...,6,3)
    pen_f = ((fa @ R1).abs() @ h1[..., None] + (fa @ R2).abs() @ h2[..., None]
             - (fa @ t[..., None]).abs())[..., 0]
    c9 = cross(R1.transpose(-1, -2)[..., :, None, :],
               R2.transpose(-1, -2)[..., None, :, :]).reshape(p1.shape[:-1] + (9, 3))
    cn = _norm(c9)
    ea = c9 / cn.clamp_min(1e-15)[..., None]
    pen_e = torch.where(
        cn > 1e-15,
        ((ea @ R1).abs() @ h1[..., None] + (ea @ R2).abs() @ h2[..., None]
         - (ea @ t[..., None]).abs())[..., 0],
        torch.full_like(cn, BIG))
    pens = torch.cat([pen_f, pen_e], dim=-1)                     # (...,15)
    axes = torch.cat([fa, ea], dim=-2)                           # (...,15,3)
    best = pens[..., 0]
    code = torch.zeros_like(best, dtype=torch.long)
    for k in range(1, 15):
        better = pens[..., k] < best * (1.0 - 1e-12)
        best = torch.where(better, pens[..., k], best)
        code = torch.where(better, torch.full_like(code, k), code)
    raw = axes.gather(-2, code[..., None, None].expand(code.shape + (1, 3)))[..., 0, :]
    a = raw * _sign1(_dot(raw, t))[..., None]                    # box1 -> box2
    use_edge = code >= 6
    ref_is_1 = code < 3

    def pick(c1, c2):
        return torch.where(ref_is_1.reshape(ref_is_1.shape + (1,) * (c1.dim() - ref_is_1.dim())),
                           c1, c2)

    # ================= face-case manifold =================
    rp, rR, rh = pick(p1, p2), pick(R1, R2), pick(h1, h2)
    ip_, iR, ih = pick(p2, p1), pick(R2, R1), pick(h2, h1)
    rsg = torch.where(ref_is_1, 1.0, -1.0).to(dtype)
    rn = rsg[..., None] * a
    koh = oh3(torch.clamp(code, 0, 5) % 3)
    koh1 = torch.roll(koh, 1, dims=-1)
    koh2 = torch.roll(koh, 2, dims=-1)
    mcol = _mv(rR, koh)
    mr = mcol * _sign1(_dot(mcol, rn))[..., None]
    cr = rp + mr * _dot(rh, koh)[..., None]
    hu, hv = _dot(rh, koh1), _dot(rh, koh2)
    eu, ev = _mv(rR, koh1), _mv(rR, koh2)

    idots = _mtv(iR, -rn)
    ioh = oh3(idots.abs().argmax(-1))
    mi = _mv(iR, ioh) * _sign1(_dot(idots, ioh))[..., None]
    ci = ip_ + mi * _dot(ih, ioh)[..., None]
    ioh1 = torch.roll(ioh, 1, dims=-1)
    ioh2 = torch.roll(ioh, 2, dims=-1)
    iu = _mv(iR, ioh1) * _dot(ih, ioh1)[..., None]
    iv = _mv(iR, ioh2) * _dot(ih, ioh2)[..., None]

    Ci = (ci[..., None, :] + loop[:, 0:1] * iu[..., None, :]
          + loop[:, 1:2] * iv[..., None, :])                     # (...,4,3)
    rn_mr = _dot(rn, mr)
    rn_mr = torch.where(rn_mr.abs() > 1e-12, rn_mr, torch.full_like(rn_mr, 1e-12))
    lam = _dot(cr[..., None, :] - Ci, mr[..., None, :]) / rn_mr[..., None]
    Qi3 = Ci + lam[..., None] * rn[..., None, :]
    Q = torch.stack([_dot(Qi3 - cr[..., None, :], eu[..., None, :]),
                     _dot(Qi3 - cr[..., None, :], ev[..., None, :])], dim=-1)  # (...,4,2)
    D = _dot(Ci - cr[..., None, :], mr[..., None, :])            # (...,4)

    # clcorner via the decoded sign-bit rule
    al = (_dot(raw, t) * rsg) < 0
    su = torch.where((_dot(raw, iu) > 0) != al, -1.0, 1.0).to(dtype)
    sv = torch.where((_dot(raw, iv) > 0) != al, -1.0, 1.0).to(dtype)
    c0_oh = ((loop[:, 0] == su[..., None]) & (loop[:, 1] == sv[..., None])).to(dtype)

    in_u = _dot(iu, rn) ** 2 < 0.25 * _dot(iu, iu)
    in_v = _dot(iv, rn) ** 2 < 0.25 * _dot(iv, iv)
    n_in = in_u.long() + in_v.long()

    PU = torch.tensor(_PU, dtype=dtype, device=dev)
    PV = torch.tensor(_PV, dtype=dtype, device=dev)
    pu_c0 = c0_oh @ PU.T
    pv_c0 = c0_oh @ PV.T
    nb_oh = torch.where(in_u[..., None], pu_c0, pv_c0)

    QA, QB = Q, torch.roll(Q, -1, dims=-2)
    DA, DB = D, torch.roll(D, -1, dims=-1)
    edge_both = ((c0_oh * torch.roll(nb_oh, -1, dims=-1))
                 + (nb_oh * torch.roll(c0_oh, -1, dims=-1))) > 0.5
    n_in4 = n_in[..., None]
    line_act = (n_in4 >= 2) | ((n_in4 == 1) & edge_both)

    dvec = QB - QA
    f_q, f_d, f_act = [], [], []
    for ax, lim, olim in ((0, hu, hv), (1, hv, hu)):
        for sg in (1.0, -1.0):
            den = dvec[..., ax]
            ok = den.abs() > 1e-15
            tt = (sg * lim[..., None] - QA[..., ax]) / torch.where(ok, den, torch.ones_like(den))
            q = QA + tt[..., None] * dvec
            f_q.append(q)
            f_d.append(DA + tt * (DB - DA))
            f_act.append(line_act & ok & (tt >= 0.0) & (tt <= 1.0)
                         & (q[..., 1 - ax].abs() <= olim[..., None]))
    lead = Q.shape[:-2]
    fq = torch.stack(f_q, dim=-2).reshape(lead + (16, 2))       # edge-major
    fd = torch.stack(f_d, dim=-1).reshape(lead + (16,))
    fact = torch.stack(f_act, dim=-1).reshape(lead + (16,))

    # contained reference-rect corners (2-in-plane regime only)
    q0 = (c0_oh[..., None] * Q).sum(-2)
    D0 = (c0_oh * D).sum(-1)
    U = (pu_c0[..., None] * Q).sum(-2) - q0
    V = (pv_c0[..., None] * Q).sum(-2) - q0
    Du = (pu_c0 * D).sum(-1) - D0
    Dv = (pv_c0 * D).sum(-1) - D0
    det = U[..., 0] * V[..., 1] - U[..., 1] * V[..., 0]
    det_ok = det.abs() > 1e-15
    det_s = torch.where(det_ok, det, torch.ones_like(det))
    rc_q, rc_d, rc_act = [], [], []
    for su_ in (1.0, -1.0):
        for sv_ in (1.0, -1.0):
            rc = torch.stack([su_ * hu, sv_ * hv], dim=-1)
            w = rc - q0
            aa = (w[..., 0] * V[..., 1] - w[..., 1] * V[..., 0]) / det_s
            bb = (U[..., 0] * w[..., 1] - U[..., 1] * w[..., 0]) / det_s
            rc_q.append(rc)
            rc_d.append(D0 + aa * Du + bb * Dv)
            rc_act.append((n_in >= 2) & det_ok & (aa >= 0.0) & (aa <= 1.0)
                          & (bb >= 0.0) & (bb <= 1.0))
    rcq = torch.stack(rc_q, dim=-2)
    rcd = torch.stack(rc_d, dim=-1)
    rcact = torch.stack(rc_act, dim=-1)

    # incident quad corners inside the reference rect
    inside_rect = (Q[..., 0].abs() <= hu[..., None]) & (Q[..., 1].abs() <= hv[..., None])
    allowed = (n_in4 >= 2) | ((n_in4 == 1) & (nb_oh > 0.5))
    qc_act = inside_rect & allowed

    face_q = torch.cat([fq, rcq, Q, q0[..., None, :]], dim=-2)    # (...,25,2)
    face_d = torch.cat([fd, rcd, D, D0[..., None]], dim=-1)
    face_act = torch.cat([fact, rcact, qc_act, torch.ones_like(qc_act[..., :1])], dim=-1)
    face_pos = (cr[..., None, :] + face_q[..., 0:1] * eu[..., None, :]
                + face_q[..., 1:2] * ev[..., None, :]
                + 0.5 * face_d[..., None] * mr[..., None, :])

    # ================= edge-case manifold =================
    def support_face(p, R, h, toward):
        dots = _mtv(R, toward)
        oh = oh3(dots.abs().argmax(-1))
        sg = _sign1(_dot(dots, oh))
        m = _mv(R, oh) * sg[..., None]
        c = p + m * _dot(h, oh)[..., None]
        o1 = torch.roll(oh, 1, dims=-1)
        o2 = torch.roll(oh, 2, dims=-1)
        fu = _mv(R, o1) * _dot(h, o1)[..., None]
        fv = _mv(R, o2) * _dot(h, o2)[..., None]
        corners = (c[..., None, :] + loop[:, 0:1] * fu[..., None, :]
                   + loop[:, 1:2] * fv[..., None, :])
        return corners, c, m, oh, sg

    C1e, c1p, m1, oh1f, sg1f = support_face(p1, R1, h1, a)
    C2e, c2p, m2, _, _ = support_face(p2, R2, h2, -a)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=dev)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev)
    seed = torch.where((a[..., 2].abs() > 0.9)[..., None], ey, ez)
    ue = seed - _dot(seed, a)[..., None] * a
    ue = ue / _norm(ue).clamp_min(1e-12)[..., None]
    ve = cross(a, ue)
    O = p1

    def to2d(P):
        rel = P - O[..., None, :]
        return torch.stack([_dot(rel, ue[..., None, :]), _dot(rel, ve[..., None, :])], dim=-1)

    Q1 = to2d(C1e)
    Q2 = to2d(C2e)

    def safe(x):
        return torch.where(x.abs() > 1e-12, x, torch.full_like(x, 1e-12))

    am1 = safe(_dot(a, m1))
    am2 = safe(_dot(a, m2))

    def alpha(xy, cp, m, am):
        return ((_dot(cp - O, m)[..., None] - xy[..., 0] * _dot(ue, m)[..., None]
                 - xy[..., 1] * _dot(ve, m)[..., None]) / am[..., None])

    A1 = Q1.repeat_interleave(4, dim=-2)                         # (...,16,2)
    B1 = torch.roll(Q1, -1, dims=-2).repeat_interleave(4, dim=-2)
    A2 = Q2.repeat((1,) * (Q2.dim() - 2) + (4, 1))
    B2 = torch.roll(Q2, -1, dims=-2).repeat((1,) * (Q2.dim() - 2) + (4, 1))
    d1 = B1 - A1
    d2 = B2 - A2
    den = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    den_ok = den.abs() >= 1e-14
    den_s = torch.where(den_ok, den, torch.ones_like(den))
    w0 = A2 - A1
    tt = (w0[..., 0] * d2[..., 1] - w0[..., 1] * d2[..., 0]) / den_s
    ss = (w0[..., 0] * d1[..., 1] - w0[..., 1] * d1[..., 0]) / den_s
    xpt = A1 + tt[..., None] * d1
    xact = den_ok & (tt >= 0.0) & (tt <= 1.0) & (ss >= 0.0) & (ss <= 1.0)

    def inside(pts, quad):
        e = torch.roll(quad, -1, dims=-2) - quad
        rel = pts[..., :, None, :] - quad[..., None, :, :]
        cz = e[..., None, :, 0] * rel[..., 1] - e[..., None, :, 1] * rel[..., 0]
        return (cz >= -1e-12).all(-1) | (cz <= 1e-12).all(-1)

    c1in = inside(Q1, Q2)
    c2in = inside(Q2, Q1)
    # at most one box1-face corner: the first inside one in mjc_BoxBox's
    # enumeration order, PRIO[axis][sign][slot] (higher is earlier)
    sgsel = torch.stack([(sg1f > 0), (sg1f <= 0)], dim=-1).to(dtype)
    prio = torch.einsum("...k,...s,ksl->...l", oh1f, sgsel,
                        torch.tensor(_PRIO, dtype=dtype, device=dev))
    score = torch.where(c1in, prio, torch.zeros_like(prio))
    c1pick = torch.nn.functional.one_hot(score.argmax(-1), 4).to(dtype)
    c1_q = (c1pick[..., None] * Q1).sum(-2)
    edge_q = torch.cat([xpt, Q2, c1_q[..., None, :],
                        torch.zeros(lead + (4, 2), dtype=dtype, device=dev)], dim=-2)
    edge_act = torch.cat([xact, c2in, c1in.any(-1, keepdim=True),
                          torch.zeros(lead + (4,), dtype=torch.bool, device=dev)], dim=-1)
    edge_al1 = alpha(edge_q, c1p, m1, am1)
    edge_d = alpha(edge_q, c2p, m2, am2) - edge_al1
    edge_pos = (O[..., None, :] + edge_q[..., 0:1] * ue[..., None, :]
                + edge_q[..., 1:2] * ve[..., None, :]
                + (edge_al1 + 0.5 * edge_d)[..., None] * a[..., None, :])

    # ================= select + shared filters =================
    ue_ = use_edge[..., None]
    dep = torch.where(ue_, edge_d, face_d)
    pos = torch.where(ue_[..., None], edge_pos, face_pos)
    act = torch.where(ue_, edge_act, face_act) & (dep <= margin[..., None])

    # mju_outsideBox(1.01) drop rule
    def outside_flags(p, R, h):
        loc = (pos - p[..., None, :]) @ R
        hs = (h + margin[..., None])[..., None, :]
        return (loc.abs() <= hs / 1.01).all(-1), (loc.abs() > hs * 1.01).any(-1)

    in1, out1 = outside_flags(p1, R1, h1)
    in2, out2 = outside_flags(p2, R2, h2)
    act = act & ~((out1 & ~in2) | (out2 & ~in1))

    # exact dedup keeping the lowest slot, then the first 8 survivors
    diff = _norm(pos[..., :, None, :] - pos[..., None, :, :])
    same = (diff < 1e-9) & act[..., :, None] & act[..., None, :]
    act = act & ~torch.tril(same, diagonal=-1).any(-1)
    act = act & (torch.cumsum(act.long(), dim=-1) <= 8)
    return dep, pos, a[..., None, :].expand(pos.shape), act


def _combine(model, g1, g2, dtype):
    """Pair friction (max) and margin (sum), (P,) or (B,P)."""
    mu = torch.maximum(model.geom_friction[..., g1, 0], model.geom_friction[..., g2, 0])
    margin = model.geom_margin[..., g1] + model.geom_margin[..., g2]
    return mu.to(dtype), margin.to(dtype)


def self_contacts(model: RobotModel, kin: Kin, keeps=None,
                  frames: GeomFrames | None = None) -> SelfContacts:
    """All body-body contact candidates, the deepest MAX_SELF selected.
    keeps = (CC_KEEP, CB_KEEP, BB_KEEP) by default; `frames` are
    geom_frames(model, kin), computed here when not given."""
    cc_keep, cb_keep, bb_keep = (CC_KEEP, CB_KEEP, BB_KEEP) if keeps is None else keeps
    if frames is None:
        frames = geom_frames(model, kin)
    B = kin.xpos.shape[0]
    dtype, dev = kin.xpos.dtype, kin.xpos.device
    pl = pair_lists(model)
    count("rows.pair_sides", 2 * sum(len(v) for v in pl.values()))
    out = {k: [] for k in ("dist", "pos", "normal", "b1", "b2", "mu", "margin")}
    geom_body = np.asarray(model.geom_body, np.int64)
    # per geom: segment centers and half-lengths (the culls' bounds), radii;
    # each pair reads its sides from these and the frames by gather_rows
    center = 0.5 * (frames.seg_p + frames.seg_q)
    half_len = 0.5 * _norm(frames.seg_q - frames.seg_p)
    radius = model.geom_size[..., 0].to(dtype)

    def per_pair(x, nd: int = 1):
        """(P,...) per pair or (B,P,...) per env and pair, nd dims per env,
        -> (B,P,...)."""
        x = torch.as_tensor(x, device=dev)
        return x.expand((B,) + x.shape[x.dim() - nd:])

    def indices(g1, g2):
        """The pair geoms and their bodies, (P,) each, in one copy to the device."""
        return torch.as_tensor(np.stack([g1, g2, geom_body[g1], geom_body[g2]]), device=dev)

    def cull(d_low, keep, tensors):
        _, idx, _ = top_k(-d_low, keep)
        return [gather_rows(x, idx) for x in tensors]

    def emit(dist, pos, normal, b1, b2, mu, margin):
        for key, v in zip(out, (dist, pos, normal, b1, b2, mu, margin)):
            out[key].append(v)

    if len(pl["cc"]):
        g1, g2 = pl["cc"][:, 0], pl["cc"][:, 1]
        mu, margin = _combine(model, g1, g2, dtype)
        r1, r2 = radius[..., g1], radius[..., g2]
        r1, r2, mu, margin, gg1, gg2, bb1, bb2 = map(per_pair, (r1, r2, mu, margin,
                                                              *indices(g1, g2)))
        if len(g1) > cc_keep:
            d_low = (_norm(gather_rows(center, gg1) - gather_rows(center, gg2))
                     - gather_rows(half_len, gg1) - gather_rows(half_len, gg2) - r1 - r2)
            r1, r2, mu, margin, bb1, bb2, gg1, gg2 = cull(
                d_low, cc_keep, (r1, r2, mu, margin, bb1, bb2, gg1, gg2))
        p1, q1 = gather_rows(frames.seg_p, gg1), gather_rows(frames.seg_q, gg1)
        p2, q2 = gather_rows(frames.seg_p, gg2), gather_rows(frames.seg_q, gg2)
        c1, c2, par = _seg_seg_closest(p1, q1, p2, q2)
        delta = c2 - c1
        gap = _norm(delta)
        n = delta / gap.clamp_min(1e-12)[..., None]
        pos = 0.5 * (c1 + r1[..., None] * n + c2 - r2[..., None] * n)
        # near-parallel overlapping segments: two contacts at the overlap ends
        d1 = q1 - p1
        len1sq = _dot(d1, d1).clamp_min(1e-12)
        d2 = q2 - p2
        len2sq = _dot(d2, d2).clamp_min(1e-12)
        far = torch.full_like(gap, BIG)
        for other in (p2, q2):
            tt = torch.clamp(_dot(other - p1, d1) / len1sq, 0.0, 1.0)
            c1p = p1 + tt[..., None] * d1
            t2 = torch.clamp(_dot(c1p - p2, d2) / len2sq, 0.0, 1.0)
            c2p = p2 + t2[..., None] * d2
            gg = _norm(c2p - c1p)
            nn = (c2p - c1p) / gg.clamp_min(1e-12)[..., None]
            ppar = 0.5 * (c1p + r1[..., None] * nn + c2p - r2[..., None] * nn)
            emit(torch.where(par, gg - r1 - r2, far), ppar, nn, bb1, bb2, mu, margin)
        emit(torch.where(par, far, gap - r1 - r2), pos, n, bb1, bb2, mu, margin)

    if len(pl["cb"]):
        g1, g2 = pl["cb"][:, 0], pl["cb"][:, 1]        # round geom, box
        mu, margin = _combine(model, g1, g2, dtype)
        half = per_pair(model.geom_size[..., g2, :].to(dtype), 2)
        r1, mu, margin, gg1, gg2, bb1, bb2 = map(per_pair, (radius[..., g1], mu, margin,
                                                          *indices(g1, g2)))
        if len(g1) > cb_keep:
            d_low = (_norm(gather_rows(center, gg1) - gather_rows(frames.pos, gg2))
                     - gather_rows(half_len, gg1) - r1 - _norm(half))
            r1, half, mu, margin, bb1, bb2, gg1, gg2 = cull(
                d_low, cb_keep, (r1, half, mu, margin, bb1, bb2, gg1, gg2))
        p1, q1 = gather_rows(frames.seg_p, gg1), gather_rows(frames.seg_q, gg1)
        bpos, bR = gather_rows(frames.pos, gg2), gather_rows(frames.rot, gg2)
        d_cb, p_cb, n_cb = capsule_box_contacts(_mtv(bR, p1 - bpos), _mtv(bR, q1 - bpos),
                                                half, r1)
        p_w = bpos[..., None, :] + p_cb @ bR.transpose(-1, -2)
        n_w = n_cb @ bR.transpose(-1, -2)
        P = d_cb.shape[1]
        rep = lambda x: x.repeat_interleave(2, dim=1)
        emit(d_cb.reshape(B, 2 * P), p_w.reshape(B, 2 * P, 3), n_w.reshape(B, 2 * P, 3),
             rep(bb1), rep(bb2), rep(mu), rep(margin))

    if len(pl["bb"]):
        g1, g2 = pl["bb"][:, 0], pl["bb"][:, 1]
        mu, margin = _combine(model, g1, g2, dtype)
        h1 = per_pair(model.geom_size[..., g1, :].to(dtype), 2)
        h2 = per_pair(model.geom_size[..., g2, :].to(dtype), 2)
        mu, margin, gg1, gg2, bb1, bb2 = map(per_pair, (mu, margin, *indices(g1, g2)))
        if len(g1) > bb_keep:
            d_low = (_norm(gather_rows(frames.pos, gg1) - gather_rows(frames.pos, gg2))
                     - (_norm(h1) + _norm(h2)))
            h1, h2, mu, margin, bb1, bb2, gg1, gg2 = cull(
                d_low, bb_keep, (h1, h2, mu, margin, bb1, bb2, gg1, gg2))
        pos1, R1 = gather_rows(frames.pos, gg1), gather_rows(frames.rot, gg1)
        pos2, R2 = gather_rows(frames.pos, gg2), gather_rows(frames.rot, gg2)
        d_bb, p_bb, n_bb, act_bb = _box_box(pos1, R1, h1, pos2, R2, h2, margin)
        d_bb = torch.where(act_bb, d_bb, torch.full_like(d_bb, BIG))
        # mjc_BoxBox emits at most 8 points: keep the deepest 8 of 25 slots
        P = d_bb.shape[1]
        _, i8, _ = top_k(-d_bb, 8)                                   # (B,P,8)
        d_bb = d_bb.gather(-1, i8)
        i83 = i8[..., None].expand(i8.shape + (3,))
        p_bb = p_bb.gather(-2, i83)
        n_bb = n_bb.gather(-2, i83)
        rep = lambda x: x.repeat_interleave(8, dim=1)
        emit(d_bb.reshape(B, 8 * P), p_bb.reshape(B, 8 * P, 3), n_bb.reshape(B, 8 * P, 3),
             rep(bb1), rep(bb2), rep(mu), rep(margin))

    dist, pos, normal, b1, b2, mu, margin = (torch.cat(out[k], dim=1) for k in out)
    active_all = dist < margin
    score = torch.where(active_all, -dist, torch.full_like(dist, -BIG))
    sval, sel, _ = top_k(score, MAX_SELF)
    g = lambda x: gather_rows(x, sel)
    return SelfContacts(dist=g(dist), pos=g(pos), normal=g(normal), body1=g(b1),
                        body2=g(b2), friction=g(mu), margin=g(margin),
                        active=g(active_all) & (sval > -BIG / 2))
