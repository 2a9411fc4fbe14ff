"""PyTorch port, module by module, against the JAX package's batched
(vmapped) functions in float64: kinematics, dynamics, constraint rows and
self-contacts at the 1e-9 relative bar of tests/test_substep_lanes.py; the
narrowphase's per-geom world frames and the floor points against the
per-pair and per-point products they replaced, bit for bit."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from smplsim_tpu.physics import collision_pairs as jax_cp
from smplsim_tpu.physics import constraints as jax_con
from smplsim_tpu.physics import dynamics as jax_dyn
from smplsim_tpu.physics import kinematics as jax_kin
from smplsim_tpu_torch import transforms
from smplsim_tpu_torch.models import registry, stack_models, tile_model
from smplsim_tpu_torch.models.spec import GEOM_CAPSULE
from smplsim_tpu_torch.physics import collision_pairs, constraints, dynamics, kinematics
from smplsim_tpu_torch.utils import profiler
from tests._torch_port import T, models, rel_err, states

TOL = 1e-9
B = 6
KINDS = ["air", "contact", "tangled"]


@pytest.fixture(scope="module")
def pair():
    return models()


@pytest.fixture(scope="module")
def jax_fns(pair):
    jm, _ = pair

    def one(q, v):
        kin = jax_kin.fk(jm, q)
        return (kin, jax_kin.body_quats(jm, q), jax_dyn.mass_matrix(jm, kin),
                jax_dyn.bias_forces(jm, kin, v), jax_con.make_efc(jm, kin, q, v))

    return jax.jit(jax.vmap(one))


@pytest.mark.parametrize("kind", KINDS)
def test_fk_dynamics_efc_match(pair, jax_fns, kind):
    jm, tm = pair
    qpos, qvel, _ = states(jm, B, kind, seed=1)
    kin_j, quats_j, M_j, C_j, efc_j = jax_fns(qpos, qvel)
    q, v = T(qpos), T(qvel)
    kin = kinematics.fk(tm, q)
    for name in ("xpos", "xmat", "S", "com", "inertia_w"):
        assert rel_err(getattr(kin_j, name), getattr(kin, name)) < TOL, name
    assert rel_err(quats_j, kinematics.body_quats(tm, q)) < TOL
    assert rel_err(M_j, dynamics.mass_matrix(tm, kin)) < TOL
    assert rel_err(C_j, dynamics.bias_forces(tm, kin, v)) < TOL

    efc = constraints.make_efc(tm, kin, q, v)
    np.testing.assert_array_equal(efc.active.numpy(), np.asarray(efc_j.active))
    np.testing.assert_array_equal(efc.geom_floor_contact.numpy(),
                                  np.asarray(efc_j.geom_floor_contact))
    act4 = np.asarray(efc_j.active)[:, constraints.MAX_LIMITS:].reshape(B, -1, 4)[..., 0]
    for name in ("body1", "body2"):
        np.testing.assert_array_equal(
            np.where(act4, getattr(efc, name).numpy(), 0),
            np.where(act4, np.asarray(getattr(efc_j, name)), 0), err_msg=name)
    for name in ("l_J", "l_aref", "l_R", "W6", "aref", "R"):
        assert rel_err(getattr(efc_j, name), getattr(efc, name)) < TOL, name
    if kind == "contact":
        assert act4.sum() > 0


def _self_contacts_jax(jm):
    """The per-env reference (collision_pairs), env by env. Under vmap the
    JAX package reroutes to its lanes twin (collision_lanes), whose
    capsule-box routine departs from the reference on deep penetrations."""
    one = jax.jit(lambda q: jax_cp.self_contacts(jm, jax_kin.fk(jm, q)))

    def run(qpos):
        outs = [one(q) for q in qpos]
        return jax_cp.SelfContacts(*(np.stack([np.asarray(o[i]) for o in outs])
                                     for i in range(len(outs[0]))))

    return run


def _check_self_contacts(sc_j, sc):
    act = np.asarray(sc_j.active)
    np.testing.assert_array_equal(sc.active.numpy(), act)
    # the selected sets, then (float64) their order slot by slot
    for b in range(act.shape[0]):
        key = lambda b1, b2, d: sorted(zip(b1, b2, np.round(d, 9)))
        ref = key(*(np.asarray(x)[b][act[b]] for x in (sc_j.body1, sc_j.body2, sc_j.dist)))
        val = key(*(x.numpy()[b][act[b]] for x in (sc.body1, sc.body2, sc.dist)))
        assert ref == val, b
    for name in ("body1", "body2"):
        np.testing.assert_array_equal(np.where(act, getattr(sc, name).numpy(), 0),
                                      np.where(act, np.asarray(getattr(sc_j, name)), 0))
    for name in ("dist", "pos", "normal", "friction", "margin"):
        r = np.asarray(getattr(sc_j, name))
        v = getattr(sc, name).numpy()
        m = act.reshape(act.shape + (1,) * (r.ndim - 2))
        assert rel_err(np.where(m, r, 0.0), np.where(m, v, 0.0)) < TOL, name


@pytest.mark.parametrize("seed", [2, 5])
def test_self_contacts_match_wide_keeps(pair, seed):
    """conftest pins the KEEPs to 4096 (no cull): the port gets the same."""
    jm, tm = pair
    qpos, _, _ = states(jm, B, "tangled", seed=seed)
    sc_j = _self_contacts_jax(jm)(qpos)
    sc = collision_pairs.self_contacts(tm, kinematics.fk(tm, T(qpos)),
                                       keeps=(jax_cp.CC_KEEP, jax_cp.CB_KEEP, jax_cp.BB_KEEP))
    assert int(np.asarray(sc_j.active).sum()) > 2 * B
    _check_self_contacts(sc_j, sc)


def test_self_contacts_match_product_keeps(pair, monkeypatch):
    """The product operating point culls each pair family to 24/16/8."""
    jm, tm = pair
    monkeypatch.setattr(jax_cp, "CC_KEEP", 24)
    monkeypatch.setattr(jax_cp, "CB_KEEP", 16)
    monkeypatch.setattr(jax_cp, "BB_KEEP", 8)
    qpos, _, _ = states(jm, B, "tangled", seed=3)
    sc_j = _self_contacts_jax(jm)(qpos)
    sc = collision_pairs.self_contacts(tm, kinematics.fk(tm, T(qpos)), keeps=(24, 16, 8))
    _check_self_contacts(sc_j, sc)


def test_top_k_ties_and_nan():
    """First index wins ties, NaN ranks last (constraints.top_k_onehot)."""
    score = torch.tensor([[1.0, 3.0, float("nan"), 3.0, -2.0, 1.0]], dtype=torch.float64)
    vals, idx, _ = collision_pairs.top_k(score, 6)
    assert idx.tolist() == [[1, 3, 0, 5, 4, 2]]
    _, onehot = jax_con.top_k_onehot(np.asarray(score[0]), 6)
    np.testing.assert_array_equal(np.asarray(onehot).argmax(1), idx[0].numpy())
    assert vals[0, -1].item() == -collision_pairs.BIG


# ---------------------------------------------------------------------------
# Geom world frames: per-geom tables against the per-pair form
# ---------------------------------------------------------------------------

SMPLX_FILE = os.path.join(os.path.dirname(__file__), "..", "simbench", "configs",
                          "smplx_synthetic.json.gz")
PRODUCT_KEEPS = (24, 16, 8)


def _frames_model(kind, dtype, B):
    """The SMPL asset, the SMPL-X stand-in, or two bodies stacked (the SMPL
    asset and a copy with moved, turned and resized geoms) tiled over B."""
    if kind == "smplx":
        return registry.load_model(SMPLX_FILE, dtype, "cpu")
    m = registry.default_humanoid(dtype, device="cpu")
    if kind == "smpl":
        return m
    g = torch.Generator().manual_seed(4)
    quat = m.geom_quat + 0.1 * torch.randn(m.geom_quat.shape, generator=g, dtype=dtype)
    other = dataclasses.replace(
        m, geom_pos=m.geom_pos * 1.05, geom_size=m.geom_size * 1.1,
        geom_quat=quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True))
    return tile_model(stack_models([m, other]), B)


def _frames_states(model, B, seed):
    """(qpos, qvel): large joint angles (self-contacts), every other env
    lying at the floor (floor rows)."""
    rng = np.random.RandomState(seed)
    q0 = model.qpos0.reshape(-1, model.nq)[0].double().numpy()
    qpos = np.tile(q0, (B, 1))
    low = np.arange(B) % 2 == 1
    qpos[:, 2] = np.where(low, 0.15, 0.95)
    qpos[low, 3:7] = [0.7071068, 0.7071068, 0.0, 0.0]
    qpos[:, 7:] += rng.randn(B, model.nv - 6) * 0.7
    qvel = rng.randn(B, model.nv) * 0.2
    return (torch.as_tensor(x, dtype=model.dtype) for x in (qpos, qvel))


def _per_pair_world(model, kin, gidx):
    """The per-pair form: world center (B,P,3), rotation (B,P,3,3) and body
    (P,) of geoms gidx, one 3x3 product per pair side."""
    body = np.asarray(model.geom_body, np.int64)[gidx]
    Rb = kin.xmat[:, body]
    gpos = model.geom_pos[..., gidx, :].to(Rb.dtype)
    pos = kin.xpos[:, body] + (Rb @ gpos[..., None])[..., 0]
    Rg = Rb @ transforms.quat_to_matrix(model.geom_quat[..., gidx, :].to(Rb.dtype))
    return pos, Rg, body


def _per_pair_segment(model, kin, gidx):
    """The per-pair form: capsule/sphere segment ends (B,P,3) and radius."""
    pos, Rg, body = _per_pair_world(model, kin, gidx)
    size = model.geom_size[..., gidx, :].to(pos.dtype)
    is_cap = torch.as_tensor([model.geom_type[g] == GEOM_CAPSULE for g in gidx],
                             dtype=pos.dtype)
    half = (size[..., 1] * is_cap)[..., None] * Rg[..., :, 2]
    return pos - half, pos + half, size[..., 0], body


def _per_pair_self_contacts(model, kin, keeps):
    """collision_pairs.self_contacts in the per-pair form: each family
    computes both sides' frames per pair, then the same narrowphase."""
    cc_keep, cb_keep, bb_keep = keeps
    B = kin.xpos.shape[0]
    dtype = kin.xpos.dtype
    pl = collision_pairs.pair_lists(model)
    out = []
    norm, dot = collision_pairs._norm, collision_pairs._dot
    per_pair = lambda x, nd=1: torch.as_tensor(x).expand((B,) + torch.as_tensor(x).shape[-nd:])

    def cull(d_low, keep, tensors):
        _, idx, _ = collision_pairs.top_k(-d_low, keep)
        return [collision_pairs.gather_rows(x, idx) for x in tensors]

    if len(pl["cc"]):
        g1, g2 = pl["cc"][:, 0], pl["cc"][:, 1]
        p1, q1, r1, bb1 = _per_pair_segment(model, kin, g1)
        p2, q2, r2, bb2 = _per_pair_segment(model, kin, g2)
        mu, margin = collision_pairs._combine(model, g1, g2, dtype)
        r1, r2, mu, margin, bb1, bb2 = map(per_pair, (r1, r2, mu, margin, bb1, bb2))
        if len(g1) > cc_keep:
            d_low = (norm(0.5 * (p1 + q1) - 0.5 * (p2 + q2)) - 0.5 * norm(q1 - p1)
                     - 0.5 * norm(q2 - p2) - r1 - r2)
            p1, q1, p2, q2, r1, r2, mu, margin, bb1, bb2 = cull(
                d_low, cc_keep, (p1, q1, p2, q2, r1, r2, mu, margin, bb1, bb2))
        c1, c2, par = collision_pairs._seg_seg_closest(p1, q1, p2, q2)
        gap = norm(c2 - c1)
        n = (c2 - c1) / gap.clamp_min(1e-12)[..., None]
        d1, d2 = q1 - p1, q2 - p2
        far = torch.full_like(gap, collision_pairs.BIG)
        for other in (p2, q2):
            c1p = p1 + torch.clamp(dot(other - p1, d1) / dot(d1, d1).clamp_min(1e-12),
                                   0.0, 1.0)[..., None] * d1
            c2p = p2 + torch.clamp(dot(c1p - p2, d2) / dot(d2, d2).clamp_min(1e-12),
                                   0.0, 1.0)[..., None] * d2
            gg = norm(c2p - c1p)
            nn = (c2p - c1p) / gg.clamp_min(1e-12)[..., None]
            out.append((torch.where(par, gg - r1 - r2, far),
                        0.5 * (c1p + r1[..., None] * nn + c2p - r2[..., None] * nn),
                        nn, bb1, bb2, mu, margin))
        out.append((torch.where(par, far, gap - r1 - r2),
                    0.5 * (c1 + r1[..., None] * n + c2 - r2[..., None] * n),
                    n, bb1, bb2, mu, margin))
    if len(pl["cb"]):
        g1, g2 = pl["cb"][:, 0], pl["cb"][:, 1]
        p1, q1, r1, bb1 = _per_pair_segment(model, kin, g1)
        bpos, bR, bb2 = _per_pair_world(model, kin, g2)
        mu, margin = collision_pairs._combine(model, g1, g2, dtype)
        half = per_pair(model.geom_size[..., g2, :].to(dtype), 2)
        r1, mu, margin, bb1, bb2 = map(per_pair, (r1, mu, margin, bb1, bb2))
        if len(g1) > cb_keep:
            d_low = (norm(0.5 * (p1 + q1) - bpos) - 0.5 * norm(q1 - p1) - r1 - norm(half))
            p1, q1, r1, bpos, bR, half, mu, margin, bb1, bb2 = cull(
                d_low, cb_keep, (p1, q1, r1, bpos, bR, half, mu, margin, bb1, bb2))
        d, p, n = collision_pairs.capsule_box_contacts(
            collision_pairs._mtv(bR, p1 - bpos), collision_pairs._mtv(bR, q1 - bpos), half, r1)
        rep = lambda x: x.repeat_interleave(2, dim=1)
        out.append((d.reshape(B, -1), (bpos[..., None, :] + p @ bR.transpose(-1, -2))
                    .reshape(B, -1, 3), (n @ bR.transpose(-1, -2)).reshape(B, -1, 3),
                    rep(bb1), rep(bb2), rep(mu), rep(margin)))
    if len(pl["bb"]):
        g1, g2 = pl["bb"][:, 0], pl["bb"][:, 1]
        pos1, R1, bb1 = _per_pair_world(model, kin, g1)
        pos2, R2, bb2 = _per_pair_world(model, kin, g2)
        mu, margin = collision_pairs._combine(model, g1, g2, dtype)
        h1 = per_pair(model.geom_size[..., g1, :].to(dtype), 2)
        h2 = per_pair(model.geom_size[..., g2, :].to(dtype), 2)
        mu, margin, bb1, bb2 = map(per_pair, (mu, margin, bb1, bb2))
        if len(g1) > bb_keep:
            d_low = norm(pos1 - pos2) - (norm(h1) + norm(h2))
            pos1, R1, h1, pos2, R2, h2, mu, margin, bb1, bb2 = cull(
                d_low, bb_keep, (pos1, R1, h1, pos2, R2, h2, mu, margin, bb1, bb2))
        d, p, n, act = collision_pairs._box_box(pos1, R1, h1, pos2, R2, h2, margin)
        d = torch.where(act, d, torch.full_like(d, collision_pairs.BIG))
        _, i8, _ = collision_pairs.top_k(-d, 8)
        i83 = i8[..., None].expand(i8.shape + (3,))
        rep = lambda x: x.repeat_interleave(8, dim=1)
        out.append((d.gather(-1, i8).reshape(B, -1), p.gather(-2, i83).reshape(B, -1, 3),
                    n.gather(-2, i83).reshape(B, -1, 3),
                    rep(bb1), rep(bb2), rep(mu), rep(margin)))
    dist, pos, normal, b1, b2, mu, margin = (torch.cat(x, dim=1) for x in zip(*out))
    active_all = dist < margin
    sval, sel, _ = collision_pairs.top_k(
        torch.where(active_all, -dist, torch.full_like(dist, -collision_pairs.BIG)),
        collision_pairs.MAX_SELF)
    g = lambda x: collision_pairs.gather_rows(x, sel)
    return collision_pairs.SelfContacts(
        dist=g(dist), pos=g(pos), normal=g(normal), body1=g(b1), body2=g(b2),
        friction=g(mu), margin=g(margin),
        active=g(active_all) & (sval > -collision_pairs.BIG / 2))


def _per_point_floor(model, kin):
    """constraints.floor_points with one 3x3 product per point."""
    cgeom, sign, _ = constraints._candidate_meta(model.geom_type)
    dtype = kin.xpos.dtype
    cbody = np.asarray(model.geom_body, np.int64)[cgeom]
    g_size = model.geom_size.to(dtype)[..., cgeom, :]
    is_cap = torch.as_tensor([model.geom_type[g] == GEOM_CAPSULE for g in cgeom])
    size_eff = torch.cat([g_size[..., :2],
                          torch.where(is_cap, g_size[..., 1], g_size[..., 2])[..., None]], dim=-1)
    g_quat = model.geom_quat.to(dtype)[..., cgeom, :]
    offset = model.geom_pos.to(dtype)[..., cgeom, :] + transforms.quat_rotate(
        g_quat, torch.as_tensor(sign, dtype=dtype) * size_eff)
    R_b = kin.xmat[:, cbody]
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=dtype)
    return (kin.xpos[:, cbody] + (R_b @ offset[..., None])[..., 0],
            (R_b @ transforms.quat_rotate(g_quat, ez)[..., None])[..., 0])


def _bit_equal(a, b, skip=()):
    for f in dataclasses.fields(a):
        if f.name not in skip:
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert x.shape == y.shape and torch.equal(x, y), f.name


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kind", ["smpl", "smplx", "stacked"])
def test_geom_tables_match_per_pair_form(kind, dtype, monkeypatch):
    """self_contacts and make_efc on the per-geom tables against the
    per-pair form they replaced, bit for bit: every pair side's frame and
    every self contact with no cull and at the product culls (cc, cb and bb
    each present), the floor points and the whole of make_efc."""
    B = 8
    model = _frames_model(kind, dtype, B)
    qpos, qvel = _frames_states(model, B, seed=2)
    kin = kinematics.fk(model, qpos)
    frames = collision_pairs.geom_frames(model, kin)
    pl = collision_pairs.pair_lists(model)
    assert all(len(pl[k]) for k in ("cc", "cb", "bb"))
    gidx = np.arange(model.ngeom)
    pos, rot, _ = _per_pair_world(model, kin, gidx)
    seg_p, seg_q, _, _ = _per_pair_segment(model, kin, gidx)
    for name, ref in (("pos", pos), ("rot", rot), ("seg_p", seg_p), ("seg_q", seg_q)):
        assert torch.equal(getattr(frames, name), ref), name
    for fam in ("cc", "cb", "bb"):
        for g in pl[fam].T:
            p, R, _ = _per_pair_world(model, kin, g)
            assert torch.equal(frames.pos[:, g], p) and torch.equal(frames.rot[:, g], R), fam

    for keeps in ((4096, 4096, 4096), PRODUCT_KEEPS):
        sc = collision_pairs.self_contacts(model, kin, keeps)
        assert int(sc.active.sum()) > B
        _bit_equal(sc, _per_pair_self_contacts(model, kin, keeps))

    new = constraints.make_efc(model, kin, qpos, qvel, PRODUCT_KEEPS)
    assert int(new.active[:, constraints.MAX_LIMITS:4 * constraints.MAX_CONTACTS].sum()) > 0
    for x, y in zip(constraints.floor_points(model, kin), _per_point_floor(model, kin)):
        assert torch.equal(x, y)
    monkeypatch.setattr(constraints, "self_contacts",
                        lambda m, k, keeps, frames: _per_pair_self_contacts(m, k, keeps))
    monkeypatch.setattr(constraints, "floor_points", _per_point_floor)
    _bit_equal(new, constraints.make_efc(model, kin, qpos, qvel, PRODUCT_KEEPS))


class _ProductBatches(torch.overrides.TorchFunctionMode):
    """Records the batch of every matmul, bmm and einsum: the product of
    the broadcast leading dims of a matmul's operands, of an einsum's
    output dims but the last."""

    NAMES = {"matmul", "__matmul__", "__rmatmul__", "bmm", "baddbmm", "einsum"}

    def __init__(self):
        super().__init__()
        self.batches = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "")
        if name in self.NAMES:
            if name == "einsum":
                lead = out.shape[:-1]
            else:
                a, b = args[:2]
                if name == "__rmatmul__":
                    a, b = b, a
                lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2] if b.dim() > 1 else ())
            self.batches.append((name, int(np.prod(lead, dtype=np.int64))))
        return out


@pytest.mark.parametrize("kind", ["smpl", "smplx"])
def test_make_efc_products_stay_per_geom(kind):
    """At the product culls no product in make_efc has a batch above
    B * ngeom (the per-pair frames had B * pairs); the counters read the
    frames computed (ngeom) and the pair sides served (2 per pair) once
    per call under a profiler."""
    B = 8
    model = _frames_model(kind, torch.float32, B)
    qpos, qvel = _frames_states(model, B, seed=1)
    kin = kinematics.fk(model, qpos)
    mode = _ProductBatches()
    with mode:
        constraints.make_efc(model, kin, qpos, qvel, PRODUCT_KEEPS)
    assert mode.batches and max(n for _, n in mode.batches) <= B * model.ngeom, mode.batches
    pl = collision_pairs.pair_lists(model)
    profiler.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        constraints.make_efc(model, kin, qpos, qvel, PRODUCT_KEEPS)
    counts = profiler.counters()
    profiler.clear()
    assert counts["rows.geom_frames"] == model.ngeom
    assert counts["rows.pair_sides"] == 2 * sum(len(pl[k]) for k in ("cc", "cb", "bb"))
