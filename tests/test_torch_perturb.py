"""PyTorch port: body velocities, observation v2, the PD/PID laws, external
forces and the projectile spheres against the JAX package, and the
projectiles' formula checks of tests/test_projectiles.py.

  * kinematics.body_velocities, envs/obs.py::compute_self_obs_v2,
    dynamics.external_forces (with and without torques), the SimplePID law
    (three calls from an unprimed state, the four P/D-on-measurement
    settings, an integral gain large enough to hit the anti-windup clamp)
    and the PIDController law against the JAX functions, vmapped;
  * make_efc(spheres=): the projectile slots (rows, R, reference, active
    flags, bodies, proj_sphere) of three envs with two spheres each, one
    env's spheres out of reach, against jax.vmap(constraints.make_efc);
  * control_step with ext_force, with proj and with both against
    jax.vmap(engine.control_step) with both hooks (one compile; a case
    without a hook gives JAX a zero force or spheres out of reach, which
    change no bit), 3 substeps, two control steps chained through the
    cache and the spheres' state;
  * the reference loop with ext_force under forward AD (a tangent on qvel
    and on the force) against jax.jvp of the per-env control step;
  * the formula checks: a ball thrown at the standing humanoid shoves it
    and bounces off, and the batched spine with spheres equals the per-env
    reference loop.

Tolerance: float64, |ref - val| / (1 + |ref|) <= 1e-9, integer and bool
channels exact; float32 at 5e-3 for body_velocities and obs v2.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

from smplsim_tpu.envs import obs as jax_obs
from smplsim_tpu.ops import qp_kernel as jax_qp
from smplsim_tpu.physics import collision_pairs as jax_cp
from smplsim_tpu.physics import constraints as jax_con
from smplsim_tpu.physics import control as jax_control
from smplsim_tpu.physics import dynamics as jax_dyn
from smplsim_tpu.physics import engine as jax_engine
from smplsim_tpu.physics import kinematics as jax_kin
from smplsim_tpu.physics import solver as jax_solver
from smplsim_tpu_torch.envs import obs
from smplsim_tpu_torch.physics import (collision_pairs, constraints, control, dynamics,
                                       engine, kinematics, substep)
from tests._torch_port import T, TORCH_DTYPE, models, rel_err, states

TOL = 1e-9
B = 3
CFI = 3
KNOBS = dict(qp_iters=jax_qp.NEWTON_ITERS, qp_rows=jax_solver.COMPACT_ROWS,
             qp_tol=jax_qp._tol_for(jnp.float64),
             keeps=(jax_cp.CC_KEEP, jax_cp.CB_KEEP, jax_cp.BB_KEEP))


def _spheres(tm, qpos, seed=0):
    """(pos (B,2,3), vel, radius (B,2), inverse mass) numpy: per env one
    sphere overlapping the pelvis box and one the left knee capsule, moving
    at them; env 2's first sphere out of reach."""
    rng = np.random.RandomState(seed)
    kin = kinematics.fk(tm, T(qpos))
    gpos = collision_pairs.geom_frames(tm, kin).pos.numpy()
    pos = np.stack([gpos[:, 0], gpos[:, 2]], 1) + [[0.2, 0.0, 0.0], [0.15, 0.0, 0.0]]
    pos[2, 0] = [50.0, 0.0, 1.0]
    vel = np.stack([[-6.0, 0.0, 0.0], [-4.0, 0.5, 0.0]])[None] + rng.randn(len(qpos), 2, 3)
    return pos, vel, np.full((len(qpos), 2), 0.12), np.full((len(qpos), 2), 0.5)


@pytest.mark.parametrize("dtype,tol", [(jnp.float64, TOL), (jnp.float32, 5e-3)],
                         ids=["f64", "f32"])
def test_body_velocities_and_obs_v2_match_jax(dtype, tol):
    jm, tm = models(dtype)
    tdt = TORCH_DTYPE[dtype]
    qpos, qvel, _ = states(jm, B, "tangled", seed=2)

    def ref(q, v):
        kin = jax_kin.fk(jm, q)
        lin, ang = jax_kin.body_velocities(jm, kin, v)
        rot = jax_kin.body_quats(jm, q)
        return lin, ang, jax_obs.compute_self_obs_v2(kin.xpos, rot, lin, ang, False, True, "smpl")

    lin_j, ang_j, obs_j = jax.jit(jax.vmap(ref))(jnp.asarray(qpos, dtype), jnp.asarray(qvel, dtype))
    q, v = T(qpos, tdt), T(qvel, tdt)
    kin = kinematics.fk(tm, q)
    lin, ang = kinematics.body_velocities(tm, kin, v)
    o = obs.compute_self_obs_v2(kin.xpos, kinematics.body_quats(tm, q), lin, ang, False, True)
    assert o.shape == (B, obs.self_obs_size(tm.nbody, 2, True))
    for name, r, x in (("lin", lin_j, lin), ("ang", ang_j, ang), ("obs", obs_j, o)):
        assert rel_err(r, x) < tol, (name, rel_err(r, x))
    for v_, rh, shape in ((1, True, False), (2, False, True)):
        assert obs.self_obs_size(24, v_, rh, shape) == jax_obs.self_obs_size(24, v_, rh, shape)


def test_external_forces_match_jax():
    jm, tm = models()
    qpos, _, _ = states(jm, B, "tangled", seed=3)
    rng = np.random.RandomState(3)
    force, torque = rng.randn(2, B, jm.nbody, 3) * 50.0
    ref = jax.jit(jax.vmap(lambda q, f, t: (
        jax_dyn.external_forces(jm, jax_kin.fk(jm, q), f),
        jax_dyn.external_forces(jm, jax_kin.fk(jm, q), f, t))))(
        jnp.asarray(qpos), jnp.asarray(force), jnp.asarray(torque))
    kin = kinematics.fk(tm, T(qpos))
    out = (dynamics.external_forces(tm, kin, T(force)),
           dynamics.external_forces(tm, kin, T(force), T(torque)))
    for r, x in zip(ref, out):
        assert x.shape == (B, tm.nv) and rel_err(r, x) < TOL, rel_err(r, x)
    # a pure vertical push on the root: the free joint takes it all
    f = torch.zeros(B, tm.nbody, 3, dtype=torch.float64)
    f[:, 0, 2] = 10.0
    g = dynamics.external_forces(tm, kin, f)
    assert torch.allclose(g[:, 2], torch.full((B,), 10.0, dtype=torch.float64))
    assert float(g[:, 6:].abs().max()) < 1e-12


@pytest.mark.parametrize("pom,dom", [(False, False), (True, False), (False, True),
                                     (True, True)])
def test_pid_laws_match_jax(pom, dom):
    jm, tm = models()
    qpos, qvel, act = states(jm, B, "air", seed=4)
    rng = np.random.RandomState(4)
    jki = np.abs(rng.randn(jm.nu)) * 1e8     # saturates the integral clamp

    def law(st, q, a, ki):
        return jax_control.simple_pid_torque(jm, st, q, a, ki, pom, dom)

    vlaw = jax.jit(jax.vmap(law, in_axes=(0, 0, 0, None)))
    st_j = jax.vmap(lambda _: jax_control.simple_pid_init(jm.nu, jnp.float64))(jnp.arange(B))
    st_t = control.simple_pid_init(tm, B)
    assert not st_t.primed.any()
    for k in range(3):
        q = qpos + 0.01 * k * rng.randn(*qpos.shape)
        a = act * (1.0 - 0.3 * k)
        tau_j, st_j = vlaw(st_j, jnp.asarray(q), jnp.asarray(a), jnp.asarray(jki))
        tau, st_t = control.simple_pid_torque(tm, st_t, T(q), T(a), T(jki), pom, dom)
        assert rel_err(tau_j, tau) < TOL, (k, rel_err(tau_j, tau))
        for name, r, x in zip(st_j._fields, st_j, st_t):
            if name == "primed":
                assert x.tolist() == np.asarray(r).tolist()
            else:
                assert rel_err(r, x) < TOL, (k, name)
    lim = tm.torque_lim
    assert float((st_t.integral.abs() == lim).double().mean()) > 0.9   # clamped
    # PIDController
    integral = rng.randn(B, jm.nu) * 100.0
    target = T(act)
    ref = jax.jit(jax.vmap(lambda q, v, t, i: jax_control.pid_torque(jm, q, v, t, i)))(
        jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(act), jnp.asarray(integral))
    out = control.pid_torque(tm, T(qpos), T(qvel), target, T(integral))
    for r, x in zip(ref, out):
        assert rel_err(r, x) < TOL


def test_stable_pd_gain_scales_match_jax():
    """kp_scale and kd_scale in the per-env form and in the spine's
    (Kernel A's shift becomes dt kd kd_scale)."""
    jm, tm = models()
    qpos, qvel, act = states(jm, B, "air", seed=8)
    q, v = T(qpos), T(qvel)
    M, C = engine.pd_cache(tm, engine.PhysicsState(q, v))
    tgt = control.pd_target_from_action(tm, T(act))
    ref = jax.jit(jax.vmap(lambda M_, C_, q_, v_, t_: jax_control.stable_pd_torque(
        jm, M_, C_, q_, v_, t_, 0.7, 1.6)))(*(jnp.asarray(x.numpy()) for x in (M, C, q, v, tgt)))
    for fn in (control.stable_pd_torque, control.stable_pd_torque_ref):
        tau = fn(tm, M, C, q, v, tgt, 0.7, 1.6)
        assert rel_err(ref, tau) < TOL, (fn.__name__, rel_err(ref, tau))
    assert not torch.equal(control.stable_pd_torque(tm, M, C, q, v, tgt), tau)


def test_make_efc_sphere_rows_match_jax():
    jm, tm = models()
    qpos, qvel, _ = states(jm, B, "air", seed=9)
    sph = _spheres(tm, qpos, seed=9)

    def ref(q, v, *s):
        e = jax_con.make_efc(jm, jax_kin.fk(jm, q), q, v, s)
        P = jax_con.MAX_PROJC
        return (e.W6[-P:], e.aref[-P:], e.R[-P:], e.active[-4 * P:], e.body1[-P:],
                e.body2[-P:], e.proj_sphere)

    out_j = jax.jit(jax.vmap(ref))(*(jnp.asarray(x) for x in (qpos, qvel) + sph))
    kin = kinematics.fk(tm, T(qpos))
    e = constraints.make_efc(tm, kin, T(qpos), T(qvel), KNOBS["keeps"],
                             tuple(T(x) for x in sph))
    P = constraints.MAX_PROJC
    out = (e.W6[:, -P:], e.aref[:, -P:], e.R[:, -P:], e.active[:, -4 * P:], e.body1[:, -P:],
           e.body2[:, -P:], e.proj_sphere)
    names = ("W6", "aref", "R", "active", "body1", "body2", "proj_sphere")
    for name, r, x in zip(names, out_j, out):
        if name in ("active", "body1", "body2", "proj_sphere"):
            np.testing.assert_array_equal(x.numpy(), np.asarray(r), err_msg=name)
        else:
            assert rel_err(r, x) < TOL, (name, rel_err(r, x))
    ps = e.proj_sphere
    # every env touches something; env 2 only with its second sphere; an
    # inactive slot names no sphere and has no rows
    assert (ps >= 0).any(1).all() and not (ps[2] == 0).any()
    assert (ps == -1).any() and torch.equal(e.active[:, -4 * P:].reshape(B, P, 4).all(-1), ps >= 0)
    assert (e.W6[:, -P:][ps < 0] == 0).all() and (e.body1[:, -P:] == -1).all()


@functools.lru_cache(maxsize=None)
def _jax_step():
    """jit(vmap) of the JAX control step with both hooks: the one compile of
    the chained cases."""
    jm, _ = models()

    def step(q, v, M, C, fw, a, ext, pp, pv, pr, pi):
        st, info, power, cache, (pp2, pv2) = jax_engine.control_step(
            jm, jax_engine.PhysicsState(q, v), a, control_freq_inv=CFI, cache=(M, C, fw),
            ext_force=ext, proj=(pp, pv, pr, pi))
        return (st.qpos, st.qvel, power, info.nactive_max, info.stalled_any,
                info.geom_floor_contact) + tuple(cache) + (pp2, pv2)

    return jax.jit(jax.vmap(step))


@pytest.mark.parametrize("hooks", ["ext_force", "proj", "both"])
def test_control_step_hooks_match_jax(hooks):
    jm, tm = models()
    qpos, qvel, act = states(jm, B, "air", seed=10)
    act = 0.3 * act
    pos, vel, rad, inv = _spheres(tm, qpos, seed=10)
    if hooks == "ext_force":
        pos[:, :, 0] += 100.0      # out of reach: the same physics as no spheres
    force = np.random.RandomState(10).randn(B, jm.nbody, 3) * 30.0
    force[:, 0] = [50.0, -20.0, 0.0]
    if hooks == "proj":
        force[:] = 0.0
    st = engine.PhysicsState(T(qpos), T(qvel))
    cache = engine.pd_cache(tm, st) + (torch.zeros(B, constraints.NEFC, dtype=torch.float64),)
    carry_j = (qpos, qvel) + tuple(x.numpy() for x in cache)
    sph_j = (pos, vel)
    sph = (T(pos), T(vel))
    names = ["qpos", "qvel", "power", "nact", "stall", "gfc", "M", "C", "fw"]
    for k in range(2):
        out_j = _jax_step()(*(jnp.asarray(x) for x in carry_j + (act, force) + sph_j
                              + (rad, inv)))
        kw = dict(ext_force=None if hooks == "proj" else T(force),
                  proj=None if hooks == "ext_force" else sph + (T(rad), T(inv)))
        res = engine.control_step(tm, st, T(act), control_freq_inv=CFI, cache=cache, **KNOBS,
                                  **kw)
        assert len(res) == (4 if hooks == "ext_force" else 5)
        st, info, power, cache = res[:4]
        out = (st.qpos, st.qvel, power, info.nactive_max, info.stalled_any,
               info.geom_floor_contact) + tuple(cache)
        for name, r, x in zip(names, out_j, out):
            if name in ("nact", "stall", "gfc"):
                np.testing.assert_array_equal(x.numpy(), np.asarray(r), err_msg=name)
            else:
                assert rel_err(r, x) < TOL, (hooks, k, name, rel_err(r, x))
        if hooks != "ext_force":
            sph = res[4]
            for name, r, x in zip(("pos", "vel"), out_j[9:], sph):
                assert rel_err(r, x) < TOL, (hooks, k, name, rel_err(r, x))
        carry_j = tuple(np.asarray(x) for x in out_j[:2] + out_j[6:9])
        sph_j = tuple(np.asarray(x) for x in out_j[9:])
    if hooks != "ext_force":
        # the spheres met the humanoid: they were slowed or turned back
        assert float((sph[1][:2, :, 0] - T(vel)[:2, :, 0]).max()) > 0.5


@functools.lru_cache(maxsize=None)
def _jax_jvp():
    jm, _ = models()

    def dyn(q, v, a, ext):
        st, _, _, _ = jax_engine.control_step(jm, jax_engine.PhysicsState(q, v), a,
                                              control_freq_inv=2, ext_force=ext)
        return st.qpos, st.qvel

    return jax.jit(jax.vmap(lambda q, v, a, e, dv, de: jax.jvp(
        lambda v_, e_: dyn(q, v_, a, e_), (v, e), (dv, de))))


def test_reference_loop_ext_force_jvp_matches_jax():
    """The uhc_pd step under forward AD (the per-env reference loop) with a
    tangent on qvel and on ext_force, an air and a contact state."""
    jm, tm = models()
    (qa, va, aa), (qc, vc, ac) = (states(jm, 1, kind, seed=12) for kind in ("air", "contact"))
    q, v, a = np.concatenate([qa, qc]), np.concatenate([va, vc]), 0.1 * np.concatenate([aa, ac])
    rng = np.random.RandomState(12)
    ext, dv, de = rng.randn(2, jm.nbody, 3) * 40.0, rng.randn(2, jm.nv), rng.randn(2, jm.nbody, 3)
    (qj, vj), (dqj, dvj) = _jax_jvp()(*(jnp.asarray(x) for x in (q, v, a, ext, dv, de)))
    with forward_ad.dual_level():
        st = engine.PhysicsState(T(q), forward_ad.make_dual(T(v), T(dv)))
        out = engine.control_step(tm, st, T(a), control_freq_inv=2,
                                  ext_force=forward_ad.make_dual(T(ext), T(de)), **KNOBS)[0]
        pq, pv = forward_ad.unpack_dual(out.qpos), forward_ad.unpack_dual(out.qvel)
    for name, r, x in (("qpos", qj, pq.primal), ("qvel", vj, pv.primal),
                       ("dqpos", dqj, pq.tangent), ("dqvel", dvj, pv.tangent)):
        assert rel_err(r, x) < TOL, (name, rel_err(r, x))
    # the force's tangent moves the state
    assert float(pv.tangent.abs().max()) > 1e-3


def test_thrown_ball_shoves_humanoid_and_bounces():
    """tests/test_projectiles.py's check on the port: one ball (radius 0.12,
    inverse mass 0.5) from (1.2, -0.2, 0.85) at -10 m/s against a ball at
    rest at the same place, 25 control steps of 5 substeps, in one batch."""
    _, tm = models()
    q = tm.qpos0[None].repeat(2, 1)
    q[:, 2] = 0.92
    st = engine.PhysicsState(q, torch.zeros(2, tm.nv, dtype=torch.float64))
    cache = engine.pd_cache(tm, st) + (torch.zeros(2, constraints.NEFC, dtype=torch.float64),)
    pp = torch.tensor([[[1.2, -0.2, 0.85]]] * 2, dtype=torch.float64)
    pv = torch.tensor([[[-10.0, 0.0, 0.0]], [[0.0, 0.0, 0.0]]], dtype=torch.float64)
    rad = torch.full((2, 1), 0.12, dtype=torch.float64)
    inv = torch.full((2, 1), 0.5, dtype=torch.float64)
    act = torch.zeros(2, tm.nu, dtype=torch.float64)
    for _ in range(25):
        st, _, _, cache, (pp, pv) = engine.control_step(tm, st, act, control_freq_inv=5,
                                                        cache=cache, proj=(pp, pv, rad, inv))
    assert bool(torch.isfinite(st.qpos).all())
    # the ball does not pass through: its x-velocity reversed or damped
    assert float(pv[0, 0, 0]) > -9.0, float(pv[0, 0, 0])
    # the humanoid is shoved along the throw (-x) against the undisturbed run
    assert float(st.qpos[0, 0]) < float(st.qpos[1, 0]) - 0.05, st.qpos[:, 0]


def test_projectile_spine_matches_per_env_reference_loop():
    """The batched spine with spheres (fused factor+solve) against the
    per-env reference loop (Gram form), one env at a time: they agree to
    rounding, as JAX's lanes loop and its per-env loop do."""
    jm, tm = models()
    rng = np.random.RandomState(0)
    qpos = np.tile(np.asarray(jm.qpos0), (B, 1))
    qpos[:, 2] = 0.92
    qvel = rng.randn(B, jm.nv) * 0.1
    ppos = np.asarray([[[1.2, -0.2, 0.85]], [[0.9, 0.0, 0.9]], [[-0.8, 0.1, 0.8]]])
    pvel = np.asarray([[[-9.0, 0, 0]], [[-7.0, 0.5, 0]], [[8.0, 0, 0.5]]])
    ppos[:, 0, 0] -= 0.6 * np.sign(ppos[:, 0, 0])     # within reach in 4 substeps
    act = T(rng.uniform(-0.3, 0.3, (B, jm.nu)))
    rad, inv = T(np.full((B, 1), 0.12)), T(np.full((B, 1), 0.5))
    st = engine.PhysicsState(T(qpos), T(qvel))
    out = engine.control_step(tm, st, act, control_freq_inv=4, **KNOBS,
                              proj=(T(ppos), T(pvel), rad, inv))
    ref_ref = engine.reset_reference(tm)
    f0 = torch.zeros(1, constraints.NEFC, dtype=torch.float64)
    for i in range(B):
        s = slice(i, i + 1)
        st_i = engine.PhysicsState(st.qpos[s], st.qvel[s])
        r = substep.control_loop(tm, st_i.qpos, st_i.qvel, *engine.pd_cache(tm, st_i), f0,
                                 control.pd_target_from_action(tm, act[s]), ref_ref, 4,
                                 KNOBS["qp_iters"], KNOBS["qp_rows"], KNOBS["qp_tol"],
                                 KNOBS["keeps"], reference=True,
                                 proj=(T(ppos)[s], T(pvel)[s], rad[s], inv[s]))
        for name, x, y in (("qpos", r[0], out[0].qpos[s]), ("qvel", r[1], out[0].qvel[s]),
                           ("power", r[5], out[2][s]), ("ppos", r[9][0], out[4][0][s]),
                           ("pvel", r[9][1], out[4][1][s])):
            assert rel_err(x.numpy(), y) < TOL, (name, i, rel_err(x.numpy(), y))
    # the spheres hit: their velocities changed beyond gravity's
    dv = (out[4][1] - T(pvel)).abs()
    assert float(dv[..., :2].max()) > 0.1
