"""PyTorch port: the articulated-body solve (physics/aba.py) and its route in
the batched control loop against the JAX package.

  * aba_levels equal;
  * mass_solve on tests/test_aba.py's cases (seeds 0 and 3, m = 1 and 33,
    with the stable-PD diagonal shift): float64 against JAX's mass_solve at
    1e-9 x scale, float32 against the float64 dense answer at 2e-4 x scale,
    as tests/test_aba.py holds the JAX package's;
  * a stacked model of two β bodies against per-body JAX solves;
  * the route of control_loop in float32 against
    jax.vmap(engine.control_step), both with SMPLSIM_ABA=1 (the JAX package
    takes it then, as when the variable is unset), 5e-3 over 2 control
    steps from the air (no deep capsule-box contacts: there JAX's lanes
    routine departs from its per-env one, ROADMAP.md §3);
  * the route's algebra in float64 against the dense route at 1e-9 where
    both QPs converge, in the air, at the floor and with both perturbation
    hooks (float64 never takes it by the switch: the test turns it on);
  * chol_solve calls per control step: 1 on the route, 30 on the dense one.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smplsim_tpu.body_model import SMPLParser as JaxParser
from smplsim_tpu.models import builder as jax_builder
from smplsim_tpu.physics import aba as jax_aba
from smplsim_tpu.physics import dynamics as jax_dynamics
from smplsim_tpu.physics import engine as jax_engine
from smplsim_tpu.physics import kinematics as jax_kin
from smplsim_tpu.physics import topology as jax_topology
from smplsim_tpu_torch.body_model import SMPLParser
from smplsim_tpu_torch.models import builder, stack_models
from smplsim_tpu_torch.ops import linalg
from smplsim_tpu_torch.physics import aba, dynamics, engine, kinematics, substep, topology
from tests._torch_port import T, TORCH_DTYPE, models, rel_err, states
from tests._torch_synthetic_body import make_synthetic_body

CFI = 3


def _case(jm, seed):
    """qpos of tests/test_aba.py::_case."""
    rng = np.random.RandomState(seed)
    qpos = np.asarray(jm.qpos0, np.float64).copy()
    qpos[:3] += rng.randn(3) * 0.5
    quat = rng.randn(4)
    qpos[3:7] = quat / np.linalg.norm(quat)
    qpos[7:] += rng.randn(jm.nv - 6) * 0.4
    return qpos


def _rhs(nv, seed, m):
    rng = np.random.RandomState(seed + 100)
    rhs = rng.randn(nv, m) * 50.0
    extra = np.concatenate([np.zeros(6), rng.rand(nv - 6) * 2.0])
    return rhs, extra


def _port_solve(tm, qpos, rhs, extra, dtype):
    kin = kinematics.fk(tm, T(qpos[None], dtype))
    return aba.mass_solve(tm.parents, kin.S, kin.com, kin.inertia_w, kin.xpos, tm.body_mass,
                          tm.armature + T(extra[None], dtype), T(rhs[None], dtype))[0]


def test_aba_levels_equal():
    jm, tm = models()
    for parents in (tm.parents, (-1, 0, 1, 0, 3, 4, 1, 6, 2)):
        lj, pj = jax_topology.aba_levels(tuple(parents))
        lt, pt = topology.aba_levels(tuple(parents))
        assert len(lj) == len(lt) and all(np.array_equal(a, b) for a, b in zip(lj, lt))
        np.testing.assert_array_equal(pj, pt)


@pytest.mark.parametrize("m", [1, 33])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("dtype,tol", [(jnp.float64, 1e-9), (jnp.float32, 2e-4)],
                         ids=["f64", "f32"])
def test_mass_solve_matches_jax(dtype, tol, seed, m):
    jm, tm = models(dtype)
    jm64, tm64 = models(jnp.float64)
    qpos = _case(jm, seed)
    rhs, extra = _rhs(jm.nv, seed, m)
    got = _port_solve(tm, qpos, rhs, extra, TORCH_DTYPE[dtype])
    assert got.dtype == TORCH_DTYPE[dtype]
    if dtype == jnp.float64:
        kin = jax_kin.fk(jm, jnp.asarray(qpos))
        ref = np.asarray(jax.jit(lambda S, c, iw, xp, d, r: jax_aba.mass_solve(
            jm.parents, S, c, iw, xp, jm.body_mass, d, r))(
            kin.S, kin.com, kin.inertia_w, kin.xpos, jm.armature + extra, jnp.asarray(rhs)))
    else:
        # float32 against the float64 dense answer, as tests/test_aba.py
        kin = jax_kin.fk(jm64, jnp.asarray(qpos))
        M = np.asarray(jax_dynamics.mass_matrix(jm64, kin)) + np.diag(extra)
        ref = np.linalg.solve(M, rhs)
    scale = np.abs(ref).max()
    assert np.abs(got.double().numpy() - ref).max() <= tol * scale
    # the port's float64 elimination is the dense solve with its own CRBA M
    if dtype == jnp.float64:
        kin_t = kinematics.fk(tm, T(qpos[None]))
        dense = torch.linalg.solve(dynamics.mass_matrix(tm, kin_t)[0] + torch.diag(T(extra)),
                                   T(rhs))
        assert (got - dense).abs().max() <= 1e-9 * scale


def test_stacked_model_matches_per_body_jax():
    d = make_synthetic_body(np.random.RandomState(0), "smpl")
    rng = np.random.RandomState(5)
    betas = [rng.randn(1, 10) * 0.8 for _ in range(2)]
    jms = [jax_builder.build_robot_model(JaxParser(data=d), betas=jnp.asarray(b),
                                         dtype=jnp.float64)[0] for b in betas]
    tms = [builder.build_robot_model(SMPLParser(data=d), betas=b, dtype=torch.float64,
                                     device="cpu")[0] for b in betas]
    sm = stack_models(tms)
    qs = np.stack([_case(jms[0], s) for s in (1, 2)])
    rhs = np.stack([_rhs(jms[0].nv, s, 7)[0] for s in (1, 2)])
    extra = np.stack([_rhs(jms[0].nv, s, 7)[1] for s in (1, 2)])
    kin = kinematics.fk(sm, T(qs))
    got = aba.mass_solve(sm.parents, kin.S, kin.com, kin.inertia_w, kin.xpos, sm.body_mass,
                         sm.armature + T(extra), T(rhs))
    for i, jm in enumerate(jms):
        k = jax_kin.fk(jm, jnp.asarray(qs[i]))
        ref = np.asarray(jax_aba.mass_solve(jm.parents, k.S, k.com, k.inertia_w, k.xpos,
                                            jm.body_mass, jm.armature + extra[i], rhs[i]))
        assert np.abs(got[i].numpy() - ref).max() <= 1e-9 * np.abs(ref).max()
    # each row solved with its own body
    assert float((tms[0].body_mass - tms[1].body_mass).abs().max()) > 1e-3


@functools.lru_cache(maxsize=None)
def _jax_step32():
    jm, _ = models(jnp.float32)

    def step(q, v, M, C, fw, a):
        st, info, power, cache = jax_engine.control_step(
            jm, jax_engine.PhysicsState(q, v), a, control_freq_inv=CFI, cache=(M, C, fw))
        return (st.qpos, st.qvel, power) + tuple(cache)

    return jax.jit(jax.vmap(step))


def test_aba_route_float32_matches_jax(monkeypatch):
    # both packages read it: JAX when the step is traced, the port per call
    monkeypatch.setenv("SMPLSIM_ABA", "1")
    jm, tm = models(jnp.float32)
    qpos, qvel, act = states(jm, 4, "air", seed=11)
    st = engine.PhysicsState(T(qpos, torch.float32), T(qvel, torch.float32))
    cache = engine.pd_cache(tm, st) + (torch.zeros(4, engine.constraints.NEFC),)
    carry_j = (jnp.asarray(st.qpos.numpy()), jnp.asarray(st.qvel.numpy())) + tuple(
        jnp.asarray(x.numpy()) for x in cache)
    step = _jax_step32()
    names = ["qpos", "qvel", "power", "M", "C", "fw"]
    for k in range(2):
        a = act * (1.0 - 0.5 * k)
        out_j = step(*carry_j, jnp.asarray(a, jnp.float32))
        st, info, power, cache = engine.control_step(tm, st, T(a, torch.float32),
                                                     control_freq_inv=CFI, cache=cache)
        for name, r, v in zip(names, out_j, (st.qpos, st.qvel, power) + tuple(cache)):
            assert v.dtype == torch.float32 and rel_err(r, v) < 5e-3, (k, name, rel_err(r, v))
        carry_j = (out_j[0], out_j[1]) + tuple(out_j[3:])


@pytest.mark.parametrize("kind", ["air", "contact", "hooks"])
def test_aba_route_float64_matches_dense(monkeypatch, kind):
    """With "hooks": a 50 N push on the root and a ball thrown at each env,
    the route carrying both as the dense one does."""
    _, tm = models()
    qpos, qvel, act = states(tm, 4, "air" if kind == "hooks" else kind, seed=3)
    st0 = engine.PhysicsState(T(qpos), T(qvel))
    hooks = {}
    if kind == "hooks":
        push = torch.zeros(4, tm.nbody, 3, dtype=torch.float64)
        push[:, 0, 0] = 50.0
        ball = (st0.qpos[:, None, :3] + torch.tensor([0.25, 0.0, 0.0], dtype=torch.float64),
                torch.tensor([[[-10.0, 0.0, 0.0]]] * 4, dtype=torch.float64),
                torch.full((4, 1), 0.12, dtype=torch.float64),
                torch.full((4, 1), 0.5, dtype=torch.float64))
        hooks = dict(ext_force=push, proj=ball)
    outs = []
    for route in (False, True):
        monkeypatch.setattr(substep, "_aba_enabled", lambda dtype, on=route: on)
        st, cache = st0, None
        for k in range(2):
            st, info, power, cache = engine.control_step(tm, st, T(act) * (1.0 - 0.5 * k),
                                                         control_freq_inv=CFI, cache=cache,
                                                         **hooks)[:4]
            outs.append((st.qpos, st.qvel, power) + tuple(cache) + (info.stalled_any,))
    dense, route = outs[:2], outs[2:]
    for d, r in zip(dense, route):
        conv = ~(d[-1] | r[-1])
        assert int(conv.sum()) >= 2
        for x, y in zip(d[:-1], r[:-1]):
            assert rel_err(x[conv].numpy(), y[conv]) < 1e-9


@pytest.mark.parametrize("dtype,flag,per_step", [
    (torch.float32, "1", 1), (torch.float32, "0", 30), (torch.float32, None, 30),
    (torch.float64, "1", 30)], ids=["f32-aba", "f32-dense", "f32-default", "f64-aba-flag"])
def test_chol_solve_calls_per_control_step(monkeypatch, dtype, flag, per_step):
    if flag is None:
        monkeypatch.delenv("SMPLSIM_ABA", raising=False)
    else:
        monkeypatch.setenv("SMPLSIM_ABA", flag)
    calls = []
    real = linalg.chol_solve

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(linalg, "chol_solve", counted)
    _, tm = models(jnp.float64 if dtype == torch.float64 else jnp.float32)
    qpos, qvel, act = states(tm, 2, "air", seed=1)
    st = engine.PhysicsState(T(qpos, dtype), T(qvel, dtype))
    cache = engine.pd_cache(tm, st)
    for _ in range(2):
        st, _, _, cache = engine.control_step(tm, st, T(act, dtype) * 0.5, cache=cache)
    assert len(calls) == 2 * per_step
    assert torch.isfinite(st.qpos).all() and cache[0].shape == (2, tm.nv, tm.nv)
