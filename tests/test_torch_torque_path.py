"""PyTorch port: the torque- and direct-control physics against the JAX
package's vmapped per-env composition on the CPU.

  * engine.control_step in "torque" and "default" mode vs the vmapped JAX
    control_step, two control steps of 3 substeps each, the second from the
    first's state;
  * HumanoidSpeed(SpeedConfig(control_mode="torque")): reset, then two
    step_autoreset vs the vmapped JAX env from the same injected state.

States come from tests/_torch_port.py ("air" and "contact"): under vmap the
JAX package reroutes self-contacts to its lanes twin, which departs from the
per-env reference on deep penetrations (ROADMAP §3), and these states stay
clear of that. The torque limits are 500-1000 Nm and the env's power_scale
is 10, so a full-scale random action throws the body about within one
control step (|qvel| in the thousands) and the closed loop turns chaotic:
the comparisons use actions of 3% of full scale (1% in the env over its 15
substeps), where the two packages agree to rounding over two control steps.

Tolerances, relative (|ref - val| / (1 + |ref|)): float64 at 1e-9, the bar
of tests/test_substep_lanes.py, with integer and bool channels exact;
float32 at 5e-3 in the air at half those actions, kept to two control
steps.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smplsim_tpu.envs import tasks as jax_tasks
from smplsim_tpu.physics import control as jax_control
from smplsim_tpu.physics import engine as jax_engine
from smplsim_tpu_torch.envs import HumanoidSpeed, SpeedConfig, SpeedTask
from smplsim_tpu_torch.envs.base import EnvState
from smplsim_tpu_torch.ops import linalg, qp
from smplsim_tpu_torch.physics import control, engine, kinematics
from tests._torch_port import T, TORCH_DTYPE, models, rel_err, states

B = 4
CFI = 3
TOLS = {jnp.float64: 1e-9, jnp.float32: 5e-3}


def _check(names, ref, val, tol):
    for name, r, v in zip(names, ref, val):
        assert v.shape == r.shape and v.device.type == "cpu", name
        if np.asarray(r).dtype.kind in "biu":
            np.testing.assert_array_equal(v.numpy(), np.asarray(r), err_msg=name)
        else:
            assert rel_err(r, v) < tol, (name, rel_err(r, v))


@functools.lru_cache(maxsize=None)
def _jax_control_step(mode, dtype, power_scale):
    jm, _ = models(dtype)

    def one(q, v, a):
        st, info, power, cache = jax_engine.control_step(
            jm, jax_engine.PhysicsState(q, v), a, control_freq_inv=CFI,
            control_mode=mode, power_scale=power_scale)
        assert cache is None
        return (st.qpos, st.qvel, power, info.nactive_max, info.stalled_any,
                info.geom_floor_contact)

    return jax.jit(jax.vmap(one))


@pytest.mark.parametrize("mode,dtype,kind", [
    ("torque", jnp.float64, "air"),
    ("torque", jnp.float64, "contact"),
    ("default", jnp.float64, "contact"),
    ("torque", jnp.float32, "air"),
], ids=["torque-f64-air", "torque-f64-contact", "default-f64-contact", "torque-f32-air"])
def test_control_step_matches_jax(mode, dtype, kind):
    jm, tm = models(dtype)
    tdt, tol = TORCH_DTYPE[dtype], TOLS[dtype]
    qpos, qvel, act = states(jm, B, kind, seed=13)
    power_scale = 10.0 if mode == "torque" else 1.0
    act = 0.03 * act
    if mode == "default":
        act = act * power_scale * np.asarray(jm.torque_lim)     # joint torques
    step_j = _jax_control_step(mode, dtype, power_scale)
    J = lambda x: jnp.asarray(x, dtype)
    q_j, v_j = J(qpos), J(qvel)
    state = engine.PhysicsState(T(qpos, tdt), T(qvel, tdt))
    names = ["qpos", "qvel", "power", "nact", "stall", "gfc"]
    for k in range(2):
        a = act * 0.5 ** (k + (dtype == jnp.float32))
        out_j = step_j(q_j, v_j, J(a))
        state, info, power, cache = engine.control_step(
            tm, state, T(a, tdt), control_freq_inv=CFI, control_mode=mode,
            power_scale=power_scale)
        assert cache is None
        out = (state.qpos, state.qvel, power, info.nactive_max, info.stalled_any,
               info.geom_floor_contact)
        _check(names, out_j, out, tol)
        assert all(bool(torch.isfinite(x).all()) for x in (state.qpos, state.qvel, power))
        q_j, v_j = out_j[0], out_j[1]
    assert info.nactive_max.dtype == torch.int32
    if kind == "contact":
        assert int(info.nactive_max.min()) > 0


def test_torque_ctrl_matches_jax():
    jm, tm = models()
    act = np.random.RandomState(2).uniform(-1.5, 1.5, (B, jm.nu))
    for ps in (1.0, 10.0):
        ref = jax.vmap(lambda a: jax_control.torque_ctrl(jm, a, ps))(act)
        assert rel_err(ref, control.torque_ctrl(tm, T(act), ps)) == 0.0


def test_control_modes_keep_the_uhc_pd_default():
    """uhc_pd stays the default mode; "default" mode with the torque mode's
    torques is the torque mode; an unknown mode raises."""
    jm, tm = models()
    qpos, qvel, act = states(jm, 2, "air", seed=3)
    st = engine.PhysicsState(T(qpos), T(qvel))
    a = T(act)
    uhc = engine.control_step(tm, st, a, control_freq_inv=1)
    uhc2 = engine.control_step(tm, st, a, control_freq_inv=1, control_mode="uhc_pd",
                               power_scale=10.0)
    assert torch.equal(uhc[0].qpos, uhc2[0].qpos) and len(uhc[3]) == 3
    tq = engine.control_step(tm, st, a, control_freq_inv=1, control_mode="torque",
                             power_scale=0.25)
    df = engine.control_step(tm, st, control.torque_ctrl(tm, a, 0.25), control_freq_inv=1,
                             control_mode="default")
    assert torch.equal(tq[0].qpos, df[0].qpos) and torch.equal(tq[2], df[2])
    with pytest.raises(NotImplementedError):
        engine.control_step(tm, st, a, control_freq_inv=1, control_mode="pid")
    st0 = engine.init_state(tm, 3)
    assert st0.qpos.shape == (3, tm.nq) and torch.equal(st0.qpos[1], tm.qpos0)
    assert not bool(st0.qvel.any())


EPISODE = 300


@pytest.fixture(scope="module")
def torque_envs():
    jm, tm = models()
    cfg_j = jax_tasks.SpeedConfig(episode_length=EPISODE, control_mode="torque")
    env_j = jax_tasks.HumanoidSpeed(jm, cfg_j)
    env_t = HumanoidSpeed(tm, SpeedConfig(control_mode="torque"))
    assert env_t.config.power_scale == cfg_j.power_scale == 10.0
    return jm, tm, env_j, env_t


def test_torque_env_reset_matches_jax(torque_envs):
    jm, tm, env_j, env_t = torque_envs
    s_j = jax.vmap(env_j.reset)(jax.random.split(jax.random.PRNGKey(1), B))
    s = env_t.reset(B, torch.Generator().manual_seed(1))
    assert s.pd_cache is None and s_j.pd_cache is None
    for name, r, v in (("qpos", s_j.phys.qpos, s.phys.qpos), ("qvel", s_j.phys.qvel, s.phys.qvel),
                       ("obs", s_j.obs[:, :-1], s.obs[:, :-1])):
        assert rel_err(r, v) < 1e-9, name
    assert torch.equal(s.obs[:, -1], s.task.tar_speed)


def test_torque_env_step_autoreset_matches_jax(torque_envs):
    """Two step_autoreset from one injected state: two envs in the air, one
    that truncates at the second step and one lying on the floor (an
    illegal floor contact: terminated and reset at the first), at 1% of
    full-scale actions. Between the steps the JAX task draws of the reset
    env are copied into the port's state, as the two random streams
    differ."""
    jm, tm, env_j, env_t = torque_envs
    qpos, qvel, act = states(jm, B, "air", seed=5)
    lying, lying_v, _ = states(jm, 1, "contact", seed=5)
    qpos[3], qvel[3] = lying[0], lying_v[0]
    cur_t = np.asarray([0, 17, EPISODE - 1, 4], np.int32)

    def start(key, q, v, t):
        s = env_j.reset(key)
        phys = jax_engine.PhysicsState(q, v)
        task = s.task.replace(change_step=jnp.asarray(10**6, jnp.int32))
        obs = env_j.compute_obs(task, phys, jax_engine.kinematics.fk(jm, q))
        return s.replace(phys=phys, cur_t=t, task=task, obs=obs, kin=None)

    keys = jax.random.split(jax.random.PRNGKey(0), B)
    s_j = jax.jit(jax.vmap(start))(keys, jnp.asarray(qpos), jnp.asarray(qvel),
                                   jnp.asarray(cur_t))
    st = EnvState(
        phys=engine.PhysicsState(T(qpos), T(qvel)), obs=T(s_j.obs), reward=T(s_j.reward),
        terminated=T(s_j.terminated), truncated=T(s_j.truncated), cur_t=T(s_j.cur_t),
        task=SpeedTask(T(s_j.task.tar_speed), T(s_j.task.change_step),
                       T(s_j.task.prev_root_pos)),
        info={k: T(v) for k, v in s_j.info.items()}, pd_cache=None,
        kin=kinematics.fk(tm, T(qpos)), rng=torch.Generator().manual_seed(0))
    step_j = jax.jit(jax.vmap(env_j.step_autoreset))
    for k in range(2):
        a = 0.01 * act * (1.0 - 0.5 * k)
        s_j = step_j(s_j, jnp.asarray(a))
        st = env_t.step_autoreset(st, T(a))
        assert st.pd_cache is None and s_j.pd_cache is None
        done = np.asarray(s_j.terminated | s_j.truncated)
        assert done.tolist() == ([False, False, False, True] if k == 0
                                 else [False, False, True, False])
        keep = ~done
        pairs = {
            "qpos": (s_j.phys.qpos, st.phys.qpos), "qvel": (s_j.phys.qvel, st.phys.qvel),
            "obs": (s_j.obs[:, :-1], st.obs[:, :-1]), "reward": (s_j.reward, st.reward),
            "terminated": (s_j.terminated, st.terminated),
            "truncated": (s_j.truncated, st.truncated), "cur_t": (s_j.cur_t, st.cur_t),
            "prev_root_pos": (s_j.task.prev_root_pos, st.task.prev_root_pos),
            **{f"info.{n}": (s_j.info[n], st.info[n]) for n in s_j.info},
        }
        for name, (r, v) in pairs.items():
            r = np.asarray(r)
            if r.dtype.kind in "biu":
                np.testing.assert_array_equal(v.numpy(), r, err_msg=name)
            else:
                assert rel_err(r, v) < 1e-9, (k, name, rel_err(r, v))
        for name in ("tar_speed", "change_step"):
            r = np.asarray(getattr(s_j.task, name))
            np.testing.assert_array_equal(getattr(st.task, name).numpy()[keep], r[keep])
        assert float(st.info["power"][keep].min()) > 0.0
        # the reset env draws its task from its own stream: take JAX's
        st = dataclasses.replace(st, task=dataclasses.replace(
            st.task, tar_speed=T(s_j.task.tar_speed), change_step=T(s_j.task.change_step)))
    assert int(st.info["nactive"].max()) > 0
    assert qp.newton_qp.launches == 0 and linalg.cho_factor_solve.launches == 0
