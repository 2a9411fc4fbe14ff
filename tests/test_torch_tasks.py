"""PyTorch port: the Fall init, HumanoidGetup and HumanoidReach (observation
v2) against the JAX envs, vmapped, from the same float64 states.

The JAX package draws the Fall actions and the task targets from its keys,
the port from a torch.Generator, so every draw that counts is fed to both
as numpy numbers:

  * the Fall init: 3 control steps from the drop pose under fixed actions
    in [-0.5, 0.5], through the jitted vmapped HumanoidGetup.step (whose
    physics is the control step the JAX Fall runs, with the same primed
    cache and reset reference), against the port's fall_phys;
  * reset and step_autoreset: the port's Fall draws are replaced by those
    fixed actions, and the finished envs are compared on everything that
    does not depend on the task's draws;
  * step: the targets are set by hand; one getup env's target is due, so
    its resample (random in both) is checked for range only.

The envs run 5 substeps per control step (15 by default). Four getup
envs cover the recovery counter: one in the air with its
target due (the counter is kept through the resample), one lying on the
floor while recovering (its illegal contact does not terminate), one lying
with the counter at 0 (terminated) and one at the episode's end
(truncated). Four reach envs: two in the air, one truncated, one lying
(terminated).

Tolerance: float64, |ref - val| / (1 + |ref|) <= 1e-9 on every channel,
integer and bool channels exact. The Fall states are tangled: the JAX
lanes capsule-box routine departs from its per-env reference on deep
penetrations (ROADMAP.md §3), which these seeds do not reach (the 1e-9
check would show it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smplsim_tpu.envs import base as jax_base
from smplsim_tpu.envs import tasks as jax_tasks
from smplsim_tpu.physics import engine as jax_engine
from smplsim_tpu_torch.envs import (TASKS, EnvState, GetupConfig, GetupTask, HumanoidGetup,
                                    HumanoidReach, ReachConfig, ReachTask)
from smplsim_tpu_torch.envs import obs as obs_mod
from smplsim_tpu_torch.physics import constraints, engine, kinematics
from tests._torch_port import T, models, states

TOL = 1e-9
EPISODE = 300
B = 4
# substeps per control step: 5 of the default 15 keep the CPU run short
CFI = 5


def _jax_state(env_j, qpos, qvel, cur_t, task, pd_cache):
    """A vmapped JAX EnvState at (qpos, qvel) with the port's pd_cache;
    step reads neither obs nor info, and kin=None makes it run FK."""
    n = qpos.shape[0]
    z = jnp.zeros(n, jnp.float64)
    f = jnp.zeros(n, bool)
    return jax_base.EnvState(
        phys=jax_engine.PhysicsState(jnp.asarray(qpos), jnp.asarray(qvel)),
        obs=jnp.zeros((n, env_j.obs_size)), reward=z, terminated=f, truncated=f,
        cur_t=jnp.asarray(cur_t, jnp.int32), rng=jax.random.split(jax.random.PRNGKey(0), n),
        task=task, info={"power": z, "nactive": jnp.zeros(n, jnp.int32), "overflow": f,
                         "stalled": f},
        pd_cache=tuple(jnp.asarray(x.numpy()) for x in pd_cache), kin=None)


def _port_state(env_t, qpos, qvel, cur_t, task):
    phys = engine.PhysicsState(T(qpos), T(qvel))
    n = qpos.shape[0]
    z = torch.zeros(n, dtype=torch.float64)
    f = torch.zeros(n, dtype=torch.bool)
    return EnvState(phys=phys, obs=torch.zeros(n, env_t.obs_size), reward=z, terminated=f,
                    truncated=f, cur_t=torch.as_tensor(cur_t, dtype=torch.int32), task=task,
                    info={"power": z, "nactive": torch.zeros(n, dtype=torch.int32),
                          "overflow": f, "stalled": f},
                    pd_cache=env_t._fresh_cache(phys), kin=kinematics.fk(env_t.model, phys.qpos),
                    rng=torch.Generator().manual_seed(0))


def _compare(pairs, rows, skip=()):
    """Each (JAX, port) pair of `pairs` on `rows`, except `skip`."""
    for name, (r, v) in pairs.items():
        if name in skip:
            continue
        r = np.asarray(r)[rows]
        v = v[torch.as_tensor(rows)].numpy()
        if r.dtype.kind in "biu":
            np.testing.assert_array_equal(v, r, err_msg=name)
        else:
            err = float(np.max(np.abs(r - v) / (1.0 + np.abs(r)))) if r.size else 0.0
            assert err < TOL, (name, err)


def _channels(sj, st, task_names):
    pairs = {
        "qpos": (sj.phys.qpos, st.phys.qpos), "qvel": (sj.phys.qvel, st.phys.qvel),
        "obs": (sj.obs, st.obs), "reward": (sj.reward, st.reward),
        "terminated": (sj.terminated, st.terminated), "truncated": (sj.truncated, st.truncated),
        "cur_t": (sj.cur_t, st.cur_t),
        "M": (sj.pd_cache[0], st.pd_cache[0]), "C": (sj.pd_cache[1], st.pd_cache[1]),
        "fw": (sj.pd_cache[2], st.pd_cache[2]),
        **{f"info.{k}": (sj.info[k], st.info[k]) for k in sj.info},
    }
    pairs.update({n: (getattr(sj.task, n), getattr(st.task, n)) for n in task_names})
    return pairs


@pytest.fixture(scope="module")
def getup():
    """The getup envs, the step's inputs, and the JAX Fall from the drop
    pose under fixed actions (3,B,nu): one compile of the vmapped step."""
    jm, tm = models()
    env_j = jax_tasks.HumanoidGetup(jm, jax_tasks.GetupConfig(episode_length=EPISODE,
                                                                 control_frequency_inv=CFI))
    env_t = HumanoidGetup(tm, GetupConfig(episode_length=EPISODE, control_frequency_inv=CFI))
    jstep = jax.jit(jax.vmap(env_j.step))
    fall_act = np.random.RandomState(3).uniform(-0.5, 0.5, (3, B, jm.nu))

    # the Fall through the JAX env's step: qpos = 0, z = 0.3, quat (1,0,0,0)
    q0 = np.zeros((B, jm.nq))
    q0[:, 2], q0[:, 3] = 0.3, 1.0
    task0 = GetupTask(T(np.ones(B)), torch.full((B,), 10**6, dtype=torch.int32),
                      torch.zeros(B, dtype=torch.int32))
    st = _port_state(env_t, q0, np.zeros((B, jm.nv)), np.zeros(B), task0)
    sj = _jax_state(env_j, q0, np.zeros((B, jm.nv)), np.zeros(B),
                    jax_tasks.GetupTask(*(jnp.asarray(x.numpy()) for x in (
                        task0.tar_height, task0.change_step, task0.recovery_counter))),
                    st.pd_cache)
    fall_j = []
    for k in range(3):
        sj = jstep(sj, jnp.asarray(fall_act[k]))
        fall_j.append(sj)

    # the step's inputs: air with its target due and recovering, lying while
    # recovering, lying with the counter spent, air at the episode's end
    qpos, qvel, act = states(jm, B, "air", seed=5)
    lying, lying_v, _ = states(jm, 2, "contact", seed=5)
    qpos[1:3], qvel[1:3] = lying, lying_v
    cur_t = np.asarray([17, 4, 9, EPISODE], np.int32)
    tar = np.asarray([0.8, 0.9, 1.0, 0.6])
    change = np.asarray([17, 10**6, 10**6, 10**6], np.int32)
    counter = np.asarray([3, 5, 0, 0], np.int32)
    task = GetupTask(T(tar), T(change), T(counter))
    st = _port_state(env_t, qpos, qvel, cur_t, task)
    sj = _jax_state(env_j, qpos, qvel, cur_t, jax_tasks.GetupTask(
        jnp.asarray(tar), jnp.asarray(change), jnp.asarray(counter)), st.pd_cache)
    return env_t, st, act, jstep(sj, jnp.asarray(act)), fall_act, fall_j


@pytest.mark.parametrize("n_steps", [1, 3])
def test_fall_control_steps_match_jax(getup, n_steps):
    env_t, _, _, _, fall_act, fall_j = getup
    phys = env_t.fall_phys(T(fall_act[:n_steps]))
    ref = fall_j[n_steps - 1]
    _compare({"qpos": (ref.phys.qpos, phys.qpos), "qvel": (ref.phys.qvel, phys.qvel)},
             np.arange(B))
    assert bool(torch.isfinite(phys.qvel).all())
    if n_steps == 3:
        # the Fall has reached the floor
        assert int(ref.info["nactive"].max()) > 0


def test_getup_reset_matches_jax_fall(getup, monkeypatch):
    env_t, _, _, _, fall_act, fall_j = getup
    monkeypatch.setattr(env_t, "_fall_actions", lambda n, g: T(fall_act[:, :n]))
    s = env_t.reset(B, torch.Generator().manual_seed(1))
    ref = fall_j[-1]
    _compare({"qpos": (ref.phys.qpos, s.phys.qpos), "qvel": (ref.phys.qvel, s.phys.qvel),
              "prop": (ref.obs[:, :-1], s.obs[:, :-1])}, np.arange(B))
    assert s.obs.shape == (B, env_t.obs_size) and env_t.obs_size == obs_mod.self_obs_size(
        24, 1, True) + 1
    assert (s.task.recovery_counter == 60).all() and (s.cur_t == 0).all()
    assert ((s.task.tar_height >= 0.5) & (s.task.tar_height <= 1.2)).all()
    assert ((s.task.change_step >= 100) & (s.task.change_step < 200)).all()
    assert torch.equal(s.obs[:, -1], s.task.tar_height)
    M, C = engine.pd_cache(env_t.model, s.phys)
    assert torch.equal(s.pd_cache[0], M) and torch.equal(s.pd_cache[1], C)
    assert not s.pd_cache[2].any()


def test_getup_step_matches_jax(getup):
    env_t, st, act, out_j, _, _ = getup
    out = env_t.step(st, T(act))
    pairs = _channels(out_j, out, ("tar_height", "change_step", "recovery_counter"))
    _compare(pairs, np.arange(1, B))
    # env 0's target was due: its resample is the packages' own draw
    _compare(pairs, np.arange(1), skip=("obs", "reward", "tar_height", "change_step"))
    _compare({"prop": (out_j.obs[:, :-1], out.obs[:, :-1])}, np.arange(1))
    assert 0.5 <= float(out.task.tar_height[0]) <= 1.2
    assert 17 + 100 <= int(out.task.change_step[0]) < 17 + 200
    # the counter: kept through the resample, counted down, suppressing the
    # lying env's termination while it was > 0
    assert out.task.recovery_counter.tolist() == [2, 4, 0, 0]
    assert out.terminated.tolist() == [False, False, True, False]
    assert out.truncated.tolist() == [False, False, False, True]
    assert bool(out.info["nactive"][1] > 0)


def test_getup_step_autoreset_matches_jax(getup, monkeypatch):
    env_t, st, act, out_j, fall_act, fall_j = getup
    monkeypatch.setattr(env_t, "_fall_actions", lambda n, g: T(fall_act[:, :n]))
    out = env_t.step_autoreset(st, T(act))
    done = np.asarray(out_j.terminated | out_j.truncated)
    assert done.tolist() == [False, False, True, True]
    pairs = _channels(out_j, out, ("tar_height", "change_step", "recovery_counter"))
    _compare(pairs, np.flatnonzero(~done)[1:])
    _compare(pairs, np.arange(1), skip=("obs", "reward", "tar_height", "change_step"))
    # finished envs: the Fall state under the fixed draws, a fresh task and
    # cache, the finishing step's reward, flags and info
    rows = np.flatnonzero(done)
    ref = fall_j[-1]
    _compare({"qpos": (ref.phys.qpos, out.phys.qpos), "qvel": (ref.phys.qvel, out.phys.qvel),
              "prop": (ref.obs[:, :-1], out.obs[:, :-1])}, rows)
    _compare(pairs, rows, skip=("qpos", "qvel", "obs", "cur_t", "M", "C", "fw", "tar_height",
                                "change_step", "recovery_counter"))
    assert out.task.recovery_counter.tolist() == [2, 4, 60, 60]
    assert (out.cur_t[2:] == 0).all() and not out.pd_cache[2][2:].any()


@pytest.fixture(scope="module")
def reach():
    jm, tm = models()
    cfg = dict(episode_length=EPISODE, self_obs_v=2, control_frequency_inv=CFI)
    env_j = jax_tasks.HumanoidReach(jm, jax_tasks.ReachConfig(**cfg))
    env_t = HumanoidReach(tm, ReachConfig(**cfg))
    qpos, qvel, act = states(jm, B, "air", seed=6)
    lying, lying_v, _ = states(jm, 1, "contact", seed=6)
    qpos[3], qvel[3] = lying[0], lying_v[0]
    cur_t = np.asarray([0, 17, EPISODE, 4], np.int32)
    tar = np.random.RandomState(6).uniform(-1.0, 1.5, (B, 3))
    change = np.full(B, 10**6, np.int32)
    st = _port_state(env_t, qpos, qvel, cur_t, ReachTask(T(tar), T(change)))
    sj = _jax_state(env_j, qpos, qvel, cur_t,
                    jax_tasks.ReachTask(jnp.asarray(tar), jnp.asarray(change)), st.pd_cache)
    obs0 = jax.jit(jax.vmap(env_j.compute_obs))(
        sj.task, sj.phys, jax.vmap(lambda q: jax_engine.kinematics.fk(jm, q))(sj.phys.qpos))
    return env_t, st, act, jax.jit(jax.vmap(env_j.step))(sj, jnp.asarray(act)), obs0


def test_reach_obs_v2_matches_jax(reach):
    env_t, st, _, _, obs0 = reach
    obs = env_t.compute_obs(st.task, st.phys, st.kin)
    assert env_t.obs_size == obs_mod.self_obs_size(24, 2, True) + 3 == obs.shape[1]
    _compare({"obs": (obs0, obs)}, np.arange(B))


def test_reach_step_and_autoreset_match_jax(reach):
    env_t, st, act, out_j, _ = reach
    out = env_t.step(st, T(act))
    pairs = _channels(out_j, out, ("tar_pos", "change_step"))
    _compare(pairs, np.arange(B))
    assert out.terminated.tolist() == [False, False, False, True]
    assert out.truncated.tolist() == [False, False, True, False]
    assert out.reward.min() > 0
    auto = env_t.step_autoreset(st, T(act))
    pairs = _channels(out_j, auto, ("tar_pos", "change_step"))
    _compare(pairs, np.arange(2))
    # finished envs: the Default init (no draws), the finishing step's flags
    fresh = env_t.reset(2, torch.Generator().manual_seed(0))
    assert torch.equal(auto.phys.qpos[2:], fresh.phys.qpos)
    assert torch.equal(auto.obs[2:, :-3], fresh.obs[:, :-3])
    _compare(pairs, np.arange(2, B), skip=("qpos", "qvel", "obs", "cur_t", "M", "C", "fw",
                                           "tar_pos", "change_step"))
    tp = auto.task.tar_pos[2:]
    assert ((tp[:, :2].abs() <= 1.0).all() and (tp[:, 2] >= 0.2).all()
            and (tp[:, 2] <= 2.0).all())


def test_tasks_registry_and_fall_pool():
    """TASKS names every env; a Fall pool is built once at construction and
    resets draw whole rows of it."""
    assert set(TASKS) == {"HumanoidEnv", "HumanoidSpeed", "HumanoidGetup", "HumanoidReach"}
    _, tm = models()
    env = HumanoidGetup(tm, GetupConfig(fall_init_pool=3, fall_pool_seed=2,
                                        control_frequency_inv=2))
    pool = env._fall_pool
    assert pool.qpos.shape == (3, tm.nq) and bool(torch.isfinite(pool.qpos).all())
    s = env.reset(5, torch.Generator().manual_seed(0))
    hit = (s.phys.qpos[:, None, :] == pool.qpos[None]).all(-1)
    assert (hit.sum(1) == 1).all()
    assert torch.equal(s.phys.qvel, pool.qvel[hit.int().argmax(1)])
    assert s.pd_cache[0].shape == (5, tm.nv, tm.nv) and constraints.NEFC == s.pd_cache[2].shape[1]
