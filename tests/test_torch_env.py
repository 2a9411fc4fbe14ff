"""PyTorch port: HumanoidSpeed.step and step_autoreset against the JAX env
(vmapped) from the same float64 EnvState.

Four envs: two in the air, one a step before truncation and one lying on the
floor (an illegal floor contact: terminated). The target-speed resample is
set far ahead, so the step draws nothing that counts from either package's
random stream; after step_autoreset the finished envs are compared on
everything that does not depend on those streams.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smplsim_tpu.envs import tasks as jax_tasks
from smplsim_tpu.physics import engine as jax_engine
from smplsim_tpu_torch.envs import EnvState, HumanoidSpeed, SpeedTask
from smplsim_tpu_torch.physics import engine, kinematics
from tests._torch_port import T, models, rel_err, states

TOL = 1e-9
EPISODE = 300


@pytest.fixture(scope="module")
def envs():
    jm, tm = models()
    cfg_j = jax_tasks.SpeedConfig(episode_length=EPISODE)
    env_j = jax_tasks.HumanoidSpeed(jm, cfg_j)
    env_t = HumanoidSpeed(tm)
    assert env_t.config.episode_length == EPISODE and env_t.obs_size == env_j.obs_size

    qpos, qvel, act = states(jm, 4, "air", seed=5)
    lying, lying_v, _ = states(jm, 1, "contact", seed=5)
    qpos[3], qvel[3] = lying[0], lying_v[0]
    cur_t = np.asarray([0, 17, EPISODE, 4], np.int32)

    def start(key, q, v, t):
        """One env's reset, then its state replaced by (q, v) with the
        speed resample a million steps ahead."""
        s = env_j.reset(key)
        phys = jax_engine.PhysicsState(q, v)
        task = s.task.replace(change_step=jnp.asarray(10**6, jnp.int32))
        M, C = jax_engine.pd_cache(jm, phys)
        fw = jnp.zeros(jax_engine.constraints.NEFC, q.dtype)
        obs = env_j.compute_obs(task, phys, jax_engine.kinematics.fk(jm, q))
        return s.replace(phys=phys, cur_t=t, task=task, pd_cache=(M, C, fw), obs=obs,
                         kin=None)

    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    s = jax.jit(jax.vmap(start))(keys, jnp.asarray(qpos), jnp.asarray(qvel),
                                 jnp.asarray(cur_t))
    st = EnvState(
        phys=engine.PhysicsState(T(qpos), T(qvel)), obs=T(s.obs), reward=T(s.reward),
        terminated=T(s.terminated), truncated=T(s.truncated), cur_t=T(s.cur_t),
        task=SpeedTask(T(s.task.tar_speed), T(s.task.change_step),
                       T(s.task.prev_root_pos)),
        info={k: T(v) for k, v in s.info.items()},
        pd_cache=tuple(T(x) for x in s.pd_cache), kin=kinematics.fk(tm, T(qpos)),
        rng=torch.Generator().manual_seed(0))
    # one compile for both entry points
    both = jax.jit(lambda s, a: (jax.vmap(env_j.step)(s, a),
                                 jax.vmap(env_j.step_autoreset)(s, a)))
    out_j = both(s, jnp.asarray(act))
    return env_t, st, act, out_j


def _compare(sj, st, rows, skip=()):
    """Every channel of the two EnvStates on `rows`, except `skip`."""
    pairs = {
        "qpos": (sj.phys.qpos, st.phys.qpos), "qvel": (sj.phys.qvel, st.phys.qvel),
        "obs": (sj.obs, st.obs), "reward": (sj.reward, st.reward),
        "terminated": (sj.terminated, st.terminated), "truncated": (sj.truncated, st.truncated),
        "cur_t": (sj.cur_t, st.cur_t),
        "tar_speed": (sj.task.tar_speed, st.task.tar_speed),
        "change_step": (sj.task.change_step, st.task.change_step),
        "prev_root_pos": (sj.task.prev_root_pos, st.task.prev_root_pos),
        "M": (sj.pd_cache[0], st.pd_cache[0]), "C": (sj.pd_cache[1], st.pd_cache[1]),
        "fw": (sj.pd_cache[2], st.pd_cache[2]),
        **{f"info.{k}": (sj.info[k], st.info[k]) for k in sj.info},
    }
    for name, (r, v) in pairs.items():
        if name in skip:
            continue
        r = np.asarray(r)[rows]
        v = v[torch.as_tensor(rows)]
        if r.dtype.kind in "biu":
            np.testing.assert_array_equal(v.numpy(), r, err_msg=name)
        else:
            assert rel_err(r, v) < TOL, (name, rel_err(r, v))


def test_step_matches_jax(envs):
    env_t, st, act, (out_j, _) = envs
    out = env_t.step(st, T(act))
    _compare(out_j, out, np.arange(4))
    assert out.truncated.tolist() == [False, False, True, False]
    assert out.terminated.tolist() == [False, False, False, True]
    assert out.obs.shape == (4, env_t.obs_size)


def test_step_autoreset_matches_jax(envs):
    env_t, st, act, (_, out_j) = envs
    out = env_t.step_autoreset(st, T(act))
    done = np.asarray(out_j.terminated | out_j.truncated)
    assert done.tolist() == [False, False, True, True]
    _compare(out_j, out, np.flatnonzero(~done))
    # finished envs: a fresh Default-init state, the finishing step's flags
    _compare(dataclasses.replace(out_j, obs=out_j.obs[:, :-1]),
             dataclasses.replace(out, obs=out.obs[:, :-1]), np.flatnonzero(done),
             skip=("tar_speed", "change_step"))
    assert (out.cur_t[2:] == 0).all()
    speed = out.task.tar_speed[2:]
    assert ((speed >= 0) & (speed <= 5)).all()
    assert ((out.task.change_step[2:] >= 100) & (out.task.change_step[2:] < 200)).all()
    assert torch.equal(out.obs[2:, -1], speed)
