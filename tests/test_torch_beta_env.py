"""PyTorch port: HumanoidSpeed on a stacked model of 4 β bodies (each env its
own body) against the JAX env stepped with the model mapped
(jax.vmap(lambda s, a, m: env.step(s, a, model=m)), as
tests/test_beta_batch.py steps it), in float64.

As in tests/test_torch_env.py, the port's state is the JAX package's reset
state with (qpos, qvel) replaced and the speed resample set far ahead, so
neither package's random stream decides a compared value: two envs in the
air, one a step before truncation, one lying on the floor (terminated).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smplsim_tpu.body_model import SMPLParser as JaxParser
from smplsim_tpu.envs import tasks as jax_tasks
from smplsim_tpu.models import builder as jax_builder
from smplsim_tpu.models import stack_models as jax_stack
from smplsim_tpu.physics import engine as jax_engine
from smplsim_tpu_torch.body_model import SMPLParser
from smplsim_tpu_torch.envs import EnvState, HumanoidSpeed, SpeedConfig, SpeedTask
from smplsim_tpu_torch.models import builder, stack_models, tile_model
from smplsim_tpu_torch.physics import engine, kinematics
from tests._torch_port import T, rel_err, states
from tests._torch_synthetic_body import make_synthetic_body
from tests.test_torch_env import _compare

N = 4
EPISODE = 300
# substeps per control step: the physics is held at this width by
# tests/test_torch_beta_batch.py; here it is the env around it
CFI = 3


@pytest.fixture(scope="module")
def envs():
    d = make_synthetic_body(np.random.RandomState(0), "smpl")
    pj, pt = JaxParser(data=d), SMPLParser(data=d)
    rng = np.random.RandomState(11)
    betas = [rng.randn(1, 10) * 0.8 for _ in range(N)]
    jms = [jax_builder.build_robot_model(pj, betas=jnp.asarray(b), dtype=jnp.float64)[0]
           for b in betas]
    tms = [builder.build_robot_model(pt, betas=b, dtype=torch.float64, device="cpu")[0]
           for b in betas]
    jm, tm = jax_stack(jms), stack_models(tms)
    env_j = jax_tasks.HumanoidSpeed(
        jms[0], jax_tasks.SpeedConfig(episode_length=EPISODE, control_frequency_inv=CFI))
    env_t = HumanoidSpeed(tm, SpeedConfig(episode_length=EPISODE, control_frequency_inv=CFI))

    qpos, qvel, act = states(jms[0], N, "air", seed=6)
    lying, lying_v, _ = states(jms[0], 1, "contact", seed=6)
    qpos[3], qvel[3] = lying[0], lying_v[0]
    cur_t = np.asarray([0, 17, EPISODE, 4], np.int32)

    def start(key, m, q, v, t):
        s = env_j.reset(key, model=m)
        phys = jax_engine.PhysicsState(q, v)
        task = s.task.replace(change_step=jnp.asarray(10**6, jnp.int32))
        M, C = jax_engine.pd_cache(m, phys)
        fw = jnp.zeros(jax_engine.constraints.NEFC, q.dtype)
        obs = env_j.compute_obs(task, phys, jax_engine.kinematics.fk(m, q), m)
        return s, s.replace(phys=phys, cur_t=t, task=task, pd_cache=(M, C, fw), obs=obs,
                            kin=None)

    keys = jax.random.split(jax.random.PRNGKey(0), N)
    reset_j, s = jax.jit(jax.vmap(start))(keys, jm, jnp.asarray(qpos), jnp.asarray(qvel),
                                          jnp.asarray(cur_t))
    st = EnvState(
        phys=engine.PhysicsState(T(qpos), T(qvel)), obs=T(s.obs), reward=T(s.reward),
        terminated=T(s.terminated), truncated=T(s.truncated), cur_t=T(s.cur_t),
        task=SpeedTask(T(s.task.tar_speed), T(s.task.change_step), T(s.task.prev_root_pos)),
        info={k: T(v) for k, v in s.info.items()},
        pd_cache=tuple(T(x) for x in s.pd_cache), kin=kinematics.fk(tm, T(qpos)),
        rng=torch.Generator().manual_seed(0))
    both = jax.jit(lambda s, a, m: (
        jax.vmap(lambda s_, a_, m_: env_j.step(s_, a_, model=m_))(s, a, m),
        jax.vmap(lambda s_, a_, m_: env_j.step_autoreset(s_, a_, model=m_))(s, a, m)))
    return env_t, st, act, both(s, jnp.asarray(act), jm), reset_j


def test_reset_matches_jax(envs):
    env_t, _, _, _, reset_j = envs
    s = env_t.reset(N, torch.Generator().manual_seed(1))
    for r, v in ((reset_j.phys.qpos, s.phys.qpos), (reset_j.phys.qvel, s.phys.qvel),
                 (reset_j.pd_cache[0], s.pd_cache[0]), (reset_j.pd_cache[1], s.pd_cache[1]),
                 (reset_j.obs[:, :-1], s.obs[:, :-1])):
        assert rel_err(r, v) < 1e-9
    # the stable-PD cache of each env is its own body's
    assert rel_err(reset_j.pd_cache[0][0], s.pd_cache[0][1]) > 1e-6
    with pytest.raises(ValueError, match="exactly 4"):
        env_t.reset(N + 1, torch.Generator().manual_seed(1))


def test_step_matches_jax(envs):
    env_t, st, act, (out_j, _), _ = envs
    out = env_t.step(st, T(act))
    _compare(out_j, out, np.arange(N))
    assert out.truncated.tolist() == [False, False, True, False]
    assert out.terminated.tolist() == [False, False, False, True]


def test_step_autoreset_matches_jax(envs):
    env_t, st, act, (_, out_j), _ = envs
    out = env_t.step_autoreset(st, T(act))
    done = np.asarray(out_j.terminated | out_j.truncated)
    assert done.tolist() == [False, False, True, True]
    _compare(out_j, out, np.flatnonzero(~done))
    # finished envs: a fresh Default-init state of their own bodies
    _compare(dataclasses.replace(out_j, obs=out_j.obs[:, :-1]),
             dataclasses.replace(out, obs=out.obs[:, :-1]), np.flatnonzero(done),
             skip=("tar_speed", "change_step"))
    assert (out.cur_t[2:] == 0).all()


def test_tiled_env_and_fall_pool(envs):
    """tile_model repeats the bodies over a larger batch; a Fall pool on a
    stacked model is simulated on the bodies in order and env i resets from
    its own body's states."""
    from smplsim_tpu_torch.envs import GetupConfig, HumanoidGetup

    env_t = envs[0]
    big = tile_model(env_t.model, 2 * N)
    assert torch.equal(big.body_mass[N + 1], env_t.model.body_mass[1])
    g = torch.Generator().manual_seed(2)
    genv = HumanoidGetup(big, GetupConfig(control_frequency_inv=2, fall_init_pool=4 * N))
    pool = genv._fall_pool
    s = genv.reset(2 * N, g)
    rows = [int(torch.nonzero((pool.qpos == s.phys.qpos[i]).all(1))[0]) for i in range(2 * N)]
    assert [r % (2 * N) for r in rows] == list(range(2 * N))
    with pytest.raises(ValueError, match="multiple"):
        HumanoidGetup(big, GetupConfig(fall_init_pool=3))
