"""PyTorch port: the Isaac-path humanoid (envs/nv.py) and the gym vector
facade (envs/vector.py) against the JAX package.

  * the four observation functions against JAX's, vmapped, on numpy inputs
    (float64, 1e-12), both root-observation forms and both upright forms;
  * BodyHistory init and push;
  * one NvHumanoid step in float64 (obs v2, freeze_hand, one projectile and
    the impulse, 3 substeps) against jax.vmap(NvHumanoid.step) from the
    same states: the JAX package draws the impulse and the throw from each
    env's key, the port from its generator, so the test derives JAX's draws
    from the keys the way its step does and feeds them to the port. Four
    envs: two in the air (one with its impulse and throw due, one
    truncated by the nv rule cur_t >= episode_length - 1), two lying at
    the floor (one past its first control steps: fallen, one at cur_t 0:
    not yet). Every channel within 1e-9, bool and int channels exact;
  * GymVectEnv with gymnasium present (its spaces) and with its import
    blocked (no spaces, the same steps).
"""
import dataclasses
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smplsim_tpu.envs import base as jax_base
from smplsim_tpu.envs import nv as jax_nv
from smplsim_tpu.physics import engine as jax_engine
from smplsim_tpu_torch.envs import (GymVectEnv, HumanoidSpeed, NvConfig, NvHumanoid,
                                    SpeedConfig)
from smplsim_tpu_torch.envs import nv
from smplsim_tpu_torch.envs.nv import BodyHistory
from smplsim_tpu_torch.physics import engine, kinematics
from tests._torch_port import T, models, rel_err, states

B = 4
EPISODE = 10
CFG = dict(obs_v=2, past_track_steps=2, freeze_hand=True, perturb_interval=2,
           num_projectiles=1, proj_interval=2, control_frequency_inv=3,
           episode_length=EPISODE)


def _rand_frames(rng, shape):
    pos = rng.normal(size=shape + (3,))
    pos[..., 0, 2] = np.abs(pos[..., 0, 2]) + 0.5
    rot = rng.normal(size=shape + (4,))
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    return pos, rot, rng.normal(size=shape + (3,)), rng.normal(size=shape + (3,))


@pytest.mark.parametrize("lro,upright", [(True, True), (False, False)])
def test_observation_functions_match_jax(lro, upright):
    rng = np.random.default_rng(0)
    kw = dict(local_root_obs=lro, upright=upright, humanoid_type="smpl")
    frames = _rand_frames(rng, (3, 24))
    got = nv.compute_obs_max(*map(T, frames), **kw)
    ref = jax.vmap(lambda *a: jax_nv.compute_obs_max(*a, **kw))(*map(jnp.asarray, frames))
    assert got.shape == (3, nv.obs_max_size(24)) and rel_err(ref, got) < 1e-12

    hist = _rand_frames(rng, (3, 4, 24))
    got = nv.compute_obs_max_v2(*map(T, hist), **kw)
    ref = jax.vmap(lambda *a: jax_nv.compute_obs_max_v2(*a, **kw))(*map(jnp.asarray, hist))
    assert got.shape == (3, nv.obs_max_v2_size(24, 4)) and rel_err(ref, got) < 1e-12

    dof = rng.normal(size=(3, 69))
    assert rel_err(jax.vmap(jax_nv.dof_to_obs_smpl)(jnp.asarray(dof)),
                   nv.dof_to_obs_smpl(T(dof))) < 1e-12
    root = _rand_frames(rng, (3, 1))
    args = (root[0][:, 0], root[1][:, 0], root[2][:, 0], root[3][:, 0], dof,
            rng.normal(size=(3, 69)), rng.normal(size=(3, 4, 3)))
    got = nv.compute_obs_reduced(*map(T, args), **kw)
    ref = jax.vmap(lambda *a: jax_nv.compute_obs_reduced(*a, **kw))(*map(jnp.asarray, args))
    assert rel_err(ref, got) < 1e-12


def test_body_history():
    rng = np.random.default_rng(3)
    f0 = [T(x) for x in _rand_frames(rng, (2, 5))]
    f1 = [T(x) for x in _rand_frames(rng, (2, 5))]
    h = BodyHistory.init(*f0, time_steps=3)
    assert h.pos.shape == (2, 3, 5, 3) and all(torch.equal(h.rot[:, t], f0[1]) for t in range(3))
    h2 = h.push(*f1)
    assert torch.equal(h2.vel[:, :2], h.vel[:, 1:]) and torch.equal(h2.ang_vel[:, -1], f1[3])
    hj = jax_nv.BodyHistory.init(*(jnp.asarray(x[0].numpy()) for x in f0), 3).push(
        *(jnp.asarray(x[0].numpy()) for x in f1))
    for a, b in zip((hj.pos, hj.rot, hj.vel, hj.ang_vel), (h2.pos, h2.rot, h2.vel, h2.ang_vel)):
        np.testing.assert_array_equal(np.asarray(a), b[0].numpy())


def _jax_draws(env_j, keys):
    """The impulse and throw draws of JAX's NvHumanoid.step, from each env's
    key, split as the step splits it."""
    cfg, nbody = env_j.config, env_j.model.nbody
    P = cfg.num_projectiles

    def one(rng):
        k_task, _ = jax.random.split(rng)
        k_body, k_dir, k_mag = jax.random.split(k_task, 3)
        body = jax.random.randint(k_body, (), 0, nbody)
        d = jax.random.normal(k_dir, (3,), jnp.float64)
        mag = jax.random.uniform(k_mag, (), jnp.float64, 0.0, cfg.perturb_force)
        k_throw, _ = jax.random.split(k_task)
        k_ang, k_h, k_sp = jax.random.split(k_throw, 3)
        ang = jax.random.uniform(k_ang, (P,), jnp.float64, 0.0, 2 * jnp.pi)
        h = jax.random.uniform(k_h, (P,), jnp.float64, 0.6, 1.4)
        sp = jax.random.uniform(k_sp, (P,), jnp.float64, 0.7, 1.0)
        return body, d, mag, ang, h, sp

    return [T(x) for x in jax.vmap(one)(keys)]


@pytest.fixture(scope="module")
def nv_step():
    jm, tm = models()
    env_t = NvHumanoid(tm, NvConfig(**CFG))
    env_j = jax_nv.NvHumanoid(jm, jax_nv.NvConfig(**CFG))
    qpos, qvel, act = states(jm, B, "air", seed=5)
    lying, lying_v, _ = states(jm, 2, "contact", seed=5)
    qpos[2:], qvel[2:] = lying, lying_v
    cur_t = torch.tensor([0, EPISODE - 1, 5, 0], dtype=torch.int32)

    s = env_t.reset(B, torch.Generator().manual_seed(0))
    phys = engine.PhysicsState(T(qpos), T(qvel))
    kin = kinematics.fk(tm, phys.qpos)
    hist = BodyHistory.init(*env_t._kin_tuple(phys, kin, tm), CFG["past_track_steps"] + 1)
    # a ball in flight at each root (re-thrown where its interval is due)
    proj = (phys.qpos[:, None, :3] + torch.tensor([0.5, 0.0, 0.0], dtype=torch.float64),
            torch.tensor([[[-5.0, 0.0, 0.0]]] * B, dtype=torch.float64))
    st = dataclasses.replace(s, phys=phys, kin=kin, cur_t=cur_t, task=hist, proj=proj,
                             pd_cache=env_t._fresh_cache(phys),
                             obs=env_t.compute_obs_from_hist(hist))
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    J = lambda x: jnp.asarray(x.numpy())
    z = jnp.zeros(B, jnp.float64)
    f = jnp.zeros(B, bool)
    sj = jax_base.EnvState(
        phys=jax_engine.PhysicsState(J(phys.qpos), J(phys.qvel)), obs=J(st.obs), reward=z,
        terminated=f, truncated=f, cur_t=J(cur_t), rng=keys,
        task=jax_nv.BodyHistory(J(hist.pos), J(hist.rot), J(hist.vel), J(hist.ang_vel)),
        info={"power": z, "nactive": jnp.zeros(B, jnp.int32), "overflow": f, "stalled": f},
        pd_cache=tuple(J(x) for x in st.pd_cache), kin=None, proj=tuple(J(x) for x in proj))
    out_j = jax.jit(jax.vmap(env_j.step))(sj, jnp.asarray(act))
    return env_t, env_j, st, act, out_j, _jax_draws(env_j, keys)


def test_step_matches_jax(nv_step, monkeypatch):
    env_t, env_j, st, act, out_j, draws = nv_step
    monkeypatch.setattr(env_t, "_impulse_draws", lambda n, g: tuple(draws[:3]))
    monkeypatch.setattr(env_t, "_throw_draws", lambda n, g: tuple(draws[3:]))
    out = env_t.step(st, T(act))
    pairs = [("qpos", out_j.phys.qpos, out.phys.qpos), ("qvel", out_j.phys.qvel, out.phys.qvel),
             ("obs", out_j.obs, out.obs), ("reward", out_j.reward, out.reward),
             ("power", out_j.info["power"], out.info["power"]),
             ("proj pos", out_j.proj[0], out.proj[0]), ("proj vel", out_j.proj[1], out.proj[1]),
             ("hist", out_j.task.pos, out.task.pos), ("hist rot", out_j.task.rot, out.task.rot)]
    pairs += [(f"cache{i}", a, b) for i, (a, b) in enumerate(zip(out_j.pd_cache, out.pd_cache))]
    for name, r, v in pairs:
        assert rel_err(r, v) < 1e-9, (name, rel_err(r, v))
    for name in ("terminated", "truncated", "cur_t"):
        np.testing.assert_array_equal(np.asarray(getattr(out_j, name)),
                                      getattr(out, name).numpy(), err_msg=name)
    for k in ("nactive", "overflow", "stalled"):
        np.testing.assert_array_equal(np.asarray(out_j.info[k]), out.info[k].numpy(), err_msg=k)
    # the nv rules: truncated at cur_t >= episode_length - 1; fallen only
    # past the first control steps, lying on the floor
    assert out.truncated.tolist() == [False, True, False, False]
    assert out.terminated.tolist() == [False, False, True, False]
    assert out.obs.shape == (B, env_t.obs_size)
    # the impulse and the throw acted where due: env 0's ball was re-thrown
    # from proj_distance away, env 1's flew on
    d0 = (st.proj[0][0, 0, :2] - st.phys.qpos[0, :2]).norm()
    assert abs(float(d0) - 0.5) < 1e-12
    moved = (out.proj[0][:, 0, :2] - st.phys.qpos[:, :2]).norm(dim=1)
    assert float(moved[1]) < 0.5


def test_freeze_mask_and_reset(nv_step):
    env_t = nv_step[0]
    mask = env_t.pd_target_mask()
    names = list(env_t.model.body_names)
    for n in ("L_Hand", "R_Hand"):
        d = (names.index(n) - 1) * 3
        assert (mask[d:d + 3] == 0).all()
    assert float(mask.sum()) == mask.shape[0] - 6
    np.testing.assert_array_equal(mask.numpy(), np.asarray(nv_step[1].pd_target_mask()))
    s = env_t.reset(2, torch.Generator().manual_seed(1))
    per = s.obs.reshape(2, CFG["past_track_steps"] + 1, -1)
    assert torch.equal(per[:, 1], per[:, 0]) and torch.equal(per[:, 2], per[:, 0])
    assert float(s.proj[0][0, 0, 0]) == 100.0 and not s.proj[1].any()


def _speed_env():
    _, tm = models()
    return HumanoidSpeed(tm, SpeedConfig(control_frequency_inv=2, episode_length=1))


@pytest.mark.parametrize("gym", [True, False], ids=["gymnasium", "no-gymnasium"])
def test_gym_vect_env(monkeypatch, gym):
    if not gym:
        monkeypatch.setitem(sys.modules, "gymnasium", None)
    env = _speed_env()
    venv = GymVectEnv(env, 2, clip_observations=5.0, seed=3)
    assert venv.has_spaces == gym
    if gym:
        assert venv.action_space.shape == (2, env.action_size)
        assert venv.observation_space.shape == (2, env.obs_size)
    else:
        assert not hasattr(venv, "action_space")
    obs, info = venv.reset()
    ref = env.reset(2, torch.Generator().manual_seed(3))
    assert isinstance(obs, np.ndarray) and info == {}
    np.testing.assert_array_equal(obs, np.clip(ref.obs.numpy(), -5.0, 5.0))
    a = np.full((2, env.action_size), 0.1)
    for k in range(2):
        prev = obs
        obs, rew, term, trunc, info = venv.step(a)
        ref = env.step_autoreset(ref, torch.as_tensor(a.astype(np.float32)).double())
        np.testing.assert_array_equal(rew, ref.reward.numpy())
        np.testing.assert_array_equal(trunc, ref.truncated.numpy())
        assert obs.shape == (2, env.obs_size) and np.abs(obs).max() <= 5.0
        # episode_length 1: the second step truncates, and the facade hands
        # back the observation before it as the final one
        assert ("final_observation" in info) == (k == 1)
    np.testing.assert_array_equal(info["final_observation"], prev)
    assert math.isfinite(float(rew.sum()))
