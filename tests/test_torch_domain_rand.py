"""PyTorch port: domain randomization (envs/domain_rand.py) against the JAX
package, float64.

The JAX package draws every noise from a key, the port from a generator;
the tests take JAX's standard draws (its normal or uniform bits from the
same keys) or its finished factors and feed them to the port:

  * schedule_scaling and apply_noise for every distribution, operation and
    schedule, with per-env step counts and a correlated component;
  * randomize_model: JAX's per-env factors (vmapped over keys) fed to the
    port, every field of the stacked model equal to JAX's batched model;
  * one DomainRandEnv step of HumanoidSpeed (3 substeps) on a realization
    fed to both, with observation and action noise: every channel within
    1e-9;
  * the redraw gate: a realization is redrawn at every `frequency`-th reset
    of an env, kept otherwise;
  * factors of 1 give the undisturbed env within 1e-9.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smplsim_tpu.envs import base as jax_base
from smplsim_tpu.envs import domain_rand as jax_dr
from smplsim_tpu.envs import tasks as jax_tasks
from smplsim_tpu.physics import engine as jax_engine
from smplsim_tpu_torch.envs import HumanoidSpeed, SpeedConfig, SpeedTask
from smplsim_tpu_torch.envs import domain_rand as dr
from smplsim_tpu_torch.models.spec import ARRAY_FIELDS
from smplsim_tpu_torch.physics import engine
from tests._torch_port import T, models, rel_err, states

B = 3
CFI = 3
SPECS = [dict(distribution=d, operation=o, range=r, range_correlated=rc, schedule=s,
              schedule_steps=10)
         for d, r, rc in (("gaussian", (0.1, 0.05), (0.0, 0.02)),
                          ("uniform", (0.8, 1.2), (-0.01, 0.01)))
         for o in ("additive", "scaling") for s in (None, "linear", "constant")]
PHYS = dict(body_mass=dr.NoiseSpec("uniform", "scaling", (0.8, 1.2)),
            friction=dr.NoiseSpec("uniform", "scaling", (0.5, 1.5)),
            dof_damping=dr.NoiseSpec("gaussian", "scaling", (1.0, 0.2)),
            armature=dr.NoiseSpec("uniform", "scaling", (0.5, 2.0)),
            pd_gains=dr.NoiseSpec("uniform", "scaling", (0.7, 1.3)),
            gravity=dr.NoiseSpec("uniform", "scaling", (0.9, 1.1)))
NOISE = dict(observations=dr.NoiseSpec("gaussian", "additive", (0.0, 0.01)),
             actions=dr.NoiseSpec("uniform", "additive", (-0.05, 0.05)))


def _z(key, shape, spec):
    """JAX's standard draws behind one _sample of `spec` from `key`."""
    if spec.distribution == "gaussian":
        return jax.random.normal(key, shape, jnp.float64)
    return jax.random.uniform(key, shape, jnp.float64)


@pytest.mark.parametrize("kw", SPECS, ids=lambda kw: "-".join(
    str(kw[k]) for k in ("distribution", "operation", "schedule")))
def test_schedule_and_noise_match_jax(kw):
    spec_t, spec_j = dr.NoiseSpec(**kw), jax_dr.NoiseSpec(**kw)
    steps = np.asarray([0, 5, 20], np.int32)
    for s in steps:
        assert float(dr.schedule_scaling(spec_t, int(s))) == float(
            jax_dr.schedule_scaling(spec_j, int(s)))
    keys = jax.random.split(jax.random.PRNGKey(3), 2 * B)
    x = np.random.RandomState(0).randn(B, 5)
    corr = jax.vmap(lambda k, s: jax_dr.sample_correlated(k, (5,), spec_j, s, jnp.float64))(
        keys[B:], jnp.asarray(steps))
    ref = jax.vmap(lambda k, x_, s, c: jax_dr.apply_noise(k, x_, spec_j, s, c))(
        keys[:B], jnp.asarray(x), jnp.asarray(steps), corr)
    z_c = jax.vmap(lambda k: _z(k, (5,), spec_j))(keys[B:])
    z = jax.vmap(lambda k: _z(k, (5,), spec_j))(keys[:B])
    corr_t = dr.sample_correlated(None, (B, 5), spec_t, torch.as_tensor(steps), z=T(z_c))
    assert rel_err(corr, corr_t) < 1e-15
    got = dr.apply_noise(None, T(x), spec_t, torch.as_tensor(steps), corr_t, z=T(z))
    assert rel_err(ref, got) < 1e-15


def _jax_factors(keys, jm, cfg):
    """JAX randomize_model's per-field factors, drawn as it draws them."""
    def one(key):
        ks = jax.random.split(key, 6)
        s = lambda k, shape, spec: jax_dr._sample(k, shape, spec, jax_dr.schedule_scaling(spec, 0),
                                                  False, jnp.float64)
        return dict(body_mass=s(ks[0], jm.body_mass.shape, cfg.body_mass),
                    geom_friction=s(ks[1], jm.geom_friction.shape, cfg.friction),
                    floor_friction=s(ks[1], jm.floor_friction.shape, cfg.friction),
                    dof_damping=s(ks[2], jm.dof_damping.shape, cfg.dof_damping),
                    armature=s(ks[3], jm.armature.shape, cfg.armature),
                    pd_gains=s(ks[4], jm.jkp.shape, cfg.pd_gains),
                    gravity=s(ks[5], jm.gravity.shape, cfg.gravity))
    return {k: T(v) for k, v in jax.vmap(one)(keys).items()}


@pytest.fixture(scope="module")
def realization():
    jm, tm = models()
    kw = {k: jax_dr.NoiseSpec(**dataclasses.asdict(v)) for k, v in PHYS.items()}
    cfg_j = jax_dr.DomainRandConfig(**kw)
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    jmodel = jax.vmap(lambda k: jax_dr.randomize_model(k, jm, cfg_j))(keys)
    tmodel = dr.randomize_model(None, tm, dr.DomainRandConfig(**PHYS), B,
                                factors=_jax_factors(keys, jm, cfg_j))
    return jm, tm, jmodel, tmodel


def test_randomize_model_matches_jax(realization):
    jm, tm, jmodel, tmodel = realization
    assert tmodel.stacked and tmodel.num_stacked == B
    for f in ARRAY_FIELDS:
        ref = np.asarray(getattr(jmodel, f))
        got = getattr(tmodel, f)
        if ref.ndim == np.asarray(getattr(jm, f)).ndim:      # not mapped: shared
            ref = np.broadcast_to(ref, got.shape)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f)
    # the realizations differ between envs, and mass and inertia scale together
    assert float((tmodel.body_mass[0] - tmodel.body_mass[1]).abs().max()) > 1e-3
    r = tmodel.body_mass / tm.body_mass
    assert torch.allclose(tmodel.body_inertia, tm.body_inertia * r[..., None, None], rtol=1e-15)
    assert torch.allclose(tmodel.jkp / tm.jkp, tmodel.jkd / tm.jkd, rtol=1e-15)


def test_domain_rand_step_matches_jax(realization, monkeypatch):
    jm, tm, jmodel, tmodel = realization
    scfg = dict(control_frequency_inv=CFI, episode_length=300)
    env_t = HumanoidSpeed(tm, SpeedConfig(**scfg))
    env_j = jax_tasks.HumanoidSpeed(jm, jax_tasks.SpeedConfig(**scfg))
    noise_j = {k: jax_dr.NoiseSpec(**dataclasses.asdict(v)) for k, v in NOISE.items()}
    dr_t = dr.DomainRandEnv(env_t, dr.DomainRandConfig(**PHYS, **NOISE))
    dr_j = jax_dr.DomainRandEnv(env_j, jax_dr.DomainRandConfig(**noise_j))

    qpos, qvel, act = states(jm, B, "air", seed=9)
    qpos[2], qvel[2] = (x[0] for x in states(jm, 1, "contact", seed=9)[:2])
    s = env_t.reset(B, torch.Generator().manual_seed(0), tmodel)
    phys = engine.PhysicsState(T(qpos), T(qvel))
    task = dataclasses.replace(s.task, change_step=torch.full((B,), 10**6, dtype=torch.int32))
    kin = engine.kinematics.fk(tmodel, phys.qpos)
    inner = dataclasses.replace(s, phys=phys, task=task, kin=kin,
                                pd_cache=env_t._fresh_cache(phys, tmodel),
                                cur_t=torch.tensor([0, 4, 9], dtype=torch.int32))
    rng = np.random.RandomState(4)
    corr_obs, corr_act = T(rng.randn(B, env_t.obs_size) * 0.01), T(rng.randn(B, tm.nu) * 0.01)
    st = dr.DRState(inner=inner, model=tmodel, corr_obs=corr_obs, corr_act=corr_act,
                    resets=torch.zeros(B, dtype=torch.int32),
                    step_count=torch.tensor([0, 4, 9], dtype=torch.int32))

    keys = jax.random.split(jax.random.PRNGKey(8), B)
    J = lambda x: jnp.asarray(x.numpy())
    z, f = jnp.zeros(B, jnp.float64), jnp.zeros(B, bool)
    inner_j = jax_base.EnvState(
        phys=jax_engine.PhysicsState(J(phys.qpos), J(phys.qvel)), obs=J(s.obs), reward=z,
        terminated=f, truncated=f, cur_t=J(inner.cur_t), rng=keys,
        task=jax_tasks.SpeedTask(J(task.tar_speed), J(task.change_step), J(task.prev_root_pos)),
        info={"power": z, "nactive": jnp.zeros(B, jnp.int32), "overflow": f, "stalled": f},
        pd_cache=tuple(J(x) for x in inner.pd_cache), kin=None)
    sj = jax_dr.DRState(inner=inner_j, model=jmodel, corr_obs=J(corr_obs), corr_act=J(corr_act),
                        resets=jnp.zeros(B, jnp.int32), step_count=J(st.step_count))
    out_j = jax.jit(jax.vmap(dr_j.step))(sj, jnp.asarray(act))

    # JAX's action and observation draws, from the keys its step folds
    def draws(rng):
        k_act, k_obs = jax.random.split(jax.random.fold_in(rng, 17))
        return (_z(k_act, (tm.nu,), NOISE["actions"]),
                _z(k_obs, (env_t.obs_size,), NOISE["observations"]))
    fed = [T(x) for x in jax.vmap(draws)(keys)]
    monkeypatch.setattr(dr, "standard_draws", lambda g, shape, spec, dtype, device: fed.pop(0))
    out = dr_t.step(st, T(act))
    assert not fed
    for name, r, v in (("qpos", out_j.inner.phys.qpos, out.inner.phys.qpos),
                       ("qvel", out_j.inner.phys.qvel, out.inner.phys.qvel),
                       ("obs", out_j.inner.obs, out.inner.obs),
                       ("reward", out_j.inner.reward, out.inner.reward),
                       ("power", out_j.inner.info["power"], out.inner.info["power"]),
                       *((f"cache{i}", a, b) for i, (a, b) in
                         enumerate(zip(out_j.inner.pd_cache, out.inner.pd_cache)))):
        assert rel_err(r, v) < 1e-9, (name, rel_err(r, v))
    for name in ("terminated", "truncated", "cur_t"):
        np.testing.assert_array_equal(np.asarray(getattr(out_j.inner, name)),
                                      getattr(out.inner, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(out_j.step_count), out.step_count.numpy())
    assert out.inner.terminated.tolist() == [False, False, True]
    # the realization acted: the same step on the env's own model differs
    plain = env_t.step(inner, T(act))
    assert (plain.phys.qpos - out.inner.phys.qpos).abs().max() > 1e-6


def test_redraw_gate():
    """episode_length 0 finishes every env every step: with frequency 2 the
    realization is kept at the first reset and redrawn at the second."""
    _, tm = models()
    env = HumanoidSpeed(tm, SpeedConfig(control_frequency_inv=1, episode_length=0))
    denv = dr.DomainRandEnv(env, dr.DomainRandConfig(frequency=2, body_mass=PHYS["body_mass"]))
    g = torch.Generator().manual_seed(2)
    s0 = denv.reset(B, g)
    a = torch.zeros(B, tm.nu, dtype=torch.float64)
    s1 = denv.step_autoreset(s0, a)
    s2 = denv.step_autoreset(s1, a)
    assert s1.inner.done.all() and s2.inner.done.all()
    assert s1.resets.tolist() == [1] * B and s2.resets.tolist() == [2] * B
    assert torch.equal(s1.model.body_mass, s0.model.body_mass)
    assert ((s2.model.body_mass - s1.model.body_mass).abs().amax(1) > 1e-6).all()
    assert s2.step_count.tolist() == [2] * B and s2.inner.cur_t.tolist() == [0] * B


def test_unit_factors_give_the_undisturbed_env():
    _, tm = models()
    one = dr.NoiseSpec("uniform", "scaling", (1.0, 1.0))
    cfg = dr.DomainRandConfig(**{k: one for k in PHYS})
    env = HumanoidSpeed(tm, SpeedConfig(control_frequency_inv=CFI))
    denv = dr.DomainRandEnv(env, cfg)
    s = denv.reset(B, torch.Generator().manual_seed(6))
    for f in ARRAY_FIELDS:
        assert torch.equal(getattr(s.model, f), getattr(tm, f).expand_as(getattr(s.model, f)))
    ref = env.reset(B, torch.Generator().manual_seed(6))
    qpos, qvel, act = states(tm, B, "air", seed=1)
    phys = engine.PhysicsState(T(qpos), T(qvel))
    # the wrapper's reset drew the realization first: its task draws differ
    s = dataclasses.replace(s, inner=dataclasses.replace(
        s.inner, phys=phys, kin=engine.kinematics.fk(tm, phys.qpos), task=ref.task,
        pd_cache=env._fresh_cache(phys)))
    ref = dataclasses.replace(ref, phys=phys, kin=s.inner.kin, pd_cache=s.inner.pd_cache)
    out, want = denv.step(s, T(act)), env.step(ref, T(act))
    for r, v in ((want.phys.qpos, out.inner.phys.qpos), (want.phys.qvel, out.inner.phys.qvel),
                 (want.obs, out.inner.obs), (want.reward, out.inner.reward),
                 (want.pd_cache[0], out.inner.pd_cache[0])):
        assert rel_err(r.numpy(), v) < 1e-9
    assert isinstance(out.inner.task, SpeedTask)
