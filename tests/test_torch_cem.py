"""The port's CEM planner (smplsim_tpu_torch/control/cem.py).

Against the JAX planner with one analytic cost on both sides (no env is
compiled) and the same standard normals: the samples of every iteration
(which pin each iteration's mean and std), the final mean and the best
cost. Then on a tiny port env, as tests/test_control.py:92-107 checks the
JAX planner: CEM beats the zero policy, a plan leaves the env's generator
where it was, and a receding-horizon loop runs.
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import rel_err
from smplsim_tpu.control.cem import CEMConfig as JCEMConfig
from smplsim_tpu.control.cem import CEMPlanner as JCEMPlanner
from smplsim_tpu_torch.control import CEMConfig, CEMPlanner
from smplsim_tpu_torch.envs import GetupConfig, HumanoidGetup, HumanoidSpeed, SpeedConfig
from smplsim_tpu_torch.models import registry

NU, H = 5, 4


class Phys(NamedTuple):
    qpos: jax.Array


class State(NamedTuple):
    phys: Phys


class StubEnv:
    action_size = NU


@pytest.mark.parametrize("dtype,warm", [(np.float64, False), (np.float64, True),
                                        (np.float32, False)])
def test_cem_plan_matches_jax_on_an_analytic_cost(dtype, warm):
    kw = dict(horizon=H, num_samples=24, num_elites=5, iterations=3, init_std=0.6)
    rng = np.random.RandomState(0)
    target = rng.uniform(-1.2, 1.2, (H, NU)).astype(dtype)    # partly outside the clip
    weight = rng.uniform(0.5, 2.0, (H, NU)).astype(dtype)
    mean0 = rng.uniform(-0.3, 0.3, (H, NU)).astype(dtype) if warm else None

    recorded = []

    def j_cost(state, a):      # one sample (H, nu); vmapped by the planner
        jax.debug.callback(lambda x: recorded.append(np.asarray(x)), a)
        return jnp.sum(jnp.asarray(weight) * (a - jnp.asarray(target)) ** 2)

    jplanner = JCEMPlanner(StubEnv(), JCEMConfig(**kw))
    jplanner._rollout_cost = j_cost
    key = jax.random.PRNGKey(3)
    jstate = State(Phys(jnp.zeros((1, 3), dtype)))
    j_a0, j_mean, j_best = jplanner.plan(key, jstate, None if mean0 is None
                                         else jnp.asarray(mean0))
    jax.block_until_ready(j_mean)
    eps = np.stack([np.asarray(jax.random.normal(k, (kw["num_samples"], H, NU), dtype))
                    for k in jax.random.split(key, kw["iterations"])])

    t_samples = []

    def t_cost(state, a):      # the whole batch (N, H, nu)
        t_samples.append(a.clone())
        return (torch.as_tensor(weight) * (a - torch.as_tensor(target)) ** 2).sum((1, 2))

    planner = CEMPlanner(StubEnv(), CEMConfig(**kw))
    planner._rollout_cost = t_cost
    tstate = State(Phys(torch.zeros((1, 3), dtype=torch.as_tensor(target).dtype)))
    t_a0, t_mean, t_best = planner.plan(
        tstate, None if mean0 is None else torch.as_tensor(mean0), eps=torch.as_tensor(eps))

    tol = 1e-9 if dtype == np.float64 else 5e-3
    # the vmapped callback sees the samples in no fixed order: compare each
    # iteration's samples as a set, rows sorted lexicographically
    def rows(x):
        x = np.asarray(x, np.float64).reshape(kw["iterations"], kw["num_samples"], H * NU)
        return np.stack([it[np.lexsort(it.T[::-1])] for it in x])

    assert rel_err(rows(np.stack(recorded)), rows(torch.stack(t_samples).numpy())) <= tol
    assert rel_err(j_mean, t_mean) <= tol and rel_err(j_a0, t_a0) <= tol
    assert rel_err(np.asarray(j_best)[None], t_best[None]) <= tol
    assert t_mean.dtype == torch.as_tensor(target).dtype


@pytest.fixture(scope="module")
def model():
    return registry.default_humanoid(torch.float32, device="cpu")


def test_cem_beats_zero_policy(model):
    env = HumanoidGetup(model, GetupConfig(control_frequency_inv=3))
    planner = CEMPlanner(env, CEMConfig(horizon=3, num_samples=32, num_elites=4, iterations=2))
    st = env.reset(1, torch.Generator().manual_seed(0))
    a0, mean, best = planner.plan(st, generator=torch.Generator().manual_seed(1))
    zero_cost = planner._rollout_cost(st, torch.zeros(1, 3, env.action_size))
    assert float(best) <= float(zero_cost[0]) + 1e-6
    assert a0.shape == (env.action_size,) and mean.shape == (3, env.action_size)
    assert float(a0.abs().max()) <= 1.0


def test_plan_leaves_the_env_generator_and_receding_horizon_runs(model):
    env = HumanoidSpeed(model, SpeedConfig(control_frequency_inv=2))
    gen = torch.Generator().manual_seed(0)
    st = env.reset(1, gen)
    before = gen.get_state().clone()
    planner = CEMPlanner(env, CEMConfig(horizon=2, num_samples=4, num_elites=2, iterations=1))
    samples = torch.Generator().manual_seed(1)
    planner.plan(st, generator=samples)
    assert torch.equal(gen.get_state(), before)
    assert not torch.equal(samples.get_state(), torch.Generator().manual_seed(1).get_state())
    # control: stepping the env itself draws from its generator
    env.step(st, torch.zeros(1, env.action_size))
    assert not torch.equal(gen.get_state(), before)
    with pytest.raises(ValueError):
        planner.plan(st)

    final, rews, costs = planner.receding_horizon(env.reset(1, gen), 2, samples)
    assert rews.shape == (2,) and costs.shape == (2,)
    assert bool(torch.isfinite(rews).all() & torch.isfinite(costs).all())
    assert int(final.cur_t[0]) == 2


def test_every_candidate_sees_the_same_task_draw(model):
    """A task resample inside the horizon draws one target for all the
    candidates, as the JAX planner's rollouts, vmapped with the state and
    its key shared, do: with the same actions in every row the costs tie
    (to float32 rounding: the batched products need not be bitwise equal
    by row)."""
    env = HumanoidSpeed(model, SpeedConfig(control_frequency_inv=2))
    st = env.reset(1, torch.Generator().manual_seed(0))
    st.task.change_step[:] = 1                 # due at the second of 3 steps
    seen = []
    update = env.update_task

    def recording(gen, task, cur_t):
        out = update(gen, task, cur_t)
        seen.append((cur_t.clone(), out.tar_speed.clone(), out.change_step.clone()))
        return out

    env.update_task = recording
    planner = CEMPlanner(env, CEMConfig(horizon=3, num_samples=6, num_elites=2, iterations=1))
    costs = planner._rollout_cost(st, torch.full((6, 3, env.action_size), 0.3))
    assert all(bool((v == v[:1]).all()) for _, *vals in seen for v in vals)
    tar = [float(s[0]) for t, s, _ in seen if t.numel() == 6]
    assert len(tar) == 3 and tar[0] == float(st.task.tar_speed[0]) and tar[1] != tar[0]
    assert float(costs.max() - costs.min()) <= 1e-5 * float(costs.abs().max())
