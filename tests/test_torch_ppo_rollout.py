"""The port's PPO iterations, rollout and update, against the JAX trainer's
on HumanoidSpeed, with every draw passed in.

The JAX iteration is its own `_rollout` (jitted) followed by `train_step`
with `_rollout` replaced on the instance by one that returns that rollout,
so the JAX env is compiled once. Both sides get:

- the actions' noise: the standard normals JAX's `sample_action` draws
  from each step's key, fed to the port's rollout in place of its
  generator's draws;
- the env's draws: the speed task's `_sample` is replaced on both env
  instances by one function of cur_t (the target cycles through the
  speed range, a resample every CHANGE control steps), and the Default
  init draws nothing;
- the minibatch permutations of JAX's `k_perm`, passed to `update(perms=)`.

The envs start at different cur_t, so inside the window some truncate and
are reset by step_autoreset. Trajectories, the env states after each
rollout, parameters and metrics agree within 1e-9 in float64.

The window is short on purpose. Under vmap the JAX package routes
capsule-box self-contacts to its lanes routine, which departs from its own
per-env routine on deep penetrations (ROADMAP.md §3); the port follows the
per-env routine. Over 16 control steps of 15 substeps (the script's
defaults) a flailing env meets such a contact within a few steps, and from
there the two trajectories part: the script then compares the curves, not
the numbers.

Run as a script for both trainers' learning curves over more epochs:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_ppo_rollout.py \\
        --epochs 20 --num-envs 32 --horizon 16 --cfi 15

It prints each epoch's reward_mean on both sides with their largest
differences (the trajectory by control step, the env states, the
parameters), then each side's mean reward of the last five epochs over the
first five.
"""
import argparse
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

jax.config.update("jax_enable_x64", True)

from _torch_port import models  # noqa: E402
from test_torch_learning import flat, port_flat  # noqa: E402
from smplsim_tpu.envs import tasks as jax_tasks  # noqa: E402
from smplsim_tpu.learning.ppo import PPO as JPPO  # noqa: E402
from smplsim_tpu.learning.ppo import PPOConfig as JPPOConfig  # noqa: E402
from smplsim_tpu_torch.envs import HumanoidSpeed, SpeedConfig  # noqa: E402
from smplsim_tpu_torch.learning import nets as tnets  # noqa: E402
from smplsim_tpu_torch.learning import ppo as tppo_mod  # noqa: E402
from smplsim_tpu_torch.learning.ppo import PPO, PPOConfig, TrainState  # noqa: E402
from smplsim_tpu_torch.learning.running_norm import RunningNorm  # noqa: E402

TOL = 1e-9
LO, HI = 0.0, 5.0       # SpeedConfig's target range


def _jax_sample(change):
    def sample(key, task, cur_t):
        u = jnp.mod(0.37 * cur_t.astype(jnp.float64) + 0.21, 1.0)
        return task.replace(tar_speed=(LO + (HI - LO) * u).astype(task.tar_speed.dtype),
                            change_step=(cur_t + change).astype(jnp.int32))
    return sample


def _port_sample(change):
    def sample(generator, task, cur_t):
        u = torch.remainder(0.37 * cur_t.to(torch.float64) + 0.21, 1.0)
        return dataclasses.replace(task, tar_speed=(LO + (HI - LO) * u).to(task.tar_speed.dtype),
                                   change_step=(cur_t + change).to(torch.int32))
    return sample


def rel(ref, val) -> float:
    r = np.asarray(ref, np.float64)
    v = val.detach().cpu().numpy().astype(np.float64)
    assert r.shape == v.shape, (r.shape, v.shape)
    return float(np.max(np.abs(r - v) / (1.0 + np.abs(r)))) if r.size else 0.0


def iterations(epochs, num_envs, horizon, cfi, episode_length, change, widths,
               opt_num_epochs, num_minibatches, seed=0):
    """Both trainers side by side, one PPO iteration per yield: a dict of
    both sides' metrics and the largest differences (relative to 1 + |JAX|)
    in the trajectory, the env states and the parameters."""
    jm, tm = models(jnp.float64)
    ecfg = dict(control_frequency_inv=cfi, episode_length=episode_length)
    env_j = jax_tasks.HumanoidSpeed(jm, jax_tasks.SpeedConfig(**ecfg))
    env_t = HumanoidSpeed(tm, SpeedConfig(**ecfg))
    env_j._sample, env_t._sample = _jax_sample(change), _port_sample(change)
    kw = dict(horizon=horizon, num_envs=num_envs, opt_num_epochs=opt_num_epochs,
              num_minibatches=num_minibatches, policy_widths=widths, value_widths=widths)
    jppo, tppo = JPPO(env_j, JPPOConfig(**kw)), PPO(env_t, PPOConfig(**kw))
    cfg = tppo.cfg
    cur_t0 = np.arange(num_envs) * 2 % (episode_length + 1)

    # the JAX state, params in float64, the envs at cur_t0
    ts = jppo.init(jax.random.PRNGKey(seed))
    f64 = lambda tree: jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree)
    pp, vp = f64(ts.policy_params), f64(ts.value_params)
    rng = np.random.RandomState(seed + 1)
    obs_n = env_t.obs_size
    norm_np = dict(n=np.asarray(40.0), mean=rng.randn(obs_n) * 0.3, var=rng.rand(obs_n) + 0.5)
    ts = ts.replace(policy_params=pp, value_params=vp, policy_opt=jppo.policy_tx.init(pp),
                    value_opt=jppo.value_tx.init(vp),
                    obs_norm=type(ts.obs_norm)(**{k: jnp.asarray(v) for k, v in norm_np.items()}),
                    env_states=ts.env_states.replace(cur_t=jnp.asarray(cur_t0, jnp.int32)))
    roll = jax.jit(jppo._rollout)
    jppo._rollout = lambda ts_, key: ts_.env_states      # (env_states, traj), passed in
    train_step = jax.jit(jppo.train_step)

    # the port's state: the same weights, norm and envs
    policy = tnets.load_flax_params(
        tnets.PolicyGaussian(obs_n, env_t.action_size, widths).double(), jax.device_get(pp))
    value = tnets.load_flax_params(tnets.ValueNet(obs_n, widths).double(), jax.device_get(vp))
    st0 = env_t.reset(num_envs, torch.Generator().manual_seed(seed))
    tts = TrainState(
        policy=policy, value=value,
        policy_opt=torch.optim.Adam(policy.parameters(), lr=cfg.policy_lr, eps=1e-8),
        value_opt=torch.optim.Adam(value.parameters(), lr=cfg.value_lr, eps=1e-8),
        obs_norm=RunningNorm(**{k: torch.as_tensor(v) for k, v in norm_np.items()}),
        env_states=dataclasses.replace(st0, cur_t=torch.as_tensor(cur_t0, dtype=torch.int32)),
        generator=torch.Generator().manual_seed(seed), epoch=0)

    noise = []
    sample = lambda generator, mean, log_std: mean + torch.exp(log_std) * noise.pop(0)
    for _ in range(epochs):
        k_roll, k_perm, _ = jax.random.split(ts.rng, 3)
        t0 = time.perf_counter()
        jenv, jtraj = roll(ts, k_roll)
        ts, j_met = train_step(ts.replace(env_states=(jenv, jtraj)))
        jax.block_until_ready(ts)
        j_sec = time.perf_counter() - t0

        noise[:] = [torch.as_tensor(np.array(jax.random.normal(
            k, (num_envs, env_t.action_size), jnp.float64))) for k in jax.random.split(
                k_roll, horizon)]
        perms = torch.as_tensor(np.stack([np.asarray(jax.random.permutation(
            k, horizon * num_envs)) for k in jax.random.split(k_perm, opt_num_epochs)]))
        t0 = time.perf_counter()
        drawn, tppo_mod.sample_action = tppo_mod.sample_action, sample
        try:
            tenv, ttraj = tppo.rollout(tts)
        finally:
            tppo_mod.sample_action = drawn
        assert not noise
        tts, t_met = tppo.update(tts, tenv, ttraj, perms=perms)
        t_sec = time.perf_counter() - t0

        traj_err = {k: rel(jtraj[k], ttraj[k]) for k in jtraj}
        step_err = [max(rel(jtraj[k][t], ttraj[k][t]) for k in ("obs", "reward"))
                    for t in range(horizon)]
        done_differs = int((np.asarray(jtraj["done"]) != ttraj["done"].numpy()).sum())
        env_err = {k: rel(r, v) for k, (r, v) in {
            "qpos": (jenv.phys.qpos, tenv.phys.qpos), "qvel": (jenv.phys.qvel, tenv.phys.qvel),
            "obs": (jenv.obs, tenv.obs), "cur_t": (jenv.cur_t, tenv.cur_t),
            "tar_speed": (jenv.task.tar_speed, tenv.task.tar_speed),
            "change_step": (jenv.task.change_step, tenv.task.change_step)}.items()}
        param_err = max(
            max(rel(ref[k], torch.as_tensor(port[k])) for k in ref)
            for ref, port in ((flat(jax.device_get(ts.policy_params)["params"]),
                               port_flat(tts.policy)),
                              (flat(jax.device_get(ts.value_params)["params"]),
                               port_flat(tts.value))))
        yield dict(epoch=int(ts.epoch), jax=jax.device_get(j_met),
                   port={k: float(v) for k, v in t_met.items()},
                   traj_err=traj_err, step_err=step_err, done_differs=done_differs,
                   env_err=env_err, param_err=param_err,
                   done=int(np.asarray(jtraj["done"]).sum()), jax_sec=j_sec, port_sec=t_sec)


def test_ppo_iterations_match_jax_with_the_draws_passed_in():
    """Two iterations of 4 envs x 4 control steps of 2 substeps, envs at
    cur_t 0, 2, 4 and 6 of episode_length 5 (so three truncate and reset
    inside the windows), a task resample every 2 steps, widths (16, 16),
    2 epochs x 2 minibatches."""
    seen = list(iterations(epochs=2, num_envs=4, horizon=4, cfi=2, episode_length=5, change=2,
                           widths=(16, 16), opt_num_epochs=2, num_minibatches=2))
    assert [it["epoch"] for it in seen] == [1, 2]
    assert sum(it["done"] for it in seen) >= 3
    for it in seen:
        assert max(it["traj_err"].values()) <= TOL, it["traj_err"]
        assert max(it["env_err"].values()) <= TOL, it["env_err"]
        assert it["param_err"] <= TOL
        assert set(it["jax"]) == set(it["port"])
        for k, v in it["jax"].items():
            assert abs(float(v) - it["port"][k]) <= TOL * (1.0 + abs(float(v))), k


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--num-envs", type=int, default=32)
    ap.add_argument("--horizon", type=int, default=16)
    ap.add_argument("--cfi", type=int, default=15)
    ap.add_argument("--episode-length", type=int, default=300)
    ap.add_argument("--change", type=int, default=150)
    ap.add_argument("--widths", type=str, default="256,256")
    ap.add_argument("--opt-epochs", type=int, default=10)
    ap.add_argument("--minibatches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    torch.set_num_threads(1)
    rows = []
    for it in iterations(a.epochs, a.num_envs, a.horizon, a.cfi, a.episode_length, a.change,
                         tuple(int(w) for w in a.widths.split(",")), a.opt_epochs,
                         a.minibatches, a.seed):
        rows.append((float(it["jax"]["reward_mean"]), it["port"]["reward_mean"]))
        print(f"epoch {it['epoch']}: reward_mean JAX {rows[-1][0]:.9f} port {rows[-1][1]:.9f}; "
              f"max diff: trajectory {max(it['traj_err'].values()):.3e} (by control step: "
              f"{' '.join(f'{e:.1e}' for e in it['step_err'])}), env states "
              f"{max(it['env_err'].values()):.3e}, parameters {it['param_err']:.3e}; "
              f"{it['done']} episodes ended, {it['done_differs']} ends on one side only; "
              f"seconds JAX {it['jax_sec']:.2f} port "
              f"{it['port_sec']:.2f}", flush=True)
    if len(rows) >= 10:
        r = np.asarray(rows)
        ratio = r[-5:].mean(0) / r[:5].mean(0)
        print(f"reward_mean, last 5 epochs over first 5: JAX {ratio[0]:.4f}, port {ratio[1]:.4f}")


if __name__ == "__main__":
    main()
