"""PPO on batched envs (port of smplsim_tpu/learning/ppo.py).

One iteration is `rollout` then `update`. The rollout steps the env's
`step_autoreset` `horizon` times on the whole batch and keeps the (T, B, ...)
trajectory on the device; nothing is read back to the host. The update
takes the values under the current value net, GAE, the advantage
normalisation (population std), merges the trajectory's observations into
the running norm, then runs `opt_num_epochs` permutations of
`num_minibatches` slices, each one clipped-surrogate step on the policy and
one squared-error step on the value net. The minibatch losses normalise
with the statistics from before the iteration; the merged ones are stored
for the next.

The optimiser is optax's chain(clip_by_global_norm(max_grad_norm),
adam(lr)): torch.optim.Adam (eps 1e-8, betas 0.9/0.999) behind
`clip_by_global_norm`, optax's clip (scale by max_norm / norm only where
norm >= max_norm), over each net's parameters, log_std included.

With a process group (`update(group=)`, the JAX package's axis_name),
each rank updates from its own shard of the trajectory: every gradient is
averaged over the group before the clip, in one flattened all-reduce per
net and minibatch step, the running norm merges the group's moments, and
the six metrics are averaged over it (nactive_max too, as the JAX pmean
does). The advantage normalisation and the permutations stay per rank.
parallel/rollout.py composes the sharded step.

Spans (utils/profiler.py, live only under torch.profiler):
smplsim.learning.rollout with .policy inside, smplsim.learning.update with
.advantages (the values, GAE, the advantage normalisation and the norm
merge) and .minibatch (one policy step and one value step). Counters:
learning.minibatch_steps (net steps) and learning.grad_clipped (net steps
whose global norm reached max_grad_norm, a device tensor).

Hyperparameters mirror the JAX package's PPOConfig: gamma 0.99, tau 0.95,
clip 0.2, 10 epochs x 4 minibatches, policy lr 5e-5, value lr 3e-4, fixed
log_std -2.5. The nets take the env model's dtype and device.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from smplsim_tpu_torch.envs.base import map_state
from smplsim_tpu_torch.learning.gae import estimate_advantages
from smplsim_tpu_torch.learning.nets import (PolicyGaussian, ValueNet, gaussian_log_prob,
                                             sample_action)
from smplsim_tpu_torch.learning.running_norm import (RunningNorm, norm_init, norm_update,
                                                     normalize)
from smplsim_tpu_torch.parallel.mesh import pmean
from smplsim_tpu_torch.utils.profiler import count, profiling, span


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    horizon: int = 32            # control steps per env per iteration
    num_envs: int = 1024
    gamma: float = 0.99
    tau: float = 0.95
    clip_epsilon: float = 0.2
    opt_num_epochs: int = 10
    num_minibatches: int = 4
    policy_lr: float = 5e-5
    value_lr: float = 3e-4
    max_grad_norm: float = 50.0
    policy_widths: tuple = (2048, 1536, 1024, 1024, 512, 512)
    value_widths: tuple = (2048, 1536, 1024, 1024, 512, 512)
    activation: str = "silu"
    log_std: float = -2.5
    obs_clip: float = 5.0


@dataclasses.dataclass
class TrainState:
    """The trainer's state. The nets and optimisers are updated in place by
    `PPO.update`; `generator` (on the env's device) draws the actions'
    noise and the minibatch permutations; env_states carries the env's
    own generator."""

    policy: PolicyGaussian
    value: ValueNet
    policy_opt: torch.optim.Adam
    value_opt: torch.optim.Adam
    obs_norm: RunningNorm
    env_states: Any       # batched EnvState
    generator: torch.Generator
    epoch: int


def state_tensors(ts: TrainState, env: bool = True) -> list:
    """Every tensor of a TrainState, copied, in a fixed order: the
    trainer's generator state, both nets, both optimisers' states, the
    running norm and (env) the env states' tensors, generators as their
    state. Two states are the same bit for bit where these lists are."""
    out = [ts.generator.get_state()]
    for net in (ts.policy, ts.value):
        out += [t.detach().clone() for t in net.state_dict().values()]
    for opt in (ts.policy_opt, ts.value_opt):
        for st in opt.state_dict()["state"].values():
            out += [v.detach().clone() for v in st.values()]
    out += [ts.obs_norm.n.clone(), ts.obs_norm.mean.clone(), ts.obs_norm.var.clone()]
    if env:
        map_state(lambda x: out.append(x.get_state() if isinstance(x, torch.Generator)
                                       else x.clone()), ts.env_states)
    return out


def clip_by_global_norm(grads: list, max_norm: float) -> list:
    """optax.clip_by_global_norm: (g / norm) * max_norm where the global
    norm is >= max_norm, g unchanged below it; no host sync. Counter
    `learning.grad_clipped`: the calls whose norm reached max_norm."""
    g_norm = torch.sqrt(sum(g.square().sum() for g in grads))
    keep = g_norm < max_norm
    if profiling():
        count("learning.grad_clipped", ~keep)
    return [torch.where(keep, g, (g / g_norm) * max_norm) for g in grads]


class PPO:
    """PPO trainer bound to a batched env (envs.base API)."""

    def __init__(self, env, config: PPOConfig | None = None):
        self.env = env
        self.cfg = config or PPOConfig()

    def init(self, seed: int) -> TrainState:
        """Nets drawn from a CPU generator seeded with `seed` (the same
        weights on every device), then the trainer's and the env's
        generators seeded from it, and a reset of num_envs envs."""
        cfg, env, m = self.cfg, self.env, self.env.model
        g = torch.Generator().manual_seed(seed)
        policy = PolicyGaussian(env.obs_size, env.action_size, cfg.policy_widths, cfg.activation,
                                cfg.log_std, generator=g).to(device=m.device, dtype=m.dtype)
        value = ValueNet(env.obs_size, cfg.value_widths, cfg.activation,
                         generator=g).to(device=m.device, dtype=m.dtype)
        s_train, s_env = torch.randint(2 ** 62, (2,), generator=g).tolist()
        env_gen = torch.Generator(device=m.device).manual_seed(s_env)
        return TrainState(
            policy=policy, value=value,
            policy_opt=torch.optim.Adam(policy.parameters(), lr=cfg.policy_lr, eps=1e-8),
            value_opt=torch.optim.Adam(value.parameters(), lr=cfg.value_lr, eps=1e-8),
            obs_norm=norm_init(env.obs_size, m.dtype, m.device),
            env_states=env.reset(cfg.num_envs, env_gen),
            generator=torch.Generator(device=m.device).manual_seed(s_train),
            epoch=0,
        )

    @span("smplsim.learning.rollout")
    @torch.no_grad()
    def rollout(self, ts: TrainState):
        """(env_states, traj): `horizon` step_autoresets under the current
        policy; traj holds (T, B, ...) tensors obs, action, logp, reward,
        terminated, done, nactive, overflow, stalled."""
        cfg = self.cfg
        st = ts.env_states
        steps = []
        for _ in range(cfg.horizon):
            obs = st.obs
            with span("smplsim.learning.policy"):
                mean, log_std = ts.policy(normalize(ts.obs_norm, obs, cfg.obs_clip))
            action = sample_action(ts.generator, mean, log_std)
            logp = gaussian_log_prob(mean, log_std, action)
            st = self.env.step_autoreset(st, action.clamp(-1.0, 1.0))
            steps.append(dict(obs=obs, action=action, logp=logp, reward=st.reward,
                              terminated=st.terminated, done=st.done,
                              nactive=st.info["nactive"], overflow=st.info["overflow"],
                              stalled=st.info["stalled"]))
        return st, {k: torch.stack([s[k] for s in steps]) for k in steps[0]}

    def _apply(self, loss: torch.Tensor, net: torch.nn.Module, opt: torch.optim.Adam,
               group=None) -> None:
        """One clipped Adam step of `net` on `loss`. A parameter that gets
        no gradient (a fixed log_std) gets a zero one, so Adam keeps a
        state for every parameter, as optax does. group: the gradients are
        first averaged over its ranks."""
        params = list(net.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if group is not None:
            flat = pmean(torch.cat([g.reshape(-1) for g in grads]), group)
            grads = [g.view_as(p) for g, p in zip(flat.split([p.numel() for p in params]),
                                                   params)]
        for p, g in zip(params, clip_by_global_norm(grads, self.cfg.max_grad_norm)):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
        count("learning.minibatch_steps", 1)

    @span("smplsim.learning.update")
    def update(self, ts: TrainState, env_states, traj: dict, perms: torch.Tensor | None = None,
               group=None):
        """The update half of a PPO iteration on a rollout's trajectory.
        perms: optional (opt_num_epochs, n) permutations of the n = T * B
        samples; without it they are drawn from ts.generator. group: a
        process group whose every rank calls update on its own (T, B)
        shard (see the module docstring). Returns the next TrainState
        (epoch + 1) and six 0-d metric tensors."""
        cfg = self.cfg
        with torch.no_grad(), span("smplsim.learning.advantages"):
            nobs_t = normalize(ts.obs_norm, traj["obs"], cfg.obs_clip)
            values = ts.value(nobs_t)                                          # (T, B)
            last_value = ts.value(normalize(ts.obs_norm, env_states.obs, cfg.obs_clip))
            dtype = values.dtype
            adv, ret = estimate_advantages(
                traj["reward"], values, last_value, 1.0 - traj["done"].to(dtype),
                1.0 - traj["terminated"].to(dtype), cfg.gamma, cfg.tau)
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
            nobs = nobs_t.reshape(-1, nobs_t.shape[-1])
            action = traj["action"].reshape(-1, traj["action"].shape[-1])
            logp_old, adv, ret = traj["logp"].reshape(-1), adv.reshape(-1), ret.reshape(-1)
            n = logp_old.shape[0]
            obs_norm = norm_update(ts.obs_norm, traj["obs"].reshape(nobs.shape), group)
        if perms is None:
            perms = torch.stack([torch.randperm(n, generator=ts.generator, device=nobs.device)
                                 for _ in range(cfg.opt_num_epochs)])
        mb = n // cfg.num_minibatches
        for perm in perms:
            for i in range(cfg.num_minibatches):
                with span("smplsim.learning.minibatch"):
                    idx = perm[i * mb:(i + 1) * mb]
                    mean, log_std = ts.policy(nobs[idx])
                    ratio = torch.exp(gaussian_log_prob(mean, log_std, action[idx])
                                      - logp_old[idx])
                    a = adv[idx]
                    surr = torch.minimum(
                        ratio * a, ratio.clamp(1.0 - cfg.clip_epsilon, 1.0 + cfg.clip_epsilon) * a)
                    self._apply(-surr.mean(), ts.policy, ts.policy_opt, group)
                    self._apply((ts.value(nobs[idx]) - ret[idx]).square().mean(), ts.value,
                                ts.value_opt, group)
        metrics = {
            "reward_mean": traj["reward"].mean(),
            "episode_done_frac": traj["done"].to(dtype).mean(),
            "value_mean": values.mean(),
            # constraint-solver health: env-steps whose compact solve dropped
            # rows and whose QP stopped at its cap, and the deepest row count
            "efc_overflow_frac": traj["overflow"].to(dtype).mean(),
            "qp_stalled_frac": traj["stalled"].to(dtype).mean(),
            "nactive_max": traj["nactive"].max().to(dtype),
        }
        if group is not None:
            metrics = dict(zip(metrics, pmean(torch.stack(list(metrics.values())), group)))
        return dataclasses.replace(ts, obs_norm=obs_norm, env_states=env_states,
                                   epoch=ts.epoch + 1), metrics
