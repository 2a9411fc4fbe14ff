"""Cross-entropy-method MPC over the batched env (port of
smplsim_tpu/control/cem.py).

N candidate action sequences roll out as one batch: the batch-1 state is
repeated N times and `env.step` steps all of them, H control steps of the
env's physics; elites are the num_elites cheapest (cost = -sum of reward;
termination is absorbing), and the sampling distribution is refit from
them (population std, alpha smoothing, min_std) for a fixed number of
iterations.

The rollouts step a clone of the state's generator, so planning leaves the
env's generator where it was, as the JAX planner leaves its state.

With a process group (`plan(group=)`, the JAX planner's axis_name) each
rank rolls out its own num_samples candidates from the same state; the
costs (N,) and actions (N, H, nu) of all ranks are gathered in rank order,
and the elites are the num_elites cheapest of them all by a stable sort, so
every rank refits the same mean and std bit for bit. The caller gives each
rank its own generator or eps (fold_in(generator, rank), parallel/mesh.py).
"""
from __future__ import annotations

import dataclasses

import torch

from smplsim_tpu_torch.envs.base import EnvState, HumanoidEnv, clone_generator, map_state
from smplsim_tpu_torch.parallel.mesh import all_gather


@dataclasses.dataclass(frozen=True)
class CEMConfig:
    horizon: int = 8            # control steps per rollout (each = 15 substeps)
    num_samples: int = 128      # candidate action sequences
    num_elites: int = 16
    iterations: int = 3
    init_std: float = 0.5
    min_std: float = 0.05
    alpha: float = 0.1          # distribution smoothing (old <- new mix)


class CEMPlanner:
    """Plans in the env's action space, cost = -sum(reward)."""

    def __init__(self, env: HumanoidEnv, config: CEMConfig | None = None):
        self.env = env
        self.cfg = config or CEMConfig()

    @torch.no_grad()
    def _rollout_cost(self, state: EnvState, actions: torch.Tensor) -> torch.Tensor:
        """actions (N, H, nu) from the batch-1 state -> costs (N,).

        Every candidate sees the same task draws, as in the JAX planner,
        whose rollouts are vmapped with the state and its key shared: before
        each step the task is updated once, on row 0, and repeated over the
        rows, so the step's own update finds nothing due. The rows share
        cur_t and every task field that update_task and task_termination
        move (they start as one state and step never resets); the fields
        that differ by row are set from the row's own state in pre_physics."""
        n = actions.shape[0]
        rep = lambda x: x.repeat(n, *(1,) * (x.dim() - 1))
        st = map_state(lambda x: clone_generator(x) if isinstance(x, torch.Generator)
                       else rep(x), state)
        alive = torch.ones(n, dtype=actions.dtype, device=actions.device)
        total = torch.zeros_like(alive)
        for h in range(actions.shape[1]):
            task = self.env.update_task(st.rng, map_state(lambda x: x[:1], st.task),
                                        st.cur_t[:1])
            st = dataclasses.replace(st, task=map_state(rep, task))
            st = self.env.step(st, actions[:, h])
            total = total + st.reward * alive
            alive = alive * (1.0 - st.terminated.to(alive.dtype))
        return -total

    def plan(self, state: EnvState, mean: torch.Tensor | None = None,
             generator: torch.Generator | None = None, eps: torch.Tensor | None = None,
             group=None):
        """One MPC solve from a batch-1 state. Returns (first action (nu,),
        mean (H, nu), best cost of the last iteration).

        mean: warm-start action-sequence mean (receding horizon: the previous
        plan shifted by one step). The samples' noise is drawn from
        `generator` (on the state's device), or taken from eps, an
        (iterations, N, H, nu) tensor of standard normals. group: a process
        group whose every rank plans from the same state and mean with
        num_samples candidates of its own; the elites are chosen from all."""
        cfg = self.cfg
        nu = self.env.action_size
        q = state.phys.qpos
        if eps is None and generator is None:
            raise ValueError("plan needs a generator or eps")
        if mean is None:
            mean = torch.zeros((cfg.horizon, nu), dtype=q.dtype, device=q.device)
        std = torch.full((cfg.horizon, nu), cfg.init_std, dtype=q.dtype, device=q.device)
        for it in range(cfg.iterations):
            e = eps[it] if eps is not None else torch.randn(
                (cfg.num_samples, cfg.horizon, nu), generator=generator, dtype=q.dtype,
                device=q.device)
            actions = (mean + std * e).clamp(-1.0, 1.0)
            costs = self._rollout_cost(state, actions)
            if group is not None:
                costs = all_gather(costs, group).reshape(-1)
                actions = all_gather(actions, group).reshape(-1, *actions.shape[1:])
            elite_idx = torch.argsort(costs, stable=True)[:cfg.num_elites]
            elites = actions[elite_idx]
            mean = cfg.alpha * mean + (1 - cfg.alpha) * elites.mean(0)
            std = torch.clamp(cfg.alpha * std + (1 - cfg.alpha) * elites.std(0, correction=0),
                              min=cfg.min_std)
            best = costs[elite_idx[0]]
        return mean[0], mean, best

    def receding_horizon(self, state: EnvState, n_steps: int, generator: torch.Generator,
                         group=None):
        """Closed-loop MPC: plan, apply the first action, shift, repeat.
        Returns (final EnvState, rewards (n_steps,), costs (n_steps,)).
        group: plan over its ranks (plan(group=)); every rank applies the
        same first action to the same state."""
        nu = self.env.action_size
        q = state.phys.qpos
        mean = torch.zeros((self.cfg.horizon, nu), dtype=q.dtype, device=q.device)
        rews, costs = [], []
        for _ in range(n_steps):
            a, mean, cost = self.plan(state, mean, generator, group=group)
            state = self.env.step(state, a[None])
            mean = torch.cat([mean[1:], torch.zeros_like(mean[:1])])
            rews.append(state.reward[0])
            costs.append(cost)
        return state, torch.stack(rews), torch.stack(costs)
