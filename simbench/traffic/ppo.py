"""Loop kind `ppo`: PPO training through the port's normal path. One unit
is one PPO iteration, `PPO.rollout` then `PPO.update`, as
agents/agent_humanoid.py::optimize_policy calls them, on `num_envs` envs
for `horizon` control steps: num_envs * horizon env-steps.

The learner's settings are the configuration's `learning` block (every
field of the port's PPOConfig); the env's are its `env` block with the
traffic's task_config and QP.

Traffic keys: task (HumanoidSpeed), task_config, qp
{qp_iters, qp_tol, qp_rows}, keeps, device_units (iterations profiled
after the window of a --trace 0 run, for the device-time rate),
check_samples (step_autoreset calls of the window the physics check
compares), check_steps (minibatch steps of each net the learner check
compares).

Warm-up: one rollout step through PPO.rollout, then one minibatch step of
each net at the window's minibatch size through PPO.update, on copies of
the nets and optimisers; no full iteration.

Device time: an iteration is recorded in pieces (`_Pieces`), the rollout
cut at each step_autoreset's return and the update whole, each piece
under its own torch.profiler recording, synchronised between them; the
busy seconds of the pieces add up to the iteration's (one recording of
the whole would take minutes to reduce). The traced run records the
first rollout step and the update with host activity as well.

The check's iteration (`release`): one more iteration after the window
and the profiled one, kept by simbench/ppocheck.py, unprofiled. It starts
from the running norm and both Adam states that the earlier updates left,
so that the norm's merge and normalisation and Adam's carried moments are
compared away from their start (at the first iteration of training the
norm is (0, 0, 1), so normalising is a clamp, and Adam has no moments).
"""
from __future__ import annotations

import copy
import dataclasses
import time

import torch

from simbench import envcheck, ppocheck, trace


def _merge(tables: list) -> dict:
    """The sum of {name: number} tables, or of {name: [seconds, count]}."""
    out = {}
    for t in tables:
        for k, v in t.items():
            if isinstance(v, list):
                rec = out.setdefault(k, [0.0, 0])
                rec[0] += v[0]
                rec[1] += v[1]
            else:
                out[k] = out.get(k, 0) + v
    return out


class _Pieces:
    """One iteration recorded in pieces, each under its own torch.profiler
    recording, synchronised at both ends: the rollout from its first
    policy forward to its first step_autoreset's return, from there to
    each next step_autoreset's return (the observation's normalisation,
    the policy, the action and the step), from the last to the rollout's
    return (the trajectory's stacks); then the update. With `traced`, the
    first piece and the update are recorded with host activity as well
    and reduced (simbench/trace.py); the others are reduced to their busy
    seconds. (Recordings of 8 steps read 0.4% faster and spread more over
    six runs on the card: the pieces stay one step.)"""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.prof = None
        self.busy, self.wall = [], []     # of each recording
        self.summaries = []               # of the host-traced recordings

    def start(self, host: bool) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
        torch.cuda.synchronize()
        self.prof, self.host = profile(activities=acts), host
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        self.prof.stop()
        if self.host:
            self.summaries.append(trace.reduce(self.prof.events(), wall, 1))
            self.busy.append(self.summaries[-1]["busy_s"])
        else:
            self.busy.append(trace.device_busy_s(self.prof))
        self.wall.append(wall)
        self.prof = None


class PPOLoop:
    def __init__(self, ctx):
        from smplsim_tpu_torch.envs import HumanoidSpeed, SpeedConfig
        from smplsim_tpu_torch.learning.ppo import PPO, PPOConfig
        from smplsim_tpu_torch.models import registry

        t = ctx.traffic
        self.ctx = ctx
        self.dev = ctx.device
        self.model = registry.load_model(ctx.model_path(), dtype=ctx.dtype(), device=self.dev)
        if t["task"] != "HumanoidSpeed":
            raise ValueError(f"loop kind ppo runs HumanoidSpeed, not {t['task']}")
        self.env = HumanoidSpeed(self.model, SpeedConfig(**ctx.config["env"], **t["task_config"]),
                                 keeps=tuple(t["keeps"]), **t["qp"])
        learning = dict(ctx.config["learning"])
        for k in ("policy_widths", "value_widths"):
            learning[k] = tuple(learning[k])
        self.cfg = PPOConfig(**learning)
        self.ppo = PPO(self.env, self.cfg)
        s_init, s_check = envcheck.sub_seeds(ctx.seed, 2)
        self.ts = self.ppo.init(s_init)
        self.reservoir = envcheck.Reservoir(t["check_samples"], s_check)
        self.counters = {}
        self.window_iterations = 0

    @property
    def env_steps(self) -> int:
        return self.cfg.num_envs * self.cfg.horizon

    def warmup(self):
        cfg, ts, PPO = self.cfg, self.ts, type(self.ppo)
        st, traj = PPO(self.env, dataclasses.replace(cfg, horizon=1)).rollout(ts)
        self.ts = ts = dataclasses.replace(ts, env_states=st)
        # a trajectory of one minibatch, on copies of the nets and optimisers
        T = max(1, -(-self.env_steps // cfg.num_minibatches) // cfg.num_envs)
        rep = {k: v.expand(T, *v.shape[1:]).clone() for k, v in traj.items()}
        policy, value = copy.deepcopy(ts.policy), copy.deepcopy(ts.value)
        spare = dataclasses.replace(
            ts, policy=policy, value=value,
            policy_opt=torch.optim.Adam(policy.parameters(), lr=cfg.policy_lr, eps=1e-8),
            value_opt=torch.optim.Adam(value.parameters(), lr=cfg.value_lr, eps=1e-8),
            generator=torch.Generator(device=self.dev).manual_seed(0))
        PPO(self.env, dataclasses.replace(cfg, opt_num_epochs=1, num_minibatches=1)).update(
            spare, st, rep)
        # the window's step_autoreset calls are the ones sampled
        self.env.step_autoreset = envcheck.record_call(type(self.env).step_autoreset.__get__(
            self.env), self.reservoir)

    def run_one(self) -> int:
        self.ts, _ = self.ppo.update(self.ts, *self.ppo.rollout(self.ts))
        self.window_iterations += 1
        return self.env_steps

    def _unsample(self):
        self.env.__dict__.pop("step_autoreset", None)

    def _iteration(self, pieces: _Pieces) -> tuple:
        """One iteration, recorded in pieces; (rollout, update) busy
        seconds."""
        ts = self.ts
        step = type(self.env).step_autoreset.__get__(self.env)

        def start(module, args):
            if pieces.prof is None:
                pieces.start(host=pieces.traced and not pieces.busy)

        def recorded_step(state, action, *a, **k):
            out = step(state, action, *a, **k)
            pieces.stop()
            pieces.start(host=False)
            return out
        hook = ts.policy.register_forward_pre_hook(start)
        self.env.step_autoreset = recorded_step
        try:
            st, traj = self.ppo.rollout(ts)
        finally:
            hook.remove()
            self._unsample()
        pieces.stop()
        rollout = sum(pieces.busy)
        pieces.start(host=pieces.traced)
        self.ts, _ = self.ppo.update(ts, st, traj)
        pieces.stop()
        return rollout, pieces.busy[-1]

    def end_to_end(self, n: int, window_s: float) -> dict:
        """env-steps per second of device-busy time: `device_units` more
        iterations recorded in pieces with device activity alone, over the
        sum of their pieces' busy seconds. Only on a card."""
        if self.dev.type != "cuda":
            return {}
        self._unsample()
        busy = sum(sum(self._iteration(_Pieces()))
                   for _ in range(self.ctx.traffic["device_units"]))
        return {"env_steps_per_device_s": self.env_steps * self.ctx.traffic["device_units"] / busy}

    def trace(self, window_s: float, n: int) -> dict:
        """One iteration in pieces: the first rollout step and the update
        with host activity as well, the other steps device activity alone;
        the port's span table cleared before it (where the port has one)."""
        from smplsim_tpu_torch.utils import profiler
        from simbench.reference.physics.constraints import NEFC

        self._unsample()
        if hasattr(profiler, "clear"):
            profiler.clear()
        pieces = _Pieces(traced=True)
        rollout, update = self._iteration(pieces)
        if hasattr(profiler, "counters"):
            self.counters = profiler.counters()
        step, upd = pieces.summaries
        c, t = self.cfg, self.ctx.traffic
        return dict(
            tag="train", units=1, busy_s=rollout + update, window_s=sum(pieces.wall),
            rollout_busy_s=rollout, update_busy_s=update,
            wall_s_per_unit=window_s / self.window_iterations,
            device_ops=_merge([step["device_ops"], upd["device_ops"]]),
            runtime=_merge([step["runtime"], upd["runtime"]]),
            idle_by_host_op=_merge([step["idle_by_host_op"], upd["idle_by_host_op"]]),
            shapes=dict(B=c.num_envs, T=c.horizon, obs=self.env.obs_size,
                        act=self.env.action_size, policy_widths=list(c.policy_widths),
                        value_widths=list(c.value_widths), epochs=c.opt_num_epochs,
                        minibatches=c.num_minibatches, nv=self.model.nv,
                        rows=min(t["qp"]["qp_rows"], NEFC),
                        substeps=self.ctx.config["env"]["control_frequency_inv"],
                        dtype=self.ctx.config["dtype"]))

    def _checked_iteration(self) -> dict:
        """One more iteration, unprofiled, with what the check compares
        kept on the host (ppocheck.Capture)."""
        ts = self.ts
        cap = ppocheck.Capture(self.ctx.traffic["check_steps"])
        cap.inputs(ts)
        st, traj = self.ppo.rollout(ts)
        cap.trajectory(ts, st, traj)
        try:
            self.ts, _ = self.ppo.update(ts, st, traj)
        finally:
            cap.close()
        cap.outputs(self.ts)
        return cap.kept

    def release(self):
        self._unsample()
        kept = {"learner": self._checked_iteration(), "calls": self.reservoir.kept,
                "counters": self.counters}
        self.ts = self.ppo = self.env = self.model = None
        return kept


def setup(ctx):
    return PPOLoop(ctx)


def check(ctx, samples):
    """The learner's numbers (simbench/ppocheck.py) on the iteration after
    the window and the profiled one, then the physics'
    (simbench/envcheck.py) on the window's sampled step_autoreset calls. Observed besides, after a traced run: the
    port's learning counters over the traced update (net steps, and those
    whose gradient norm reached max_grad_norm)."""
    lim = ctx.limits
    checks, failed, observed = envcheck.check_calls(ctx, samples["calls"])
    observed.update({k: v for k, v in samples["counters"].items() if k.startswith("learning.")})
    nums, seen = ppocheck.readings(samples["learner"], ctx.config["learning"], ctx.device,
                                   ctx.traffic["check_steps"])
    observed.update(seen)
    observed.update({k: nums[k] for k in ppocheck.NAMES if k not in lim})
    return [(k, float(nums[k]), float(lim[k])) for k in ppocheck.NAMES if k in lim] + checks, \
        failed, observed
