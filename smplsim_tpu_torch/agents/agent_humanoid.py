"""Training driver: env + PPO + checkpoints + logging (port of
smplsim_tpu/agents/agent_humanoid.py).

AgentHumanoid builds the task env from TASKS on the baked humanoid, runs
the PPO epoch loop, logs each epoch to log.txt as one JSON line (epoch,
T_step, steps_per_sec and the six PPO metrics, read to the host once per
epoch after the device has finished), saves checkpoints as
Humanoid_{epoch:08d}.pt with resume by epoch=-1|N, and runs eval rollouts
(run_policy).

A checkpoint is a flat dict of tensors and plain values saved with
torch.save: both nets' and both optimisers' state dicts, the running norm,
the env states' tensors in field order (generators as their state), the
epoch and the trainer's generator state. It loads with
torch.load(weights_only=True) into a template state from PPO.init, and a
checkpoint whose env states do not fit the run's config (their shapes
or dtypes) is refused.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any

import torch

from smplsim_tpu_torch.agents.config import RunConfig
from smplsim_tpu_torch.envs.base import map_state
from smplsim_tpu_torch.envs.tasks import TASKS
from smplsim_tpu_torch.learning.nets import sample_action
from smplsim_tpu_torch.learning.ppo import PPO, TrainState
from smplsim_tpu_torch.learning.running_norm import RunningNorm, normalize
from smplsim_tpu_torch.models import registry


def _state_tensor(x):
    return x.get_state() if isinstance(x, torch.Generator) else x


class AgentHumanoid:
    def __init__(self, cfg: RunConfig, dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.model = registry.default_humanoid(dtype=dtype, device=device)
        self.env = TASKS[cfg.task](self.model, cfg.env)
        self.ppo = PPO(self.env, cfg.learning)
        self.out_dir = os.path.join(cfg.output_dir, cfg.exp_name)
        os.makedirs(self.out_dir, exist_ok=True)
        self.state: TrainState | None = None
        # wall seconds of each epoch's rollout and update, for the caller
        self.epoch_seconds: list[dict] = []

    def _sync(self):
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    # ---------------- checkpointing ----------------
    def _ckpt_path(self, epoch: int) -> str:
        return os.path.join(self.out_dir, f"Humanoid_{epoch:08d}.pt")

    def save_checkpoint(self, ts: TrainState) -> str:
        path = os.path.abspath(self._ckpt_path(ts.epoch))
        leaves = []
        map_state(lambda x: leaves.append(_state_tensor(x)), ts.env_states)
        torch.save({
            "epoch": ts.epoch,
            "policy": ts.policy.state_dict(),
            "value": ts.value.state_dict(),
            "policy_opt": ts.policy_opt.state_dict(),
            "value_opt": ts.value_opt.state_dict(),
            "obs_norm": dataclasses.asdict(ts.obs_norm),
            "env_states": leaves,
            "generator": ts.generator.get_state(),
        }, path)
        return path

    def load_checkpoint(self, epoch: int = -1) -> TrainState:
        if epoch == -1:
            cands = sorted(d for d in os.listdir(self.out_dir)
                           if d.startswith("Humanoid_") and d.endswith(".pt"))
            if not cands:
                raise FileNotFoundError(f"no checkpoints under {self.out_dir}")
            path = os.path.join(self.out_dir, cands[-1])
        else:
            path = self._ckpt_path(epoch)
        ck = torch.load(path, map_location="cpu", weights_only=True)
        ts = self.ppo.init(self.cfg.seed)
        ts.policy.load_state_dict(ck["policy"])
        ts.value.load_state_dict(ck["value"])
        ts.policy_opt.load_state_dict(ck["policy_opt"])
        ts.value_opt.load_state_dict(ck["value_opt"])
        ts.generator.set_state(ck["generator"])
        leaves = iter(ck["env_states"])

        def fill(x):
            saved, like = next(leaves, None), _state_tensor(x)
            if saved is None or saved.shape != like.shape or saved.dtype != like.dtype:
                raise ValueError(f"{path}: its env states do not match this run's config")
            if isinstance(x, torch.Generator):
                x.set_state(saved)
                return x
            return saved.to(x.device)

        env_states = map_state(fill, ts.env_states)
        if next(leaves, None) is not None:
            raise ValueError(f"{path}: its env states do not match this run's config")
        dev = self.model.device
        return dataclasses.replace(
            ts, epoch=ck["epoch"], env_states=env_states,
            obs_norm=RunningNorm(**{k: v.to(dev) for k, v in ck["obs_norm"].items()}))

    # ---------------- logging ----------------
    def _maybe_init_wandb(self):
        """Optional wandb mirroring, enabled by cfg.wandb=True and a working
        wandb install."""
        if getattr(self, "_wandb", None) is not None:
            return self._wandb
        self._wandb = False
        if self.cfg.wandb:
            try:
                import wandb

                wandb.init(project=self.cfg.wandb_project, name=self.cfg.exp_name,
                           resume="allow", id=self.cfg.exp_name,
                           config=dataclasses.asdict(self.cfg))
                self._wandb = wandb
            except Exception:
                pass
        return self._wandb

    def log(self, record: dict[str, Any]):
        line = json.dumps(record)
        with open(os.path.join(self.out_dir, "log.txt"), "a") as f:
            f.write(line + "\n")
        print(line, flush=True)
        wb = self._maybe_init_wandb()
        if wb:
            wb.log(record)

    # ---------------- training ----------------
    def optimize_policy(self, num_epochs: int | None = None) -> TrainState:
        cfg = self.cfg
        num_epochs = num_epochs or cfg.num_epochs
        if self.state is None:
            self.state = (self.load_checkpoint(cfg.epoch) if cfg.epoch != 0
                          else self.ppo.init(cfg.seed))
        ts = self.state
        steps = cfg.learning.horizon * cfg.learning.num_envs
        for epoch in range(ts.epoch, ts.epoch + num_epochs):
            t0 = time.perf_counter()
            env_states, traj = self.ppo.rollout(ts)
            self._sync()
            t1 = time.perf_counter()
            ts, metrics = self.ppo.update(ts, env_states, traj)
            self._sync()
            t2 = time.perf_counter()
            values = torch.stack(list(metrics.values())).tolist()
            self.epoch_seconds.append({"rollout": t1 - t0, "update": t2 - t1})
            self.log({"epoch": epoch + 1, "T_step": round(t2 - t0, 3),
                      "steps_per_sec": round(steps / (t2 - t0), 1),
                      **dict(zip(metrics, values))})
            if (epoch + 1) % cfg.save_frequency == 0:
                self.save_checkpoint(ts)
        self.state = ts
        self.save_checkpoint(ts)
        return ts

    # ---------------- eval ----------------
    @torch.no_grad()
    def run_policy(self, n_episodes: int = 4, horizon: int = 300, stochastic: bool = False,
                   record_path: str | None = None, render_path: str | None = None):
        """Mean-action (or sampled, with stochastic) eval rollouts of
        n_episodes envs with env.step; an env stops accruing return and
        length once it is done. record_path: dump qpos, qvel, reward and
        done per step, (n_episodes, horizon, ...), to a joblib pkl.
        render_path: draw episode 0's qpos, every second step, to a GIF (or
        an mp4 by the extension) with render.render_rollout (needs
        matplotlib and imageio)."""
        ts = self.state if self.state is not None else self.load_checkpoint(self.cfg.epoch)
        env, m = self.env, self.model
        gen = torch.Generator(device=m.device).manual_seed(self.cfg.seed + 1)
        st = env.reset(n_episodes, gen)
        ret = torch.zeros(n_episodes, dtype=m.dtype, device=m.device)
        length = torch.zeros_like(ret)
        alive = torch.ones_like(ret)
        rec = {"qpos": [], "qvel": [], "reward": [], "done": []}
        for _ in range(horizon):
            mean, log_std = ts.policy(normalize(ts.obs_norm, st.obs, self.ppo.cfg.obs_clip))
            a = sample_action(gen, mean, log_std) if stochastic else mean
            st = env.step(st, a.clamp(-1.0, 1.0))
            ret = ret + st.reward * alive
            length = length + alive
            alive = alive * (1.0 - st.done.to(ret.dtype))
            if record_path:
                for k, v in (("qpos", st.phys.qpos), ("qvel", st.phys.qvel),
                             ("reward", st.reward), ("done", st.done)):
                    rec[k].append(v)
            elif render_path:
                rec["qpos"].append(st.phys.qpos)
        if record_path:
            import joblib

            joblib.dump({k: torch.stack(v, 1).cpu().numpy() for k, v in rec.items()},
                        record_path)
        if render_path:
            from smplsim_tpu_torch.render import render_rollout

            render_rollout(m, torch.stack(rec["qpos"], 1)[0], render_path, every=2)
        out = {
            "eval_return_mean": ret.mean().item(),
            "eval_return_std": ret.std(correction=0).item(),
            "eval_length_mean": length.mean().item(),
        }
        self.log(out)
        return out
