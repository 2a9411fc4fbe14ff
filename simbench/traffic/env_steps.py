"""Loop kind `env_steps`: a batch of envs stepped by `step_autoreset` as
fast as each call returns, under uniform random actions drawn from the seed.

Traffic keys: task (HumanoidSpeed | HumanoidGetup), task_config, batch,
actions {low, high}, qp {qp_iters, qp_tol, qp_rows}, keeps, warmup_units,
device_units (units profiled after the window of a --trace 0 run, for the
device-time rate), trace_units, control_steps_per_unit (control steps one step_autoreset runs:
4 with a per-reset Fall init), check_samples.

The env comes from the port (smplsim_tpu_torch.envs); the model from the
configuration's model file. One unit is one step_autoreset of the batch.
"""
from __future__ import annotations

import torch

from simbench import envcheck, trace


class EnvSteps:
    def __init__(self, ctx):
        from smplsim_tpu_torch.envs import GetupConfig, HumanoidGetup, HumanoidSpeed, SpeedConfig
        from smplsim_tpu_torch.models import registry

        t = ctx.traffic
        self.ctx = ctx
        self.dev = ctx.device
        self.model = registry.load_model(ctx.model_path(), dtype=ctx.dtype(), device=self.dev)
        env_cls, cfg_cls = {"HumanoidSpeed": (HumanoidSpeed, SpeedConfig),
                            "HumanoidGetup": (HumanoidGetup, GetupConfig)}[t["task"]]
        cfg = cfg_cls(**ctx.config["env"], **t.get("task_config", {}))
        self.env = env_cls(self.model, cfg, keeps=tuple(t["keeps"]), **t["qp"])
        self.B = t["batch"]
        s_env, s_act, s_check = envcheck.sub_seeds(ctx.seed, 3)
        self.gen_act = torch.Generator(device=self.dev).manual_seed(s_act)
        self.lo, self.hi = t["actions"]["low"], t["actions"]["high"]
        self.state = self.env.reset(self.B, torch.Generator(device=self.dev).manual_seed(s_env))
        self.reservoir = envcheck.Reservoir(t["check_samples"], s_check)
        self.step = self.env.step_autoreset
        self.stalled = torch.zeros((), dtype=torch.float64, device=self.dev)
        self.window_units = 0

    def _action(self):
        u = torch.rand((self.B, self.model.nu), generator=self.gen_act, dtype=self.model.dtype,
                       device=self.dev)
        return self.lo + (self.hi - self.lo) * u

    def warmup(self):
        for _ in range(self.ctx.traffic["warmup_units"]):
            self.state = self.step(self.state, self._action())
        # the window's calls are the ones sampled
        self.step = envcheck.record_call(self.env.step_autoreset, self.reservoir)

    def run_one(self) -> int:
        self.state = self.step(self.state, self._action())
        self.stalled += self.state.info["stalled"].sum()
        self.window_units += 1
        return self.B

    def _one(self):
        self.state = self.step(self.state, self._action())

    def end_to_end(self, n: int, window_s: float) -> dict:
        """env-steps per second of device-busy time: the window's shapes
        stepped `device_units` more times under the profiler, device
        activity alone, over the union of their device intervals. Only on
        a card: a CPU run has no device time."""
        if self.dev.type != "cuda":
            return {}
        self.step = self.env.step_autoreset
        s = trace.record(self._one, self.ctx.traffic["device_units"], host=False)
        return {"env_steps_per_device_s": self.B * s["units"] / s["busy_s"]}

    def trace(self, window_s: float, n: int) -> dict:
        t = self.ctx.traffic
        self.step = self.env.step_autoreset
        s = trace.record(self._one, t["trace_units"])
        from simbench.reference.physics.constraints import NEFC
        s.update(
            tag="sim", wall_s_per_unit=window_s / self.window_units,
            counters={"stalled_share": float(self.stalled) / n},
            shapes=dict(B=self.B, nv=self.model.nv, rows=min(t["qp"]["qp_rows"], NEFC),
                        substeps=self.ctx.config["env"]["control_frequency_inv"],
                        control_steps_per_unit=t["control_steps_per_unit"],
                        dtype=self.ctx.config["dtype"],
                        itemsize=torch.empty((), dtype=self.model.dtype).element_size()))
        return s

    def release(self):
        kept = self.reservoir.kept
        self.state = self.env = self.model = self.step = None
        return kept


def setup(ctx):
    return EnvSteps(ctx)


def check(ctx, kept):
    return envcheck.check_calls(ctx, kept)
