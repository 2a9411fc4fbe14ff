"""Typed run configuration (port of smplsim_tpu/agents/config.py).

One dataclass tree; CLI overrides use dotted `a.b=c` paths, so `env=speed
learning.gamma=0.99 env.episode_length=10` works as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from smplsim_tpu_torch.envs.base import EnvConfig
from smplsim_tpu_torch.envs.tasks import GetupConfig, ReachConfig, SpeedConfig
from smplsim_tpu_torch.learning.ppo import PPOConfig
from smplsim_tpu_torch.models.builder import RobotConfig

TASK_CONFIGS = {
    "HumanoidEnv": EnvConfig,
    "HumanoidSpeed": SpeedConfig,
    "HumanoidGetup": GetupConfig,
    "HumanoidReach": ReachConfig,
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    exp_name: str = "humanoid_smpl"
    task: str = "HumanoidSpeed"
    seed: int = 0
    output_dir: str = "outputs"
    epoch: int = 0                 # 0 = fresh, -1 = resume latest, N = exact
    num_epochs: int = 1000
    save_frequency: int = 50
    test: bool = False
    wandb: bool = False            # mirror log records to wandb when available
    wandb_project: str = "smplsim_tpu"
    env: EnvConfig = dataclasses.field(default_factory=SpeedConfig)
    robot: RobotConfig = dataclasses.field(default_factory=RobotConfig)
    learning: PPOConfig = dataclasses.field(default_factory=PPOConfig)


def _set_path(cfg: Any, path: list[str], value: str) -> Any:
    """Immutable nested dataclass update with string coercion."""
    field_name = path[0]
    cur = getattr(cfg, field_name)
    if len(path) == 1:
        new = _coerce(value, cur)
    else:
        new = _set_path(cur, path[1:], value)
    return dataclasses.replace(cfg, **{field_name: new})


def _coerce(value: str, current: Any) -> Any:
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        parts = [p for p in value.strip("()[]").split(",") if p]
        elem = current[0] if current else ""
        return tuple(type(elem)(p) for p in parts)
    return value


def parse_cli_overrides(cfg: RunConfig, argv: list[str]) -> RunConfig:
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"override must be key=value, got {arg!r}")
        key, value = arg.split("=", 1)
        if key in ("env", "task"):   # hydra-style `env=speed` task selection
            task = {
                "speed": "HumanoidSpeed", "getup": "HumanoidGetup",
                "reach": "HumanoidReach", "base_env": "HumanoidEnv",
            }.get(value, value)
            cfg = dataclasses.replace(cfg, task=task, env=TASK_CONFIGS[task]())
            continue
        cfg = _set_path(cfg, key.split("."), value)
    return cfg
