"""Per-episode statistics over batched rollouts (port of
smplsim_tpu/learning/episode_stats.py): per-env running return and length,
plus the aggregates of completed episodes, all on the device."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class EpisodeStats:
    cur_return: torch.Tensor    # (B,)
    cur_length: torch.Tensor    # (B,)
    num_episodes: torch.Tensor  # ()
    total_return: torch.Tensor  # ()
    total_length: torch.Tensor  # ()
    max_return: torch.Tensor    # ()
    min_return: torch.Tensor    # ()


def stats_init(num_envs: int, dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cuda") -> EpisodeStats:
    z = torch.zeros(num_envs, dtype=dtype, device=device)
    s = lambda v: torch.full((), v, dtype=dtype, device=device)
    return EpisodeStats(cur_return=z, cur_length=z, num_episodes=s(0.0), total_return=s(0.0),
                        total_length=s(0.0), max_return=s(-torch.inf), min_return=s(torch.inf))


def stats_step(s: EpisodeStats, reward: torch.Tensor, done: torch.Tensor) -> EpisodeStats:
    """Fold one batched env step (reward (B,), done (B,) bool)."""
    ret = s.cur_return + reward
    length = s.cur_length + 1.0
    d = done.to(ret.dtype)
    return EpisodeStats(
        cur_return=ret * (1.0 - d),
        cur_length=length * (1.0 - d),
        num_episodes=s.num_episodes + d.sum(),
        total_return=s.total_return + (ret * d).sum(),
        total_length=s.total_length + (length * d).sum(),
        max_return=torch.maximum(s.max_return, torch.where(done, ret, -torch.inf).max()),
        min_return=torch.minimum(s.min_return, torch.where(done, ret, torch.inf).min()),
    )


def stats_summary(s: EpisodeStats) -> dict:
    safe = torch.clamp(s.num_episodes, min=1.0)
    return {
        "num_episodes": s.num_episodes,
        "avg_episode_reward": s.total_return / safe,
        "avg_episode_len": s.total_length / safe,
        "max_episode_reward": s.max_return,
        "min_episode_reward": s.min_return,
    }
