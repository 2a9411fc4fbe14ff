"""Per-episode statistics over batched rollouts (port of
smplsim_tpu/learning/episode_stats.py): per-env running return and length,
plus the aggregates of completed episodes, all on the device."""
from __future__ import annotations

import dataclasses

import torch

from smplsim_tpu_torch.parallel.mesh import pmax, pmin, psum


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


def stats_summary(s: EpisodeStats, group=None) -> dict:
    """LoggerRL-style summary; with a process group, the episode count,
    return and length are summed over its ranks and the extremes taken
    over them."""
    n, tr, tl = s.num_episodes, s.total_return, s.total_length
    mx, mn = s.max_return, s.min_return
    if group is not None:
        n, tr, tl = psum(torch.stack([n, tr, tl]), group).unbind()
        mx, mn = pmax(mx, group), pmin(mn, group)
    safe = torch.clamp(n, min=1.0)
    return {
        "num_episodes": n,
        "avg_episode_reward": tr / safe,
        "avg_episode_len": tl / safe,
        "max_episode_reward": mx,
        "min_episode_reward": mn,
    }
