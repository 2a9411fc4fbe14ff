"""Running input normalization (port of smplsim_tpu/learning/running_norm.py).

The statistics are an explicit value, (n, mean, var) tensors on the device,
merged functionally from rollout batches with Chan's parallel update; the
`maximum(n, 1)` guards keep an empty merge finite. With a process group the
batch moments are first merged over its ranks, so every rank holds the same
statistics.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from smplsim_tpu_torch.parallel.mesh import pmean


@dataclasses.dataclass
class RunningNorm:
    n: torch.Tensor       # () count
    mean: torch.Tensor    # (dim,)
    var: torch.Tensor     # (dim,) population variance


def norm_init(dim: int, dtype: torch.dtype = torch.float32,
              device: str | torch.device = "cuda") -> RunningNorm:
    return RunningNorm(
        n=torch.zeros((), dtype=dtype, device=device),
        mean=torch.zeros(dim, dtype=dtype, device=device),
        var=torch.ones(dim, dtype=dtype, device=device),
    )


def norm_update(stats: RunningNorm, batch: torch.Tensor, group=None) -> RunningNorm:
    """Merge a batch (B, dim) into the running stats. group: a process
    group whose ranks each hold a batch of B rows; the JAX package's
    axis_name order: the global mean is the mean of the batch means, the
    variance the mean of bvar + (bmean - gmean)^2, the count B times the
    group's size."""
    bn = float(batch.shape[0])
    bmean = batch.mean(0)
    bvar = (batch - bmean).square().mean(0)
    if group is not None:
        gmean = pmean(bmean, group)
        bvar = pmean(bvar + (bmean - gmean).square(), group)
        bmean = gmean
        bn = bn * dist.get_world_size(group)
    n = stats.n + bn
    safe = torch.clamp(n, min=1.0)
    delta = bmean - stats.mean
    mean = stats.mean + delta * (bn / safe)
    m2 = stats.var * stats.n + bvar * bn + delta.square() * stats.n * bn / safe
    return RunningNorm(n=n, mean=mean, var=m2 / safe)


def normalize(stats: RunningNorm, x: torch.Tensor, clip: float = 5.0) -> torch.Tensor:
    """(x - mean) / std, clipped to [-clip, clip]."""
    return ((x - stats.mean) / torch.sqrt(stats.var + 1e-8)).clamp(-clip, clip)
