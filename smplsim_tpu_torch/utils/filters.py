"""Signal filters (port of smplsim_tpu/utils/filters.py): the One-Euro
filter and a running mean/std with freeze modes.

The One-Euro filter (Casiez et al.) runs as a loop over time; the running
mean/std updates with Chan's parallel-variance rule and has three modes:
live, frozen (no updates) and partially frozen (the statistics go on
accumulating, normalization uses the snapshot taken at the freeze).
"""
from __future__ import annotations

import dataclasses
import math

import torch


# ---------------------------------------------------------------------------
# One-Euro filter
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class OneEuroState:
    x_prev: torch.Tensor
    dx_prev: torch.Tensor
    t_prev: torch.Tensor


def one_euro_init(t0, x0, dx0=None) -> OneEuroState:
    x0 = torch.as_tensor(x0)
    return OneEuroState(x_prev=x0,
                        dx_prev=torch.zeros_like(x0) if dx0 is None else torch.as_tensor(dx0),
                        t_prev=torch.as_tensor(t0, dtype=x0.dtype))


def _smoothing_factor(t_e, cutoff):
    r = 2.0 * math.pi * cutoff * t_e
    return r / (r + 1.0)


def one_euro_step(state: OneEuroState, t, x, min_cutoff: float = 1.0, beta: float = 0.0,
                  d_cutoff: float = 1.0):
    """One filter update; returns (state', x_hat)."""
    x = torch.as_tensor(x)
    t = torch.as_tensor(t, dtype=x.dtype)
    t_e = t - state.t_prev
    a_d = _smoothing_factor(t_e, d_cutoff)
    dx = (x - state.x_prev) / t_e
    dx_hat = a_d * dx + (1.0 - a_d) * state.dx_prev
    cutoff = min_cutoff + beta * dx_hat.abs()
    a = _smoothing_factor(t_e, cutoff)
    x_hat = a * x + (1.0 - a) * state.x_prev
    return OneEuroState(x_prev=x_hat, dx_prev=dx_hat, t_prev=t), x_hat


def one_euro_filter(ts, xs, min_cutoff: float = 1.0, beta: float = 0.0,
                    d_cutoff: float = 1.0) -> torch.Tensor:
    """Filter a whole sequence xs (T, ...) sampled at times ts (T,)."""
    state = one_euro_init(ts[0], xs[0])
    out = [xs[0]]
    for t, x in zip(ts[1:], xs[1:]):
        state, x_hat = one_euro_step(state, t, x, min_cutoff, beta, d_cutoff)
        out.append(x_hat)
    return torch.stack(out)


# ---------------------------------------------------------------------------
# running mean / std with freeze modes
# ---------------------------------------------------------------------------
LIVE, FROZEN, PARTIAL = 0, 1, 2


@dataclasses.dataclass
class RunningMeanStd:
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor
    # LIVE, FROZEN (no updates) or PARTIAL (statistics accumulate,
    # normalization uses the snapshot taken at the freeze)
    mode: int
    frozen_mean: torch.Tensor
    frozen_var: torch.Tensor


def rms_init(shape, dtype=torch.float32, epsilon: float = 1e-4, device=None) -> RunningMeanStd:
    z = torch.zeros(shape, dtype=dtype, device=device)
    o = torch.ones(shape, dtype=dtype, device=device)
    return RunningMeanStd(mean=z, var=o, count=torch.tensor(epsilon, dtype=dtype, device=device),
                          mode=LIVE, frozen_mean=z, frozen_var=o)


def rms_update(s: RunningMeanStd, batch: torch.Tensor) -> RunningMeanStd:
    """Chan's parallel-variance update over the leading axis; none when
    frozen."""
    if s.mode == FROZEN:
        return s
    bmean = batch.mean(0)
    bvar = batch.var(0, correction=0)
    bcount = batch.shape[0]
    delta = bmean - s.mean
    tot = s.count + bcount
    new_mean = s.mean + delta * bcount / tot
    M2 = s.var * s.count + bvar * bcount + delta.square() * s.count * bcount / tot
    return dataclasses.replace(s, mean=new_mean, var=M2 / tot, count=tot)


def rms_freeze(s: RunningMeanStd) -> RunningMeanStd:
    return dataclasses.replace(s, mode=FROZEN)


def rms_freeze_partial(s: RunningMeanStd) -> RunningMeanStd:
    """Snapshot the statistics for normalization; accumulation goes on."""
    return dataclasses.replace(s, mode=PARTIAL, frozen_mean=s.mean, frozen_var=s.var)


def rms_unfreeze(s: RunningMeanStd) -> RunningMeanStd:
    return dataclasses.replace(s, mode=LIVE)


def _stats(s: RunningMeanStd):
    return (s.frozen_mean, s.frozen_var) if s.mode == PARTIAL else (s.mean, s.var)


def rms_normalize(s: RunningMeanStd, x: torch.Tensor, clip: float = 10.0,
                  eps: float = 1e-8) -> torch.Tensor:
    mean, var = _stats(s)
    return torch.clamp((x - mean) / torch.sqrt(var + eps), -clip, clip)


def rms_denormalize(s: RunningMeanStd, x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    mean, var = _stats(s)
    return x * torch.sqrt(var + eps) + mean
