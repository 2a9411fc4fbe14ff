"""The plain PPO learner (see the package docstring).

Nets are plain lists of layers, each a (W (out, in), b (out,)) pair; every
layer but the last is followed by SiLU. The policy's mean is its net's
output and its log-std a fixed vector; the value is its net's one output.

One iteration's update, as SMPLSim's default learner runs it on a
trajectory of T control steps of B envs (`update`):

  1. the values of the trajectory's observations and of the observation
     after it, under the value net, each observation normalised by the
     running norm from before the iteration (clipped to +-obs_clip);
  2. GAE (gamma, tau): a true termination stops the bootstrap from the
     next value, any episode end stops the carried advantage; the returns
     are the advantages plus the values;
  3. the advantages normalised by their mean and population std (+1e-8);
  4. the trajectory's observations merged into the running norm (Chan's
     parallel update) for the next iteration;
  5. minibatch steps: the T*B samples in the order of a permutation, cut
     into num_minibatches slices; for each slice one step of the policy on
     the clipped surrogate (the ratio of the new to the rollout's
     probability, clipped to 1 +- clip_epsilon) and one step of the value
     net on the mean squared error to the returns; each step's gradient is
     scaled to max_grad_norm where its global norm reaches it, then Adam
     (betas 0.9 / 0.999, eps 1e-8, bias-corrected) moves the parameters.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8
ADV_EPS = 1e-8          # the advantage normalisation's epsilon
NORM_EPS = 1e-8         # the running norm's epsilon under the square root


@contextlib.contextmanager
def precision(p: str = "ieee"):
    """Matrix products at precision p inside the block: "ieee" (full
    precision, no TF32) or "tf32"; the caller's setting restored after."""
    m = torch.backends.cuda.matmul
    prev = m.fp32_precision
    m.fp32_precision = p
    try:
        yield
    finally:
        m.fp32_precision = prev


# ------------------------------------------------------------------ nets
def silu(x):
    return x * torch.sigmoid(x)


def silu_grad(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def forward(layers: list, x: torch.Tensor, keep: bool = False):
    """The net's output for rows x; with keep, also what the gradient
    needs: each layer's input and each hidden layer's pre-activation."""
    inputs, pre = [], []
    h = x
    for i, (W, b) in enumerate(layers):
        inputs.append(h)
        z = h @ W.T + b
        if i + 1 < len(layers):
            pre.append(z)
            h = silu(z)
        else:
            h = z
    return (h, (inputs, pre)) if keep else h


def backward(layers: list, kept, d_out: torch.Tensor) -> list:
    """[(dW, db)] of each layer, given d loss / d output of each row."""
    inputs, pre = kept
    grads = [None] * len(layers)
    d = d_out
    for i in range(len(layers) - 1, -1, -1):
        W, _ = layers[i]
        grads[i] = (d.T @ inputs[i], d.sum(0))
        if i > 0:
            d = (d @ W) * silu_grad(pre[i - 1])
    return grads


def flat(pairs: list) -> list:
    return [t for pair in pairs for t in pair]


def unflat(tensors: list) -> list:
    return [(tensors[i], tensors[i + 1]) for i in range(0, len(tensors), 2)]


# ---------------------------------------------------------- distributions
def gaussian_logp(mean, log_std, action):
    """Summed log-density of a diagonal Gaussian."""
    z = (action - mean) / torch.exp(log_std)
    return (-0.5 * z * z - log_std - 0.5 * math.log(2.0 * math.pi)).sum(-1)


# --------------------------------------------------------------- the norm
@dataclasses.dataclass
class Norm:
    n: torch.Tensor       # () samples merged so far
    mean: torch.Tensor    # (dim,)
    var: torch.Tensor     # (dim,) population variance


def normalize(norm: Norm, x, clip: float):
    return ((x - norm.mean) / torch.sqrt(norm.var + NORM_EPS)).clamp(-clip, clip)


def merge(norm: Norm, batch: torch.Tensor) -> Norm:
    """Chan's parallel update of (n, mean, var) by the rows of batch."""
    m = float(batch.shape[0])
    bmean = batch.mean(0)
    bvar = ((batch - bmean) ** 2).mean(0)
    n = norm.n + m
    d = bmean - norm.mean
    w = m / max(float(n), 1.0)
    m2 = norm.var * norm.n + bvar * m + d * d * norm.n * w
    return Norm(n=n, mean=norm.mean + d * w, var=m2 / max(float(n), 1.0))


# -------------------------------------------------------------------- GAE
def gae(reward, value, last_value, done, terminated, gamma: float, tau: float):
    """(advantages, returns), (T, B) each."""
    T = reward.shape[0]
    adv = torch.zeros_like(value)
    carry = torch.zeros_like(last_value)
    nxt = last_value
    for t in range(T - 1, -1, -1):
        alive = 1.0 - terminated[t].to(value.dtype)
        going = 1.0 - done[t].to(value.dtype)
        delta = reward[t] + gamma * nxt * alive - value[t]
        carry = delta + gamma * tau * going * carry
        adv[t] = carry
        nxt = value[t]
    return adv, adv + value


# ---------------------------------------------------------- the optimiser
def global_norm(grads: list) -> float:
    return float(torch.sqrt(sum((g * g).sum() for g in grads)))


def clip_global(grads: list, max_norm: float) -> list:
    """The gradients scaled by max_norm / norm where their global norm
    reaches max_norm."""
    norm = global_norm(grads)
    if norm >= max_norm:
        return [g * (max_norm / norm) for g in grads]
    return list(grads)


@dataclasses.dataclass
class Adam:
    lr: float
    step: int            # steps taken
    m: list              # first moments, one per parameter
    v: list              # second moments

    def apply(self, params: list, grads: list) -> list:
        self.step += 1
        c1 = 1.0 - BETA1 ** self.step
        c2 = 1.0 - BETA2 ** self.step
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.m[i] = BETA1 * self.m[i] + (1.0 - BETA1) * g
            self.v[i] = BETA2 * self.v[i] + (1.0 - BETA2) * g * g
            out.append(p - self.lr * (self.m[i] / c1) / (torch.sqrt(self.v[i] / c2) + ADAM_EPS))
        return out


# ----------------------------------------------------------- the learner
@dataclasses.dataclass
class Config:
    gamma: float
    tau: float
    clip_epsilon: float
    num_minibatches: int
    max_grad_norm: float
    obs_clip: float


@dataclasses.dataclass
class Step:
    """One minibatch step of one net: the global norm of its gradient
    before the clip, the clipped gradient and the parameters after the
    step, flat in layer order (W, b, W, b, ...); `at` the clipped gradient
    of the same minibatch at other parameters, where update was given
    them."""

    norm: float
    grads: list
    params: list
    at: list | None = None


def rollout_logp(policy: list, log_std, norm: Norm, obs, action, clip: float):
    """(T, B) log-probability of the trajectory's actions under the
    policy, one control step at a time."""
    return torch.stack([gaussian_logp(forward(policy, normalize(norm, o, clip)), log_std, a)
                        for o, a in zip(obs, action)])


def policy_grad(policy: list, log_std, x, action, adv, logp_old, clip_epsilon: float) -> list:
    """The gradient (flat) of the clipped surrogate -mean(min(r a, clip(r) a))
    over the rows of x, r = exp(logp - logp_old)."""
    lo, hi = 1.0 - clip_epsilon, 1.0 + clip_epsilon
    mean, kept = forward(policy, x, keep=True)
    r = torch.exp(gaussian_logp(mean, log_std, action) - logp_old)
    # d/d logp: -r a / n where the unclipped term is the smaller or the
    # ratio lies inside the clip range, else 0
    live = (r * adv <= r.clamp(lo, hi) * adv) | ((r >= lo) & (r <= hi))
    d_logp = -(adv * r * live.to(r.dtype)) / x.shape[0]
    d_mean = d_logp[:, None] * (action - mean) / torch.exp(2.0 * log_std)
    return flat(backward(policy, kept, d_mean))


def value_grad(value: list, x, ret) -> list:
    """The gradient (flat) of mean((v - ret)^2) over the rows of x."""
    v, kept = forward(value, x, keep=True)
    d_v = 2.0 * (v[:, 0] - ret) / x.shape[0]
    return flat(backward(value, kept, d_v[:, None]))


def update(cfg: Config, policy: list, log_std, value: list, policy_adam: Adam,
           value_adam: Adam, norm: Norm, traj: dict, last_obs, perms, steps: int,
           at: dict | None = None) -> dict:
    """The first `steps` minibatch steps of each net in an iteration's
    update. traj: (T, B, ...) obs, action, logp (the rollout's), reward,
    terminated, done; perms: the permutations of the T*B samples, one per
    epoch; at: {"policy": [...], "value": [...]}, where given, each step's
    parameters (flat) at which to take its gradient once more (Step.at).
    Returns {values, last_value, gae (the advantages before the
    normalisation), adv (after it), ret, norm (the merged running norm),
    steps ({"policy": [Step], "value": [Step]})}."""
    T, B = traj["reward"].shape
    clip = cfg.obs_clip
    values = torch.stack([forward(value, normalize(norm, o, clip))[:, 0] for o in traj["obs"]])
    last = forward(value, normalize(norm, last_obs, clip))[:, 0]
    raw, ret = gae(traj["reward"], values, last, traj["done"], traj["terminated"], cfg.gamma,
                   cfg.tau)
    adv = (raw - raw.mean()) / (torch.sqrt(((raw - raw.mean()) ** 2).mean()) + ADV_EPS)
    merged = merge(norm, traj["obs"].reshape(T * B, -1))

    nobs = normalize(norm, traj["obs"].reshape(T * B, -1), clip)
    action = traj["action"].reshape(T * B, -1)
    logp_old, adv_f, ret_f = traj["logp"].reshape(-1), adv.reshape(-1), ret.reshape(-1)
    mb = T * B // cfg.num_minibatches
    grads = {"policy": lambda net, idx: policy_grad(net, log_std, nobs[idx], action[idx],
                                                    adv_f[idx], logp_old[idx], cfg.clip_epsilon),
             "value": lambda net, idx: value_grad(net, nobs[idx], ret_f[idx])}
    nets = {"policy": policy, "value": value}
    adams = {"policy": policy_adam, "value": value_adam}
    out = {"policy": [], "value": []}
    order = [(e, i) for e in range(len(perms)) for i in range(cfg.num_minibatches)][:steps]
    for k, (e, i) in enumerate(order):
        idx = perms[e][i * mb:(i + 1) * mb]
        for name in ("policy", "value"):     # the policy's step, then the value net's
            g = grads[name](nets[name], idx)
            norm_g, g = global_norm(g), clip_global(g, cfg.max_grad_norm)
            g_at = None
            if at is not None and k < len(at[name]):
                g_at = clip_global(grads[name](unflat(at[name][k]), idx), cfg.max_grad_norm)
            nets[name] = unflat(adams[name].apply(flat(nets[name]), g))
            out[name].append(Step(norm=norm_g, grads=g, params=flat(nets[name]), at=g_at))
    return dict(values=values, last_value=last, gae=raw, adv=adv, ret=ret, norm=merged,
                steps=out)
