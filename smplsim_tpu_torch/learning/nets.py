"""Policy, value and discriminator networks (port of
smplsim_tpu/learning/nets.py) as torch.nn.Modules.

Flax infers a layer's input width at init; here every module takes it
(`in_dim`). The init follows flax's, not torch's default: each kernel is
drawn from variance_scaling(scale, "fan_in", "truncated_normal") (a normal
cut at two standard deviations, std = sqrt(scale / fan_in) / 0.8796...),
with scale 1 (lecun normal) for a plain Dense, 0.01 for the value, MCP and
PNN heads and 1 for the discriminator head; biases start at zero. The
draws come from the CPU generator passed in, so a module is built on the
CPU and moved to its device.

`load_flax_params(module, params)` carries the JAX package's weights
across: `params` is the nested dict of numpy arrays that
`jax.device_get(params)` gives, with flax's names (`MLP_i/Dense_j`, kernels
(in, out)); each module's `flax_layers()` maps those names to its
nn.Linear layers in flax's creation order.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_ACT = {
    "silu": F.silu,
    "relu": F.relu,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # flax's nn.gelu
    "elu": F.elu,
}

# std of a unit normal cut at +-2, as flax's variance_scaling divides by
_TRUNC_STD = 0.87962566103423978


def dense(in_dim: int, out_dim: int, scale: float = 1.0,
          generator: torch.Generator | None = None) -> nn.Linear:
    """nn.Linear with flax's variance_scaling(scale, fan_in, truncated
    normal) kernel and a zero bias."""
    lin = nn.Linear(in_dim, out_dim)
    std = math.sqrt(scale / in_dim) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        lin.bias.zero_()
    return lin


class MLP(nn.Module):
    def __init__(self, in_dim: int, widths: Sequence[int], activation: str = "silu",
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = (in_dim,) + tuple(widths)
        self.layers = nn.ModuleList(dense(a, b, generator=generator)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self.act = _ACT[activation]
        self.out_dim = dims[-1]

    def forward(self, x):
        for lin in self.layers:
            x = self.act(lin(x))
        return x

    def flax_layers(self, prefix: str) -> dict:
        return {f"{prefix}/Dense_{j}": lin for j, lin in enumerate(self.layers)}


def _log_std(action_dim: int, init: float) -> nn.Parameter:
    return nn.Parameter(torch.full((action_dim,), init))


class PolicyGaussian(nn.Module):
    """Diagonal Gaussian policy with a state-independent log_std; with
    fixed_std, log_std stays a parameter that receives no gradient."""

    def __init__(self, in_dim: int, action_dim: int,
                 widths: Sequence[int] = (2048, 1536, 1024, 1024, 512, 512),
                 activation: str = "silu", log_std_init: float = -2.5, fixed_std: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.mlp = MLP(in_dim, widths, activation, generator)
        self.head = dense(self.mlp.out_dim, action_dim, generator=generator)
        self.log_std = _log_std(action_dim, log_std_init)
        self.fixed_std = fixed_std

    def forward(self, obs):
        mean = self.head(self.mlp(obs))
        log_std = self.log_std.detach() if self.fixed_std else self.log_std
        return mean, log_std.expand(mean.shape)

    def flax_layers(self) -> dict:
        return {**self.mlp.flax_layers("MLP_0"), "Dense_0": self.head}


class PolicyMCP(nn.Module):
    """Multiplicative composition policy: N primitive MLP mean heads blended
    by a softmax composer; a shared state-independent log_std."""

    def __init__(self, in_dim: int, action_dim: int, num_primitive: int = 4,
                 widths: Sequence[int] = (2048, 1536, 1024, 1024, 512, 512),
                 composer_widths: Sequence[int] = (300, 200), activation: str = "silu",
                 log_std_init: float = -2.5, fixed_std: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.prims = nn.ModuleList(MLP(in_dim, widths, activation, generator)
                                   for _ in range(num_primitive))
        self.heads = nn.ModuleList(dense(p.out_dim, action_dim, 0.01, generator)
                                   for p in self.prims)
        self.composer = MLP(in_dim, composer_widths, activation, generator)
        self.composer_head = dense(self.composer.out_dim, num_primitive, generator=generator)
        self.log_std = _log_std(action_dim, log_std_init)
        self.fixed_std = fixed_std

    def forward(self, obs):
        x_all = torch.stack([h(p(obs)) for p, h in zip(self.prims, self.heads)], -2)
        w = torch.softmax(self.composer_head(self.composer(obs)), -1)
        mean = (w[..., None] * x_all).sum(-2)
        log_std = self.log_std.detach() if self.fixed_std else self.log_std
        return mean, log_std.expand(mean.shape)

    def flax_layers(self) -> dict:
        # flax names submodules in creation order: the N primitives' MLP_i
        # and Dense_i first, then the composer's MLP_N and Dense_N
        n = len(self.prims)
        out = {}
        for i, (p, h) in enumerate(zip(self.prims, self.heads)):
            out.update(p.flax_layers(f"MLP_{i}"))
            out[f"Dense_{i}"] = h
        out.update(self.composer.flax_layers(f"MLP_{n}"))
        out[f"Dense_{n}"] = self.composer_head
        return out


class ValueNet(nn.Module):
    def __init__(self, in_dim: int, widths: Sequence[int] = (2048, 1536, 1024, 1024, 512, 512),
                 activation: str = "silu", generator: torch.Generator | None = None):
        super().__init__()
        self.mlp = MLP(in_dim, widths, activation, generator)
        self.head = dense(self.mlp.out_dim, 1, 0.01, generator)

    def forward(self, obs):
        return self.head(self.mlp(obs)).squeeze(-1)

    def flax_layers(self) -> dict:
        return {**self.mlp.flax_layers("MLP_0"), "Dense_0": self.head}


class PolicyPNN(nn.Module):
    """Progressive-primitive policy: N primitive columns evaluated in
    parallel; `active` selects the column that drives the Gaussian head and
    detaches the columns before it (they keep their knowledge, gradients
    reach only the newest). active=None returns all primitive means stacked
    (..., N, A)."""

    def __init__(self, in_dim: int, action_dim: int, num_primitive: int = 4,
                 widths: Sequence[int] = (1024, 512), activation: str = "relu",
                 log_std_init: float = -2.9, fixed_std: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cols = nn.ModuleList(MLP(in_dim, widths, activation, generator)
                                  for _ in range(num_primitive))
        self.heads = nn.ModuleList(dense(c.out_dim, action_dim, 0.01, generator)
                                   for c in self.cols)
        self.log_std = _log_std(action_dim, log_std_init)
        self.fixed_std = fixed_std

    def forward(self, obs, active: int | None = None):
        means = []
        for i, (c, h) in enumerate(zip(self.cols, self.heads)):
            m = h(c(obs))
            means.append(m.detach() if active is not None and i < active else m)
        log_std = self.log_std.detach() if self.fixed_std else self.log_std
        mean = torch.stack(means, -2) if active is None else means[active]
        return mean, log_std.expand(mean.shape)

    def flax_layers(self) -> dict:
        out = {}
        for i, (c, h) in enumerate(zip(self.cols, self.heads)):
            out.update(c.flax_layers(f"MLP_{i}"))
            out[f"Dense_{i}"] = h
        return out


class AMPDiscriminator(nn.Module):
    """AMP discriminator: raw logits, demo transitions scoring positive."""

    def __init__(self, in_dim: int, widths: Sequence[int] = (1024, 512),
                 activation: str = "relu", generator: torch.Generator | None = None):
        super().__init__()
        self.mlp = MLP(in_dim, widths, activation, generator)
        self.head = dense(self.mlp.out_dim, 1, 1.0, generator)

    def forward(self, amp_obs):
        return self.head(self.mlp(amp_obs)).squeeze(-1)

    def flax_layers(self) -> dict:
        return {**self.mlp.flax_layers("MLP_0"), "Dense_0": self.head}


def load_flax_params(module: nn.Module, params: dict) -> nn.Module:
    """Fill `module` from the JAX package's params (nested dict of numpy
    arrays, with or without flax's top-level "params" key): each kernel
    (in, out) is transposed into nn.Linear.weight (out, in)."""
    p = params.get("params", params)
    with torch.no_grad():
        for path, lin in module.flax_layers().items():
            node = p
            for key in path.split("/"):
                node = node[key]
            lin.weight.copy_(torch.tensor(np.asarray(node["kernel"]).T))
            lin.bias.copy_(torch.tensor(np.asarray(node["bias"])))
        if "log_std" in p:
            module.log_std.copy_(torch.tensor(np.asarray(p["log_std"])))
    return module


def amp_disc_loss(disc: nn.Module, agent_obs: torch.Tensor, demo_obs: torch.Tensor,
                  logit_reg: float = 0.01, grad_penalty: float = 5.0):
    """AMP discriminator loss: least-squares GAN targets (+1 demo, -1
    agent), logit regularization, and a gradient penalty on the demo batch.
    The penalty's input gradient is taken with create_graph=True, so the
    loss stays differentiable in the parameters. Returns (loss, aux)."""
    logit_a = disc(agent_obs)
    demo = demo_obs.detach().requires_grad_(True)
    logit_d = disc(demo)
    loss_a = (logit_a + 1.0).square().mean()
    loss_d = (logit_d - 1.0).square().mean()
    g, = torch.autograd.grad(logit_d.sum(), demo, create_graph=True)
    gp = g.square().sum(-1).mean()
    reg = logit_a.square().mean() + logit_d.square().mean()
    loss = 0.5 * (loss_a + loss_d) + logit_reg * reg + grad_penalty * gp
    return loss, {
        "disc_loss": loss, "grad_penalty": gp,
        "disc_acc_demo": (logit_d > 0).float().mean(),
        "disc_acc_agent": (logit_a < 0).float().mean(),
    }


def amp_reward(logit: torch.Tensor, scale: float = 2.0) -> torch.Tensor:
    """Style reward from a discriminator logit: -scale log(1 - sigmoid)."""
    return -scale * torch.log(torch.clamp(1.0 - torch.sigmoid(logit), 1e-4, 1.0))


def gaussian_log_prob(mean, log_std, action):
    """Summed diagonal-Gaussian log prob."""
    var = torch.exp(2.0 * log_std)
    lp = -0.5 * ((action - mean).square() / var + 2.0 * log_std + math.log(2.0 * math.pi))
    return lp.sum(-1)


def gaussian_kl(mean0, log_std0, mean1, log_std1):
    """KL(p0 || p1) summed over dims."""
    var0, var1 = torch.exp(2 * log_std0), torch.exp(2 * log_std1)
    return (log_std1 - log_std0 + (var0 + (mean0 - mean1).square()) / (2 * var1) - 0.5).sum(-1)


def sample_action(generator: torch.Generator, mean, log_std):
    return mean + torch.exp(log_std) * torch.randn(
        mean.shape, generator=generator, dtype=mean.dtype, device=mean.device)
