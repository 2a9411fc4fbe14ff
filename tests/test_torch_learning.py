"""The port's RL stack (smplsim_tpu_torch/learning) against the JAX package.

Every JAX comparison feeds both packages the same numpy inputs and, for the
nets, the same weights (the flax params carried across with
load_flax_params). Float64 within 1e-9 relative; float32 within 5e-3 of
each tensor's largest entry. No env is compiled: the PPO iteration replaces
the JAX trainer's `_rollout` on the instance with a fixed trajectory, and
the port's `update` takes the same trajectory and the permutations JAX
draws from its k_perm key.
"""
from types import SimpleNamespace
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import rel_err
from test_learning import reference_gae
from smplsim_tpu.learning import episode_stats as jes
from smplsim_tpu.learning import nets as jnets
from smplsim_tpu.learning import running_norm as jrn
from smplsim_tpu.learning.gae import estimate_advantages as j_gae
from smplsim_tpu.learning.ppo import PPO as JPPO
from smplsim_tpu.learning.ppo import PPOConfig as JPPOConfig
from smplsim_tpu_torch.learning import episode_stats as tes
from smplsim_tpu_torch.learning import nets as tnets
from smplsim_tpu_torch.learning import running_norm as trn
from smplsim_tpu_torch.learning.gae import estimate_advantages as t_gae
from smplsim_tpu_torch.learning.ppo import PPO, PPOConfig, TrainState

TOL64 = 1e-9
TOL32 = 5e-3


def f64(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree)


def flat(tree, prefix=""):
    """Nested dict -> {"a/b/c": numpy array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def port_flat(module, of=lambda p: p):
    """The port module's tensors under flax's names, kernels as (in, out);
    `of` maps a parameter to the tensor to report (its grad, an Adam moment)."""
    out = {}
    for path, lin in module.flax_layers().items():
        out[f"{path}/kernel"] = of(lin.weight).detach().numpy().T
        out[f"{path}/bias"] = of(lin.bias).detach().numpy()
    if hasattr(module, "log_std"):
        out["log_std"] = of(module.log_std).detach().numpy()
    return out


def close_rel_max(ref, val, tol):
    """max |ref - val| / max |ref| <= tol (the float32 measure)."""
    ref, val = np.asarray(ref, np.float64), np.asarray(val, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    return float(np.abs(ref - val).max()) / scale <= tol


# --------------------------------------------------------------- GAE, norm
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gae_matches_jax_and_reference_recursion(dtype):
    rng = np.random.RandomState(0)
    T_, B = 40, 7
    rewards, values, last_value = rng.randn(T_, B), rng.randn(T_, B), rng.randn(B)
    done = rng.rand(T_, B) < 0.1
    dead = done & (rng.rand(T_, B) < 0.5)
    not_done, not_dead = 1.0 - done, 1.0 - dead
    args = [a.astype(dtype) for a in (rewards, values, last_value, not_done, not_dead)]
    ref_adv, ref_ret = reference_gae(rewards, values, last_value, not_done, not_dead, 0.99, 0.95)
    j_adv, j_ret = j_gae(*map(jnp.asarray, args), 0.99, 0.95)
    t_adv, t_ret = t_gae(*map(torch.as_tensor, args), 0.99, 0.95)
    tol = TOL64 if dtype == np.float64 else 1e-5
    assert rel_err(ref_adv, t_adv) <= tol and rel_err(ref_ret, t_ret) <= tol
    assert rel_err(j_adv, t_adv) <= tol and rel_err(j_ret, t_ret) <= tol


def test_running_norm_matches_jax():
    rng = np.random.RandomState(1)
    js = jrn.norm_init(5, jnp.float64)
    ts = trn.norm_init(5, torch.float64, "cpu")
    for c in [rng.randn(64, 5) * 3.0 + 1.5 for _ in range(6)] + [rng.randn(1, 5)]:
        js = jrn.norm_update(js, jnp.asarray(c))
        ts = trn.norm_update(ts, torch.as_tensor(c))
    for f in ("n", "mean", "var"):
        assert rel_err(getattr(js, f), getattr(ts, f)) <= TOL64, f
    x = rng.randn(32, 5) * 10.0
    for clip in (5.0, 1.0):
        assert rel_err(jrn.normalize(js, jnp.asarray(x), clip),
                       trn.normalize(ts, torch.as_tensor(x), clip)) <= TOL64


# ------------------------------------------------------------------- nets
IN, ACT = 11, 4
NETS = {
    # name: (flax module, port module, forward kwargs)
    "gaussian": (lambda: jnets.PolicyGaussian(ACT, widths=(16, 12)),
                 lambda: tnets.PolicyGaussian(IN, ACT, (16, 12)), {}),
    "gaussian_tanh": (lambda: jnets.PolicyGaussian(ACT, widths=(16,), activation="tanh"),
                      lambda: tnets.PolicyGaussian(IN, ACT, (16,), "tanh"), {}),
    "mcp": (lambda: jnets.PolicyMCP(ACT, num_primitive=3, widths=(16, 12),
                                    composer_widths=(10, 6)),
            lambda: tnets.PolicyMCP(IN, ACT, 3, (16, 12), (10, 6)), {}),
    "value": (lambda: jnets.ValueNet(widths=(16, 12), activation="gelu"),
              lambda: tnets.ValueNet(IN, (16, 12), "gelu"), {}),
    "pnn": (lambda: jnets.PolicyPNN(ACT, num_primitive=3, widths=(16, 12)),
            lambda: tnets.PolicyPNN(IN, ACT, 3, (16, 12)), {}),
    "pnn_active2": (lambda: jnets.PolicyPNN(ACT, num_primitive=3, widths=(16, 12)),
                    lambda: tnets.PolicyPNN(IN, ACT, 3, (16, 12)), {"active": 2}),
    "disc": (lambda: jnets.AMPDiscriminator(widths=(16, 12), activation="elu"),
             lambda: tnets.AMPDiscriminator(IN, (16, 12), "elu"), {}),
}


def carried(name, seed=0):
    """(flax module, float64 params, port module in float64 with them)."""
    jf, tf, kw = NETS[name]
    jnet = jf()
    params = f64(jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, IN)), **kw))
    tnet = tnets.load_flax_params(tf().to(torch.float64), jax.device_get(params))
    return jnet, params, tnet, kw


@pytest.mark.parametrize("name", list(NETS))
def test_net_forward_with_carried_weights(name):
    jnet, params, tnet, kw = carried(name)
    obs = np.random.RandomState(2).randn(9, IN) * 2.0
    j_out = jnet.apply(params, jnp.asarray(obs), **kw)
    t_out = tnet(torch.as_tensor(obs), **kw)
    j_out = j_out if isinstance(j_out, tuple) else (j_out,)
    t_out = t_out if isinstance(t_out, tuple) else (t_out,)
    for j, t in zip(j_out, t_out):
        assert rel_err(j, t) <= TOL64


def test_gaussian_functions_and_amp_reward():
    rng = np.random.RandomState(3)
    m0, m1, a = rng.randn(3, 6, ACT)
    s0, s1 = rng.randn(2, 6, ACT) * 0.5 - 1.0
    pairs = [
        (jnets.gaussian_log_prob(*map(jnp.asarray, (m0, s0, a))),
         tnets.gaussian_log_prob(*map(torch.as_tensor, (m0, s0, a)))),
        (jnets.gaussian_kl(*map(jnp.asarray, (m0, s0, m1, s1))),
         tnets.gaussian_kl(*map(torch.as_tensor, (m0, s0, m1, s1)))),
    ]
    logit = np.concatenate([rng.randn(20) * 3.0, [-30.0, 30.0]])
    for scale in (2.0, 0.5):
        pairs.append((jnets.amp_reward(jnp.asarray(logit), scale),
                      tnets.amp_reward(torch.as_tensor(logit), scale)))
    for j, t in pairs:
        assert rel_err(j, t) <= TOL64


def test_amp_disc_loss_and_parameter_gradient_match_jax():
    jnet, params, tnet, _ = carried("disc", seed=4)
    rng = np.random.RandomState(4)
    agent, demo = rng.randn(16, IN) - 0.5, rng.randn(16, IN) + 0.5

    def jloss(p):
        return jnets.amp_disc_loss(jnet.apply, p, jnp.asarray(agent), jnp.asarray(demo))

    (j_loss, j_aux), j_grad = jax.value_and_grad(jloss, has_aux=True)(params)
    t_loss, t_aux = tnets.amp_disc_loss(tnet, torch.as_tensor(agent), torch.as_tensor(demo))
    t_loss.backward()
    assert rel_err(j_loss, t_loss) <= TOL64
    for k in j_aux:
        assert rel_err(j_aux[k], t_aux[k]) <= TOL64, k
    g_ref = flat(jax.device_get(j_grad)["params"])
    g_port = port_flat(tnet, lambda p: p.grad)
    assert set(g_ref) == set(g_port)
    for k in g_ref:
        assert rel_err(g_ref[k], g_port[k]) <= TOL64, k
    # the penalty's gradient is part of it: without it the gradient differs
    gp_grad = jax.grad(lambda p: jloss(p)[1]["grad_penalty"])(params)
    assert max(float(jnp.abs(x).max()) for x in jax.tree_util.tree_leaves(gp_grad)) > 1e-6


def test_episode_stats_match_jax():
    rng = np.random.RandomState(5)
    B = 6
    js, ts = jes.stats_init(B, jnp.float64), tes.stats_init(B, torch.float64, "cpu")
    for t in range(30):
        r, d = rng.randn(B), rng.rand(B) < 0.15
        js = jes.stats_step(js, jnp.asarray(r), jnp.asarray(d))
        ts = tes.stats_step(ts, torch.as_tensor(r), torch.as_tensor(d))
    for f in ("cur_return", "cur_length", "num_episodes", "total_return", "total_length",
              "max_return", "min_return"):
        assert rel_err(getattr(js, f), getattr(ts, f)) <= TOL64, f
    j_sum, t_sum = jes.stats_summary(js), tes.stats_summary(ts)
    assert set(j_sum) == set(t_sum)
    for k in j_sum:
        assert rel_err(j_sum[k], t_sum[k]) <= TOL64, k


# ------------------------------------------------------------- init, PNN, AMP
@pytest.mark.parametrize("name", ["gaussian", "mcp", "value", "pnn", "disc"])
def test_init_follows_flax_statistics(name):
    """Kernels: a normal of std sqrt(scale / fan_in) cut at twice the
    std of its underlying normal (flax's variance_scaling with a truncated
    normal), scale 0.01 on the value, MCP and PNN heads; biases zero."""
    factory = {
        "gaussian": lambda g: tnets.PolicyGaussian(256, 64, (256, 256), generator=g),
        "mcp": lambda g: tnets.PolicyMCP(256, 64, 2, (256, 256), (256, 128), generator=g),
        "value": lambda g: tnets.ValueNet(256, (512, 512), generator=g),
        "pnn": lambda g: tnets.PolicyPNN(256, 64, 2, (256, 256), generator=g),
        "disc": lambda g: tnets.AMPDiscriminator(256, (512, 512), generator=g),
    }[name]
    net = factory(torch.Generator().manual_seed(0))
    small_heads = {"mcp": ("Dense_0", "Dense_1"), "value": ("Dense_0",),
                   "pnn": ("Dense_0", "Dense_1")}.get(name, ())
    for path, lin in net.flax_layers().items():
        scale = 0.01 if path in small_heads else 1.0
        w = lin.weight.detach().double()
        std = np.sqrt(scale / lin.in_features)
        cut = 2.0 * std / 0.87962566103423978
        assert float(w.abs().max()) <= cut * (1 + 1e-6), path
        tol = max(0.05, 4.0 / np.sqrt(2 * w.numel()))
        assert abs(float(w.std()) / std - 1.0) <= tol, (path, float(w.std()), std)
        assert abs(float(w.mean())) <= 4.0 * std / np.sqrt(w.numel()), path
        assert float(lin.bias.detach().abs().max()) == 0.0, path
    if hasattr(net, "log_std"):
        assert float(net.log_std.detach().max()) == float(net.log_std.detach().min())


def test_pnn_frozen_columns_get_zero_gradients():
    net = tnets.PolicyPNN(8, 3, num_primitive=4, widths=(16, 16),
                          generator=torch.Generator().manual_seed(0))
    mean, log_std = net(torch.ones(5, 8), active=2)
    assert mean.shape == (5, 3) and log_std.shape == (5, 3)
    all_means, _ = net(torch.ones(5, 8))
    assert all_means.shape == (5, 4, 3)
    assert torch.equal(mean, all_means[:, 2])
    (mean ** 2).sum().backward()
    for i in range(4):
        for p in list(net.cols[i].parameters()) + list(net.heads[i].parameters()):
            norm = 0.0 if p.grad is None else float(p.grad.abs().sum())
            assert (norm > 0.0) == (i == 2), (i, norm)
    assert net.log_std.grad is None


def test_amp_discriminator_separates_two_blobs():
    rng = np.random.default_rng(0)
    demo = torch.as_tensor(rng.normal(2.0, 0.4, (256, 6)), dtype=torch.float32)
    agent = torch.as_tensor(rng.normal(-2.0, 0.4, (256, 6)), dtype=torch.float32)
    disc = tnets.AMPDiscriminator(6, (32, 32), generator=torch.Generator().manual_seed(1))
    opt = torch.optim.Adam(disc.parameters(), lr=1e-2)
    for _ in range(60):
        loss, aux = tnets.amp_disc_loss(disc, agent, demo)
        opt.zero_grad()
        loss.backward()
        opt.step()
    assert float(aux["disc_acc_demo"]) > 0.95 and float(aux["disc_acc_agent"]) > 0.95
    with torch.no_grad():
        assert float(tnets.amp_reward(disc(demo)).mean()) > float(tnets.amp_reward(disc(agent)).mean())


# -------------------------------------------------------- one PPO iteration
OBS, NU, TT, BB = 10, 3, 4, 8


class StubState(NamedTuple):
    obs: jax.Array


class StubEnv:
    obs_size, action_size = OBS, NU

    def reset(self, key):
        return StubState(obs=jnp.zeros((OBS,)))


def trajectory(dtype, policy, params, norm):
    """A numpy-made (T, B) trajectory; logp is the initial policy's plus
    noise, so some ratios leave the clip range."""
    rng = np.random.RandomState(6)
    obs = rng.randn(TT, BB, OBS) * 2.0 + 0.3
    action = rng.randn(TT, BB, NU) * 0.2
    mean, log_std = policy.apply(params, jrn.normalize(norm, jnp.asarray(obs)))
    logp = np.asarray(jnets.gaussian_log_prob(mean, log_std, jnp.asarray(action)))
    done = rng.rand(TT, BB) < 0.15
    traj = dict(obs=obs, action=action, logp=logp + 0.3 * rng.randn(TT, BB),
                reward=rng.randn(TT, BB), terminated=done & (rng.rand(TT, BB) < 0.5),
                done=done, nactive=rng.randint(0, 40, (TT, BB)).astype(np.int32),
                overflow=rng.rand(TT, BB) < 0.2, stalled=rng.rand(TT, BB) < 0.1)
    cast = lambda v: v.astype(dtype) if v.dtype == np.float64 else v
    return {k: cast(v) for k, v in traj.items()}, cast(rng.randn(BB, OBS) * 2.0)


@pytest.mark.parametrize("dtype,max_grad_norm", [(np.float64, 50.0), (np.float32, 50.0),
                                                  (np.float64, 1e-3)])
def test_ppo_iteration_matches_jax(dtype, max_grad_norm):
    """One PPO iteration (2 epochs x 2 minibatches, widths (32, 32)): the
    JAX trainer's train_step on a fixed trajectory against the port's
    update with the permutations JAX draws. Parameters, Adam moments, the
    running norm and the six metrics agree within 1e-9 in float64. In
    float32 Adam's first steps are close to lr * sign(g), so an element
    whose gradient is near zero may move by up to 2 lr per step on one side
    and not the other; the 5e-3 tolerance is relative to each tensor's
    largest entry. At max_grad_norm 1e-3 every step is clipped, so the
    clip's scaling is held too."""
    jdt, tdt = (jnp.float64, torch.float64) if dtype == np.float64 else (jnp.float32,
                                                                           torch.float32)
    kw = dict(horizon=TT, num_envs=BB, opt_num_epochs=2, num_minibatches=2,
              policy_widths=(32, 32), value_widths=(32, 32), max_grad_norm=max_grad_norm)
    jppo = JPPO(StubEnv(), JPPOConfig(**kw))
    ts = jppo.init(jax.random.PRNGKey(7))
    cast = lambda tree: jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), tree)
    pp, vp = cast(ts.policy_params), cast(ts.value_params)
    rng = np.random.RandomState(8)
    norm_np = dict(n=np.asarray(50.0), mean=rng.randn(OBS) * 0.5, var=rng.rand(OBS) + 0.5)
    norm = jrn.RunningNorm(**{k: jnp.asarray(v, jdt) for k, v in norm_np.items()})
    ts = ts.replace(policy_params=pp, value_params=vp, policy_opt=jppo.policy_tx.init(pp),
                    value_opt=jppo.value_tx.init(vp), obs_norm=norm)
    traj, last_obs = trajectory(dtype, jppo.policy, pp, norm)
    jtraj = {k: jnp.asarray(v) for k, v in traj.items()}
    jppo._rollout = lambda ts_, key: (StubState(obs=jnp.asarray(last_obs)), jtraj)
    ts2, j_metrics = jax.jit(jppo.train_step)(ts)
    _, k_perm, _ = jax.random.split(ts.rng, 3)
    n = TT * BB
    perms = np.stack([np.asarray(jax.random.permutation(k, n))
                      for k in jax.random.split(k_perm, 2)])

    policy = tnets.load_flax_params(tnets.PolicyGaussian(OBS, NU, (32, 32)).to(tdt),
                                    jax.device_get(pp))
    value = tnets.load_flax_params(tnets.ValueNet(OBS, (32, 32)).to(tdt), jax.device_get(vp))
    cfg = PPOConfig(**kw)
    tts = TrainState(
        policy=policy, value=value,
        policy_opt=torch.optim.Adam(policy.parameters(), lr=cfg.policy_lr, eps=1e-8),
        value_opt=torch.optim.Adam(value.parameters(), lr=cfg.value_lr, eps=1e-8),
        obs_norm=trn.RunningNorm(**{k: torch.as_tensor(v).to(tdt) for k, v in norm_np.items()}),
        env_states=None, generator=torch.Generator().manual_seed(0), epoch=0)
    tppo = PPO(SimpleNamespace(), cfg)
    tts2, t_metrics = tppo.update(
        tts, SimpleNamespace(obs=torch.as_tensor(last_obs)),
        {k: torch.as_tensor(v) for k, v in traj.items()}, perms=torch.as_tensor(perms))

    def same(ref, val, what):
        if dtype == np.float64:
            assert rel_err(ref, val) <= TOL64, what
        else:
            assert close_rel_max(ref, val, TOL32), what

    assert tts2.epoch == 1 and int(ts2.epoch) == 1
    for jparams, jopt, net, opt in ((ts2.policy_params, ts2.policy_opt, tts2.policy,
                                     tts2.policy_opt),
                                    (ts2.value_params, ts2.value_opt, tts2.value,
                                     tts2.value_opt)):
        adam = jopt[1][0]     # chain(clip, chain(scale_by_adam, scale))
        for ref, port, what in (
                (flat(jax.device_get(jparams)["params"]), port_flat(net), "param"),
                (flat(jax.device_get(adam.mu)["params"]),
                 port_flat(net, lambda p: opt.state[p]["exp_avg"]), "mu"),
                (flat(jax.device_get(adam.nu)["params"]),
                 port_flat(net, lambda p: opt.state[p]["exp_avg_sq"]), "nu")):
            assert set(ref) == set(port)
            for k in ref:
                same(ref[k], port[k], f"{what} {k}")
        assert all(int(opt.state[p]["step"]) == int(adam.count) == 4 for p in net.parameters())
    # the fixed log_std did not move
    assert float((tts2.policy.log_std.detach() - cfg.log_std).abs().max()) == 0.0
    for f in ("n", "mean", "var"):
        same(getattr(ts2.obs_norm, f), getattr(tts2.obs_norm, f), f)
    assert set(j_metrics) == set(t_metrics)
    for k in j_metrics:
        assert t_metrics[k].dim() == 0
        same(np.asarray(j_metrics[k])[None], t_metrics[k][None], k)
