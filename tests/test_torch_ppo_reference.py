"""PyTorch port: PPO's update and its rollout's log-probabilities against
the benchmark's plain float64 learner (simbench/reference/learning), on
seeded random weights: widths (64, 64), 8 HumanoidSpeed envs, horizon 4,
2 epochs x 2 minibatches, float64 throughout.

The second of two iterations is compared, so that the running norm and
both Adam states are not at their start: the trajectory's logp, the GAE
advantages and returns, the merged norm, and each net's clipped gradient
and parameters after every minibatch step, taken with the optimisers'
step hooks (the policy's gradient norm reaches max_grad_norm, so the clip
is live). A fault planted in the port's update comes out over the
tolerance.
"""
import copy
import dataclasses
import math
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from simbench.reference.learning import ppo as ref  # noqa: E402
from smplsim_tpu_torch.envs import HumanoidSpeed, SpeedConfig  # noqa: E402
from smplsim_tpu_torch.learning import ppo as ppo_mod  # noqa: E402
from smplsim_tpu_torch.learning.ppo import PPO, PPOConfig  # noqa: E402
from smplsim_tpu_torch.models import registry  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-9
STEPS = 4          # 2 epochs x 2 minibatches: every step of the update
CFG = PPOConfig(num_envs=8, horizon=4, opt_num_epochs=2, num_minibatches=2,
                policy_widths=(64, 64), value_widths=(64, 64))
NETS = ("policy", "value")


@pytest.fixture(scope="module")
def second_iteration():
    """(ppo, train state, env states, trajectory) of the second iteration,
    after its rollout."""
    m = registry.default_humanoid(torch.float64, device="cpu")
    env = HumanoidSpeed(m, SpeedConfig(control_frequency_inv=2), keeps=(24, 16, 8),
                        qp_iters=4, qp_rows=64, qp_tol=1e-6)
    ppo = PPO(env, CFG)
    ts = ppo.init(7)
    ts, _ = ppo.update(ts, *ppo.rollout(ts))
    st, traj = ppo.rollout(ts)
    return ppo, ts, st, traj


def _trained(net) -> list:
    """The net's parameters in the reference's layer order (the MLP's
    layers, then the head; W before b), the fixed log_std left out."""
    named = dict(net.named_parameters())
    layers = sum(1 for k in named if k.startswith("mlp.layers.") and k.endswith(".weight"))
    return [named[f"{layer}.{w}"] for layer in [f"mlp.layers.{i}" for i in range(layers)] + ["head"]
            for w in ("weight", "bias")]


def _update(second_iteration, monkeypatch, ppo=None):
    """The port's update of the second iteration on copies of its state:
    {inputs, steps: {net: [(clipped grads, params after)]}, norm, adv, ret}."""
    ppo0, ts, st, traj = second_iteration
    ppo = ppo or ppo0
    ts = copy.deepcopy(ts)
    kept = {"start": {n: [p.detach().clone() for p in _trained(getattr(ts, n))] for n in NETS},
            "adam": {}, "gen": ts.generator.get_state(), "steps": {n: [] for n in NETS}}
    for n in NETS:
        opt, net = getattr(ts, n + "_opt"), getattr(ts, n)
        state = opt.state
        kept["adam"][n] = [{k: v.clone() for k, v in state[p].items()} for p in _trained(net)]
    gae = ppo_mod.estimate_advantages

    def spy(*args, **kwargs):
        kept["adv"], kept["ret"] = gae(*args, **kwargs)
        return kept["adv"], kept["ret"]
    monkeypatch.setattr(ppo_mod, "estimate_advantages", spy)
    hooks = []
    for n in NETS:
        net, rec = getattr(ts, n), kept["steps"][n]
        opt = getattr(ts, n + "_opt")
        hooks += [
            opt.register_step_pre_hook(
                lambda o, a, k, net=net, rec=rec: rec.append(
                    [[p.grad.clone() for p in _trained(net)]])),
            opt.register_step_post_hook(
                lambda o, a, k, net=net, rec=rec: rec[-1].append(
                    [p.detach().clone() for p in _trained(net)]))]
    try:
        out, _ = ppo.update(ts, st, traj)
    finally:
        for h in hooks:
            h.remove()
    kept["norm"] = out.obs_norm
    return kept


def _reference(second_iteration, kept) -> dict:
    _, ts, st, traj = second_iteration
    with torch.no_grad():
        nets = {n: ref.unflat([t.clone() for t in kept["start"][n]]) for n in NETS}
        adams = {n: ref.Adam(lr=getattr(CFG, n + "_lr"), step=int(kept["adam"][n][0]["step"]),
                             m=[s["exp_avg"] for s in kept["adam"][n]],
                             v=[s["exp_avg_sq"] for s in kept["adam"][n]]) for n in NETS}
        norm = ref.Norm(ts.obs_norm.n.clone(), ts.obs_norm.mean.clone(), ts.obs_norm.var.clone())
        gen = torch.Generator().set_state(kept["gen"])
        T, B = traj["reward"].shape
        perms = [torch.randperm(T * B, generator=gen) for _ in range(CFG.opt_num_epochs)]
        log_std = ts.policy.log_std.detach()
        rcfg = ref.Config(**{f: getattr(CFG, f) for f in (
            "gamma", "tau", "clip_epsilon", "num_minibatches", "max_grad_norm", "obs_clip")})
        out = ref.update(rcfg, nets["policy"], log_std, nets["value"], adams["policy"],
                         adams["value"], norm, traj, st.obs, perms, STEPS)
        out["logp"] = ref.rollout_logp(nets["policy"], log_std, norm, traj["obs"],
                                       traj["action"], CFG.obs_clip)
    return out


def _gap(a, b) -> float:
    """The largest |a - b| / (1 + |b|) over two lists of tensors."""
    return max(float(((x - y).abs() / (1.0 + y.abs())).max()) for x, y in zip(a, b))


def _gaps(second_iteration, kept, r) -> dict:
    traj = second_iteration[3]
    out = {"logp": _gap([traj["logp"]], [r["logp"]]),
           "gae": _gap([kept["adv"], kept["ret"]], [r["gae"], r["ret"]]),
           "norm": _gap([kept["norm"].n.reshape(1), kept["norm"].mean, kept["norm"].var],
                        [r["norm"].n.reshape(1), r["norm"].mean, r["norm"].var])}
    for n in NETS:
        prog, mine = kept["steps"][n], r["steps"][n]
        if len(prog) != len(mine):
            out[n] = math.inf
            continue
        out[n] = max(max(_gap(g, q.grads), _gap(p, q.params)) for (g, p), q in zip(prog, mine))
    return out


def test_update_and_logp_match_the_plain_learner(second_iteration, monkeypatch):
    kept = _update(second_iteration, monkeypatch)
    ts = second_iteration[1]
    assert kept["adam"]["policy"] and int(ts.obs_norm.n) == CFG.num_envs * CFG.horizon
    r = _reference(second_iteration, kept)
    gaps = _gaps(second_iteration, kept, r)
    assert max(gaps.values()) < TOL, gaps
    assert all(len(kept["steps"][n]) == STEPS for n in NETS)
    # the policy's global gradient norm reaches max_grad_norm: the clip is live
    assert max(s.norm for s in r["steps"]["policy"]) > CFG.max_grad_norm


def _no_grad_clip(monkeypatch, ppo):
    monkeypatch.setattr(ppo_mod, "clip_by_global_norm", lambda grads, max_norm: list(grads))
    return ppo


def _tau(monkeypatch, ppo):
    return PPO(ppo.env, dataclasses.replace(ppo.cfg, tau=0.9))


@pytest.mark.parametrize("fault", [_no_grad_clip, _tau], ids=["no_grad_clip", "tau_0.9"])
def test_a_planted_fault_fails(second_iteration, monkeypatch, fault):
    ppo = fault(monkeypatch, second_iteration[0])
    kept = _update(second_iteration, monkeypatch, ppo)
    gaps = _gaps(second_iteration, kept, _reference(second_iteration, kept))
    assert max(gaps.values()) > 1e3 * TOL, gaps
