"""What decides `correct` for PPO training, beside the physics: one PPO
iteration after the window's (traffic/ppo.py), the program's learner
against the plain float64 learner (simbench/reference/learning).

`Capture` copies to the host, around that iteration:

  * inputs, before the rollout: both nets' parameters, both Adam states
    and the running norm; after the rollout: the trajectory (obs, action,
    logp, reward, terminated, done), the observation after it and the
    trainer generator's state, from which the check draws the update's
    first permutation again on the same device;
  * outputs of the update: through torch.optim.Optimizer's step hooks,
    each net's clipped gradient before and its parameters after each of
    its first `steps` optimiser steps, the global norm of its clipped
    gradient at every step of the update, and the merged running norm.

The reference takes the inputs (the kept trajectory as the update's
input, the program's own logp the ratio's denominator) and computes in
float64 with full-precision products. Numbers (limits/<cell>.json names
those compared; the others are printed as observed):

  * logp_gap         the trajectory's log-probabilities: the largest
                     |program - reference| / (1 + |reference|), the
                     reference's from the kept weights, norm, obs and
                     actions;
  * norm_gap         the merged running norm (count, mean, variance): the
                     largest |program - reference| / (1 + |reference|);
  * policy_grad_gap, value_grad_gap
                     a step's clipped gradient of the net, all its
                     parameters flat, against the reference's gradient of
                     the same minibatch at the program's own parameters
                     before that step (so that a parameter an earlier step
                     rounded the other way does not carry over):
                     |g_prog - g_ref| / |g_ref|; the value net's worst
                     step, the policy's first (GRAD_STEPS). After the
                     policy's first step some ratios sit at a clip edge,
                     where the surrogate's gradient jumps: a sample that
                     rounding puts on the other side adds or drops its
                     whole term, so those steps are left to the step gap;
  * policy_step_gap, value_step_gap
                     the net's move from the kept parameters after each
                     step: |dtheta_prog - dtheta_ref| / |dtheta_ref|, the
                     worst step. Adam's first steps move every parameter
                     by about lr times the sign of its gradient, so a
                     gradient entry near zero can flip its move on
                     rounding alone, and a sample at a clip edge (above)
                     shifts a later step's gradient by its whole term,
                     which flips the moves whose moments nearly cancel:
                     the policy's reading has a long tail;
  * clip_excess      the clip itself, at every step of both nets: the
                     largest |clipped gradient| / max_grad_norm - 1, or 0
                     where none exceeds max_grad_norm. The clip scales a
                     gradient to max_grad_norm exactly, so only rounding
                     lies above it; a step that skips the clip reads its
                     whole excess where its norm reached max_grad_norm.

Observed: the samples merged into the running norm and the Adam steps
taken before the compared iteration (`norm_count_before`,
`adam_steps_before`: both above 0 where it follows an update), the
reference's global gradient norms before the clip
(`policy_grad_norms`, `value_grad_norms`), which say whether the clip was
live in the compared steps, and each step's gradient gap
(`policy_grad_gaps`, `value_grad_gaps`), and the steps whose clipped
gradient norm is max_grad_norm (`policy_clipped_steps`,
`value_clipped_steps`): the steps where the clip was live.
"""
from __future__ import annotations

import math

import torch

from simbench.reference.learning import ppo as ref

NAMES = ("logp_gap", "norm_gap", "policy_grad_gap", "value_grad_gap", "policy_step_gap",
         "value_step_gap", "clip_excess")
TRAJ = ("obs", "action", "logp", "reward", "terminated", "done")
NETS = ("policy", "value")
# the steps whose gradients are compared, where not all: the policy's first,
# where every ratio is 1 up to rounding (see policy_grad_gap)
GRAD_STEPS = {"policy": 1}
FIXED = ("log_std",)      # parameters that get no gradient: left out of the comparison


def host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _params(net) -> list:
    return [p for name, p in net.named_parameters() if name not in FIXED]


def _opt_state(opt) -> dict:
    """The optimiser's per-parameter state on the host, keyed by the
    parameter's index in its group."""
    return {i: {k: host(v) if isinstance(v, torch.Tensor) else v for k, v in st.items()}
            for i, st in opt.state_dict()["state"].items()}


class Capture:
    """Keeps what the check compares of one PPO iteration: call `inputs`
    before the rollout, `trajectory` between rollout and update (it hooks
    the optimisers), `outputs` after the update, and `close` in any case."""

    def __init__(self, steps: int):
        self.steps = steps
        self.kept = {"steps": {n: [] for n in NETS}, "grad_norms": {n: [] for n in NETS}}
        self._hooks = []

    def inputs(self, ts) -> None:
        k = self.kept
        for name, net, opt in ((n, getattr(ts, n), getattr(ts, n + "_opt")) for n in NETS):
            k[name] = {p: host(t) for p, t in net.state_dict().items()}
            k[name + "_names"] = [p for p, _ in net.named_parameters()]
            k[name + "_adam"] = _opt_state(opt)
            k[name + "_lr"] = opt.param_groups[0]["lr"]
        k["norm"] = tuple(host(t) for t in (ts.obs_norm.n, ts.obs_norm.mean, ts.obs_norm.var))

    def trajectory(self, ts, env_states, traj: dict) -> None:
        k = self.kept
        k["traj"] = {name: host(traj[name]) for name in TRAJ}
        k["last_obs"] = host(env_states.obs)
        k["gen_state"] = ts.generator.get_state()
        for name in NETS:
            net, opt, rec = getattr(ts, name), getattr(ts, name + "_opt"), k["steps"][name]
            self._hooks += [opt.register_step_pre_hook(self._pre(net, rec, k["grad_norms"][name])),
                            opt.register_step_post_hook(self._post(net, rec))]

    def _pre(self, net, rec, norms):
        def hook(opt, args, kwargs):
            grads = [p.grad for p in _params(net)]
            # a device scalar, read once the update is done
            norms.append(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads))))
            if len(rec) < self.steps:
                rec.append({"grads": [host(g) for g in grads]})
        return hook

    def _post(self, net, rec):
        def hook(opt, args, kwargs):
            if rec and "params" not in rec[-1]:
                rec[-1]["params"] = [host(p) for p in _params(net)]
        return hook

    def outputs(self, ts) -> None:
        k = self.kept
        k["norm_out"] = tuple(host(t) for t in (ts.obs_norm.n, ts.obs_norm.mean, ts.obs_norm.var))
        k["grad_norms"] = {n: [float(v) for v in k["grad_norms"][n]] for n in NETS}

    def close(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []


# ------------------------------------------------------------ the reference
def layers(state: dict) -> list:
    """The reference's [(W, b)] of a port net's state dict: the MLP's
    layers in order, then the head."""
    n = sum(1 for k in state if k.startswith("mlp.layers.") and k.endswith(".weight"))
    return ([(state[f"mlp.layers.{i}.weight"], state[f"mlp.layers.{i}.bias"]) for i in range(n)]
            + [(state["head.weight"], state["head.bias"])])


def adam(kept: dict, net: str, params: list, cast) -> ref.Adam:
    """The reference's Adam from the program's state at the kept inputs
    (none before the first step); the fixed parameters left out."""
    st = kept[net + "_adam"]
    idx = [i for i, name in enumerate(kept[net + "_names"]) if name not in FIXED]
    if not st:
        zeros = [torch.zeros_like(p) for p in params]
        return ref.Adam(lr=kept[net + "_lr"], step=0, m=zeros, v=[z.clone() for z in zeros])
    return ref.Adam(lr=kept[net + "_lr"], step=int(st[idx[0]]["step"]),
                    m=[cast(st[i]["exp_avg"]) for i in idx],
                    v=[cast(st[i]["exp_avg_sq"]) for i in idx])


def reference_update(kept: dict, cfg: dict, device, dtype=torch.float64, steps: int = 3,
                     tf32: bool = False) -> dict:
    """The reference's logp of the kept trajectory and its update from the
    kept inputs (reference.learning.ppo.update), in dtype, its matrix
    products at full precision (TF32 where `tf32`, for the control)."""
    def cast(t):
        return t.to(device=device, dtype=dtype) if t.is_floating_point() else t.to(device)

    with ref.precision("tf32" if tf32 else "ieee"), torch.no_grad():
        nets = {n: [(cast(W), cast(b)) for W, b in layers(kept[n])] for n in NETS}
        log_std = cast(kept["policy"]["log_std"])
        norm = ref.Norm(*(cast(t) for t in kept["norm"]))
        traj = {k: cast(v) for k, v in kept["traj"].items()}
        T, B = traj["reward"].shape
        gen = torch.Generator(device=device)
        gen.set_state(kept["gen_state"])
        perms = [torch.randperm(T * B, generator=gen, device=device)
                 for _ in range(math.ceil(steps / cfg["num_minibatches"]))]
        rcfg = ref.Config(**{f: cfg[f] for f in ("gamma", "tau", "clip_epsilon", "num_minibatches",
                                                 "max_grad_norm", "obs_clip")})
        logp = ref.rollout_logp(nets["policy"], log_std, norm, traj["obs"], traj["action"],
                                cfg["obs_clip"])
        # each step's gradient once more at the program's parameters before it
        at = {n: [ref.flat(nets[n])] + [[cast(t) for t in s["params"]]
                                        for s in kept["steps"][n][:steps - 1] if "params" in s]
              for n in NETS}
        out = ref.update(rcfg, nets["policy"], log_std, nets["value"],
                         adam(kept, "policy", ref.flat(nets["policy"]), cast),
                         adam(kept, "value", ref.flat(nets["value"]), cast),
                         norm, traj, cast(kept["last_obs"]), perms, steps, at)
        out["logp"] = logp
        out["start"] = {n: ref.flat(nets[n]) for n in NETS}
    return out


def _rel_max(p: torch.Tensor, r: torch.Tensor) -> float:
    """The largest |p - r| / (1 + |r|); inf where p is not finite."""
    p, r = p.to(r), r
    if not bool(torch.isfinite(p).all()):
        return math.inf
    return float(((p - r).abs() / (1.0 + r.abs())).max()) if r.numel() else 0.0


def _norm(ts: list) -> torch.Tensor:
    return torch.sqrt(sum((t.double() ** 2).sum() for t in ts))


def _rel_norm(p: list, r: list) -> float:
    """|p - r| / |r| over every tensor of the lists, flat; inf where p is
    not finite."""
    d = [a.to(b) - b for a, b in zip(p, r)]
    if not all(bool(torch.isfinite(t).all()) for t in d):
        return math.inf
    return float(_norm(d) / _norm(r))


def readings(kept: dict, cfg: dict, device, steps: int, dtype=torch.float64,
             refs: dict | None = None):
    """({name: value} of NAMES, observed) of the kept iteration against
    the reference's first `steps` steps of each net; cfg: the
    configuration's learner settings (not the program's); `refs` the
    reference_update where already worked out. A net the program stepped
    fewer times than `steps` reads inf."""
    r = refs or reference_update(kept, cfg, device, dtype, steps)
    out = {"logp_gap": _rel_max(kept["traj"]["logp"], r["logp"])}
    n, mean, var = kept["norm_out"]
    out["norm_gap"] = max(_rel_max(a, b) for a, b in zip(
        (n.reshape(1), mean, var), (r["norm"].n.reshape(1), r["norm"].mean, r["norm"].var)))
    st = kept["policy_adam"]
    observed = {"norm_count_before": float(kept["norm"][0]),
                "adam_steps_before": int(next(iter(st.values()))["step"]) if st else 0}
    for net in NETS:
        prog, mine = kept["steps"][net], r["steps"][net]
        grad = step = 0.0
        if len(prog) < len(mine) or any("params" not in s for s in prog):
            grad = step = math.inf
        gaps = [_rel_norm(p["grads"], q.grads if q.at is None else q.at)
                for p, q in zip(prog, mine)]
        observed[net + "_grad_gaps"] = gaps
        grad = max([grad] + gaps[:GRAD_STEPS.get(net, len(gaps))])
        for p, q in zip(prog, mine):
            if "params" in p:
                moved = [a.to(s) - s for a, s in zip(p["params"], r["start"][net])]
                step = max(step, _rel_norm(moved, [a - s for a, s in zip(q.params,
                                                                          r["start"][net])]))
        out[net + "_grad_gap"], out[net + "_step_gap"] = grad, step
        observed[net + "_grad_norms"] = [q.norm for q in mine]
    # the clip, at every step: the clipped norm is max_grad_norm to rounding
    limit = cfg["max_grad_norm"]
    norms = [v for n in NETS for v in kept["grad_norms"][n]]
    out["clip_excess"] = (max([0.0] + [v / limit - 1.0 for v in norms])
                          if all(math.isfinite(v) for v in norms) else math.inf)
    for n in NETS:
        observed[n + "_clipped_steps"] = sum(abs(v / limit - 1.0) < 1e-4
                                             for v in kept["grad_norms"][n])
    return out, observed
