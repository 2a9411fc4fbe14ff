"""The readings that the learner limits of a PPO cell's check are set from
(limits/<workload>.json), on the card at the cell's own size, several
seeds in one process:

    python3 simbench/calibrate_ppo.py --workload ppo_speed_b1600 --seeds 1,2,3 [--control 3]

For each seed it builds the cell as a run does, runs its warm-up, one
iteration (the window's) and the iteration after it that the check
compares (traffic/ppo.py's `release`), then prints one JSON line of
readings:

  * program   the program's iteration against the float64 reference, as a
              run reads it (simbench/ppocheck.py), and the physics of the
              sampled step_autoreset calls (simbench/envcheck.py);
  * replay    the largest difference between the program's kept outputs
              and the program's update run again from the kept inputs
              (`replay`), which the control and the faults are made of: 0
              where the replay is the program;
  * control   (the first `--control` seeds) the plain learner in the next
              precision down from the configuration's (float32 with TF32
              matrix products) put in the program's place from the kept
              inputs (`reference_control`); beside it `control_port`, the
              program's rollout log-probabilities and update run again
              from the kept inputs with TF32 products; and the physics'
              control (simbench/calibrate.py: the reference in float32
              with TF32 products) and planted faults (not with
              --physics 0);
  * faults    (the same seeds) the update run again from the kept inputs
              with each fault of FAULTS planted in the port (`planted`).

The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import inspect
import json
import os
import sys
import textwrap
import time
import types
import __future__

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from simbench import calibrate, harness, ppocheck  # noqa: E402

FAULTS = ("no_grad_clip", "tau_0.9", "no_adv_norm", "norm_not_merged", "step_skipped",
          "norm_mean_kept")
# the line of PPO.update that no_adv_norm takes out
ADV_NORM_LINE = "adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)"


def _without_line(fn, line: str):
    """fn (a method of the port) compiled again from its source with `line`
    replaced by `pass`, in its module's globals."""
    inner = inspect.unwrap(fn)          # the function under a span's wrapper
    src = textwrap.dedent(inspect.getsource(inner))
    if line not in src:
        raise ValueError(f"{fn.__qualname__} has no line {line!r}")
    ns = {}
    code = compile(src.replace(line, "pass"), inspect.getsourcefile(inner), "exec",
                   flags=__future__.annotations.compiler_flag, dont_inherit=True)
    exec(code, inner.__globals__, ns)
    return ns[fn.__name__]


@contextlib.contextmanager
def planted(fault: str, ppo):
    """The port's learner with one fault, inside the block, for the PPO
    instance `ppo`: no_grad_clip (the global-norm clip a no-op), tau_0.9
    (GAE's tau 0.9, the configuration's left as it is), no_adv_norm (the
    advantages not normalised), norm_not_merged (the running norm kept as
    it was), step_skipped (the second policy step of each update left
    out), norm_mean_kept (observations divided by the norm's std with its
    mean not subtracted, in the rollout and the update)."""
    from smplsim_tpu_torch.learning import ppo as mod

    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, obj.__dict__.get(name, getattr(obj, name))))
        setattr(obj, name, value)

    if fault == "no_grad_clip":
        patch(mod, "clip_by_global_norm", lambda grads, max_norm: list(grads))
    elif fault == "tau_0.9":
        patch(ppo, "cfg", dataclasses.replace(ppo.cfg, tau=0.9))
    elif fault == "no_adv_norm":
        patch(mod.PPO, "update", _without_line(mod.PPO.update, ADV_NORM_LINE))
    elif fault == "norm_not_merged":
        patch(mod, "norm_update", lambda stats, batch, group=None: stats)
    elif fault == "norm_mean_kept":
        patch(mod, "normalize", lambda stats, x, clip=5.0:
              (x / torch.sqrt(stats.var + 1e-8)).clamp(-clip, clip))
    elif fault == "step_skipped":
        apply, calls = mod.PPO._apply, [0]

        def skipping(self, loss, net, opt, group=None):
            if isinstance(net, mod.PolicyGaussian):
                calls[0] += 1
                if (calls[0] - 1) % (self.cfg.opt_num_epochs * self.cfg.num_minibatches) == 1:
                    return None
            return apply(self, loss, net, opt, group)
        patch(mod.PPO, "_apply", skipping)
    else:
        raise ValueError(f"no fault {fault!r}")
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def replay(kept: dict, cfg: dict, device, steps: int, fault: str | None = None,
           tf32: bool = False) -> dict:
    """The kept iteration with the program's outputs made again by the
    port from the kept inputs: the rollout's log-probabilities (one policy
    forward per control step, as PPO.rollout takes them) and PPO.update,
    with TF32 matrix products where `tf32` and with `fault` planted."""
    from smplsim_tpu_torch.learning import ppo as mod
    from smplsim_tpu_torch.learning.nets import PolicyGaussian, ValueNet, gaussian_log_prob
    from smplsim_tpu_torch.learning.ppo import PPO, PPOConfig, TrainState
    from smplsim_tpu_torch.learning.running_norm import RunningNorm

    c = dict(cfg)
    for k in ("policy_widths", "value_widths"):
        c[k] = tuple(c[k])
    pcfg = PPOConfig(**c)
    dtype = kept["policy"]["head.weight"].dtype
    obs, act = kept["policy"]["mlp.layers.0.weight"].shape[1], kept["policy"]["head.weight"].shape[0]

    def net(module, name, lr):
        module = module.to(device=device, dtype=dtype)
        module.load_state_dict(kept[name])
        opt = torch.optim.Adam(module.parameters(), lr=lr, eps=1e-8)
        if kept[name + "_adam"]:
            # a copy: the step may run in place on the state it was given
            opt.load_state_dict({"state": copy.deepcopy(kept[name + "_adam"]),
                                 "param_groups": opt.state_dict()["param_groups"]})
        return module, opt
    policy, popt = net(PolicyGaussian(obs, act, pcfg.policy_widths, pcfg.activation,
                                      pcfg.log_std), "policy", pcfg.policy_lr)
    value, vopt = net(ValueNet(obs, pcfg.value_widths, pcfg.activation), "value", pcfg.value_lr)
    gen = torch.Generator(device=device)
    gen.set_state(kept["gen_state"])
    norm = RunningNorm(*(t.to(device) for t in kept["norm"]))
    ts = TrainState(policy=policy, value=value, policy_opt=popt, value_opt=vopt, obs_norm=norm,
                    env_states=None, generator=gen, epoch=0)
    traj = {k: v.to(device) for k, v in kept["traj"].items()}
    zeros = torch.zeros(traj["reward"].shape, dtype=dtype, device=device)
    traj.update(nactive=zeros, overflow=zeros, stalled=zeros)
    ppo = PPO(None, pcfg)
    cap = ppocheck.Capture(steps)
    calibrate.tf32(tf32)
    try:
        with planted(fault, ppo) if fault else contextlib.nullcontext():
            with torch.no_grad():
                traj["logp"] = torch.stack([
                    gaussian_log_prob(*policy(mod.normalize(norm, o, pcfg.obs_clip)), a)
                    for o, a in zip(traj["obs"], traj["action"])])
            last = types.SimpleNamespace(obs=kept["last_obs"].to(device))
            cap.trajectory(ts, last, traj)
            try:
                out, _ = ppo.update(ts, last, traj)
            finally:
                cap.close()
    finally:
        calibrate.tf32(False)
    cap.outputs(out)
    return {**kept, "traj": cap.kept["traj"], "steps": cap.kept["steps"],
            "grad_norms": cap.kept["grad_norms"], "norm_out": cap.kept["norm_out"]}


def reference_control(kept: dict, cfg: dict, device, steps: int) -> dict:
    """The kept iteration with the program's outputs replaced by the plain
    learner's in float32 with TF32 products, from the kept inputs."""
    r = ppocheck.reference_update(kept, cfg, device, torch.float32, steps, tf32=True)

    def host(ts):
        return [ppocheck.host(t) for t in ts]
    return {**kept, "traj": {**kept["traj"], "logp": ppocheck.host(r["logp"])},
            "steps": {n: [{"grads": host(q.grads), "params": host(q.params)}
                          for q in r["steps"][n]] for n in ppocheck.NETS},
            "norm_out": tuple(host((r["norm"].n, r["norm"].mean, r["norm"].var)))}


def replay_gap(a: dict, b: dict) -> float:
    """The largest |a - b| over the outputs two kept iterations hold."""
    pairs = [(a["traj"]["logp"], b["traj"]["logp"])] + list(zip(a["norm_out"], b["norm_out"]))
    pairs += [(torch.tensor(a["grad_norms"][n]), torch.tensor(b["grad_norms"][n]))
              for n in ppocheck.NETS]
    for net in ppocheck.NETS:
        for s, t in zip(a["steps"][net], b["steps"][net]):
            pairs += list(zip(s["grads"], t["grads"])) + list(zip(s["params"], t["params"]))
    return max(float((x.double() - y.double()).abs().max()) for x, y in pairs)


def learner_readings(ctx, kept: dict, control: bool) -> dict:
    cfg, dev, steps = ctx.config["learning"], ctx.device, ctx.traffic["check_steps"]

    def read(k):
        nums, seen = ppocheck.readings(k, cfg, dev, steps)
        return {**nums, **seen}
    out = {"program": read(kept),
           "replay": replay_gap(kept, replay(kept, cfg, dev, steps))}
    if control:
        out["control"] = read(reference_control(kept, cfg, dev, steps))
        out["control_port"] = read(replay(kept, cfg, dev, steps, tf32=True))
        out["faults"] = {f: read(replay(kept, cfg, dev, steps, fault=f)) for f in FAULTS}
    return out


def one_seed(manifest, workload: str, seed: int, device: str = "cuda",
             base: str = harness.HERE, control: bool = True, physics: bool = True) -> dict:
    ctx = harness.Context(manifest, workload, seed, device, base)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    kind = harness.load_module(os.path.join(base, "traffic", ctx.traffic["loop"] + ".py"),
                               "simbench_loop_" + ctx.traffic["loop"])
    t0 = time.time()
    loop = kind.setup(ctx)
    loop.warmup()
    sync()
    t1 = time.time()
    loop.run_one()
    sync()
    t2 = time.time()
    kept = loop.release()
    del loop
    if device == "cuda":
        torch.cuda.empty_cache()
    t3 = time.time()
    out = {"seed": seed, "setup_s": t1 - t0, "iteration_s": t2 - t1, "checked_s": t3 - t2,
           "learner": learner_readings(ctx, kept["learner"], control)}
    t4 = time.time()
    if physics:
        out["physics"] = calibrate.env_readings(ctx, kept["calls"], control)
    out["learner_check_s"], out["physics_check_s"] = t4 - t3, time.time() - t4
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3,
                   help="read the control and the faults on this many of the first seeds")
    p.add_argument("--physics", type=int, choices=(0, 1), default=1,
                   help="0: the learner's readings alone")
    args = p.parse_args()
    manifest = harness.load_json(ROOT, "BENCHMARK.json")
    print(f"card: {harness.card()}", flush=True)
    for i, s in enumerate(args.seeds.split(",")):
        r = one_seed(manifest, args.workload, int(s), control=i < args.control,
                     physics=bool(args.physics))
        print(json.dumps({"workload": args.workload, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
