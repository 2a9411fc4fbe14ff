"""One rank of a gloo world on the CPU for tests/test_torch_parallel.py.

    python tests/_torch_distributed_worker.py <case> <rank> <world> <store> <in.npz> <out.npz>

Loads numpy inputs from in.npz, joins the world at the file:// rendezvous
`store` (init_distributed for a world of 2 or more; at one rank, where
init_distributed is a no-op, the world of 1 is made directly, so the
collectives still run), runs `case` on the port and writes its outputs to
out.npz. Imports no JAX. Also the home of run_ranks' test functions
(`ranks_sum`, `sleeper`), which spawned processes import by name.
"""
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch.distributed as dist

from smplsim_tpu_torch.parallel import mesh as pm


def unflat(inp, prefix):
    """{"<prefix>a/b/c": x} -> {"a": {"b": {"c": x}}}."""
    out = {}
    for k in inp.files:
        if k.startswith(prefix):
            node = out
            *path, leaf = k[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = inp[k]
    return out


def port_flat(prefix, module, of=lambda p: p):
    """The module's tensors under flax's names (tests/test_torch_learning.py)."""
    out = {}
    for path, lin in module.flax_layers().items():
        out[f"{prefix}{path}/kernel"] = of(lin.weight).detach().numpy().T
        out[f"{prefix}{path}/bias"] = of(lin.bias).detach().numpy()
    if hasattr(module, "log_std"):
        out[f"{prefix}log_std"] = of(module.log_std).detach().numpy()
    return out


@dataclasses.dataclass
class Batch:
    obs: torch.Tensor
    rng: torch.Generator


def case_reductions(inp, mesh, out):
    """shard_batch, shard_env_states, replicate; norm_update and
    stats_summary with the group."""
    from smplsim_tpu_torch.learning import episode_stats as es
    from smplsim_tpu_torch.learning import running_norm as rn

    r = mesh.rank
    x = torch.as_tensor(inp["x"])
    out["shard"] = pm.shard_batch({"x": x}, mesh)["x"].numpy()
    st = pm.shard_env_states(Batch(x, torch.Generator().manual_seed(5)), mesh)
    out["env_rows"] = st.obs.numpy()
    out["env_draw"] = torch.rand(4, generator=st.rng, dtype=torch.float64).numpy()
    # rank-dependent values, replicated from rank 0
    lin = torch.nn.Linear(3, 2, dtype=torch.float64)
    with torch.no_grad():
        lin.weight.fill_(float(r + 1))
        lin.bias.fill_(-float(r + 1))
    gen = torch.Generator().manual_seed(100 + r)
    rep = pm.replicate({"t": x + r, "lin": lin, "gen": gen}, mesh)
    out["rep_t"] = rep["t"].numpy()
    out["rep_w"] = lin.weight.detach().numpy()
    out["rep_b"] = lin.bias.detach().numpy()
    out["rep_draw"] = torch.rand(4, generator=gen, dtype=torch.float64).numpy()

    stats = rn.RunningNorm(*(torch.as_tensor(inp[f"norm_{f}"]) for f in ("n", "mean", "var")))
    batch = torch.as_tensor(inp["batch"][r])
    new = rn.norm_update(stats, batch, mesh.group)
    for f in ("n", "mean", "var"):
        out[f"norm_{f}"] = getattr(new, f).numpy()
    fields = ("num_episodes", "total_return", "total_length", "max_return", "min_return")
    s = es.EpisodeStats(cur_return=torch.zeros(1), cur_length=torch.zeros(1),
                        **{f: torch.as_tensor(inp[f][r]) for f in fields})
    for k, v in es.stats_summary(s, mesh.group).items():
        out[f"summary_{k}"] = v.numpy()
    # the mesh of the first rank only: rank 1 stands outside it
    sub = pm.data_mesh(1, device="cpu")
    out["sub"] = np.asarray([sub.rank, sub.size])
    if sub.rank == 0:
        out["sub_sum"] = pm.psum(torch.tensor([2.5]), sub.group).numpy()


def case_ppo(inp, mesh, out):
    """One PPO.update(group=) on the rank's columns of a (T, B) trajectory,
    per dtype tag in inp["tags"], with the nets loaded from flax params and
    the permutations given."""
    from types import SimpleNamespace

    from smplsim_tpu_torch.learning import nets
    from smplsim_tpu_torch.learning.ppo import PPO, PPOConfig, TrainState
    from smplsim_tpu_torch.learning.running_norm import RunningNorm

    r, w = mesh.rank, mesh.size
    obs_dim, nu = int(inp["obs_dim"]), int(inp["nu"])
    widths = tuple(int(v) for v in inp["widths"])
    cfg = PPOConfig(opt_num_epochs=int(inp["epochs"]), num_minibatches=int(inp["minibatches"]),
                    policy_widths=widths, value_widths=widths,
                    max_grad_norm=float(inp["max_grad_norm"]))
    for tag in inp["tags"]:
        dt = {"f64": torch.float64, "f32": torch.float32}[str(tag)]
        policy = nets.load_flax_params(nets.PolicyGaussian(obs_dim, nu, widths).to(dt),
                                       unflat(inp, f"{tag}/pp/"))
        value = nets.load_flax_params(nets.ValueNet(obs_dim, widths).to(dt),
                                      unflat(inp, f"{tag}/vp/"))
        ts = TrainState(
            policy=policy, value=value,
            policy_opt=torch.optim.Adam(policy.parameters(), lr=cfg.policy_lr, eps=1e-8),
            value_opt=torch.optim.Adam(value.parameters(), lr=cfg.value_lr, eps=1e-8),
            obs_norm=RunningNorm(*(torch.as_tensor(inp[f"{tag}/norm_{f}"])
                                   for f in ("n", "mean", "var"))),
            env_states=None, generator=torch.Generator().manual_seed(0), epoch=0)
        b = inp[f"{tag}/last_obs"].shape[0] // w
        traj = {k[len(f"{tag}/traj/"):]: torch.as_tensor(inp[k][:, r * b:(r + 1) * b])
                for k in inp.files if k.startswith(f"{tag}/traj/")}
        last = SimpleNamespace(obs=torch.as_tensor(inp[f"{tag}/last_obs"][r * b:(r + 1) * b]))
        ts, metrics = PPO(SimpleNamespace(), cfg).update(
            ts, last, traj, perms=torch.as_tensor(inp[f"{tag}/perms"][r]), group=mesh.group)
        for name, net, opt in (("policy", ts.policy, ts.policy_opt),
                               ("value", ts.value, ts.value_opt)):
            out.update(port_flat(f"{tag}/{name}/param/", net))
            out.update(port_flat(f"{tag}/{name}/mu/", net, lambda p: opt.state[p]["exp_avg"]))
            out.update(port_flat(f"{tag}/{name}/nu/", net, lambda p: opt.state[p]["exp_avg_sq"]))
            out[f"{tag}/{name}/steps"] = np.asarray(
                [int(opt.state[p]["step"]) for p in net.parameters()])
        for f in ("n", "mean", "var"):
            out[f"{tag}/norm_{f}"] = getattr(ts.obs_norm, f).numpy()
        for k, v in metrics.items():
            out[f"{tag}/metric/{k}"] = v.numpy()


def case_cem(inp, mesh, out):
    """CEMPlanner.plan(group=) on an analytic cost with the rank's normals."""
    from smplsim_tpu_torch.control import CEMConfig, CEMPlanner

    target, weight = torch.as_tensor(inp["target"]), torch.as_tensor(inp["weight"])
    eps = torch.as_tensor(inp["eps"][mesh.rank])
    iters, n, h, nu = eps.shape
    planner = CEMPlanner(type("StubEnv", (), {"action_size": nu})(), CEMConfig(
        horizon=h, num_samples=n, num_elites=int(inp["elites"]), iterations=iters,
        init_std=float(inp["init_std"])))
    planner._rollout_cost = lambda state, a: (weight * (a - target) ** 2).sum((1, 2))
    state = type("S", (), {"phys": type("P", (), {"qpos": torch.zeros(1, 3, dtype=eps.dtype)})})
    mean0 = torch.as_tensor(inp["mean0"]) if "mean0" in inp.files else None
    a0, mean, best = planner.plan(state, mean0, eps=eps, group=mesh.group)
    out.update(a0=a0.numpy(), mean=mean.numpy(), best=best.numpy())


def case_trainer(inp, mesh, out):
    """sharded_ppo_step on a tiny HumanoidSpeed on the CPU. At one rank
    also rollout + update (no group) from the derived local TrainState of
    a second, identical init; every state tensor of each iteration out."""
    from smplsim_tpu_torch.envs import HumanoidSpeed, SpeedConfig
    from smplsim_tpu_torch.learning.ppo import PPO, PPOConfig
    from smplsim_tpu_torch.models import registry
    from smplsim_tpu_torch.parallel import rollout as pr

    model = registry.default_humanoid(torch.float64, device="cpu")
    env = HumanoidSpeed(model, SpeedConfig(control_frequency_inv=2))
    ppo = PPO(env, PPOConfig(horizon=2, num_envs=4, opt_num_epochs=2, num_minibatches=2,
                             policy_widths=(16,), value_widths=(16,)))
    # sharded_rollout under a uniform random policy; at one rank also the
    # same loop by hand from fold_in(generator, 0)
    policy = lambda g, obs: torch.rand(obs.shape[0], env.action_size, generator=g,
                                       dtype=obs.dtype) * 2 - 1
    states = pm.shard_env_states(env.reset(4, torch.Generator().manual_seed(2)), mesh)
    _, traj = pr.sharded_rollout(env, policy, mesh, 2)(states, torch.Generator().manual_seed(3))
    for k, v in traj.items():
        out[f"rollout/{k}"] = v.numpy()
    if mesh.size == 1:
        g, st, rews = pm.fold_in(torch.Generator().manual_seed(3), 0), states, []
        for _ in range(2):
            st = env.step_autoreset(st, policy(g, st.obs))
            rews.append(st.reward)
        out["rollout_ref/reward"] = torch.stack(rews).numpy()
    step, ts = pr.sharded_ppo_step(ppo, mesh, ppo.init(int(inp["seed"])))
    ref = pr.place_train_state(ppo.init(int(inp["seed"])), mesh) if mesh.size == 1 else None
    for it in range(int(inp["iterations"])):
        ts, metrics = step(ts)
        out[f"it{it}/epoch"] = np.asarray(ts.epoch)
        dump(out, f"it{it}/", ts, metrics)
        if ref is not None:
            local = pr.local_train_state(ref, mesh)
            env_states, traj = ppo.rollout(local)
            new, ref_metrics = ppo.update(local, env_states, traj)
            ref = dataclasses.replace(new, generator=pm.fold_in(ref.generator, pr.CARRY_FOLD))
            dump(out, f"it{it}/ref/", ref, ref_metrics)


def dump(out, prefix, ts, metrics):
    """Every state tensor of a TrainState (learning/ppo.py::state_tensors:
    the trainer's generator, nets, optimisers and running norm under
    "state/", the env states under "env/") and the metrics."""
    from smplsim_tpu_torch.learning.ppo import state_tensors

    own = len(state_tensors(ts, env=False))
    for i, t in enumerate(state_tensors(ts)):
        out[f"{prefix}{'state' if i < own else 'env'}/{i:03d}"] = t.numpy()
    for k, v in metrics.items():
        out[f"{prefix}metric/{k}"] = v.numpy()


CASES = {"reductions": case_reductions, "ppo": case_ppo, "cem": case_cem,
         "trainer": case_trainer}


def ranks_sum(rank, world, store):
    """run_ranks' test: the sum of the ranks over a gloo world."""
    pm.init_distributed(store, world, rank, backend="gloo")
    try:
        return float(pm.psum(torch.tensor(float(rank)), pm.data_mesh(device="cpu").group))
    finally:
        dist.destroy_process_group()


def sleeper(rank, world, store):
    """run_ranks' timeout test: a rank that never finishes in time."""
    time.sleep(600)


def main():
    case, rank, world, store, src, dst = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    if world == 1:
        dist.init_process_group("gloo", init_method=store, world_size=1, rank=0,
                                timeout=pm.TIMEOUT)
    else:
        pm.init_distributed(store, world, rank, backend="gloo")
    try:
        mesh = pm.data_mesh(device="cpu")
        out = {}
        with np.load(src) as inp:
            CASES[case](inp, mesh, out)
        np.savez(dst, **out)
    finally:
        dist.destroy_process_group()
    print(f"RANK_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
