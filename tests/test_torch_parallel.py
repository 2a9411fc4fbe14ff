"""The port's data parallelism (smplsim_tpu_torch/parallel and the group=
paths of the trainer and the planner) against the JAX package's shard_map.

Each case runs a gloo world of CPU processes (tests/_torch_distributed_worker.py,
started by subprocess; numpy inputs and outputs through .npz files; the
rendezvous a FileStore under tmp_path, so parallel test workers never race
for a port) and holds every rank against JAX's shard_map over 2 of the
conftest's virtual CPU devices, given the same draws: float64 within 1e-9
relative, float32 within 5e-3 of each tensor's largest entry, and the ranks'
replicated values bit for bit against each other. The JAX trainer's
`_rollout` and planner's `_rollout_cost` are replaced on the instance, so
no JAX env is compiled. A world that outlives its timeout is killed and
fails the test.
"""
import multiprocessing
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from _torch_distributed_worker import ranks_sum, sleeper
from _torch_port import rel_err
from test_torch_cem import Phys, State
from test_torch_learning import BB, OBS, TT, StubEnv, StubState, close_rel_max, flat, trajectory
from smplsim_tpu.control.cem import CEMConfig as JCEMConfig
from smplsim_tpu.control.cem import CEMPlanner as JCEMPlanner
from smplsim_tpu.learning import episode_stats as jes
from smplsim_tpu.learning import running_norm as jrn
from smplsim_tpu.learning.ppo import PPO as JPPO
from smplsim_tpu.learning.ppo import PPOConfig as JPPOConfig
from smplsim_tpu.parallel.rollout import sharded_ppo_step as j_sharded_ppo_step
from smplsim_tpu_torch.parallel import data_mesh, init_distributed
from smplsim_tpu_torch.parallel.mesh import fold_in, run_ranks

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_distributed_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TIMEOUT = 240          # seconds for a world to finish
TOL64 = 1e-9
TOL32 = 5e-3
FIELDS = ("num_episodes", "total_return", "total_length", "max_return", "min_return")


def jax_mesh():
    return Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))


def run_world(case, world, inputs, tmp_path):
    """Run `case` on `world` worker processes; their outputs in rank order.
    On a timeout every worker is killed and the test fails."""
    src = tmp_path / f"{case}_{world}_in.npz"
    np.savez(src, **inputs)
    store = "file://" + str(tmp_path / f"{case}_{world}_store")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, WORKER, case, str(r), str(world), store, str(src),
         str(tmp_path / f"{case}_{world}_out{r}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in log, f"rank {r} failed:\n{log[-3000:]}"
    return [dict(np.load(tmp_path / f"{case}_{world}_out{r}.npz")) for r in range(world)]


def same_across_ranks(outs, keys):
    for k in keys:
        assert all(np.array_equal(outs[0][k], o[k]) for o in outs[1:]), k


# ----------------------------------------------------------------- a) plumbing
def test_init_is_a_noop_at_one_process_and_nccl_needs_a_card(tmp_path, monkeypatch):
    init_distributed(num_processes=1)
    assert not dist.is_initialized()
    mesh = data_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device) == (None, 0, 1, torch.device("cpu"))
    with pytest.raises(ValueError):
        data_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="nccl"):
        init_distributed(f"file://{tmp_path / 'store'}", 2, 0)
    assert not dist.is_initialized()


def test_fold_in_is_one_rule_of_the_state_and_the_data():
    g = torch.Generator().manual_seed(3)
    before = g.get_state().clone()
    draws = [torch.rand(4, generator=fold_in(g, r)) for r in (0, 1, 0, 2 ** 31)]
    assert torch.equal(g.get_state(), before)
    assert torch.equal(draws[0], draws[2])
    assert not torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[3])
    g2 = torch.Generator().manual_seed(3)
    torch.rand(1, generator=g2)
    assert not torch.equal(torch.rand(4, generator=fold_in(g2, 0)), draws[0])


def test_run_ranks_collects_in_rank_order_and_kills_on_timeout():
    assert run_ranks(ranks_sum, WORLD, timeout=TIMEOUT) == [1.0, 1.0]
    with pytest.raises(TimeoutError):
        run_ranks(sleeper, WORLD, timeout=5)
    assert not multiprocessing.active_children()


@pytest.fixture(scope="module")
def reductions(tmp_path_factory):
    """One 2-rank world for the plumbing and the two reductions, and its
    inputs: norm_update's running stats and a per-rank batch, and per-rank
    episode aggregates (rank 1 finished no episode: max -inf, min inf)."""
    rng = np.random.RandomState(2)
    inputs = dict(
        x=rng.randn(6, 3), norm_n=np.asarray(40.0), norm_mean=rng.randn(5) * 0.5,
        norm_var=rng.rand(5) + 0.5, batch=rng.randn(WORLD, 7, 5) * 2.0 + 0.3,
        num_episodes=np.asarray([3.0, 0.0]), total_return=np.asarray([7.5, 0.0]),
        total_length=np.asarray([41.0, 0.0]), max_return=np.asarray([4.0, -np.inf]),
        min_return=np.asarray([0.5, np.inf]))
    return inputs, run_world("reductions", WORLD, inputs, tmp_path_factory.mktemp("red"))


def test_shard_batch_and_replicate_at_two_ranks(reductions):
    inputs, outs = reductions
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["shard"], inputs["x"][3 * r:3 * r + 3])
        np.testing.assert_array_equal(o["env_rows"], inputs["x"][3 * r:3 * r + 3])
        # the env generator folded with the rank
        expect = torch.rand(4, generator=fold_in(torch.Generator().manual_seed(5), r),
                            dtype=torch.float64).numpy()
        np.testing.assert_array_equal(o["env_draw"], expect)
        # rank 0's values everywhere: a tensor, a module, a generator
        np.testing.assert_array_equal(o["rep_t"], inputs["x"])
        assert (o["rep_w"] == 1.0).all() and (o["rep_b"] == -1.0).all()
        np.testing.assert_array_equal(o["rep_draw"], torch.rand(
            4, generator=torch.Generator().manual_seed(100), dtype=torch.float64).numpy())
    assert not np.array_equal(outs[0]["env_draw"], outs[1]["env_draw"])
    # data_mesh(1) in a world of 2: rank 0 alone, rank 1 outside
    assert outs[0]["sub"].tolist() == [0, 1] and outs[1]["sub"].tolist() == [-1, 1]
    assert outs[0]["sub_sum"].tolist() == [2.5] and "sub_sum" not in outs[1]


def test_norm_update_and_stats_summary_at_two_ranks_match_jax(reductions):
    inputs, outs = reductions
    stats = jrn.RunningNorm(*(jnp.asarray(inputs[f"norm_{f}"]) for f in ("n", "mean", "var")))

    def local(batch, *agg):
        norm = jrn.norm_update(stats, batch[0], "data")
        s = jes.EpisodeStats(cur_return=jnp.zeros(1), cur_length=jnp.zeros(1),
                             **{f: a[0] for f, a in zip(FIELDS, agg)})
        return norm, jes.stats_summary(s, "data")

    f = shard_map(local, mesh=jax_mesh(), in_specs=(P("data"),) * 6, out_specs=(P(), P()),
                  check_vma=False)
    jnorm, jsum = jax.jit(f)(jnp.asarray(inputs["batch"]),
                             *(jnp.asarray(inputs[k]) for k in FIELDS))
    for o in outs:
        for fld in ("n", "mean", "var"):
            assert rel_err(getattr(jnorm, fld), o[f"norm_{fld}"]) <= TOL64, fld
        for k, v in jsum.items():
            assert rel_err(v, o[f"summary_{k}"]) <= TOL64, k
    assert float(outs[0]["summary_max_episode_reward"]) == 4.0
    assert float(outs[0]["summary_min_episode_reward"]) == 0.5
    same_across_ranks(outs, [k for k in outs[0] if k.startswith(("norm_", "summary_"))])


# ------------------------------------------------------------- c) the PPO update
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sharded_ppo_update_at_two_ranks_matches_jax(dtype, tmp_path):
    """One sharded PPO iteration (2 epochs x 2 minibatches, widths (32, 32))
    at 2 ranks: JAX's sharded_ppo_step on a 2-device mesh, its `_rollout`
    picking the shard's columns of a numpy-made trajectory by axis_index,
    against PPO.update(group=) on each rank's columns with the
    permutations JAX draws from split(fold_in(rng, r), 3)[1]."""
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    tag = "f64" if dtype == np.float64 else "f32"
    kw = dict(horizon=TT, num_envs=BB, opt_num_epochs=2, num_minibatches=2,
              policy_widths=(32, 32), value_widths=(32, 32), max_grad_norm=50.0)
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
    b = BB // WORLD
    shards = {k: jnp.stack([v[:, r * b:(r + 1) * b] for r in range(WORLD)])
              for k, v in traj.items()}
    last = jnp.stack([last_obs[r * b:(r + 1) * b] for r in range(WORLD)])

    def shard_rollout(ts_, key):
        r = jax.lax.axis_index("data")
        return StubState(obs=last[r]), {k: v[r] for k, v in shards.items()}

    jppo._rollout = shard_rollout
    step, placed = j_sharded_ppo_step(jppo, jax_mesh(), ts)
    ts2, j_metrics = step(placed)
    perms = np.stack([np.stack([
        np.asarray(jax.random.permutation(k, TT * b))
        for k in jax.random.split(jax.random.split(jax.random.fold_in(ts.rng, r), 3)[1],
                                  kw["opt_num_epochs"])]) for r in range(WORLD)])

    inputs = dict(obs_dim=OBS, nu=StubEnv.action_size, widths=np.asarray((32, 32)),
                  epochs=2, minibatches=2, max_grad_norm=50.0, tags=np.asarray([tag]))
    inputs.update({f"{tag}/pp/{k}": v for k, v in flat(jax.device_get(pp)).items()})
    inputs.update({f"{tag}/vp/{k}": v for k, v in flat(jax.device_get(vp)).items()})
    inputs.update({f"{tag}/norm_{k}": np.asarray(v, dtype) for k, v in norm_np.items()})
    inputs.update({f"{tag}/traj/{k}": v for k, v in traj.items()})
    inputs.update({f"{tag}/last_obs": last_obs, f"{tag}/perms": perms})
    outs = run_world("ppo", WORLD, inputs, tmp_path)

    def same(ref, val, what):
        if dtype == np.float64:
            assert rel_err(ref, val) <= TOL64, what
        else:
            assert close_rel_max(ref, val, TOL32), what

    for o in outs:
        for name, jparams, jopt in (("policy", ts2.policy_params, ts2.policy_opt),
                                    ("value", ts2.value_params, ts2.value_opt)):
            adam = jopt[1][0]
            for what, ref in (("param", flat(jax.device_get(jparams)["params"])),
                              ("mu", flat(jax.device_get(adam.mu)["params"])),
                              ("nu", flat(jax.device_get(adam.nu)["params"]))):
                port = {k[len(f"{tag}/{name}/{what}/"):]: v for k, v in o.items()
                        if k.startswith(f"{tag}/{name}/{what}/")}
                assert set(ref) == set(port)
                for k in ref:
                    same(ref[k], port[k], f"{name} {what} {k}")
            assert int(adam.count) == 4 and (o[f"{tag}/{name}/steps"] == 4).all()
        for f in ("n", "mean", "var"):
            same(getattr(ts2.obs_norm, f), o[f"{tag}/norm_{f}"], f)
        assert set(j_metrics) == {k.split("/")[-1] for k in o if "/metric/" in k}
        for k, v in j_metrics.items():
            same(np.asarray(v)[None], o[f"{tag}/metric/{k}"][None], k)
    same_across_ranks(outs, outs[0].keys())


# ---------------------------------------------------------------- d) the planner
@pytest.mark.parametrize("warm", [False, True])
def test_sharded_cem_plan_at_two_ranks_matches_jax(warm, tmp_path):
    """CEMPlanner.plan(group=) at 2 ranks x 6 samples, 8 elites (more than
    a rank holds), 3 iterations, on one analytic cost on both sides,
    against the JAX planner under shard_map with axis_name; each rank's
    normals are the ones JAX draws from fold_in(key, r)."""
    h, nu, n, iters = 4, 5, 6, 3
    kw = dict(horizon=h, num_samples=n, num_elites=8, iterations=iters, init_std=0.6)
    rng = np.random.RandomState(0)
    target = rng.uniform(-1.2, 1.2, (h, nu))          # partly outside the clip
    weight = rng.uniform(0.5, 2.0, (h, nu))
    mean0 = rng.uniform(-0.3, 0.3, (h, nu)) if warm else None
    planner = JCEMPlanner(type("StubEnv", (), {"action_size": nu})(), JCEMConfig(**kw))
    planner._rollout_cost = lambda state, a: jnp.sum(jnp.asarray(weight)
                                                     * (a - jnp.asarray(target)) ** 2)
    state = State(Phys(jnp.zeros((1, 3))))
    key = jax.random.PRNGKey(3)

    def solve(k, st):
        k = jax.random.fold_in(k, jax.lax.axis_index("data"))
        return planner.plan(k, st, None if mean0 is None else jnp.asarray(mean0), "data")

    f = shard_map(solve, mesh=jax_mesh(), in_specs=(P(), jax.tree.map(lambda _: P(), state)),
                  out_specs=(P(), P(), P()), check_vma=False)
    j_a0, j_mean, j_best = jax.jit(f)(key, state)
    eps = np.stack([np.stack([np.asarray(jax.random.normal(k, (n, h, nu), jnp.float64))
                              for k in jax.random.split(jax.random.fold_in(key, r), iters)])
                    for r in range(WORLD)])
    inputs = dict(target=target, weight=weight, eps=eps, elites=kw["num_elites"],
                  init_std=kw["init_std"])
    if warm:
        inputs["mean0"] = mean0
    outs = run_world("cem", WORLD, inputs, tmp_path)
    for o in outs:
        assert rel_err(j_a0, o["a0"]) <= TOL64 and rel_err(j_mean, o["mean"]) <= TOL64
        assert rel_err(np.asarray(j_best)[None], o["best"][None]) <= TOL64
    same_across_ranks(outs, ("a0", "mean", "best"))


# ----------------------------------------------------------------- e) the trainer
@pytest.mark.parametrize("world", [1, 2])
def test_sharded_rollout_and_ppo_step_on_a_port_env(world, tmp_path):
    """sharded_rollout, then sharded_ppo_step on HumanoidSpeed (float64, 2
    substeps, 4 envs, horizon 2, widths (16,)), 2 iterations. One rank: equal bit for bit to
    rollout + update (no group) from the derived local TrainState of an
    identical init, the carried generator included. Two ranks: the
    generator, nets, Adam states and running norm bit-identical across the
    ranks and the metrics equal, while each rank stepped its own envs."""
    outs = run_world("trainer", world, dict(seed=0, iterations=2), tmp_path)
    o = outs[0]
    # sharded_rollout: each rank's (T, B/W) shard; at one rank the loop by hand
    for r in outs:
        assert r["rollout/obs"].shape[:2] == (2, 4 // world) and np.isfinite(r["rollout/obs"]).all()
    if world == 1:
        assert np.array_equal(o["rollout/reward"], o["rollout_ref/reward"])
    else:
        assert not np.array_equal(o["rollout/reward"], outs[1]["rollout/reward"])
    for it in range(2):
        assert int(o[f"it{it}/epoch"]) == it + 1
        keys = [k for k in o if k.startswith(f"it{it}/") and "/ref/" not in k
                and k != f"it{it}/epoch"]
        assert any("/env/" in k for k in keys) and any("/state/" in k for k in keys)
        if world == 1:
            for k in keys:
                ref = k.replace(f"it{it}/", f"it{it}/ref/", 1)
                assert np.array_equal(o[k], o[ref]), k
        else:
            same_across_ranks(outs, [k for k in keys if "/env/" not in k])
            assert any(not np.array_equal(o[k], outs[1][k]) for k in keys if "/env/" in k)
