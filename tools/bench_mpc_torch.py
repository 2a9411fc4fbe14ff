"""MPC solves/s on the card: 1 rank against N ranks (port of tools/bench_mpc.py).

The CEM planner (CEMConfig: `horizon` control steps, `samples` candidates,
max(4, samples // 8) elites, 2 iterations, the package's default QP) plans
from one reset of HumanoidGetup or HumanoidSpeed. After a warm-up plan,
`solves` plans are timed, first in this process (1 rank), then on N ranks
in processes started with the spawn method, each rolling out samples // N
candidates, the same global count, with the elites chosen from all of
them (CEMPlanner.plan(group=)). Ranks sharing a card talk over gloo (NCCL
takes no two ranks on one device), ranks on cards of their own over NCCL.
N ranks on one card share it: their figure is then no multi-GPU scaling.

    python tools/bench_mpc_torch.py                         # the old tool's defaults
    python tools/bench_mpc_torch.py samples=512 horizon=8 solves=3 task=speed

Arguments (key=value): ranks (2), samples (64), horizon (4), solves (5),
task (getup or speed), out (a file the JSON records are appended to). Each
record is one JSON line; the card's name and power limit are printed.
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
import torch.distributed as dist

ITERATIONS = 2


def planner_and_state(task: str, samples: int, horizon: int, device):
    from smplsim_tpu_torch.control import CEMConfig, CEMPlanner
    from smplsim_tpu_torch.envs import HumanoidGetup, HumanoidSpeed
    from smplsim_tpu_torch.models import registry

    model = registry.default_humanoid(torch.float32, device=device)
    env = (HumanoidSpeed if task == "speed" else HumanoidGetup)(model)
    cfg = CEMConfig(horizon=horizon, num_samples=samples, num_elites=max(4, samples // 8),
                    iterations=ITERATIONS)
    return CEMPlanner(env, cfg), env.reset(1, torch.Generator(device=device).manual_seed(0))


def timed_solves(planner, state, gen, solves: int, group=None) -> float:
    """Seconds for `solves` plans after one warm-up plan."""
    planner.plan(state, generator=gen, group=group)
    if group is not None:
        dist.barrier(group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(solves):
        planner.plan(state, generator=gen, group=group)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def rank_solves(rank, world, store, task, samples, horizon, solves):
    """One of N ranks: samples // N candidates of its own per plan."""
    from smplsim_tpu_torch.ops import _build
    from smplsim_tpu_torch.parallel import mesh as pm

    _build.build_all()
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    pm.init_distributed(store, world, rank, backend=backend)
    try:
        mesh = pm.data_mesh()
        torch.cuda.set_device(mesh.device)
        planner, state = planner_and_state(task, samples // world, horizon, mesh.device)
        gen = pm.fold_in(torch.Generator(device=mesh.device).manual_seed(1), rank)
        return dict(backend=backend, seconds=timed_solves(planner, state, gen, solves,
                                                           mesh.group))
    finally:
        dist.destroy_process_group()


def main():
    kv = dict(a.split("=", 1) for a in sys.argv[1:])
    ranks = int(kv.get("ranks", 2))
    samples = int(kv.get("samples", 64))
    horizon = int(kv.get("horizon", 4))
    solves = int(kv.get("solves", 5))
    task = kv.get("task", "getup")
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this benchmark needs a CUDA card")
    from smplsim_tpu_torch.ops import _build
    from smplsim_tpu_torch.parallel.mesh import run_ranks

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0])
    _build.build_all()         # before any rank starts: no two ranks run nvcc
    base = dict(task=task, platform="gpu", device=torch.cuda.get_device_name(0),
                device_count=torch.cuda.device_count(), samples=samples, horizon=horizon,
                iterations=ITERATIONS, solves=solves)

    def record(config, seconds, **extra):
        rec = dict(config=config, **base, solves_per_sec=solves / seconds,
                   ms_per_solve=seconds / solves * 1e3, **extra)
        print(json.dumps(rec), flush=True)
        return rec

    dev = torch.device("cuda", 0)
    planner, state = planner_and_state(task, samples, horizon, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    records = [record("1-rank", timed_solves(planner, state, gen, solves))]
    if ranks > 1:
        out = run_ranks(rank_solves, ranks, (task, samples, horizon, solves), timeout=3000)
        records.append(record(f"{ranks}-rank", max(o["seconds"] for o in out),
                              backend=out[0]["backend"],
                              rank_seconds=[o["seconds"] for o in out]))
        records.append({"scaling_efficiency": records[1]["solves_per_sec"]
                        / records[0]["solves_per_sec"], "ranks": ranks,
                        "ranks_share_a_card": torch.cuda.device_count() < ranks})
        print(json.dumps(records[-1]), flush=True)
    if "out" in kv:
        with open(kv["out"], "a") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
