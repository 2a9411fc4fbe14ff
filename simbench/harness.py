"""One run of one cell: set-up, warm-up, the measured window, the traced
units (with --trace 1), the check against the plain reference, and the
result line.

Everything is found by name. BENCHMARK.json names the cell's
configuration and traffic; the configuration is configs/<config>.json,
the traffic traffic/<traffic>.json, whose "loop" names the loop kind
traffic/<loop>.py; the per-layer metrics are metrics/<name>.py, each with
a `read(summary)`; the limits of the check are limits/<workload>.json.

A loop kind is a module with `setup(ctx) -> loop`, where the loop has

    warmup()          the cell's own shapes, once, counted as set-up;
    run_one() -> int  one closed-loop unit of work, its env-steps;
    end_to_end(n, window_s) -> {metric: value}  after the window; a metric
                      it cannot read on this device is left out;
    trace(window_s, n) -> summary dict for the per-layer readers;
    release() -> samples   drop the program's state, keep what the check
                      compares;
and the module has `check(ctx, samples) -> ([(name, value, limit)],
failed, observed)`: each number compared with its limit, in order, how
many of the window's env-steps it compared came out wrong, and what it
observed without comparing. It runs once the window has closed, the peak
memory has been read and the program's state is freed.

Beside the window the run reads the host (`host`): the process's CPU
seconds per second of the window, so that a run slowed by waiting can be
told from one whose core ran slower.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "smplsim_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (smplsim_tpu_torch is not smplsim_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card() -> dict:
    """The card's name and power limit, as nvidia-smi reads them."""
    out = dict(name=torch.cuda.get_device_name(0), power_limit="not read")
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        if r.returncode == 0 and r.stdout.strip():
            out["power_limit"] = r.stdout.strip().splitlines()[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return out


def host_sample() -> dict:
    """What host_delta compares: this process's CPU time and the wall
    clock."""
    return dict(cpu_s=time.process_time(), wall_s=time.perf_counter())


def host_delta(a: dict, b: dict) -> dict:
    """The host between two samples: the process's CPU seconds per second
    of wall time (near 1 while its one launching thread runs throughout;
    less where the process waited or was put off its core) and the CPUs it
    may run on."""
    return dict(cpu_s_per_s=(b["cpu_s"] - a["cpu_s"]) / (b["wall_s"] - a["wall_s"]),
                cpus=len(os.sched_getaffinity(0)))


class Context:
    """What a loop kind gets: the cell, its configuration and traffic, the
    seed, the device and the directory of the benchmark."""

    def __init__(self, manifest: dict, workload: str, seed: int, device: str, base: str = HERE):
        cell = next(w for w in manifest["workloads"] if w["name"] == workload)
        self.config = load_json(base, "configs", cell["config"] + ".json")
        self.traffic = load_json(base, "traffic", cell["traffic"] + ".json")
        self.limits = load_json(base, "limits", workload + ".json")
        self.seed = seed
        self.device = torch.device(device)
        self.base = base

    def model_path(self) -> str:
        return os.path.join(self.base, "configs", self.config["model_file"])

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.config["dtype"])


def per_layer_readers(manifest: dict, workload: str, end_to_end: list, base: str = HERE) -> dict:
    """{metric: reader module} of the per-layer metrics this cell reports:
    those that list it, or list no cells and move one of its end-to-end
    metrics."""
    out = {}
    for m in manifest["per_layer"]:
        cells = m.get("workloads")
        if (workload in cells) if cells is not None else m["moves"] in end_to_end:
            out[m["name"]] = load_module(os.path.join(base, "metrics", m["name"] + ".py"),
                                         "simbench_metric_" + m["name"].replace(".", "_"))
    return out


def cell_end_to_end(manifest: dict, workload: str) -> list:
    return [m["name"] for m in manifest["end_to_end"]
            if m.get("workloads") is None or workload in m["workloads"]]


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", manifest: dict | None = None, base: str = HERE) -> dict:
    """One run; returns the result dict (the last key, "checks", holds each
    number compared beside its limit). `base` is the directory that holds
    configs/, traffic/, limits/ and metrics/."""
    manifest = manifest or load_json(ROOT, "BENCHMARK.json")
    ctx = Context(manifest, workload, seed, device, base)
    units = {m["name"]: m["unit"] for m in manifest["end_to_end"] + manifest["per_layer"]}
    e2e = cell_end_to_end(manifest, workload)
    kind = load_module(os.path.join(base, "traffic", ctx.traffic["loop"] + ".py"),
                       "simbench_loop_" + ctx.traffic["loop"])
    cuda = ctx.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    loop = kind.setup(ctx)
    loop.warmup()
    sync()
    setup_s = time.time() - t_start

    n = 0
    h0 = host_sample()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        n += loop.run_one()
    sync()
    window_s = time.perf_counter() - t0
    host = host_delta(h0, host_sample())

    result_metrics = {}
    summary = None
    if trace:
        summary = loop.trace(window_s, n)
        for name, reader in per_layer_readers(manifest, workload, e2e, base).items():
            v = reader.read(summary)
            if v is not None:
                result_metrics[name] = {"value": float(v), "unit": units[name]}
    else:
        vals = loop.end_to_end(n, window_s)
        vals["setup_s"] = setup_s
        for name in (m for m in e2e if m in vals):
            result_metrics[name] = {"value": float(vals[name]), "unit": units[name]}

    peak = torch.cuda.max_memory_allocated() if cuda else 0
    samples = loop.release()
    del loop
    if cuda:
        torch.cuda.empty_cache()
    checks, failed, observed = kind.check(ctx, samples)
    correct = failed == 0 and all(v <= lim for _, v, lim in checks)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": n, "failed": failed,
           "metrics": result_metrics, "device": dev}
    if trace:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        from simbench.trace import breakdown
        out["breakdown"] = breakdown(summary)
    if cuda:
        out["card"] = card()
    out["window"] = {"seconds": window_s, "units": n, "setup_s": setup_s}
    out["host"] = host
    out["observed"] = observed
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return out


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.time() if t_start is None else t_start
    p = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    manifest = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cells[args.workload]["chips"]:
        print(f"the cell needs {cells[args.workload]['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace), t_start,
              manifest=manifest)
    bad = forbidden_modules()
    if bad:
        print(f"modules of the JAX side are loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    c = out["card"]
    print(f"card: {c['name']}, power limit {c['power_limit']}", file=sys.stderr)
    for name, m in out["metrics"].items():
        print(f"metric {name} = {m['value']!r} {m['unit']}", file=sys.stderr)
    print(f"host {json.dumps(out['host'])}", file=sys.stderr)
    for name, v in out["observed"].items():
        print(f"observed {name} = {v!r} (not compared)", file=sys.stderr)
    for name, chk in out["checks"].items():
        ok = "ok" if chk["value"] <= chk["limit"] else "FAILED"
        print(f"check {name} = {chk['value']!r} limit {chk['limit']!r} {ok}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
