"""The traced run's reduction: one torch.profiler recording of a few units
of work (control steps, a rollout step, an update) turned into the numbers
the per-layer readers take.

`record(fn, units, host=True)` runs fn() `units` times under the profiler
(device activity, and host activity unless `host` is False), synchronises,
and returns a summary dict; with `host` False it holds only window_s,
busy_s and units, read from the profiler's raw results without building
its event tree (which takes tens of seconds for a control step's 10^5
events):

  * window_s   the traced wall time;
  * busy_s     the union of the device operations' intervals (kernels,
               copies, sets) inside it;
  * device_ops {name: [seconds, count]} over the traced units;
  * runtime    {name: count} of the host-side CUDA runtime and driver calls;
  * idle_by_host_op {name: seconds}: every stretch in which the device ran
               nothing, charged to the innermost host op running at its
               middle (runtime calls left out: the op that issued them);
  * units.

No trace file is written.
"""
from __future__ import annotations

import bisect
import json
import os
import time

import torch

KERNELS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernels")


def kernel_patterns(group: str) -> list:
    """Every name pattern of `group`: the union of the lists in
    kernels/<group>/*.json. A pattern is a list of substrings that a device
    op's name must all contain."""
    d = os.path.join(KERNELS_DIR, group)
    out = []
    for f in sorted(os.listdir(d)):
        if f.endswith(".json"):
            with open(os.path.join(d, f)) as fh:
                out += [list(p) for p in json.load(fh)["match"]]
    return out


def matches(name: str, patterns: list) -> bool:
    return any(all(s in name for s in p) for p in patterns)


def select(table: dict, group: str) -> dict:
    """The entries of a {name: value} table whose names match `group`."""
    pats = kernel_patterns(group)
    return {k: v for k, v in table.items() if matches(k, pats)}


def _is_runtime(name: str) -> bool:
    return name.startswith("cuda") or name.startswith("cu")


def record(fn, units: int, host: bool = True) -> dict:
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    if not host:
        return dict(window_s=window_s, busy_s=device_busy_s(prof), units=units)
    return reduce(prof.events(), window_s, units)


def union(spans: list) -> list:
    """The union of [start, end) intervals, as sorted disjoint [start, end]."""
    merged = []
    for s, t in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def device_busy_s(prof) -> float:
    """Seconds covered by the device operations of a finished recording:
    the union of their intervals, from the raw results where the profiler
    keeps them (its event list otherwise). Device-side user annotations are
    ranges around operations, not operations, and are left out."""
    cuda = torch.autograd.DeviceType.CUDA
    res = getattr(prof.profiler, "kineto_results", None)
    if res is None:
        spans = [(e.time_range.start * 1e3, e.time_range.end * 1e3) for e in prof.events()
                 if e.device_type == cuda]
    else:
        spans = [(e.start_ns(), e.end_ns()) for e in res.events()
                 if e.device_type() == cuda
                 and not getattr(e, "is_user_annotation", lambda: False)()]
    return sum(t - s for s, t in union(spans)) * 1e-9


def reduce(events, window_s: float, units: int) -> dict:
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in events:
        (dev if e.device_type == cuda else host).append(e)
    ops, runtime = {}, {}
    spans = []
    for e in dev:
        s, t = e.time_range.start, e.time_range.end
        spans.append((s, t))
        rec = ops.setdefault(e.name, [0.0, 0])
        rec[0] += (t - s) * 1e-6
        rec[1] += 1
    merged = union(spans)
    busy_s = sum(t - s for s, t in merged) * 1e-6
    stack_ev = []
    for e in host:
        if _is_runtime(e.name):
            runtime[e.name] = runtime.get(e.name, 0) + 1
        else:
            stack_ev.append((e.time_range.start, e.time_range.end, e.name))
    stack_ev.sort()
    # gaps between the device's busy stretches, inside the host's span
    t_lo = min([s for s, _, _ in stack_ev] + [m[0] for m in merged[:1]], default=0.0)
    gaps, prev = [], t_lo
    for s, t in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    idle = {}
    starts = [s for s, _, _ in stack_ev]
    stack, i = [], 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (a + b) / 2
        j = bisect.bisect_right(starts, mid)
        while i < j:
            s, t, n = stack_ev[i]
            while stack and stack[-1][1] <= s:
                stack.pop()
            stack.append((s, t, n))
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "host, outside any op"
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    return dict(window_s=window_s, busy_s=busy_s, device_ops=ops, runtime=runtime,
                idle_by_host_op=idle, units=units)


def breakdown(summary: dict, top: int = 10) -> dict:
    ops = sorted(summary["device_ops"].items(), key=lambda kv: -kv[1][0])[:top]
    gaps = sorted(summary["idle_by_host_op"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k[:160], v[0]] for k, v in ops],
            "idle_gaps": [[k[:160], v] for k, v in gaps]}
