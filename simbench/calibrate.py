"""The readings that the limits of a cell's check are set from (limits/
<workload>.json), on the card at the cell's own size, several seeds in one
process:

    python3 simbench/calibrate.py --workload <name> --seeds 1,2,3 [--units 4] [--control 3]

For each seed it builds the cell as a run does, runs its warm-up and
`--units` units and keeps the sampled calls, then prints one JSON line of
readings (each number of envcheck.py, the row-gap quantiles, and what is
observed, the share of rows off at each of envcheck.THRESHOLDS with it):

  * program   the program against the float64 reference, as a run reads it;
  * control   (the first `--control` seeds) the reference itself put in the
              program's place in the next precision down from the
              configuration's float32 with TF32 off: float32 with TF32
              matrix products;
  * faults    (the same seeds) the numbers under the faults planted in the
              program's outputs by `fault_calls`.

The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from simbench import envcheck, harness  # noqa: E402


def tf32(on: bool) -> None:
    torch.backends.cuda.matmul.fp32_precision = "tf32" if on else "ieee"


def control_calls(ctx, kept: dict) -> dict:
    """The kept calls with each output replaced by the reference's in
    float32 under TF32 products, from the same input."""
    env32 = envcheck.reference_env(ctx, torch.float32)
    out = {}
    tf32(True)
    try:
        with torch.no_grad():
            for slot, (s_in, a, g, _) in kept.items():
                out[slot] = (s_in, a, g, envcheck.reference_out(env32, s_in, a, g,
                                                                torch.float32).out)
    finally:
        tf32(False)
    return out


def _where(mask, src, dst):
    """dst with the rows of mask taken from src (cast to dst's dtype)."""
    m = mask.reshape(mask.shape + (1,) * (dst.dim() - 1))
    return torch.where(m, src.to(dst.dtype), dst)


def _take_rows(out, src, mask):
    """A copy of the program's output state with the rows of mask taken
    from the reference state src: physics, observation, cache, task, clock
    and flags."""
    out = envcheck.clone_tree(out)
    out.phys.qpos = _where(mask, src.phys.qpos, out.phys.qpos)
    out.phys.qvel = _where(mask, src.phys.qvel, out.phys.qvel)
    out.obs = _where(mask, src.obs, out.obs)
    out.cur_t = _where(mask, src.cur_t, out.cur_t)
    out.terminated = _where(mask, src.terminated, out.terminated)
    out.truncated = _where(mask, src.truncated, out.truncated)
    if out.pd_cache is not None:
        out.pd_cache = tuple(_where(mask, a, b) for a, b in zip(src.pd_cache, out.pd_cache))
    if out.task is not None:
        for f in dataclasses.fields(out.task):
            setattr(out.task, f.name, _where(mask, getattr(src.task, f.name),
                                             getattr(out.task, f.name)))
    return out


def fault_calls(kept: dict, refs: dict) -> dict:
    """{fault: kept calls with that fault planted in the outputs}:
    unchanged (the step returns its input), half_batch and tenth_rows (the
    last half, or every tenth row, left unstepped), altered_answer (one
    observation moved by 0.01), no_termination (the rows the reference
    finished go on unfinished and unreset: the reference's own step of
    them, its flags cleared), wrong_reset (the finished rows reset 1 cm too
    high)."""
    faults = {k: {} for k in ("unchanged", "half_batch", "tenth_rows", "altered_answer",
                              "no_termination", "wrong_reset")}
    for slot, (s_in, a, g, s_out) in kept.items():
        B = s_out.obs.shape[0]
        rows = torch.arange(B, device=s_out.obs.device)
        faults["unchanged"][slot] = (s_in, a, g, envcheck.clone_tree(s_in))
        for name, mask in (("half_batch", rows >= B // 2), ("tenth_rows", rows % 10 == 0)):
            mixed = envcheck.clone_tree(s_out)
            mixed.phys.qpos[mask] = s_in.phys.qpos[mask]
            mixed.phys.qvel[mask] = s_in.phys.qvel[mask]
            faults[name][slot] = (s_in, a, g, mixed)
        alt = envcheck.clone_tree(s_out)
        alt.obs[0, 0] += 0.01
        faults["altered_answer"][slot] = (s_in, a, g, alt)
        ref = refs[slot]
        stepped = dataclasses.replace(
            ref.stepped, terminated=torch.zeros_like(ref.stepped.terminated),
            truncated=torch.zeros_like(ref.stepped.truncated))
        faults["no_termination"][slot] = (s_in, a, g,
                                          _take_rows(s_out, stepped, ref.stepped.done))
        high = envcheck.clone_tree(s_out)
        high.phys.qpos[s_out.done, 2] += 0.01
        faults["wrong_reset"][slot] = (s_in, a, g, high)
    return faults


def env_readings(ctx, kept: dict, control: bool = True) -> dict:
    env64 = envcheck.reference_env(ctx, torch.float64)
    refs = envcheck.reference_outs(env64, kept)

    def read(calls):
        worst, observed, _ = envcheck.readings(env64, calls, limits=ctx.limits, more=True,
                                               refs=refs)
        return {**worst, **observed}
    out = {"program": read(kept)}
    if control:
        out["control"] = read(control_calls(ctx, kept))
        out["faults"] = {k: read(v) for k, v in fault_calls(kept, refs).items()}
    return out


def one_seed(manifest, workload: str, seed: int, units: int, device: str = "cuda",
             base: str = harness.HERE, control: bool = True) -> dict:
    ctx = harness.Context(manifest, workload, seed, device, base)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    kind = harness.load_module(os.path.join(base, "traffic", ctx.traffic["loop"] + ".py"),
                               "simbench_loop_" + ctx.traffic["loop"])
    t0 = time.time()
    loop = kind.setup(ctx)
    loop.warmup()
    for _ in range(units):
        loop.run_one()
    sync()
    t_prog = time.time() - t0
    kept = loop.release()
    del loop
    if device == "cuda":
        torch.cuda.empty_cache()
    t1 = time.time()
    out = {"seed": seed, "program_s": t_prog, "calls": env_readings(ctx, kept, control)}
    out["check_s"] = time.time() - t1
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--units", type=int, default=4)
    p.add_argument("--control", type=int, default=3,
                   help="read the control and the faults on this many of the first seeds")
    args = p.parse_args()
    manifest = harness.load_json(ROOT, "BENCHMARK.json")
    print(f"card: {harness.card()}", flush=True)
    for i, s in enumerate(args.seeds.split(",")):
        r = one_seed(manifest, args.workload, int(s), args.units, control=i < args.control)
        print(json.dumps({"workload": args.workload, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
