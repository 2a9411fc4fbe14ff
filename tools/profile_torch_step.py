"""Where a control step, or a Jacobian evaluation, of the PyTorch/CUDA port
spends its time on the GPU.

    python3 tools/profile_torch_step.py [--batch 4096] [--steps 2]
                                        [--control-mode uhc_pd|torque]
                                        [--task speed|getup]
                                        [--body default|beta|smplx] [--aba]
    python3 tools/profile_torch_step.py --jacobian

Default: runs HumanoidSpeed at the main-path operating point (float32, 15
substeps, SMPLSIM_QP_ITERS=16, SMPLSIM_QP_TOL=1e-4, SMPLSIM_QP_ROWS=32) in
the given control mode (uniform random actions in [-1, 1]), warms up three
control steps, times `--steps` step_autoreset calls, then records as many
again with torch.profiler. `--task getup` runs HumanoidGetup instead, with
its per-reset Fall init: each step_autoreset is 4 control steps (the 3 of
the Fall, computed for every env, and the step). `--body` picks the
humanoid: the baked one, 64 β bodies tiled over the batch (chip_smoke.py
phase 20's) or the SMPLX humanoid (phase 21's), both built from the
synthetic bodies of tests/_torch_synthetic_body.py. `--aba` sets
SMPLSIM_ABA=1 for the run: the float32 spine's articulated-body route
(physics/substep.py; 1 chol_solve and 15 newton_qp per control step).

--jacobian: the derivative path at chip_smoke.py phase 9's operating point,
in float32 and then float64: one Jacobian evaluation (control.jacobians,
one forward-AD pass) of the uhc_pd control_step at 4 trajectory points
(one env from a reset, 3 control steps at 10% of full-scale random
actions), nq + nv + nu = 220 replicas each (880 systems), 15 substeps, the
same QP settings; one cold evaluation, one timed warm one, one recorded
with torch.profiler.

Prints the wall time per control step (per Jacobian evaluation), the
device's busy time in it (simbench/trace.py's: the union of the intervals
of its kernels, copies and sets) and so its idle share, the device time
and launches of each hand-written kernel by its device function's name,
and the top device ops; the last line is one JSON object with these
numbers and the card's name and power limit. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from simbench import trace  # noqa: E402

QP = dict(qp_iters=16, qp_tol=1e-4, qp_rows=32)
CFI = 15
N_POINTS = 4
# the hand-written kernels by device function. chol_solve_kernel is the
# column kernel's template <T, kStoreL> (A's column form without the stored
# factor, Kernel E's with it), cho_factor_solve_kernel the tiled kernel's
# <T, TPT, R, kSolve> (Kernel C with the solve, E's tiled form without).
HAND_WRITTEN = {
    "A chol_solve_tiled_kernel": lambda k: "chol_solve_tiled_kernel" in k,
    "A chol_solve_kernel (column form)": lambda k: "chol_solve_kernel<" in k and "false>" in k,
    "B newton_qp_warp_kernel": lambda k: "newton_qp_warp_kernel" in k,
    "B newton_qp_kernel (block form)": lambda k: "newton_qp_kernel<" in k,
    "C cho_factor_solve_kernel": lambda k: "cho_factor_solve_kernel<" in k and "true>" in k,
    "D solve_lower_warp_kernel": lambda k: "solve_lower_warp_kernel" in k,
    "D solve_lower_cols_kernel": lambda k: "solve_lower_cols_kernel" in k,
    "E cholesky_warp_kernel": lambda k: "cholesky_warp_kernel" in k,
    "E cho_factor_solve_kernel (tiled form, no solve)":
        lambda k: "cho_factor_solve_kernel<" in k and "false>" in k,
    "E chol_solve_kernel (column form, factor stored)":
        lambda k: "chol_solve_kernel<" in k and "true>" in k,
}


def measure(run, reps: int, unit: str) -> dict:
    """Wall ms per call of run() over `reps` calls, then the same recorded by
    simbench/trace.py's `record`: device busy ms (the union of the device
    operations' intervals, as the benchmark reads it), idle share, the
    hand-written kernels and the top device ops, printed and returned."""
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    wall_plain = (time.time() - t0) / reps
    rec = trace.record(run, reps)
    wall = rec["window_s"] / reps
    busy = rec["busy_s"] * 1e3 / reps
    idle = max(0.0, 1 - busy / (wall_plain * 1e3))
    print(f"wall per {unit} {wall_plain * 1e3:.1f} ms ({wall * 1e3:.1f} ms with the profiler "
          f"on); device busy {busy:.1f} ms: idle share {idle:.3f} of the unprofiled {unit}")
    # {device op: [seconds, calls]} over the recorded calls
    ops = rec["device_ops"]
    kern = {}
    for name, match in HAND_WRITTEN.items():
        hit = [v for k, v in ops.items() if match(k)]
        kern[name] = dict(device_ms=sum(s for s, _ in hit) * 1e3 / reps,
                          launches=sum(c for _, c in hit) / reps)
    print(f"hand-written kernels per {unit}:")
    for name, k in kern.items():
        print(f"  {name}: device {k['device_ms']:.3f} ms, {k['launches']:.1f} launches")
    hand = sum(k["device_ms"] for k in kern.values())
    print(f"  all hand-written kernels: {hand:.3f} ms of the {busy:.1f} ms busy")
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:25]
    print(f"{'device ms':>10} {'calls':>8}  device op (per {unit})")
    for k, (s, c) in top:
        print(f"{s * 1e3 / reps:10.3f} {c / reps:8.1f}  {k[:90]}")
    launches = sum(c for _, c in ops.values()) / reps
    print(f"device ops launched per {unit}: {launches:.0f}", flush=True)
    return {"wall_ms": wall_plain * 1e3, "wall_ms_profiled": wall * 1e3, "device_busy_ms": busy,
            "idle_share": idle, "device_launches": launches, "hand_written_ms": hand,
            "kernels": kern, "top": [dict(op=k[:120], device_ms=s * 1e3 / reps, calls=c / reps)
                                     for k, (s, c) in top[:10]]}


def body_model(body: str, batch: int, dev):
    """The float32 humanoid of `--body` on the card."""
    from smplsim_tpu_torch.models import registry

    if body == "default":
        return registry.default_humanoid(torch.float32)
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_synthetic_body import make_synthetic_body

    from smplsim_tpu_torch.body_model import SMPLParser
    from smplsim_tpu_torch.models import stack_models, tile_model
    from smplsim_tpu_torch.models.builder import RobotConfig, build_robot_model

    if body == "smplx":
        parser = SMPLParser(data=make_synthetic_body(np.random.default_rng(1), "smplx"),
                            model_type="smplx")
        return build_robot_model(parser, cfg=RobotConfig(model="smplx"), device=dev)[0]
    parser = SMPLParser(data=make_synthetic_body(np.random.RandomState(0), "smpl"))
    rng = np.random.RandomState(11)
    bodies = [build_robot_model(parser, betas=rng.randn(1, 10) * 0.8, device=dev)[0]
              for _ in range(64)]
    return tile_model(stack_models(bodies), batch)


def control_step_profile(args, card, dev) -> dict:
    from smplsim_tpu_torch.envs import GetupConfig, HumanoidGetup, HumanoidSpeed, SpeedConfig

    model = body_model(args.body, args.batch, dev)
    if args.task == "getup":
        env = HumanoidGetup(model, GetupConfig(control_mode=args.control_mode), **QP)
    else:
        env = HumanoidSpeed(model, SpeedConfig(control_mode=args.control_mode), **QP)
    gen = torch.Generator(device=dev).manual_seed(0)
    act = lambda: torch.rand(args.batch, model.nu, generator=gen, device=dev) * 2 - 1
    box = {"state": env.reset(args.batch, gen)}

    def step():
        box["state"] = env.step_autoreset(box["state"], act())
    for _ in range(3):
        step()
    print(f"card: {card}; {args.task} task, {args.body} body (nv {model.nv}), "
          f"{args.control_mode} control, batch {args.batch}, {args.steps} step_autoreset calls "
          "profiled")
    out = measure(step, args.steps, "step_autoreset" if args.task == "getup" else "control step")
    return dict(task=args.task, body=args.body, control_mode=args.control_mode,
                batch=args.batch, **out)


def jacobian_profile(dtype, card, dev) -> dict:
    from smplsim_tpu_torch.control import jacobians
    from smplsim_tpu_torch.envs import HumanoidSpeed
    from smplsim_tpu_torch.models import registry
    from smplsim_tpu_torch.physics import engine

    model = registry.default_humanoid(dtype)
    env = HumanoidSpeed(model, **QP)
    gen = torch.Generator(device=dev).manual_seed(0)
    nq = model.nq

    def dyn(x, u):
        st = engine.control_step(model, engine.PhysicsState(x[:, :nq], x[:, nq:]), u, CFI,
                                 **QP)[0]
        return torch.cat([st.qpos, st.qvel], 1)

    st0 = env.reset(1, gen).phys
    xs = [torch.cat([st0.qpos, st0.qvel], 1)]
    us = 0.1 * (torch.rand(N_POINTS, model.nu, generator=gen, device=dev) * 2 - 1).to(dtype)
    for t in range(N_POINTS - 1):
        xs.append(dyn(xs[-1], us[t:t + 1]))
    xs = torch.cat(xs)
    reps = model.nq + model.nv + model.nu
    jacobians(dyn, xs, us)  # cold
    print(f"card: {card}; Jacobian evaluation, {dtype}, {N_POINTS} points x {reps} replicas "
          f"({N_POINTS * reps} systems), {CFI} substeps")
    out = measure(lambda: jacobians(dyn, xs, us), 1, "Jacobian evaluation")
    return dict(dtype=str(dtype).replace("torch.", ""), systems=N_POINTS * reps, **out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--control-mode", default="uhc_pd", choices=("uhc_pd", "torque"))
    ap.add_argument("--task", default="speed", choices=("speed", "getup"),
                    help="HumanoidSpeed, or HumanoidGetup with its per-reset Fall init")
    ap.add_argument("--body", default="default", choices=("default", "beta", "smplx"),
                    help="the baked humanoid, 64 β bodies tiled over the batch, or SMPLX")
    ap.add_argument("--aba", action="store_true",
                    help="the articulated-body route of the spine (SMPLSIM_ABA=1)")
    ap.add_argument("--jacobian", action="store_true",
                    help="profile one warm Jacobian evaluation in float32 and float64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("a CUDA card is needed")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    if args.aba:
        os.environ["SMPLSIM_ABA"] = "1"
    if args.jacobian:
        result = {"card": card, "path": "jacobian",
                  "runs": [jacobian_profile(dt, card, dev)
                           for dt in (torch.float32, torch.float64)]}
    else:
        result = {"card": card, "aba": args.aba, **control_step_profile(args, card, dev)}
    print(card)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
