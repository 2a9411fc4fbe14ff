"""Where a control step of the PyTorch/CUDA port spends its time on the GPU.

    python3 tools/profile_torch_step.py [--batch 4096] [--steps 2]
                                        [--control-mode uhc_pd|torque]

Runs HumanoidSpeed at the main-path operating point (float32, 15 substeps,
SMPLSIM_QP_ITERS=16, SMPLSIM_QP_TOL=1e-4, SMPLSIM_QP_ROWS=32) in the given
control mode (uniform random actions in [-1, 1]), warms up three control
steps, times `--steps` step_autoreset calls, then records as many again
with torch.profiler. Prints the wall time per control step, the device's
busy time in it (sum of kernel and copy times) and so its idle share, the
device time and launches of each hand-written kernel by its device
function's name, and the top device ops; the last line is one JSON object
with these numbers and the card's name and power limit. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

QP = dict(qp_iters=16, qp_tol=1e-4, qp_rows=32)
# the hand-written kernels by device function. chol_solve_kernel is the
# column kernel's template <T, kStoreL>: A's column form without the stored
# factor, Kernel E with it.
HAND_WRITTEN = {
    "A chol_solve_tiled_kernel": lambda k: "chol_solve_tiled_kernel" in k,
    "A chol_solve_kernel (column form)": lambda k: "chol_solve_kernel<" in k and "false>" in k,
    "B newton_qp_warp_kernel": lambda k: "newton_qp_warp_kernel" in k,
    "B newton_qp_kernel (block form)": lambda k: "newton_qp_kernel<" in k,
    "C cho_factor_solve_kernel": lambda k: "cho_factor_solve_kernel" in k,
    "D solve_lower_warp_kernel": lambda k: "solve_lower_warp_kernel" in k,
    "D solve_lower_cols_kernel": lambda k: "solve_lower_cols_kernel" in k,
    "E chol_solve_kernel (factor stored)": lambda k: "chol_solve_kernel<" in k and "true>" in k,
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--control-mode", default="uhc_pd", choices=("uhc_pd", "torque"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("a CUDA card is needed")
    from smplsim_tpu_torch.envs import HumanoidSpeed, SpeedConfig
    from smplsim_tpu_torch.models import registry

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    model = registry.default_humanoid(torch.float32)
    env = HumanoidSpeed(model, SpeedConfig(control_mode=args.control_mode), **QP)
    gen = torch.Generator(device=dev).manual_seed(0)
    act = lambda: torch.rand(args.batch, model.nu, generator=gen, device=dev) * 2 - 1
    state = env.reset(args.batch, gen)
    for _ in range(3):
        state = env.step_autoreset(state, act())
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(args.steps):
        state = env.step_autoreset(state, act())
    torch.cuda.synchronize()
    wall_plain = (time.time() - t0) / args.steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(args.steps):
            state = env.step_autoreset(state, act())
        torch.cuda.synchronize()
        wall = (time.time() - t0) / args.steps
    # device-side events only (kernels, copies, sets): the host-side aten
    # ops report the same device time again as their own
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    busy = sum(dev_us(e) for e in events) / 1e3 / args.steps
    print(f"card: {card}; {args.control_mode} control, batch {args.batch}, {args.steps} "
          "control steps profiled")
    print(f"wall per control step {wall_plain * 1e3:.1f} ms ({wall * 1e3:.1f} ms with the "
          f"profiler on); device busy {busy:.1f} ms: idle share "
          f"{max(0.0, 1 - busy / (wall_plain * 1e3)):.3f} of the unprofiled step")
    kern = {}
    for name, match in HAND_WRITTEN.items():
        hit = [e for e in events if match(e.key)]
        kern[name] = dict(device_ms=sum(dev_us(e) for e in hit) / 1e3 / args.steps,
                          launches=sum(e.count for e in hit) / args.steps)
    print("hand-written kernels per control step:")
    for name, k in kern.items():
        print(f"  {name}: device {k['device_ms']:.3f} ms, {k['launches']:.1f} launches")
    hand = sum(k["device_ms"] for k in kern.values())
    print(f"  all hand-written kernels: {hand:.3f} ms of the {busy:.1f} ms busy")
    top = sorted(events, key=dev_us, reverse=True)[:25]
    print(f"{'device ms/step':>14} {'calls/step':>10}  device op")
    for e in top:
        print(f"{dev_us(e) / 1e3 / args.steps:14.3f} {e.count / args.steps:10.1f}  {e.key[:90]}")
    print(card)
    print(json.dumps({"card": card, "control_mode": args.control_mode, "batch": args.batch,
                      "wall_ms": wall_plain * 1e3, "wall_ms_profiled": wall * 1e3,
                      "device_busy_ms": busy, "idle_share": max(0.0, 1 - busy / (wall_plain * 1e3)),
                      "hand_written_ms": hand, "kernels": kern}))


if __name__ == "__main__":
    main()
