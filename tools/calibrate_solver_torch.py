"""The PyTorch port held to the product gate: its closed-loop speed
trajectory against the MuJoCo golden (counterpart of
tools/calibrate_solver.py).

BASELINE.md's gate is 1e-2 joint angle over 150 closed-loop control steps
against MuJoCo. The golden is MuJoCo's own speed env, seed 0, tar_speed 2.0,
under 150 actions from RandomState(7) in [-0.3, 0.3]
(tests/golden/speed_ref_150.npz). It is committed; making it needs the
reference implementation, so this tool has no `golden` mode.

Modes (each runs on the card unless `device=cpu`):

  python tools/calibrate_solver_torch.py run [iters=16 tol=1e-4 rows=32] [aba=1]
      The port's speed loop in float32 and float64 at one QP setting
      against the golden; prints one JSON line. iters, tol and rows default
      to SMPLSIM_QP_ITERS / SMPLSIM_QP_TOL / SMPLSIM_QP_ROWS as the package
      reads them; tol is the float32 tolerance (float64 keeps 1e-12). Beside
      the golden curves: f32_vs_tight against the committed tight-QP float32
      trajectory (speed_ref_150_ours_f32_tight.npy) but at that tight
      setting, and where the setting is one the JAX package's trajectories
      were written at (tools/golden_jax_trajectories.py), f32_vs_jax
      (product QP 16 / 1e-4 / 32) and f64_vs_jax (default QP: 40
      iterations, 64 rows).
  python tools/calibrate_solver_torch.py sweep [settings=40:1e-6,16:1e-4]
      `run` over tools/calibrate_solver.py's 8 settings in this process;
      writes CALIBRATION_h100_sweep.json at the root (`out=` elsewhere).

Both take steps=N (default 150), dtypes=f32,f64 (either or both) and
device=cuda|cpu. The QP setting goes to the env per call (HumanoidSpeed's
qp_iters / qp_tol / qp_rows), the route through SMPLSIM_ABA, which the port
reads at each call.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GOLDEN = os.path.join(REPO, "tests", "golden", "speed_ref_150.npz")
TIGHT = GOLDEN.replace(".npz", "_ours_f32_tight.npy")
JAX_F32_PRODUCT = GOLDEN.replace(".npz", "_jax_f32_product.npy")
JAX_F64 = GOLDEN.replace(".npz", "_jax_f64.npy")
STEPS = 150
CURVE_STEPS = (9, 49, 99, 149)
PRODUCT_QP = dict(qp_iters=16, qp_tol=1e-4, qp_rows=32)
DEFAULT_QP = dict(qp_iters=40, qp_rows=64)
# tools/calibrate_solver.py's sweep: (iterations, float32 tolerance) at 64 rows
SETTINGS = ((40, 1e-6), (24, 1e-5), (16, 1e-4), (12, 1e-4), (12, 1e-3), (8, 1e-3),
            (6, 1e-2), (4, 1e-2))


def card_line(device) -> str:
    """nvidia-smi's name and power limit of the card, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(device, dtype, steps=STEPS, qp_iters=None, qp_tol=None, qp_rows=None,
                aba=False, before_step=None):
    """The port's speed env over the golden's first `steps` actions from
    the golden's start: reset(1) from a generator seeded 0, the task pinned
    to the golden's tar_speed with no speed change, then env.step. None
    keeps the package's QP knob; aba runs the float32 articulated-body
    route; before_step(t, state, action), where given, sees each step's
    input state and (1, nu) action. Returns the (steps, nq) float64 qpos and
    the per-step stalled and overflow flags (steps,) as numpy."""
    from smplsim_tpu_torch.envs import HumanoidSpeed
    from smplsim_tpu_torch.models import registry

    gold = np.load(GOLDEN)
    model = registry.default_humanoid(dtype=dtype, device=device)
    env = HumanoidSpeed(model, qp_iters=qp_iters, qp_tol=qp_tol, qp_rows=qp_rows)
    st = env.reset(1, torch.Generator(device=device).manual_seed(0))
    st = dataclasses.replace(st, task=dataclasses.replace(
        st.task, tar_speed=torch.full_like(st.task.tar_speed, float(gold["tar_speed"])),
        change_step=torch.full_like(st.task.change_step, 10**9)))
    acts = torch.as_tensor(gold["actions"][:steps], dtype=dtype, device=device)
    before = os.environ.get("SMPLSIM_ABA")
    os.environ["SMPLSIM_ABA"] = "1" if aba else "0"
    try:
        qpos, stalled, overflow = [], [], []
        for t in range(steps):
            if before_step is not None:
                before_step(t, st, acts[t:t + 1])
            st = env.step(st, acts[t:t + 1])
            qpos.append(st.phys.qpos[0])
            stalled.append(st.info["stalled"][0])
            overflow.append(st.info["overflow"][0])
    finally:
        if before is None:
            del os.environ["SMPLSIM_ABA"]
        else:
            os.environ["SMPLSIM_ABA"] = before
    host = lambda xs: torch.stack(xs).cpu().numpy()
    return host(qpos).astype(np.float64), host(stalled), host(overflow)


def curve(qpos, ref) -> dict:
    """The error curve of a trajectory against a reference over their
    common steps, with tools/calibrate_solver.py's keys: the largest
    max-abs qpos error, the error at steps 9/49/99/149 (those reached) and
    the first step over the 1e-2 gate (-1 for none)."""
    n = min(len(qpos), len(ref))
    errs = np.abs(np.asarray(qpos[:n]) - np.asarray(ref[:n])).max(axis=1)
    over = errs > 1e-2
    return {
        "max_err_150": float(errs.max()),
        "err_at": {str(t): float(errs[t]) for t in CURVE_STEPS if t < n},
        "first_step_over_1e-2": int(np.argmax(over)) if over.any() else -1,
    }


def window_max(qpos, ref, last: int) -> float:
    """The largest max-abs qpos error over steps 0..last."""
    n = min(len(qpos), len(ref), last + 1)
    return float(np.abs(np.asarray(qpos[:n]) - np.asarray(ref[:n])).max())


def is_product(iters, tol, rows) -> bool:
    return (iters, rows) == (PRODUCT_QP["qp_iters"], PRODUCT_QP["qp_rows"]) \
        and np.isclose(tol, PRODUCT_QP["qp_tol"])


def run(device="cuda", iters=None, tol=None, rows=None, steps=STEPS, aba=False,
        dtypes=("f32", "f64")) -> dict:
    """The loops of `dtypes` ("f32", "f64") at one QP setting against the
    golden (and the tight and JAX trajectories where they apply); the
    record `run` prints."""
    from smplsim_tpu_torch.ops import qp
    from smplsim_tpu_torch.physics import solver

    iters = qp.NEWTON_ITERS if iters is None else int(iters)
    tol = qp.tol_for(torch.float32) if tol is None else float(tol)
    rows = solver.COMPACT_ROWS if rows is None else int(rows)
    ref = np.load(GOLDEN)["qpos"]
    out = {"iters": iters, "tol": tol, "rows": rows,
           "platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "device": card_line(device), "route": "aba" if aba else "dense", "steps": steps}
    for dtype, name in ((torch.float32, "f32"), (torch.float64, "f64")):
        if name not in dtypes:
            continue
        sync(device)
        t0 = time.perf_counter()
        # the tolerance is float32's; float64 keeps its own (1e-12)
        q, stalled, overflow = closed_loop(device, dtype, steps, iters,
                                           tol if dtype == torch.float32 else None, rows, aba)
        sec = time.perf_counter() - t0
        out[name] = {**curve(q, ref), "stalled_frac": float(stalled.mean()),
                     "overflow_frac": float(overflow.mean()),
                     "seconds_per_control_step": sec / steps}
        if name == "f32":
            # the tight setting is the one the tight trajectory was made at
            if not (iters >= 40 and tol <= 1.1e-6 and rows >= 64):
                out["f32_vs_tight"] = curve(q, np.load(TIGHT))
            if is_product(iters, tol, rows):
                out["f32_vs_jax"] = curve(q, np.load(JAX_F32_PRODUCT))
        elif (iters, rows) == (DEFAULT_QP["qp_iters"], DEFAULT_QP["qp_rows"]):
            out["f64_vs_jax"] = curve(q, np.load(JAX_F64))
    return out


def sweep(device="cuda", settings=SETTINGS, steps=STEPS, out_path=None,
          dtypes=("f32", "f64")) -> list:
    """`run` at each (iterations, tolerance) at 64 rows; writes the records."""
    out_path = out_path or os.path.join(REPO, "CALIBRATION_h100_sweep.json")
    results = []
    for iters, tol in settings:
        r = run(device, iters, tol, DEFAULT_QP["qp_rows"], steps, dtypes=dtypes)
        results.append(r)
        print(json.dumps(r), flush=True)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)
        f.write("\n")
    print(f"wrote {out_path}")
    return results


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0] if argv and "=" not in argv[0] else "run"
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    device = kv.get("device", "cuda")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass device=cpu to run on the CPU")
    steps = int(kv.get("steps", STEPS))
    dtypes = tuple(kv.get("dtypes", "f32,f64").split(","))
    if mode == "run":
        out = run(device, kv.get("iters"), kv.get("tol"), kv.get("rows"), steps,
                  kv.get("aba", "0") not in ("0", "false", "off"), dtypes)
        print(json.dumps(out))
        return out
    if mode == "sweep":
        settings = SETTINGS if "settings" not in kv else tuple(
            (int(s.split(":")[0]), float(s.split(":")[1])) for s in kv["settings"].split(","))
        return sweep(device, settings, steps, kv.get("out"), dtypes)
    raise SystemExit(f"unknown mode {mode} (run | sweep)")


if __name__ == "__main__":
    main()
