"""The product gate of the PyTorch port on the card (counterpart of
tools/gate_f32_tpu.py). Writes CALIBRATION_h100.json and exits non-zero
when a gate fails.

Records, in this order:

  1. speed, float64, the package's default QP (40 iterations, tol 1e-12,
     64 rows): the curve against the MuJoCo golden
     (tests/golden/speed_ref_150.npz), GATED at a largest error of 1e-9
     over every step; beside it the curve against the JAX package's float64
     trajectory (speed_ref_150_jax_f64.npy).
  2. speed, float32, the product QP (16 iterations, tol 1e-4, 32 rows), on
     the dense route and on the articulated-body route (SMPLSIM_ABA=1):
     - the curves against the golden and against the tight-QP float32
       trajectory (speed_ref_150_ours_f32_tight.npy), with
       tools/gate_f32_tpu.py's 45-step envelope and its pass/fail RECORDED,
       not gated (`envelope_pass`): the JAX package itself crosses the
       golden's 1e-2 at step 41 on the CPU today, and the TPU's record
       (CALIBRATION_r05.json) reads false;
     - the curve against the JAX package's float32 trajectory at the same
       QP (speed_ref_150_jax_f32_product.npy, made by
       tools/golden_jax_trajectories.py), GATED at 5e-3 over steps 0-39,
       before the golden crossing, and reported over every step.
  3. getup, 64 envs x 150 control steps of step_autoreset at the product
     QP, reset from a generator seeded 3, actions from RandomState(5)
     uniform in [-0.5, 0.5]: stalled_frac GATED at 0.05; overflow_frac,
     nactive_mean and nactive_max reported (the TPU read 0.011 stalled and
     0.200 overflow, CALIBRATION_r05.json).

    python tools/gate_f32_torch.py                       # on the card
    python tools/gate_f32_torch.py device=cpu steps=3 getup_envs=2 getup_steps=2 out=/tmp/c.json

`pass` is the gated outcome of each record; the run passes when every
record's does.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import calibrate_solver_torch as cal  # noqa: E402

STEPS = cal.STEPS
MIN_DIVERGENCE_STEP = 45      # tools/gate_f32_tpu.py's envelope, recorded only
F64_GATE = 1e-9               # largest float64 error against the golden, every step
F32_JAX_GATE = 5e-3           # the port's float32 tolerance against the JAX trajectory
F32_JAX_LAST = 39             # ... over steps 0..39, before the golden crossing at 41
GETUP_STALLED_GATE = 0.05
GETUP_ENVS = 64


def timed_loop(device, dtype, steps, aba=False, before_step=None, **qp):
    cal.sync(device)
    t0 = time.perf_counter()
    q, stalled, overflow = cal.closed_loop(device, dtype, steps, aba=aba,
                                           before_step=before_step, **qp)
    return q, stalled, overflow, (time.perf_counter() - t0) / steps


def speed_f64(device="cuda", steps=STEPS, before_step=None) -> dict:
    """The float64 loop at the default QP against the golden, gated;
    before_step as in calibrate_solver_torch.closed_loop."""
    q, stalled, overflow, sec = timed_loop(device, torch.float64, steps,
                                           before_step=before_step)
    golden = cal.curve(q, np.load(cal.GOLDEN)["qpos"])
    return {"task": "speed", "dtype": "float64", "route": "dense", "steps": steps,
            "qp_iters": cal.DEFAULT_QP["qp_iters"], "qp_tol": 1e-12,
            "qp_rows": cal.DEFAULT_QP["qp_rows"], "vs_f64_golden": golden,
            "vs_jax_f64": cal.curve(q, np.load(cal.JAX_F64)),
            "stalled_frac": float(stalled.mean()), "overflow_frac": float(overflow.mean()),
            "seconds_per_control_step": sec, "gate_max_err": F64_GATE,
            "pass": golden["max_err_150"] <= F64_GATE}


def speed_f32(device="cuda", steps=STEPS, aba=False) -> dict:
    """The float32 loop at the product QP: golden and tight curves with the
    45-step envelope recorded, the JAX trajectory's gated over 0..39."""
    qp_ = cal.PRODUCT_QP
    q, stalled, overflow, sec = timed_loop(device, torch.float32, steps, aba, **qp_)
    vs_golden = cal.curve(q, np.load(cal.GOLDEN)["qpos"])
    vs_tight = cal.curve(q, np.load(cal.TIGHT))
    jax32 = np.load(cal.JAX_F32_PRODUCT)
    window = cal.window_max(q, jax32, F32_JAX_LAST)
    envelope = all(c["first_step_over_1e-2"] == -1
                   or c["first_step_over_1e-2"] >= MIN_DIVERGENCE_STEP
                   for c in (vs_golden, vs_tight))
    return {"task": "speed", "dtype": "float32", "route": "aba" if aba else "dense",
            "steps": steps, **qp_, "vs_f64_golden": vs_golden, "vs_tight_f32": vs_tight,
            "vs_jax_f32": cal.curve(q, jax32), "vs_jax_f32_max_err_0_39": window,
            "stalled_frac": float(stalled.mean()), "overflow_frac": float(overflow.mean()),
            "seconds_per_control_step": sec,
            "gate_min_divergence_step": MIN_DIVERGENCE_STEP, "envelope_pass": envelope,
            "gate_vs_jax_f32": F32_JAX_GATE, "pass": window <= F32_JAX_GATE}


def getup(device="cuda", envs=GETUP_ENVS, steps=STEPS) -> dict:
    """Contact-rich regime: the product QP budget converges on Fall poses."""
    from smplsim_tpu_torch.envs import HumanoidGetup
    from smplsim_tpu_torch.models import registry

    model = registry.default_humanoid(dtype=torch.float32, device=device)
    env = HumanoidGetup(model, **cal.PRODUCT_QP)
    cal.sync(device)
    t0 = time.perf_counter()
    st = env.reset(envs, torch.Generator(device=device).manual_seed(3))
    rng = np.random.RandomState(5)
    stalled, overflow, nact = [], [], []
    for _ in range(steps):
        a = torch.as_tensor(rng.uniform(-0.5, 0.5, (envs, env.action_size)),
                            dtype=torch.float32, device=device)
        st = env.step_autoreset(st, a)
        stalled.append(st.info["stalled"])
        overflow.append(st.info["overflow"])
        nact.append(st.info["nactive"])
    stalled, overflow, nact = (torch.stack(x).cpu().numpy() for x in (stalled, overflow, nact))
    sec = time.perf_counter() - t0
    return {"task": "getup", "envs": envs, "steps": steps, **cal.PRODUCT_QP,
            "stalled_frac": float(stalled.mean()), "overflow_frac": float(overflow.mean()),
            "nactive_mean": float(nact.mean()), "nactive_max": int(nact.max()),
            "seconds_per_step_autoreset": sec / steps, "gate_stalled_frac": GETUP_STALLED_GATE,
            "pass": bool(stalled.mean() <= GETUP_STALLED_GATE)}


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    kv = dict(a.split("=", 1) for a in argv)
    device = kv.get("device", "cuda")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass device=cpu to run on the CPU")
    steps = int(kv.get("steps", STEPS))
    out = kv.get("out", os.path.join(cal.REPO, "CALIBRATION_h100.json"))
    platform = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
                "device": cal.card_line(device)}
    recs = []
    for make in (lambda: speed_f64(device, steps), lambda: speed_f32(device, steps),
                 lambda: speed_f32(device, steps, aba=True),
                 lambda: getup(device, int(kv.get("getup_envs", GETUP_ENVS)),
                               int(kv.get("getup_steps", STEPS)))):
        recs.append({**make(), **platform})
        print(json.dumps(recs[-1]), flush=True)
    with open(out, "w") as f:
        json.dump(recs, f, indent=1)
        f.write("\n")
    print(f"wrote {out}")
    if not all(r["pass"] for r in recs):
        raise SystemExit("product gate FAILED")
    print("product gate PASSED")
    return recs


if __name__ == "__main__":
    main()
