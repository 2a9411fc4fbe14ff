"""The port's closed loop against the product gate's references on the CPU
(tools/calibrate_solver_torch.py): the MuJoCo golden
(tests/golden/speed_ref_150.npz) and the JAX package's committed float32
trajectory at the product QP (speed_ref_150_jax_f32_product.npy, written by
tools/golden_jax_trajectories.py). One env, 10 control steps; the card runs
all 150 (tools/gate_f32_torch.py, chip_smoke.py phase 34). No JAX env is
compiled here: the JAX side is the committed files."""
import json
import os
import sys

import numpy as np
import torch

import _torch_port  # noqa: F401  (one torch thread per test process)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import calibrate_solver_torch as cal  # noqa: E402
import gate_f32_torch as gate  # noqa: E402

REPO = cal.REPO
STEPS = 10


def test_float64_loop_matches_mujoco_golden():
    """The float64 loop at the package's default QP stays within 1e-12 of
    MuJoCo's trajectory (1.9e-14 on the CPU) and of the JAX package's."""
    q, stalled, overflow = cal.closed_loop("cpu", torch.float64, STEPS)
    assert q.shape == (STEPS, 76) and q.dtype == np.float64
    golden = cal.curve(q, np.load(cal.GOLDEN)["qpos"])
    assert golden["max_err_150"] <= 1e-12, golden
    assert golden["first_step_over_1e-2"] == -1 and set(golden["err_at"]) == {"9"}
    assert cal.curve(q, np.load(cal.JAX_F64))["max_err_150"] <= 1e-12
    assert not stalled.any() and not overflow.any()


def test_run_float32_product_loop_matches_jax_trajectory(capsys):
    """`run` at the product QP (16 iterations, tol 1e-4, 32 rows), float32:
    its one JSON line holds the golden, tight and JAX curves; the loop stays
    within 1e-4 of the JAX package's float32 trajectory (2.2e-5 on the
    CPU)."""
    out = cal.main(["run", "device=cpu", f"steps={STEPS}", "iters=16", "tol=1e-4", "rows=32",
                    "dtypes=f32"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert (out["iters"], out["tol"], out["rows"], out["platform"], out["device"],
            out["route"]) == (16, 1e-4, 32, "cpu", "cpu", "dense")
    assert "f64" not in out and "f64_vs_jax" not in out
    assert out["f32_vs_jax"]["max_err_150"] <= 1e-4, out["f32_vs_jax"]
    # float32 rounding alone: the golden and the tight trajectory are near
    assert out["f32"]["max_err_150"] <= 1e-4 and out["f32_vs_tight"]["max_err_150"] <= 1e-4
    assert out["f32"]["stalled_frac"] == 0.0


def test_curve_keys_and_window(monkeypatch):
    """curve carries tools/calibrate_solver.py's keys, those of the TPU's
    speed record (CALIBRATION_r05.json), and reads the first crossing;
    the gate tool's float32 speed record carries every key of that record
    (its loop replaced by the JAX trajectory itself: the loops are the other
    tests')."""
    rec = next(r for r in json.load(open(os.path.join(REPO, "CALIBRATION_r05.json")))
               if r["task"] == "speed")
    ref = np.zeros((150, 3))
    q = ref.copy()
    q[41:, 1] = 0.02
    q[9, 0] = 1e-3
    c = cal.curve(q, ref)
    for name in ("vs_f64_golden", "vs_tight_f32"):
        assert set(rec[name]) <= set(c)
        assert set(rec[name]["err_at"]) == set(c["err_at"])
    assert c["first_step_over_1e-2"] == 41 and c["err_at"]["9"] == 1e-3
    assert c["max_err_150"] == 0.02
    assert cal.window_max(q, ref, 39) == 1e-3
    assert cal.curve(q[:5], ref)["err_at"] == {}
    assert cal.curve(ref, ref)["first_step_over_1e-2"] == -1
    jax32 = np.load(cal.JAX_F32_PRODUCT)
    flags = np.zeros(150, bool)
    monkeypatch.setattr(cal, "closed_loop", lambda device, dtype, steps, aba=False, **qp:
                        (jax32[:steps], flags[:steps], flags[:steps]))
    r = gate.speed_f32("cpu")
    assert set(rec) - {"platform"} <= set(r) and r["vs_jax_f32"]["max_err_150"] == 0.0
    assert r["pass"] and r["envelope_pass"] is False and r["gate_min_divergence_step"] == 45
    # the JAX package's own float32 loop crosses the golden's 1e-2 at step 41
    assert r["vs_f64_golden"]["first_step_over_1e-2"] == 41


def test_sweep_two_settings(tmp_path):
    """sweep runs `run` at each setting in this process and writes them."""
    path = tmp_path / "sweep.json"
    recs = cal.main(["sweep", "device=cpu", "steps=2", "settings=40:1e-6,16:1e-4",
                     "dtypes=f32", f"out={path}"])
    assert [(r["iters"], r["tol"], r["rows"]) for r in recs] == [(40, 1e-6, 64), (16, 1e-4, 64)]
    assert json.load(open(path)) == json.loads(json.dumps(recs))
    # the tight setting is the committed tight trajectory's own: no curve
    # against it; the loose one has one
    assert "f32_vs_tight" not in recs[0] and "f32_vs_tight" in recs[1]
    assert all(r["f32"]["max_err_150"] <= 1e-4 for r in recs)
    assert all("f32_vs_jax" not in r for r in recs)   # 64 rows: not the product QP
