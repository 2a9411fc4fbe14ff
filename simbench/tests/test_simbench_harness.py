"""The harness on the CPU: a cell added as data files only is found and
runs, nothing of the JAX side is loaded after a run, the metric arithmetic
on hand-made inputs, and a run with the timed path broken underneath
comes out not correct, once for each fault the cells can have."""
import json
import subprocess
import sys
import time
import types

import pytest
import torch

from simbench import envcheck, harness, roofline, trace
from simbench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 12345      # beyond 32 signed bits: run seeds may be


def tiny_run(m, base, seconds=1.0):
    return harness.run("tiny", SEED, seconds, False, time.time(), device="cpu", manifest=m,
                       base=base)


# ------------------------------------------------------- found and runs
def test_cell_added_as_data_files_is_found_and_runs(tmp_path):
    m, base = tiny_cell(tmp_path, "speed_b4096", "smpl", {"batch": 20, "warmup_units": 1})
    out = tiny_run(m, base)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 20 and out["failed"] == 0
    # a CPU run has no device time: the device-time rate is left out
    assert set(out["metrics"]) == {"setup_s"}
    assert out["metrics"]["setup_s"]["value"] > 0
    assert out["window"]["units"] == out["attempted"] and out["window"]["seconds"] > 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == {"state_gap_p50", "rows_off_share", "cache_gap_p50",
                                  "reset_gap", "answer_gap", "done_flips"}
    assert set(out["observed"]) == {"flipped_rows", "reset_rows", "off_shares"}
    assert 0.0 < out["host"]["cpu_s_per_s"] and out["host"]["cpus"] >= 1
    assert out["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0}


def test_no_module_of_the_jax_side_after_a_run(tmp_path):
    """In a fresh process: after a CPU run of a tiny cell no module's
    top-level name is jax, jaxlib, flax or smplsim_tpu; the port is
    loaded."""
    m, base = tiny_cell(tmp_path, "speed_b4096", "smpl", {"batch": 4, "warmup_units": 1})
    (tmp_path / "manifest.json").write_text(json.dumps(m))
    code = f"""
import json, sys, time
sys.path.insert(0, {harness.ROOT!r})
from simbench import harness
m = json.load(open({str(tmp_path / 'manifest.json')!r}))
out = harness.run("tiny", {SEED}, 0.5, False, time.time(), device="cpu", manifest=m, base={base!r})
tops = sorted({{k.split(".")[0] for k in sys.modules}})
print(json.dumps({{"correct": out["correct"], "tops": tops}}))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert not set(got["tops"]) & {"jax", "jaxlib", "flax", "smplsim_tpu"}
    assert "smplsim_tpu_torch" in got["tops"]


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "smplsim_tpu_torch_extra", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert harness.forbidden_modules() == [] or "smplsim_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "smplsim_tpu.envs", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("x"))
    assert {"smplsim_tpu", "jaxlib"} <= set(harness.forbidden_modules())
    assert "smplsim_tpu_torch" not in harness.forbidden_modules()


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "speed_b4096", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


# ------------------------------------------------------- the arithmetic
def test_chol_solve_bytes_operations_and_bound():
    """The float32 bound of one batched SPD factor + solve at B = 4096,
    n = 75: 0.0150 ms at m = 1 with the shift, 0.0381 ms at m = 33 (the
    numbers PERF.md's kernel table gives)."""
    b1 = roofline.chol_solve_bytes(4096, 75, 1, True, 4)
    assert b1 == 4 * 4096 * (75 * 76 / 2 + 2 * 75 + 75)
    assert roofline.chol_solve_flops(4096, 75, 1) == 4096 * (75 ** 3 / 3 + 2 * 75 * 75)
    t1 = roofline.bound_s(b1, roofline.chol_solve_flops(4096, 75, 1), "float32")
    t33 = roofline.bound_s(roofline.chol_solve_bytes(4096, 75, 33, False, 4),
                           roofline.chol_solve_flops(4096, 75, 33), "float32")
    assert round(t1 * 1e3, 4) == 0.0150 and round(t33 * 1e3, 4) == 0.0381
    step = roofline.control_step_solve_bound_s(4096, 75, 32, 15, "float32", 4)
    assert step == pytest.approx(15 * (t1 + t33))


def test_control_step_flops():
    """The dense work of a control step at B = 4096, n = 75, 32 rows, 15
    substeps: the solves' operations plus per substep the inertia's
    6 n (n + 1) and the Delassus product's 2 rows^2 n per system."""
    solves = roofline.control_step_solve_flops(4096, 75, 32, 15)
    assert roofline.mass_matrix_flops(1, 75) == 6 * 75 * 76
    assert roofline.delassus_flops(1, 75, 32) == 2 * 32 * 32 * 75
    assert roofline.control_step_flops(4096, 75, 32, 15) == pytest.approx(
        solves + 15 * 4096 * (6 * 75 * 76 + 2 * 32 * 32 * 75))


def _summary(**kw):
    s = dict(tag="sim", units=2, busy_s=0.5, window_s=2.5, wall_s_per_unit=1.0,
             device_ops={"ampere_sgemm_128x64_nn": [0.1, 40], "gemv2T_kernel_val<...>": [0.02, 10],
                         "void chol_solve_tiled_kernel<float, 4>(...)": [0.016, 60],
                         "void chol_solve_kernel<float, true>(...)": [1.0, 1],
                         "elementwise_kernel": [0.3, 900]},
             runtime={"cudaLaunchKernel": 1000, "cudaMemcpyAsync": 10, "cudaStreamSynchronize": 3},
             idle_by_host_op={}, counters={"stalled_share": 0.25},
             shapes=dict(B=4096, nv=75, rows=32, substeps=15, control_steps_per_unit=1,
                         dtype="float32", itemsize=4))
    s.update(kw)
    return s


def _reader(name):
    m = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cells = {e["name"]: e for e in m["per_layer"]}
    assert name in cells
    return harness.load_module(f"{harness.HERE}/metrics/{name}.py", "t_" + name.replace(".", "_"))


def test_sim_readers_on_a_hand_made_summary():
    s = _summary()
    assert _reader("idle_share.sim").read(s) == pytest.approx(75.0)
    assert _reader("gemm_ms.sim").read(s) == pytest.approx(1e3 * 0.12 / 2)
    assert _reader("host_launches_per_step.sim").read(s) == pytest.approx(505.0)
    assert _reader("stalled_share.sim").read(s) == pytest.approx(25.0)
    bound = roofline.control_step_solve_bound_s(4096, 75, 32, 15, "float32", 4)
    # E's column form (<float, true>) is not A's: only the tiled kernel counts
    assert _reader("chol_solve_roofline").read(s) == pytest.approx(100 * bound / 0.008)
    flops = roofline.control_step_flops(4096, 75, 32, 15)
    # over the device-busy seconds per traced unit (0.5 s over 2 units)
    assert _reader("step_mfu.sim").read(s) == pytest.approx(100 * flops / (0.25 * 67e12))
    assert _reader("env_steps_per_s.wall").read(s) == pytest.approx(4096.0)
    # nothing to read: no such kernel ran, or another loop's summary
    none = _summary(device_ops={"elementwise_kernel": [0.3, 900]}, runtime={})
    for name in ("gemm_ms.sim", "host_launches_per_step.sim", "chol_solve_roofline"):
        assert _reader(name).read(none) is None
        assert _reader(name).read(dict(s, tag="train")) is None


def test_device_time_rate(monkeypatch):
    """env_steps_per_device_s: B env-steps per profiled unit over the
    device-busy seconds of the units profiled with device activity alone;
    nothing on a CPU run."""
    kind = harness.load_module(f"{harness.HERE}/traffic/env_steps.py", "t_env_steps")
    seen = {}

    def record(fn, units, host=True):
        seen.update(units=units, host=host)
        return {"units": units, "busy_s": 0.8}
    monkeypatch.setattr(kind.trace, "record", record)
    env = types.SimpleNamespace(step_autoreset=None)
    loop = types.SimpleNamespace(dev=torch.device("cuda"), env=env, B=4096, _one=None,
                                 ctx=types.SimpleNamespace(traffic={"device_units": 2}))
    assert kind.EnvSteps.end_to_end(loop, 40960, 8.0) == {"env_steps_per_device_s": 10240.0}
    assert seen == {"units": 2, "host": False}
    loop.dev = torch.device("cpu")
    assert kind.EnvSteps.end_to_end(loop, 40960, 8.0) == {}


class _Ev:
    def __init__(self, name, dev, start, end):
        self.name = name
        self.device_type = (torch.autograd.DeviceType.CUDA if dev
                            else torch.autograd.DeviceType.CPU)
        self.time_range = types.SimpleNamespace(start=start, end=end)


def test_trace_reduction_on_hand_made_events():
    """Busy time is the union of the device intervals; idle stretches go to
    the innermost host op at their middle, runtime calls counted apart."""
    ev = [_Ev("aten::step", False, 0, 100), _Ev("aten::mm", False, 10, 30),
          _Ev("cudaLaunchKernel", False, 12, 14), _Ev("aten::add", False, 50, 60),
          _Ev("cudaLaunchKernel", False, 52, 53),
          _Ev("gemm_a", True, 20, 40), _Ev("gemm_a", True, 35, 45), _Ev("add_k", True, 70, 80)]
    s = trace.reduce(ev, 1e-4, 1)
    assert s["busy_s"] == pytest.approx(35e-6)
    assert s["device_ops"]["gemm_a"] == [pytest.approx(30e-6), 2]
    assert s["runtime"] == {"cudaLaunchKernel": 2}
    # gaps 0-20 (middle 10: aten::step, aten::mm starts at 10) and 45-70
    # (middle 57.5: aten::add)
    assert s["idle_by_host_op"]["aten::add"] == pytest.approx(25e-6)
    assert sum(s["idle_by_host_op"].values()) == pytest.approx(45e-6)
    b = trace.breakdown(s)
    assert b["device_ops"][0] == ["gemm_a", pytest.approx(30e-6)]
    assert len(b["idle_gaps"]) <= 10


class _Raw:
    def __init__(self, dev, start_ns, end_ns, annotation=False):
        self._dev, self._s, self._e, self._a = dev, start_ns, end_ns, annotation

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._dev else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def is_user_annotation(self):
        return self._a


def test_device_busy_from_raw_results_and_from_events():
    """The device-only recording's busy time: the union of the device
    operations' intervals, host events and device-side annotations left
    out; the same from the event list where no raw results are kept."""
    raw = [_Raw(False, 0, 100_000), _Raw(True, 20_000, 40_000), _Raw(True, 35_000, 45_000),
           _Raw(True, 70_000, 80_000), _Raw(True, 0, 100_000, annotation=True)]
    res = types.SimpleNamespace(events=lambda: raw)
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=res))
    assert trace.device_busy_s(prof) == pytest.approx(35e-6)
    ev = [_Ev("aten::step", False, 0, 100), _Ev("gemm_a", True, 20, 40),
          _Ev("gemm_a", True, 35, 45), _Ev("add_k", True, 70, 80)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=None),
                                 events=lambda: ev)
    assert trace.device_busy_s(prof) == pytest.approx(35e-6)


# ------------------------------------------------------- faults
RESET_FAULTS = ("no_termination", "wrong_reset")


def _speed_fault(monkeypatch, tmp_path, fault, episode_length=None):
    """A tiny speed cell with the port's step_autoreset broken underneath.
    Under a fault of the reset path its episodes end at every control step,
    so that every sampled call finishes every row; under the others they
    run the configuration's length, so that no row finishes."""
    from smplsim_tpu_torch.envs import HumanoidSpeed

    orig = HumanoidSpeed.step_autoreset

    def broken(self, state, action, *a, **k):
        # the port may step the state's buffers in place: keep the input
        before = envcheck.clone_tree(state)
        if fault == "unchanged":
            return before
        out = orig(self, state, action, *a, **k)
        B = action.shape[0]
        if fault in ("half_batch", "tenth_rows"):
            rows = torch.arange(B)
            mask = rows >= B // 2 if fault == "half_batch" else rows % 10 == 0
            out.phys = type(out.phys)(
                torch.where(mask[:, None], before.phys.qpos, out.phys.qpos),
                torch.where(mask[:, None], before.phys.qvel, out.phys.qvel))
            return out
        if fault == "no_termination":
            # finished rows go on from their step, unreset and unflagged
            nxt = self.step(before, action)
            fin = nxt.done
            out.phys = nxt.phys
            out.obs, out.cur_t, out.task = nxt.obs, nxt.cur_t, nxt.task
            out.pd_cache = nxt.pd_cache
            out.terminated = out.terminated & ~fin
            out.truncated = out.truncated & ~fin
            return out
        if fault == "wrong_reset":
            qpos = out.phys.qpos.clone()
            qpos[out.done, 2] += 0.01
            out.phys = type(out.phys)(qpos, out.phys.qvel)
            return out
        if fault == "stale_cache":
            out.pd_cache = before.pd_cache
            return out
        if fault == "none":
            return out
        out.obs = out.obs.clone()
        out.obs[0, 0] += 0.01
        return out
    monkeypatch.setattr(HumanoidSpeed, "step_autoreset", broken)
    m, base = tiny_cell(tmp_path, "speed_b4096", "smpl", {"batch": 100, "warmup_units": 1})
    cfg = harness.load_json(base, "configs", "smpl.json")
    if episode_length is None:
        episode_length = 0 if fault in RESET_FAULTS else cfg["env"]["episode_length"]
    cfg["env"]["episode_length"] = episode_length
    with open(f"{base}/configs/smpl.json", "w") as f:
        json.dump(cfg, f)
    return tiny_run(m, base)


@pytest.mark.parametrize("episode_length", [0, 300])
def test_fault_tests_tiny_cell_is_correct(monkeypatch, tmp_path, episode_length):
    """The fault tests' cell, unbroken: correct, with every row finished
    and compared as a reset at an episode length of 0, none at 300."""
    out = _speed_fault(monkeypatch, tmp_path, "none", episode_length)
    assert out["correct"], out["checks"]
    assert out["observed"]["reset_rows"] == (
        100 * min(out["window"]["units"] // 100, 3) if episode_length == 0 else 0)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "tenth_rows", "altered_answer",
                                   "no_termination", "wrong_reset", "stale_cache"])
def test_env_step_faults_come_out_not_correct(monkeypatch, tmp_path, fault):
    out = _speed_fault(monkeypatch, tmp_path, fault)
    assert not out["correct"], out["checks"]


def test_no_file_of_the_benchmark_imports_the_jax_side():
    """Every Python file under simbench/, the tests too: no import of jax,
    jaxlib, flax or smplsim_tpu (compared by whole top-level names)."""
    import ast
    import glob
    import os

    files = glob.glob(os.path.join(harness.HERE, "**", "*.py"), recursive=True)
    assert len(files) > 30
    for f in files:
        for node in ast.walk(ast.parse(open(f).read())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in harness.FORBIDDEN, (f, n)
