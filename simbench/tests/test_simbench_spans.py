"""The readers of the port's spans and counters on hand-made tables, and the
trace reduction charging idle stretches to the innermost span: the metric
arithmetic, nothing to read where the program has no spans, and the
breakdown's attribution."""
import types

import pytest
import torch

from simbench import harness, trace
from smplsim_tpu_torch.utils import profiler

ROOT = "smplsim.env.step_autoreset"
STEP, RESET = ROOT + "/smplsim.env.step", ROOT + "/smplsim.env.reset"
CS = STEP + "/smplsim.physics.control_step"
SPAN_READERS = ("reset_ms.span", "reset_rows_used.span", "dynamics_ms.span", "rows_ms.span",
                "solve_ms.span")


def _reader(name):
    m = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cells = {e["name"]: e for e in m["per_layer"]}
    assert cells[name]["workloads"] == ["speed_b4096", "smplx_speed_b4096"]
    return harness.load_module(f"{harness.HERE}/metrics/{name}.py", "t_" + name.replace(".", "_"))


def _rec(count, host_s):
    return {"count": count, "host_s": host_s, "self_s": host_s / 2}


def _table():
    """Two traced units: FK, CRBA, RNEA, rows and solve 30 times each in
    the control steps, FK and obs after them, the reset's FK twice, CRBA
    and RNEA; a made-up FK inside a CRBA and spans outside any
    step_autoreset, which the readers leave out."""
    return {
        ROOT: _rec(2, 2.0), STEP: _rec(2, 1.5), CS: _rec(2, 1.4),
        CS + "/smplsim.physics.fk": _rec(30, 0.10),
        CS + "/smplsim.physics.crba": _rec(30, 0.08),
        CS + "/smplsim.physics.crba/smplsim.physics.fk": _rec(30, 0.01),
        CS + "/smplsim.physics.rnea": _rec(30, 0.06),
        CS + "/smplsim.physics.rows": _rec(30, 0.30),
        CS + "/smplsim.physics.solve": _rec(30, 0.70),
        STEP + "/smplsim.physics.fk": _rec(2, 0.004),
        STEP + "/smplsim.env.obs": _rec(2, 0.02),
        RESET: _rec(2, 0.3), RESET + "/smplsim.physics.fk": _rec(4, 0.008),
        RESET + "/smplsim.physics.crba": _rec(2, 0.004),
        RESET + "/smplsim.physics.rnea": _rec(2, 0.002),
        "smplsim.physics.fk": _rec(5, 9.0),
        "smplsim.learning.rollout/smplsim.physics.solve": _rec(5, 9.0),
    }


def _program(monkeypatch, table, counts):
    monkeypatch.setattr(profiler, "span_table", lambda: table)
    monkeypatch.setattr(profiler, "counters", lambda: counts)


def test_span_readers_on_a_hand_made_table(monkeypatch):
    _program(monkeypatch, _table(), {"env.rows_reset": 8192, "env.rows_finished": 512.0})
    s = {"tag": "sim"}
    assert _reader("reset_ms.span").read(s) == pytest.approx(1e3 * 0.3 / 2)
    assert _reader("reset_rows_used.span").read(s) == pytest.approx(100 * 512 / 8192)
    dyn = 0.10 + 0.08 + 0.06 + 0.004 + 0.008 + 0.004 + 0.002
    assert _reader("dynamics_ms.span").read(s) == pytest.approx(1e3 * dyn / 2)
    assert _reader("rows_ms.span").read(s) == pytest.approx(1e3 * 0.30 / 2)
    assert _reader("solve_ms.span").read(s) == pytest.approx(1e3 * 0.70 / 2)


def test_span_readers_find_nothing_to_read(monkeypatch):
    """None on an empty table, without the step_autoreset span, on another
    loop's summary, and on a program whose profiler has no span table (the
    parent of the spans)."""
    _program(monkeypatch, {}, {})
    for name in SPAN_READERS:
        assert _reader(name).read({"tag": "sim"}) is None
    table = {p: r for p, r in _table().items() if p.startswith("smplsim.")
             and not p.startswith(ROOT)}
    _program(monkeypatch, table, {"env.rows_reset": 8, "env.rows_finished": 1.0})
    for name in SPAN_READERS:
        assert _reader(name).read({"tag": "sim"}) is None
    _program(monkeypatch, _table(), {"env.rows_reset": 8, "env.rows_finished": 1.0})
    for name in SPAN_READERS:
        assert _reader(name).read({"tag": "train"}) is None
    monkeypatch.delattr(profiler, "span_table")
    monkeypatch.delattr(profiler, "counters")
    for name in SPAN_READERS:
        assert _reader(name).read({"tag": "sim"}) is None


class _Ev:
    def __init__(self, name, dev, start, end):
        self.name = name
        self.device_type = (torch.autograd.DeviceType.CUDA if dev
                            else torch.autograd.DeviceType.CPU)
        self.time_range = types.SimpleNamespace(start=start, end=end)


def test_trace_reduce_charges_gaps_to_the_innermost_span():
    """Host events with smplsim.* spans around the ops: each idle stretch
    goes to the innermost span or op at its middle, none to "host, outside
    any op"; the spans are host events, not device operations."""
    ev = [_Ev(ROOT, False, 0, 100), _Ev("smplsim.env.step", False, 5, 60),
          _Ev("aten::mm", False, 10, 20), _Ev("cudaLaunchKernel", False, 12, 13),
          _Ev("smplsim.physics.solve", False, 30, 55), _Ev("aten::add", False, 40, 45),
          _Ev("cudaLaunchKernel", False, 41, 42), _Ev("smplsim.env.reset", False, 65, 95),
          _Ev("cudaLaunchKernel", False, 66, 67),
          _Ev("k_mm", True, 15, 35), _Ev("k_add", True, 42, 50), _Ev("k_reset", True, 72, 75)]
    s = trace.reduce(ev, 1e-4, 1)
    # gaps 0-15 (middle 7.5: in step), 35-42 (38.5: in solve, before the
    # add), 50-72 (61: step has ended, the reset not begun)
    assert s["idle_by_host_op"] == {"smplsim.env.step": pytest.approx(15e-6),
                                    "smplsim.physics.solve": pytest.approx(7e-6),
                                    ROOT: pytest.approx(22e-6)}
    assert set(s["device_ops"]) == {"k_mm", "k_add", "k_reset"}
    assert s["runtime"] == {"cudaLaunchKernel": 3}
    assert s["busy_s"] == pytest.approx(31e-6)
