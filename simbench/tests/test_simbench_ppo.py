"""The PPO cell on the CPU: a tiny cell of the loop kind `ppo` (the
configuration's learner at widths (32, 32), 8 envs x horizon 4) runs
correct through the harness, its check on an iteration that follows the
window's updates; each fault planted in the port after set-up, so that
only the window's iterations and those after it carry it, comes out not
correct;
the plain learner's gradients against autograd; the readers of the five
train metrics and the operation counts on hand-made inputs."""
import ast
import contextlib
import glob
import json
import os
import time

import pytest
import torch

from simbench import calibrate_ppo, harness, ppocheck, roofline, roofline_train
from simbench.reference.learning import ppo as ref
from simbench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 4242
TRAIN_READERS = ("update_ms.train", "update_mfu.train", "iteration_mfu.train",
                 "idle_share.train", "minibatch_ms.span")


def _tiny(tmp_path):
    m, base = tiny_cell(tmp_path, "ppo_speed_b1600", "smpl_simple_mlp",
                        {"qp": {"qp_iters": 4, "qp_tol": 1e-6, "qp_rows": 64}})
    cfg = harness.load_json(base, "configs", "smpl_simple_mlp.json")
    cfg["learning"].update(num_envs=8, horizon=4, opt_num_epochs=2, num_minibatches=2,
                           policy_widths=[32, 32], value_widths=[32, 32])
    cfg["env"]["control_frequency_inv"] = 2
    with open(os.path.join(base, "configs", "smpl_simple_mlp.json"), "w") as f:
        json.dump(cfg, f)
    return m, base


def _run(m, base):
    return harness.run("tiny", SEED, 0.5, False, time.time(), device="cpu", manifest=m, base=base)


def test_tiny_ppo_cell_is_correct(tmp_path):
    m, base = _tiny(tmp_path)
    out = _run(m, base)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 32 and out["attempted"] % 32 == 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s"}        # no device time on the CPU
    limits = harness.load_json(harness.HERE, "limits", "ppo_speed_b1600.json")
    assert {k for k in limits if k not in ("rows_off_threshold", "why")} <= set(out["checks"])
    assert list(out["checks"])[:2] == ["logp_gap", "norm_gap"]
    # the policy's global gradient norm reaches max_grad_norm: the clip is live
    assert max(out["observed"]["policy_grad_norms"]) > 50.0
    assert out["observed"]["reset_rows"] == 0 and len(out["observed"]["value_grad_norms"]) == 3
    # the compared iteration starts from a merged norm and carried Adam moments
    n = out["attempted"] // 32
    assert out["observed"]["norm_count_before"] == 32 * n
    assert out["observed"]["adam_steps_before"] == 4 * n


@pytest.fixture
def planted_after_setup(monkeypatch):
    """plant(fault): the next harness run's PPO loop gets `fault` planted
    in the port once its warm-up has run, until the test ends."""
    stack = contextlib.ExitStack()
    real = harness.load_module

    def plant(fault):
        def load(path, name):
            mod = real(path, name)
            if name == "simbench_loop_ppo":
                setup = mod.setup

                def faulty_setup(ctx):
                    loop = setup(ctx)
                    warm = loop.warmup

                    def warmup():
                        warm()
                        stack.enter_context(calibrate_ppo.planted(fault, loop.ppo))
                    loop.warmup = warmup
                    return loop
                mod.setup = faulty_setup
            return mod
        monkeypatch.setattr(harness, "load_module", load)
    with stack:
        yield plant


@pytest.mark.parametrize("fault", calibrate_ppo.FAULTS)
def test_fault_planted_after_setup_comes_out_not_correct(tmp_path, planted_after_setup, fault):
    m, base = _tiny(tmp_path)
    planted_after_setup(fault)
    out = _run(m, base)
    assert not out["correct"], out["checks"]
    over = [k for k, c in out["checks"].items() if not c["value"] <= c["limit"]]
    assert set(over) <= set(ppocheck.NAMES), over      # the learner's numbers only


def test_plain_learner_gradients_match_autograd():
    """The hand-written gradient of the MLP, the surrogate and the value
    loss against torch.autograd on the same float64 arithmetic."""
    g = torch.Generator().manual_seed(0)
    d = dict(dtype=torch.float64)
    dims = (7, 16, 12, 5)
    layers = [(torch.randn(b, a, generator=g, **d) / a ** 0.5, torch.randn(b, generator=g, **d))
              for a, b in zip(dims[:-1], dims[1:])]
    x = torch.randn(40, 7, generator=g, **d)
    w = torch.randn(40, 5, generator=g, **d)
    out, kept = ref.forward(layers, x, keep=True)
    mine = ref.flat(ref.backward(layers, kept, w))
    leaves = [t.clone().requires_grad_(True) for t in ref.flat(layers)]
    auto = torch.autograd.grad((ref.forward(ref.unflat(leaves), x) * w).sum(), leaves)
    for a, b in zip(mine, auto):
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)


def test_reference_learner_imports_nothing_of_the_port():
    files = glob.glob(os.path.join(harness.HERE, "reference", "learning", "*.py"))
    assert len(files) == 2
    for f in files:
        for node in ast.walk(ast.parse(open(f).read())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""])
                assert all(n.split(".")[0] in ("torch", "contextlib", "dataclasses", "math",
                                               "__future__") for n in names), (f, names)


# ------------------------------------------------------- the arithmetic
SHAPES = dict(B=1600, T=32, obs=292, act=69, policy_widths=[2048, 1536, 1024, 1024, 512, 512],
              value_widths=[2048, 1536, 1024, 1024, 512, 512], epochs=10, minibatches=4, nv=75,
              rows=64, substeps=15, dtype="float32")


def test_train_operation_counts():
    """simple_mlp.yaml's nets on SMPL's 292 observations and 69 actions:
    7,193,669 and 7,158,785 parameters; an update 10 x 51,200 samples x
    6 x both nets plus the value pass over 51,200 + 1,600 observations,
    about 44.8 TFLOP."""
    p, v = roofline_train.nets(SHAPES)
    assert (p, v) == (7193669, 7158785)
    upd = roofline_train.update_flops(SHAPES)
    assert upd == 10 * 51200 * 6.0 * (p + v) + 2.0 * v * (51200 + 1600)
    assert round(upd / 1e12, 1) == 44.8
    assert roofline_train.rollout_policy_flops(SHAPES) == 2.0 * p * 51200
    assert roofline_train.iteration_flops(SHAPES) == pytest.approx(
        upd + 2.0 * p * 51200 + 32 * roofline.control_step_flops(1600, 75, 64, 15))


def _reader(name):
    m = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cells = {e["name"]: e for e in m["per_layer"]}
    assert cells[name]["workloads"] == ["ppo_speed_b1600"]
    return harness.load_module(f"{harness.HERE}/metrics/{name}.py", "t_" + name.replace(".", "_"))


def test_train_readers_on_a_hand_made_summary(monkeypatch):
    from smplsim_tpu_torch.utils import profiler

    s = dict(tag="train", units=1, busy_s=6.0, window_s=30.0, rollout_busy_s=5.0,
             update_busy_s=1.0, wall_s_per_unit=24.0, shapes=SHAPES)
    peak = roofline.PEAK_FLOPS["float32"]
    assert _reader("update_ms.train").read(s) == pytest.approx(1000.0)
    assert _reader("update_mfu.train").read(s) == pytest.approx(
        100 * roofline_train.update_flops(SHAPES) / peak)
    assert _reader("iteration_mfu.train").read(s) == pytest.approx(
        100 * roofline_train.iteration_flops(SHAPES) / (6.0 * peak))
    assert _reader("idle_share.train").read(s) == pytest.approx(75.0)
    up = "smplsim.learning.update"
    table = {up: {"count": 1, "host_s": 2.0, "self_s": 0.1},
             up + "/smplsim.learning.minibatch": {"count": 40, "host_s": 1.5, "self_s": 0.2},
             "smplsim.learning.minibatch": {"count": 3, "host_s": 9.0, "self_s": 9.0}}
    monkeypatch.setattr(profiler, "span_table", lambda: table)
    assert _reader("minibatch_ms.span").read(s) == pytest.approx(1500.0)
    # a program without the span, and another loop's summary: nothing to read
    monkeypatch.setattr(profiler, "span_table", lambda: {up: table[up]})
    assert _reader("minibatch_ms.span").read(s) is None
    for name in TRAIN_READERS:
        assert _reader(name).read(dict(s, tag="sim")) is None


@pytest.mark.card
def test_ppo_control_and_faults_fail_program_passes(card, tmp_path):
    """On the card at 400 envs (the configuration's widths and horizon, the
    cell's limits): the program within every learner limit on two seeds;
    the lower-precision control and each fault over one at least."""
    m, base = tiny_cell(tmp_path, "ppo_speed_b1600", "smpl_simple_mlp", {},
                        limits="ppo_speed_b1600")
    cfg = harness.load_json(base, "configs", "smpl_simple_mlp.json")
    cfg["learning"]["num_envs"] = 400
    with open(os.path.join(base, "configs", "smpl_simple_mlp.json"), "w") as f:
        json.dump(cfg, f)
    limits = harness.load_json(base, "limits", "tiny.json")

    def over(r):
        return [k for k, v in r.items() if k in limits and not v <= limits[k]]
    for i, seed in enumerate((2 ** 31 + 11, 2 ** 31 + 22)):
        r = calibrate_ppo.one_seed(m, "tiny", seed, "cuda", base, control=i == 0)["learner"]
        assert not over(r["program"]), (seed, r["program"])
        if i == 0:
            assert over(r["control"]), r["control"]
            for fault, reading in r["faults"].items():
                assert over(reading), (fault, reading)
