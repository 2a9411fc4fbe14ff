"""PyTorch port: the spans and counters of utils/profiler.py on the env step.

  * with no profiler active a step_autoreset records nothing and enters no
    record function;
  * under torch.profiler one step_autoreset gives the whole span tree (paths
    and counts as the code implies), every span in the profiler's events,
    the four counters, and the same aten operations and state as without;
  * self time on a hand-built nest under a fake clock, the counters' fold;
  * PPO's rollout, policy and update spans; the update's advantages and
    minibatch spans under it, and its two counters;
  * the self-collision kernel's launch count stays as it was on the CPU.
"""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from smplsim_tpu_torch.envs import HumanoidSpeed, SpeedConfig
from smplsim_tpu_torch.envs.base import clone_generator
from smplsim_tpu_torch.learning.ppo import PPO, PPOConfig
from smplsim_tpu_torch.models import registry
from smplsim_tpu_torch.ops import collision
from smplsim_tpu_torch.physics import collision_pairs
from smplsim_tpu_torch.utils import profiler

B = 8
SUBSTEPS = 15
ROOT = "smplsim.env.step_autoreset"

# thousands of small-tensor ops: one intra-op thread per test process, as
# tests/_torch_port.py sets
torch.set_num_threads(1)


class _Ops(TorchDispatchMode):
    """The aten operations dispatched inside the mode, in order."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _speed(substeps, qp_iters):
    """A float32 speed env at B = 8 with the benchmark's QP rows, and a
    state whose rows 3 and 6 finish at the next step (truncation)."""
    m = registry.default_humanoid(torch.float32, device="cpu")
    env = HumanoidSpeed(m, SpeedConfig(control_frequency_inv=substeps), keeps=(24, 16, 8),
                        qp_iters=qp_iters, qp_rows=32, qp_tol=1e-4)
    s = env.reset(B, torch.Generator().manual_seed(3))
    cur_t = torch.zeros(B, dtype=torch.int32)
    cur_t[[3, 6]] = env.config.episode_length
    action = torch.rand((B, m.nu), generator=torch.Generator().manual_seed(4)) * 0.2 - 0.1
    return env, dataclasses.replace(s, cur_t=cur_t), action


@pytest.fixture(scope="module")
def speed():
    """15 substeps, as the benchmark's; 1 QP iteration (its 16 only add
    operations)."""
    return _speed(SUBSTEPS, 1)


def _fresh(state):
    """The state with a generator of its own, at the same draw."""
    return dataclasses.replace(state, rng=clone_generator(state.rng))


def _tree(substeps):
    """{path: count} that one uhc_pd step_autoreset with the Default init
    implies: per control step `substeps` of each substep span, FK and obs
    after the physics, the reward; the reset's FK, obs and pd_cache (FK,
    CRBA, RNEA)."""
    step, reset = ROOT + "/smplsim.env.step", ROOT + "/smplsim.env.reset"
    cs = step + "/smplsim.physics.control_step"
    out = {ROOT: 1, step: 1, cs: 1, step + "/smplsim.physics.fk": 1,
           step + "/smplsim.env.obs": 1, step + "/smplsim.env.reward": 1,
           reset: 1, reset + "/smplsim.physics.fk": 2, reset + "/smplsim.env.obs": 1,
           reset + "/smplsim.physics.crba": 1, reset + "/smplsim.physics.rnea": 1,
           ROOT + "/smplsim.env.select": 1}
    for k in ("pd_torque", "fk", "crba", "rnea", "rows", "solve", "integrate"):
        out[cs + "/smplsim.physics." + k] = substeps
    return out


def test_no_profiler_records_nothing_and_enters_no_record_function(speed, monkeypatch):
    env, state, action = speed
    entered = []

    class Stub:
        def __init__(self, *a, **k):
            entered.append(a)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Stub)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Stub)
    profiler.clear()
    assert not profiler.profiling()
    env.step_autoreset(_fresh(state), action)
    assert profiler.span_table() == {} and profiler.counters() == {}
    assert entered == []
    # off, a span is the name's one shared no-op context
    assert profiler.span("smplsim.env.select") is profiler.span("smplsim.env.select")


def test_step_autoreset_span_tree_and_counters(speed):
    env, state, action = speed
    profiler.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiler.profiling()
        out = env.step_autoreset(_fresh(state), action)
    assert not profiler.profiling()
    table = profiler.span_table()
    assert {p: r["count"] for p, r in table.items()} == _tree(SUBSTEPS)
    names = {p.split("/")[-1] for p in table}
    # the recording's raw events (the event tree of 10^5 ops takes a minute)
    assert names <= {e.name() for e in prof.profiler.kineto_results.events()}
    assert all(n.startswith("smplsim.") and not n.startswith("cu") for n in names)
    # the children cover the call but for its own few host statements
    root = table[ROOT]
    assert 0.0 <= root["self_s"] <= 0.05 * root["host_s"]
    for r in table.values():
        assert 0.0 <= r["self_s"] <= r["host_s"]

    c = profiler.counters()
    done = out.terminated | out.truncated
    pairs = sum(len(v) for v in collision_pairs.pair_lists(env.model).values())
    assert c == {"env.rows_reset": B, "env.rows_finished": float(done.sum()),
                 "rows.geom_frames": SUBSTEPS * env.model.ngeom,
                 "rows.pair_sides": SUBSTEPS * 2 * pairs}
    assert c["env.rows_finished"] >= 2 and bool(done[3]) and bool(done[6])
    profiler.clear()


def test_self_kernel_counts_zero_on_the_cpu():
    """Kernel F serves no CPU call: under the profiler a step_autoreset
    leaves its launch count (ops.collision.self_contacts.launches) as it
    was, and counts the plain composition's rows.pair_sides once per
    substep (1 substep)."""
    env, state, action = _speed(1, 1)
    launches = collision.self_contacts.launches
    profiler.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        env.step_autoreset(_fresh(state), action)
    c = profiler.counters()
    pairs = sum(len(v) for v in collision_pairs.pair_lists(env.model).values())
    assert collision.self_contacts.launches == launches and c["rows.pair_sides"] == 2 * pairs
    profiler.clear()


def test_spans_and_counters_add_no_operation():
    """The same aten operations, in order, and the same state with the
    spans and counters live as without; every span among `prof.events()`
    (1 substep, 1 QP iteration)."""
    env, state, action = _speed(1, 1)
    with _Ops() as off:
        ref = env.step_autoreset(_fresh(state), action)
    profiler.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with _Ops() as on:
            out = env.step_autoreset(_fresh(state), action)
    table = profiler.span_table()
    assert {p: r["count"] for p, r in table.items()} == _tree(1)
    assert {p.split("/")[-1] for p in table} <= {e.name for e in prof.events()}
    assert on.names == off.names and len(off.names) > 1000
    assert torch.equal(out.phys.qpos, ref.phys.qpos) and torch.equal(out.obs, ref.obs)
    profiler.clear()


def test_self_time_and_counters_on_a_hand_built_nest(monkeypatch):
    ticks = iter([0, 10, 15, 25, 40, 50, 60, 100])
    monkeypatch.setattr(profiler, "_clock", lambda: next(ticks))

    @profiler.span("smplsim.t.b")
    def b(inner):
        if inner:
            with profiler.span("smplsim.t.c"):
                pass

    profiler.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiler.span("smplsim.t.a"):       # 0 .. 100
            b(True)                              # 10 .. 40, c 15 .. 25
            b(False)                             # 50 .. 60
        for _ in range(2 * profiler.FOLD + 3):
            profiler.count("t.rows", torch.ones(3, dtype=torch.bool))
            profiler.count("t.calls", 1)
    profiler.count("t.calls", 1)                 # no recording: not counted
    t = profiler.span_table()
    assert t["smplsim.t.a"] == {"count": 1, "host_s": pytest.approx(100e-9),
                                "self_s": pytest.approx(60e-9)}
    assert t["smplsim.t.a/smplsim.t.b"] == {"count": 2, "host_s": pytest.approx(40e-9),
                                            "self_s": pytest.approx(30e-9)}
    assert t["smplsim.t.a/smplsim.t.b/smplsim.t.c"]["self_s"] == pytest.approx(10e-9)
    # folded into one partial sum at most once per FOLD calls
    assert len(profiler._REC.tensors["t.rows"]) <= profiler.FOLD
    assert profiler.counters() == {"t.rows": 3.0 * (2 * profiler.FOLD + 3),
                                   "t.calls": 2 * profiler.FOLD + 3}
    profiler.clear()
    assert profiler.span_table() == {} and profiler.counters() == {}


def test_ppo_rollout_policy_and_update_spans():
    m = registry.default_humanoid(torch.float32, device="cpu")
    env = HumanoidSpeed(m, SpeedConfig(control_frequency_inv=1), keeps=(24, 16, 8),
                        qp_iters=4, qp_rows=32, qp_tol=1e-4)
    ppo = PPO(env, PPOConfig(num_envs=4, horizon=2, opt_num_epochs=1, num_minibatches=1,
                             policy_widths=(16,), value_widths=(16,)))
    ts = ppo.init(0)
    profiler.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        st, traj = ppo.rollout(ts)
        ppo.update(ts, st, traj)
    t = profiler.span_table()
    assert t["smplsim.learning.rollout"]["count"] == 1
    assert t["smplsim.learning.rollout/smplsim.learning.policy"]["count"] == 2
    assert t["smplsim.learning.rollout/" + ROOT]["count"] == 2
    assert t["smplsim.learning.update"]["count"] == 1
    profiler.clear()


@pytest.mark.parametrize("max_grad_norm,clipped", [(1e-9, 8), (1e9, 0)])
def test_ppo_update_spans_and_counters(max_grad_norm, clipped):
    """2 epochs x 2 minibatches: 4 minibatch spans and one advantages span
    under the update, 8 net steps counted, and every step (or none) whose
    global gradient norm reached max_grad_norm counted as clipped."""
    m = registry.default_humanoid(torch.float32, device="cpu")
    env = HumanoidSpeed(m, SpeedConfig(control_frequency_inv=1), keeps=(24, 16, 8),
                        qp_iters=4, qp_rows=32, qp_tol=1e-4)
    ppo = PPO(env, PPOConfig(num_envs=4, horizon=2, opt_num_epochs=2, num_minibatches=2,
                             policy_widths=(16,), value_widths=(16,),
                             max_grad_norm=max_grad_norm))
    ts = ppo.init(0)
    st, traj = ppo.rollout(ts)
    profiler.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        ppo.update(ts, st, traj)
    t = profiler.span_table()
    up = "smplsim.learning.update"
    assert {p: r["count"] for p, r in t.items()} == {
        up: 1, up + "/smplsim.learning.advantages": 1, up + "/smplsim.learning.minibatch": 4}
    assert profiler.counters() == {"learning.minibatch_steps": 8,
                                   "learning.grad_clipped": clipped}
    profiler.clear()
