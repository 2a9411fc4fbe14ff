"""PyTorch port: utils/ (tolerance, filters, profiler), kinematics.body_twists
and the dm-control locomotion task (envs/legacy.py's HumanoidMove) against
the JAX package.

  * tolerance for every sigmoid, margin 0 and its ValueErrors (1e-12);
  * body_twists against jax.vmap(kinematics.body_twists) (float64, 1e-12);
  * HumanoidMove's reward against the JAX env's on the same states, for
    move_speed 0 and 1 (float64, 1e-12), and one step_autoreset at 180 Hz
    with 6 substeps;
  * the One-Euro filter and RunningMeanStd (live, frozen, partially frozen,
    unfrozen) against utils/filters.py (float64, 1e-12);
  * the profiler's span and trace (a Chrome trace file).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smplsim_tpu.envs import legacy as jax_legacy
from smplsim_tpu.physics import engine as jax_engine
from smplsim_tpu.physics import kinematics as jax_kin
from smplsim_tpu.utils import filters as jax_filters
from smplsim_tpu.utils.tolerance import tolerance as jax_tolerance
from smplsim_tpu_torch.envs import HumanoidMove, MoveConfig
from smplsim_tpu_torch.physics import engine, kinematics
from smplsim_tpu_torch.utils import filters, profiler
from smplsim_tpu_torch.utils.tolerance import tolerance
from tests._torch_port import T, models, rel_err, states

SIGMOIDS = ["gaussian", "hyperbolic", "long_tail", "reciprocal", "cosine", "linear",
            "quadratic", "tanh_squared"]


@pytest.mark.parametrize("sigmoid", SIGMOIDS)
def test_tolerance_matches_jax(sigmoid):
    x = np.random.RandomState(0).randn(200) * 2
    for kw in (dict(bounds=(0.5, np.inf), margin=0.25), dict(bounds=(-0.3, 0.4), margin=2.0),
               dict(margin=1.0, value_at_margin=0.3)):
        ref = jax_tolerance(jnp.asarray(x), sigmoid=sigmoid, **kw)
        got = tolerance(T(x), sigmoid=sigmoid, **kw)
        assert got.dtype == torch.float64 and rel_err(ref, got) < 1e-12, kw
    if sigmoid in ("cosine", "linear", "quadratic"):
        ref = jax_tolerance(jnp.asarray(x), margin=1.5, sigmoid=sigmoid, value_at_margin=0.0)
        assert rel_err(ref, tolerance(T(x), margin=1.5, sigmoid=sigmoid, value_at_margin=0.0)) \
            < 1e-12
    else:
        with pytest.raises(ValueError, match=r"\(0,1\)"):
            tolerance(T(x), margin=1.0, sigmoid=sigmoid, value_at_margin=0.0)
    with pytest.raises(ValueError, match="value_at_1"):
        tolerance(T(x), margin=1.0, sigmoid=sigmoid, value_at_margin=1.0)


def test_tolerance_bounds_and_errors():
    x = np.linspace(-2, 2, 41)
    np.testing.assert_array_equal(tolerance(T(x), bounds=(-0.5, 0.5)).numpy(),
                                  np.asarray(jax_tolerance(jnp.asarray(x), bounds=(-0.5, 0.5))))
    with pytest.raises(ValueError, match="lower bound"):
        tolerance(T(x), bounds=(1.0, 0.0))
    with pytest.raises(ValueError, match="margin"):
        tolerance(T(x), margin=-1.0)
    with pytest.raises(ValueError, match="unknown sigmoid"):
        tolerance(T(x), margin=1.0, sigmoid="nope")


def test_body_twists_match_jax():
    jm, tm = models()
    qpos, qvel, _ = states(jm, 3, "tangled", seed=2)
    got = kinematics.body_twists(tm, kinematics.fk(tm, T(qpos)), T(qvel))
    ref = jax.vmap(lambda q, v: jax_kin.body_twists(jm, jax_kin.fk(jm, q), v))(
        jnp.asarray(qpos), jnp.asarray(qvel))
    assert got.shape == (3, tm.nbody, 6) and rel_err(ref, got) < 1e-12
    lin, ang = kinematics.body_velocities(tm, kinematics.fk(tm, T(qpos)), T(qvel))
    assert torch.equal(ang, got[..., :3])


@pytest.mark.parametrize("speed", [0.0, 1.0])
def test_move_reward_matches_jax(speed):
    jm, tm = models()
    cfg = dict(move_speed=speed, sim_timestep_inv=450, control_frequency_inv=15)
    env_j = jax_legacy.HumanoidMove(jm, jax_legacy.MoveConfig(**cfg))
    env_t = HumanoidMove(tm, MoveConfig(**cfg))
    qpos, qvel, act = states(jm, 4, "air", seed=3)
    qpos[:, 2] += np.asarray([0.0, 0.4, -0.3, 0.2])       # standing terms in and out
    qvel[:, :2] *= 10.0                                   # the CoM velocity terms
    ref = jax.vmap(lambda q, v, a: env_j.reward(
        None, jax_engine.PhysicsState(q, v), jax_kin.fk(jm, q), a))(
        jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(act))
    got = env_t.reward(None, engine.PhysicsState(T(qpos), T(qvel)),
                       kinematics.fk(tm, T(qpos)), T(act))
    assert rel_err(ref, got) < 1e-12
    assert float(got.max() - got.min()) > 1e-3


def test_move_steps_at_180_hz():
    _, tm = models()
    m180 = dataclasses.replace(tm, timestep=torch.tensor(1.0 / 180.0, dtype=torch.float64))
    env = HumanoidMove(m180)
    assert env.config.control_frequency_inv == 6 and env.config.dt == pytest.approx(1 / 30)
    with pytest.raises(ValueError, match="timestep"):
        HumanoidMove(tm)
    s = env.reset(2, torch.Generator().manual_seed(0))
    s = env.step_autoreset(s, torch.full((2, tm.nu), 0.1, dtype=torch.float64))
    assert torch.isfinite(s.reward).all() and ((s.reward >= 0) & (s.reward <= 1)).all()


def test_one_euro_matches_jax():
    rng = np.random.default_rng(0)
    ts = np.arange(40) / 30.0
    xs = np.stack([np.sin(ts * 3), np.cos(ts * 2)], 1) + rng.normal(size=(40, 2)) * 0.1
    for kw in (dict(), dict(min_cutoff=0.5, beta=0.05, d_cutoff=2.0)):
        ref = jax_filters.one_euro_filter(jnp.asarray(ts), jnp.asarray(xs), **kw)
        got = filters.one_euro_filter(T(ts), T(xs), **kw)
        assert got.shape == (40, 2) and rel_err(ref, got) < 1e-12


def test_running_mean_std_modes_match_jax():
    rng = np.random.default_rng(1)
    batches = [rng.normal(2.0, 3.0, (64, 3)), rng.normal(50.0, 1.0, (32, 3)),
               rng.normal(-1.0, 0.5, (16, 3))]
    sj, st = jax_filters.rms_init((3,), jnp.float64), filters.rms_init((3,), torch.float64)
    x = rng.normal(size=(5, 3))
    steps = [("update", 0), ("freeze", None), ("update", 1), ("unfreeze", None), ("update", 1),
             ("freeze_partial", None), ("update", 2), ("unfreeze", None), ("update", 0)]
    for op, i in steps:
        if op == "update":
            sj = jax_filters.rms_update(sj, jnp.asarray(batches[i]))
            st = filters.rms_update(st, T(batches[i]))
        else:
            sj = getattr(jax_filters, f"rms_{op}")(sj)
            st = getattr(filters, f"rms_{op}")(st)
        for a, b in ((sj.mean, st.mean), (sj.var, st.var), (sj.count, st.count)):
            assert rel_err(a, b) < 1e-12, op
        assert int(sj.mode) == st.mode
        assert rel_err(jax_filters.rms_normalize(sj, jnp.asarray(x)),
                       filters.rms_normalize(st, T(x))) < 1e-12
        assert rel_err(jax_filters.rms_denormalize(sj, jnp.asarray(x)),
                       filters.rms_denormalize(st, T(x))) < 1e-12


def test_profiler(tmp_path):
    """span as a context and as a decorator: nothing recorded outside a
    recording; inside trace(logdir) both nest in the span table and appear
    in the Chrome trace beside the operations."""
    @profiler.span("smplsim.test.product")
    def product(x):
        return (x @ x).sum()

    profiler.clear()
    with profiler.span("smplsim.test.region"):
        product(torch.ones(4, 4))
    assert profiler.span_table() == {}
    with profiler.trace(str(tmp_path / "tr")):
        with profiler.span("smplsim.test.region"):
            assert product(torch.ones(16, 16)) == 16 ** 3
    table = profiler.span_table()
    assert set(table) == {"smplsim.test.region", "smplsim.test.region/smplsim.test.product"}
    inner = table["smplsim.test.region/smplsim.test.product"]
    assert inner["count"] == 1 and 0.0 < inner["host_s"] <= table["smplsim.test.region"]["host_s"]
    path = tmp_path / "tr" / "trace.json"
    assert path.exists()
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"smplsim.test.region", "smplsim.test.product", "aten::mm"} <= names
    profiler.clear()
