"""The port's example scripts (examples/*_torch.py) and its eval and bake
tools (tools/eval_policy_torch.py, tools/bake_default_humanoid_torch.py) on
the CPU at a tiny size: each script's main in process with the lines its
JAX twin prints; vis_motion's procedural motion against examples/vis_motion.py's
(run eagerly, no jit); the bake round trip against the default humanoid;
the eval metrics against smplsim_tpu.eval.metrics. No JAX env is
compiled."""
import dataclasses
import importlib.util
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import joblib
import numpy as np
import torch

import _torch_port  # noqa: F401  (one torch thread per test process)
from smplsim_tpu.eval import metrics as jax_metrics
from smplsim_tpu.models import registry as jax_registry
from smplsim_tpu.physics import kinematics as jax_kinematics
from smplsim_tpu_torch.agents import AgentHumanoid, RunConfig
from smplsim_tpu_torch.envs.tasks import SpeedConfig
from smplsim_tpu_torch.learning.ppo import PPOConfig
from smplsim_tpu_torch.models import export_mjcf, parse_mjcf_file, registry
from smplsim_tpu_torch.models.registry import ARRAY_FIELDS
from smplsim_tpu_torch.poselib import SkeletonTree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM = r"-?\d+\.\d"


def load(rel: str, name: str):
    """A script of the repo as a module, by path."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lines(capsys) -> list:
    return capsys.readouterr().out.strip().splitlines()


def test_env_humanoid_test(capsys):
    ex = load("examples/env_humanoid_test_torch.py", "env_humanoid_test_torch")
    ex.main(["env=speed", "steps=2", "env.control_frequency_inv=2", "device=cpu"])
    out = lines(capsys)
    assert len(out) == 1 and re.fullmatch(
        rf"HumanoidSpeed: 2 steps, mean reward {NUM}{{4}}, {NUM}+ steps/s, obs finite: True",
        out[0]), out


def test_benchmark(capsys):
    ex = load("examples/benchmark_torch.py", "benchmark_torch")
    ex.main(["batches=2", "steps=1", "device=cpu"])
    rec = [json.loads(x) for x in lines(capsys)]
    assert [set(r) for r in rec] == [{"batch", "reset_s", "step_ms", "sps"}]
    assert rec[0]["batch"] == 2 and rec[0]["step_ms"] > 0 and rec[0]["sps"] > 0


def test_nv_benchmark(capsys):
    ex = load("examples/nv_benchmark_torch.py", "nv_benchmark_torch")
    ex.main(["envs=2", "steps=1", "obs_v=1", "device=cpu"])
    out = lines(capsys)
    assert re.fullmatch(r"reset: \d+\.\d\ds \(.*\)  obs \(2, \d+\)", out[0]), out
    assert re.fullmatch(rf"step avg: {NUM} ms   throughput: [\d,]+ env-steps/s", out[1]), out
    assert re.fullmatch(rf"reward mean {NUM}{{3}}  terminated {NUM}{{3}}", out[2]), out


def test_create_env(capsys, tmp_path):
    ex = load("examples/create_env_torch.py", "create_env_torch")
    gif = str(tmp_path / "move.gif")
    ex.main(["--envs", "2", "--steps", "1", "--gif", gif, "--device", "cpu"])
    out = lines(capsys)
    assert out[0] == "obs size: 289  action size: 69"
    assert re.fullmatch(rf"t=  0 reward mean={NUM}{{3}} done=\d", out[1]), out
    assert out[2] == f"wrote {gif}" and os.path.getsize(gif) > 0


def test_motion_lib_test(capsys):
    ex = load("examples/motion_lib_test_torch.py", "motion_lib_test_torch")
    ex.main(["device=cpu"])
    out = lines(capsys)
    assert out[0] == "loaded 1 motions, 1.97s total, 60 frames"
    assert re.fullmatch(rf"playback 20 frames ok; root height: {NUM}+", out[1]), out
    assert out[2].startswith("sampled blended states: {'root_pos': (4, 3), ")


def test_motion_test(capsys, tmp_path):
    ex = load("examples/motion_test_torch.py", "motion_test_torch")
    gif = str(tmp_path / "clip.gif")
    ex.main(["--frames", "3", "--gif", gif, "--device", "cpu"])
    out = lines(capsys)
    assert re.fullmatch(rf"frame   0: root z={NUM}{{3}}", out[0]), out
    assert out[1:] == ["played 3 frames through HumanoidPlayback", f"wrote {gif}"]


def test_viewer_render(capsys, tmp_path):
    ex = load("examples/viewer_render_torch.py", "viewer_render_torch")
    gif = str(tmp_path / "rollout.gif")
    ex.main([gif, "--steps", "1", "--device", "cpu"])
    assert lines(capsys) == [f"wrote {gif} (1 frames)"] and os.path.getsize(gif) > 0


def test_vis_motion_from_a_clip(capsys, tmp_path):
    """The motion= branch on a 4-frame clip (the procedural default is held
    against the JAX example below)."""
    ex = load("examples/vis_motion_torch.py", "vis_motion_torch")
    rng = np.random.RandomState(0)
    clip = str(tmp_path / "clip.pkl")
    joblib.dump({"c": {"pose_aa": 0.2 * rng.randn(4, 72), "fps": 30,
                       "trans": np.tile([0.0, 0.0, 0.95], (4, 1))}}, clip)
    gif = str(tmp_path / "m.gif")
    ex.main([f"motion={clip}", f"out={gif}", "device=cpu"])
    grid = str(tmp_path / "m_frames.png")
    assert lines(capsys) == [f"wrote {grid}", f"wrote {gif}"]
    assert os.path.getsize(grid) > 0 and os.path.getsize(gif) > 0


def test_render_examples_without_drawing_libraries(capsys, tmp_path, monkeypatch):
    """Where matplotlib and imageio are missing (the H100 machine), the two
    drawing examples do their device work, say what they did not draw and
    write nothing."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    ex = load("examples/viewer_render_torch.py", "viewer_render_torch")
    ex.main([str(tmp_path / "r.gif"), "--steps", "1", "--device", "cpu"])
    vis = load("examples/vis_motion_torch.py", "vis_motion_torch")
    clip = str(tmp_path / "clip.pkl")
    joblib.dump({"c": {"pose_aa": np.zeros((2, 72)), "trans": np.zeros((2, 3)), "fps": 30}},
                clip)
    vis.main([f"motion={clip}", f"out={tmp_path / 'm.gif'}", "device=cpu"])
    out = lines(capsys)
    assert out == ["not drawn (import of imageio halted; None in sys.modules): 1 frames "
                   "stepped on cpu",
                   "not drawn (import of matplotlib halted; None in sys.modules): 2 frames "
                   "computed on cpu"], out
    assert os.listdir(tmp_path) == ["clip.pkl"]


def test_vis_motion_procedural_motion_matches_jax_example():
    ex = load("examples/vis_motion_torch.py", "vis_motion_torch")
    jex = load("examples/vis_motion.py", "vis_motion_jax")
    jm = jax_registry.default_humanoid(dtype=jnp.float64)
    tm = registry.default_humanoid(torch.float64, device="cpu")
    ref = jex.procedural_motion(jex.SkeletonTree.from_robot_model(jm))
    got = ex.procedural_motion(SkeletonTree.from_robot_model(tm), device="cpu")
    assert got.fps == ref.fps == 30 and got.local_rotation.dtype == torch.float64
    want = np.asarray(ref.global_translation)
    assert want.shape == (60, 24, 3)
    np.testing.assert_allclose(got.global_translation.numpy(), want, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.local_rotation.numpy(), np.asarray(ref.local_rotation),
                               rtol=0, atol=1e-12)


def test_bake_round_trip(tmp_path):
    """export_mjcf of the default humanoid -> bake -> load_model: the
    parse of the MJCF at 450 Hz in every field (that the port's parse equals
    the JAX package's on this MJCF is tests/test_torch_builder.py's), and
    the default humanoid at 1e-12 in every field the MJCF carries whole
    (parse_mjcf reads geoms, not <inertial>, and ranges in degrees, in both
    packages)."""
    bake = load("tools/bake_default_humanoid_torch.py", "bake_default_humanoid_torch")
    tm = registry.default_humanoid(torch.float64, device="cpu")
    xml = str(tmp_path / "humanoid.xml")
    with open(xml, "w") as f:
        f.write(export_mjcf(tm))
    out = str(tmp_path / "baked.json.gz")
    bake.main([xml, f"out={out}", "device=cpu"])
    back = registry.load_model(out, torch.float64, device="cpu")
    parsed = parse_mjcf_file(xml, torch.float64, device="cpu")
    for f in dataclasses.fields(back):
        a, b = getattr(back, f.name), getattr(parsed, f.name)
        if f.name == "timestep":          # the MJCF's, rounded in its text
            assert float(a) == 1.0 / 450.0 and abs(float(b) - float(a)) <= 1e-9
        elif isinstance(a, torch.Tensor):
            assert a.shape == b.shape and torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    kept = ("body_pos", "body_quat", "body_ipos", "armature", "dof_damping", "gear", "jkp",
            "jkd", "torque_lim", "pd_action_offset", "geom_pos", "geom_friction", "geom_margin",
            "geom_solref", "geom_solimp", "gravity", "timestep", "qpos0")
    assert set(kept) <= set(ARRAY_FIELDS)
    for f in kept:
        assert (getattr(back, f) - getattr(tm, f)).abs().max() <= 1e-12, f
    assert back.body_names == tm.body_names and back.parents == tm.parents
    assert float(back.timestep) == 1.0 / 450.0


def test_eval_policy_metrics_match_jax(tmp_path):
    """One recorded 3-step rollout of a fresh tiny agent: the tool's
    penetration and skate equal smplsim_tpu.eval.metrics on the JAX FK of
    the same qpos; and on that qpos lowered by 0.9 m (bodies below the
    floor, where both metrics are not zero)."""
    tool = load("tools/eval_policy_torch.py", "eval_policy_torch")
    cfg = RunConfig(task="HumanoidSpeed", env=SpeedConfig(control_frequency_inv=2),
                    learning=PPOConfig(horizon=2, num_envs=4, opt_num_epochs=1,
                                       num_minibatches=2, policy_widths=(32, 32),
                                       value_widths=(32, 32)),
                    output_dir=str(tmp_path), num_epochs=1)
    agent = AgentHumanoid(cfg, device="cpu")
    agent.state = agent.ppo.init(0)
    rec = tool.evaluate(agent, n_episodes=2, horizon=3)
    assert json.load(open(os.path.join(agent.out_dir, "eval_metrics.json"))) == rec
    assert set(rec) == {"eval_return_mean", "eval_return_std", "eval_length_mean",
                        "penetration_mm_mean", "skate_mm_mean", "episodes", "platform",
                        "qp_iters"}
    assert rec["episodes"] == 2 and rec["platform"] == "cpu"
    qpos = joblib.load(os.path.join(agent.out_dir, "eval_rollout.pkl"))["qpos"]
    assert qpos.shape == (2, 3, agent.model.nq)
    jm = jax_registry.default_humanoid(dtype=jnp.float32)
    # one compiled FK of every frame (an eager vmap takes seconds per call)
    fk = jax.jit(jax.vmap(lambda q: jax_kinematics.fk(jm, q).xpos))

    def jax_means(q):
        xpos = fk(jnp.asarray(q.reshape(-1, q.shape[-1]), jnp.float32))
        xpos = xpos.reshape(q.shape[:2] + xpos.shape[1:])            # (E, T, J, 3)
        pen = [float(jax_metrics.compute_penetration(x).mean()) for x in xpos]
        skate = [float(jax_metrics.compute_skate(x).mean()) for x in xpos]
        return np.asarray(pen), np.asarray(skate)

    pen, skate = jax_means(qpos)
    np.testing.assert_allclose([rec["penetration_mm_mean"], rec["skate_mm_mean"]],
                               [pen.mean(), skate.mean()], rtol=1e-5, atol=1e-4)
    low = qpos.copy()
    low[:, :, 2] -= 0.9
    low[:, :, 0] += 0.05 * np.arange(3)[None]          # slide while below the floor
    pen, skate = jax_means(low)
    tp, ts = tool.plausibility(agent.model, torch.as_tensor(low, dtype=torch.float32))
    assert (pen > 10.0).all() and (skate > 10.0).all()
    np.testing.assert_allclose(tp.numpy(), pen, rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), skate, rtol=1e-5)


def test_port_entry_points_import_no_jax():
    """The port's examples and tools import neither JAX nor the JAX
    package (tests/test_torch_model.py holds the package and chip_smoke.py)."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|smplsim_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(REPO, d, n) for d in ("examples", "tools")
             for n in sorted(os.listdir(os.path.join(REPO, d))) if n.endswith("_torch.py")]
    assert len(files) == 13
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path
