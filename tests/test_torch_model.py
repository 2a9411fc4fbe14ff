"""PyTorch port: the model crosses from the JAX package intact, the port
carries its own copy of the baked asset, and the port never imports JAX."""
import dataclasses
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from smplsim_tpu import transforms as jax_T
from smplsim_tpu.models import registry as jax_registry
from smplsim_tpu_torch import transforms as torch_T
from smplsim_tpu_torch.models import registry as torch_registry
from smplsim_tpu_torch.models.spec import ARRAY_FIELDS, STATIC_FIELDS
from tests._torch_port import T, TORCH_DTYPE, rel_err

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32], ids=["f64", "f32"])
def test_model_from_dict_matches_every_field(dtype):
    jm = jax_registry.default_humanoid(dtype=dtype)
    tm = torch_registry.model_from_dict(jax_registry.model_to_dict(jm),
                                        dtype=TORCH_DTYPE[dtype], device="cpu")
    assert set(ARRAY_FIELDS) | set(STATIC_FIELDS) == {f.name for f in dataclasses.fields(tm)}
    for f in ARRAY_FIELDS:
        ref = np.asarray(getattr(jm, f))
        val = getattr(tm, f)
        assert val.dtype == TORCH_DTYPE[dtype], f
        assert val.device.type == "cpu"
        np.testing.assert_array_equal(val.numpy(), ref, err_msg=f)
    for f in STATIC_FIELDS:
        assert getattr(tm, f) == getattr(jm, f), f
    assert (tm.nbody, tm.nq, tm.nv, tm.nu, tm.ngeom) == (jm.nbody, jm.nq, jm.nv, jm.nu, jm.ngeom)
    assert (tm.nbody, tm.nq, tm.nv, tm.nu, tm.ngeom) == (24, 76, 75, 69, 24)


def test_default_humanoid_asset_is_a_byte_identical_copy():
    rel = os.path.join("models", "assets", "smpl_humanoid_neutral.json.gz")
    with open(os.path.join(ROOT, "smplsim_tpu", rel), "rb") as f:
        jax_bytes = f.read()
    with open(os.path.join(ROOT, "smplsim_tpu_torch", rel), "rb") as f:
        torch_bytes = f.read()
    assert jax_bytes == torch_bytes
    tm = torch_registry.default_humanoid(device="cpu")
    jm = jax_registry.default_humanoid()
    np.testing.assert_array_equal(tm.qpos0.numpy(), np.asarray(jm.qpos0))


def test_cuda_entry_point_without_a_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        torch_registry.default_humanoid()


def test_transforms_match():
    rng = np.random.RandomState(0)
    q = rng.randn(16, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q2 = rng.randn(16, 4)
    v = rng.randn(16, 3)
    e = rng.randn(16, 3)
    pairs = [
        (jax_T.quat_to_matrix(q), torch_T.quat_to_matrix(T(q))),
        (jax_T.quat_rotate(q, v), torch_T.quat_rotate(T(q), T(v))),
        (jax_T.quat_mul(q, q2), torch_T.quat_mul(T(q), T(q2))),
        (jax_T.quat_to_tan_norm(q), torch_T.quat_to_tan_norm(T(q))),
        (jax_T.remove_base_rot(q), torch_T.remove_base_rot(T(q))),
        (jax_T.calc_heading_quat_inv(q), torch_T.calc_heading_quat_inv(T(q))),
        (jax_T.euler_xyz_to_quat(e), torch_T.euler_xyz_to_quat(T(e))),
        (jax_T.quat_integrate(q, v, 0.01), torch_T.quat_integrate(T(q), T(v), 0.01)),
        (jax_T.exp_map_to_quat(np.zeros((2, 3))), torch_T.exp_map_to_quat(T(np.zeros((2, 3))))),
    ]
    for i, (ref, val) in enumerate(pairs):
        assert rel_err(ref, val) < 1e-12, i


_IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|smplsim_tpu)(\.|\s|$)", re.M)


def test_port_sources_import_no_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "smplsim_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            src = f.read()
        assert not _IMPORT_RE.search(src), path


def test_control_step_runs_without_importing_jax():
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from smplsim_tpu_torch.models import registry\n"
        "from smplsim_tpu_torch.physics import engine\n"
        "m = registry.default_humanoid(torch.float64, device='cpu')\n"
        "q = m.qpos0[None].clone(); q[:, 2] = 0.95\n"
        "st = engine.PhysicsState(q, torch.zeros(1, m.nv, dtype=torch.float64))\n"
        "st2, info, power, cache = engine.control_step(m, st, torch.zeros(1, m.nu, "
        "dtype=torch.float64), control_freq_inv=1)\n"
        "assert torch.isfinite(st2.qpos).all()\n"
        "st3, info, power, cache = engine.control_step(m, st, torch.full((1, m.nu), 0.01, "
        "dtype=torch.float64), control_freq_inv=1, control_mode='torque', power_scale=10.0)\n"
        "assert torch.isfinite(st3.qpos).all() and cache is None\n"
        # a forward-mode Jacobian through the uhc_pd step and one iLQR
        # iteration over it (the reference loop and the derivative rules)
        "from smplsim_tpu_torch.control import ILQRConfig, ilqr_plan, jacobians\n"
        "def dyn(x, u):\n"
        "    s = engine.control_step(m, engine.PhysicsState(x[:, :m.nq], x[:, m.nq:]), u, "
        "control_freq_inv=1)[0]\n"
        "    return torch.cat([s.qpos, s.qvel], 1)\n"
        "x0 = torch.cat([st.qpos, st.qvel], 1)\n"
        "u0 = torch.zeros(1, m.nu, dtype=torch.float64)\n"
        "A, B = jacobians(dyn, x0, u0)\n"
        "assert A.shape == (1, 151, 151) and B.shape == (1, 151, 69)\n"
        "assert torch.isfinite(A).all() and torch.isfinite(B).all() and B.abs().max() > 0\n"
        "xs, us, J = ilqr_plan(dyn, lambda x, u, t: (x[:, m.nq] - 1.0) ** 2, "
        "lambda x: (x[:, m.nq] - 1.0) ** 2, x0[0], u0, ILQRConfig(iterations=1))\n"
        "assert torch.isfinite(J) and xs.shape == (2, 151)\n"
        # the getup and reach envs (Fall init, observation v2) and both
        # perturbation hooks
        "from smplsim_tpu_torch.envs import GetupConfig, HumanoidGetup, HumanoidReach, "
        "ReachConfig\n"
        "g = torch.Generator().manual_seed(0)\n"
        "z = torch.zeros(1, m.nu, dtype=torch.float64)\n"
        "env = HumanoidGetup(m, GetupConfig(control_frequency_inv=1))\n"
        "s = env.step_autoreset(env.reset(1, g), z)\n"
        "env = HumanoidReach(m, ReachConfig(self_obs_v=2, control_frequency_inv=1))\n"
        "s2 = env.step(env.reset(1, g), z)\n"
        "assert torch.isfinite(s.obs).all() and torch.isfinite(s2.obs).all()\n"
        "pp = torch.tensor([[[0.3, -0.2, 0.9]]], dtype=torch.float64)\n"
        "one = torch.ones(1, 1, dtype=torch.float64)\n"
        "out = engine.control_step(m, st, z, control_freq_inv=1, ext_force=torch.ones(1, "
        "m.nbody, 3, dtype=torch.float64), proj=(pp, -pp, 0.1 * one, one))\n"
        "assert len(out) == 5 and torch.isfinite(out[4][0]).all()\n"
        # the trainer (one PPO iteration, a checkpoint) and a CEM plan
        "import tempfile\n"
        "from smplsim_tpu_torch import run\n"
        "from smplsim_tpu_torch.control import CEMConfig, CEMPlanner\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    ts = run.main(['output_dir=' + d, 'num_epochs=1', 'env.control_frequency_inv=1', "
        "'learning.num_envs=2', 'learning.horizon=1', 'learning.opt_num_epochs=1', "
        "'learning.num_minibatches=1', 'learning.policy_widths=8', "
        "'learning.value_widths=8'], device='cpu')\n"
        "assert ts.epoch == 1\n"
        "cem = CEMPlanner(env, CEMConfig(horizon=1, num_samples=2, num_elites=1, iterations=1))\n"
        "assert torch.isfinite(cem.plan(env.reset(1, g), generator=g)[2])\n"
        # the motion library and its FK, playback, the metrics, the
        # converter, poselib, the fitter and the renderer's FK
        "import numpy as np, sys as _s\n"
        "_s.path.insert(0, 'tests')\n"
        "from _torch_synthetic_motion import motion_set\n"
        "from smplsim_tpu_torch.motion import (HumanoidBatchFK, MotionLib, MotionLibConfig, "
        "PoseFitter, CameraParams, SMPLConverter, normalize_smpl_pose)\n"
        "from smplsim_tpu_torch.envs import HumanoidPlayback\n"
        "from smplsim_tpu_torch.eval import compute_metrics_lite\n"
        "from smplsim_tpu_torch.poselib import SkeletonState, SkeletonTree, visualization\n"
        "from smplsim_tpu_torch import render\n"
        "fk = HumanoidBatchFK.from_robot_model(m)\n"
        "lib = MotionLib(fk, MotionLibConfig(), motion_dict=motion_set(2, min_len=5, "
        "max_len=6)).load_motions()\n"
        "st_m = lib.get_motion_state(torch.tensor([0, 1]), torch.tensor([0.05, 0.1]))\n"
        "pb = HumanoidPlayback(m, lib)\n"
        "s3 = pb.step_autoreset(pb.reset(1, g), z)\n"
        "r = compute_metrics_lite(lib.gts[None, :4].double(), lib.gts[None, 1:5].double())\n"
        "assert torch.isfinite(s3.obs).all() and r['mpjpe_g'].shape == (1, 4, 24)\n"
        "assert SMPLConverter(m, m).get_new_jkp().shape == (69,)\n"
        "tree = SkeletonTree.from_robot_model(m)\n"
        "assert SkeletonState(tree, lib.grs[:2], lib.gts[:2, 0]).global_translation.shape "
        "== (2, 24, 3)\n"
        "cam = CameraParams(np.eye(3), np.array([0.0, -1.0, 3.0]), np.array([[1000.0, 0, "
        "960], [0, 1000.0, 540], [0, 0, 1.0]]))\n"
        "fit = PoseFitter(fk, cam)\n"
        "v = torch.zeros(2, 1, 75, dtype=torch.float64); v[..., 2] = 0.95\n"
        "fit.set_targets(fit.proj2d(fit.fk_from_vec(v)))\n"
        "assert torch.isfinite(fit.fit(v, steps=2)[1]).all()\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'optax', 'orbax', 'smplsim_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
