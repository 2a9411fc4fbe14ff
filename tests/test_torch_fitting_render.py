"""PyTorch port: motion/fitting.py and render.py against the JAX package.

  * smpl_op_to_op and normalize_screen_coordinates (1e-15);
  * the four losses (proj_2d_loss in both orders, the line,
    body and root losses) and their gradients at one vector with exactly
    zero joint angles, some keypoints marked outliers, against
    jax.value_and_grad (float64, 1e-9); the camera of
    tests/test_fitting.py (R = I, t = (0, -1, 3), f = 1000 px, 1920x1080);
  * fit(steps=5) against the JAX fit(steps=5) (optax.adam under lax.scan):
    the 5 losses and the final vector (float64, 1e-9);
  * render_rollout: a GIF with one frame per `every` steps, an mp4 through
    OpenCV, draw_frame computing its own FK. run_policy(render_path=) is
    held in tests/test_torch_agent.py::test_run_policy.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smplsim_tpu.motion import fitting as jax_fit
from smplsim_tpu.motion import fk as jax_fk
from smplsim_tpu_torch import render
from smplsim_tpu_torch.motion import fitting
from smplsim_tpu_torch.motion.fk import HumanoidBatchFK
from tests._torch_port import models, rel_err

CAM = dict(full_R=np.eye(3), full_t=np.array([0.0, -1.0, 3.0]),
           K=np.array([[1000.0, 0, 960], [0, 1000.0, 540], [0, 0, 1.0]]))


def t64(x):
    return torch.as_tensor(np.array(x, np.float64))


@pytest.fixture(scope="module")
def fitters():
    jm, tm = models()
    jf = jax_fit.PoseFitter(jax_fk.HumanoidBatchFK.from_robot_model(jm, filter_vel=False),
                            jax_fit.CameraParams(**CAM))
    tf = fitting.PoseFitter(HumanoidBatchFK.from_robot_model(tm, filter_vel=False),
                            fitting.CameraParams(**CAM))
    return jm, tm, jf, tf


def _vec(rng, Tn=3, scale=0.1, J=24):
    v = np.zeros((Tn, 1, 3 + J * 3))
    v[..., 2] = 0.95
    v[..., 3:] += rng.normal(size=(Tn, 1, J * 3)) * scale
    return v


def _targets(jf, tf, rng, Tn=3):
    true = _vec(rng, Tn)
    gt2d = np.asarray(jf.proj2d(jf.fk_from_vec(jnp.asarray(true))))
    inl = np.ones(gt2d.shape[:2], bool)
    inl[0, 3] = inl[2, 7] = False
    jf.set_targets(jnp.asarray(gt2d), inl)
    tf.set_targets(t64(gt2d), torch.as_tensor(inl))
    return true


def test_helpers_match_jax():
    x = np.random.RandomState(0).randn(2, 14, 2) * 500 + 700
    assert rel_err(jax_fit.smpl_op_to_op(jnp.asarray(x)), fitting.smpl_op_to_op(t64(x))) < 1e-15
    assert rel_err(jax_fit.normalize_screen_coordinates(jnp.asarray(x), 1920, 1080),
                   fitting.normalize_screen_coordinates(t64(x), 1920, 1080)) == 0.0


def test_losses_and_gradients_match_jax(fitters):
    jm, tm, jf, tf = fitters
    rng = np.random.default_rng(1)
    _targets(jf, tf, rng)
    for a, b in ((jf.gt_2d_norm, tf.gt_2d_norm), (jf.camera_rays, tf.camera_rays),
                 (jf.weighting, tf.weighting)):
        assert rel_err(a, b) < 1e-12
    vec = _vec(rng, scale=0.05)
    vec[:, 0, 3 + 3 * 5: 3 + 3 * 9] = 0.0          # joints at exactly zero angle
    root = np.array([0.1, -0.05, 0.9, 0.02, 0.0, 0.0])
    cases = [("proj_2d_loss", {}, vec), ("proj_2d_loss", {"ord": 1, "normalize": False}, vec),
             ("proj_2d_line_loss", {}, vec), ("proj_2d_body_loss", {}, vec),
             ("proj_2d_root_loss", {}, root)]
    for name, kw, x in cases:
        val_j, g_j = jax.value_and_grad(lambda v: getattr(jf, name)(v, **kw))(jnp.asarray(x))
        xt = t64(x).requires_grad_(True)
        val_t = getattr(tf, name)(xt, **kw)
        (g_t,) = torch.autograd.grad(val_t, xt)
        assert rel_err(val_j, val_t.detach()) < 1e-9, (name, kw)
        assert torch.isfinite(g_t).all()
        assert rel_err(g_j, g_t) < 1e-9, (name, kw)


def test_fit_five_steps_matches_optax(fitters):
    jm, tm, jf, tf = fitters
    rng = np.random.default_rng(2)
    true = _targets(jf, tf, rng)
    init = true + rng.normal(size=true.shape) * 0.05
    vec_j, losses_j = jf.fit(jnp.asarray(init), steps=5, lr=0.01)
    vec_t, losses_t = tf.fit(t64(init), steps=5, lr=0.01)
    assert losses_t.shape == (5,) and not vec_t.requires_grad
    assert rel_err(losses_j, losses_t) < 1e-9
    assert rel_err(vec_j, vec_t) < 1e-9
    assert float(losses_t[-1]) < float(losses_t[0])
    # another loss by name, and a callable
    v2, l2 = tf.fit(t64(init), loss="proj_2d_body_loss", steps=2)
    v3, l3 = tf.fit(t64(init), loss=tf.proj_2d_body_loss, steps=2)
    assert torch.equal(v2, v3) and torch.equal(l2, l3)


def _standing(model, n):
    qpos = np.zeros((n, model.nq), np.float32)
    qpos[:, 2] = 0.94
    qpos[:, 3:7] = [0.5, 0.5, 0.5, 0.5]
    qpos[:, 0] = np.linspace(0.0, 0.3, n)
    return qpos


def test_render_rollout_gif_and_mp4(tmp_path):
    import imageio.v2 as imageio

    tm32 = models(jnp.float32)[1]
    path = str(tmp_path / "roll.gif")
    assert render.render_rollout(tm32, _standing(tm32, 6), path, every=2) == 3
    with open(path, "rb") as f:
        assert f.read(6) in (b"GIF87a", b"GIF89a")
    assert len(imageio.mimread(path)) == 3
    mp4 = str(tmp_path / "roll.mp4")
    assert render.render_rollout(tm32, torch.as_tensor(_standing(tm32, 4)), mp4) == 4
    assert os.path.getsize(mp4) > 1000


def test_draw_frame_computes_its_fk():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    tm32 = models(jnp.float32)[1]
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    render.draw_frame(ax, tm32, _standing(tm32, 1)[0])
    n_geoms = len(ax.lines) + len(ax.collections)
    plt.close(fig)
    assert n_geoms >= tm32.ngeom
