"""PyTorch port: eval/metrics.py and motion/converter.py against the JAX
package.

  * the 11 metrics on one (T, J, 3) sequence, and compute_metrics_lite on a
    (B, T, J, 3) batch against jax.vmap of the JAX function (float64,
    1e-9); p_mpjpe is compared by its aligned errors only (the SVD's U and
    V may differ by signs), including reflected and scaled predictions;
  * SMPLConverter from the default humanoid to itself and to the SMPLH
    humanoid the port builds from the synthetic body, every remap and
    table against the JAX converter on the same body names (exact), and
    normalize_smpl_pose with and without random roots (exact).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smplsim_tpu.eval import metrics as jax_metrics
from smplsim_tpu.motion import converter as jax_conv
from smplsim_tpu_torch.body_model import SMPLParser
from smplsim_tpu_torch.eval import metrics
from smplsim_tpu_torch.models.builder import RobotConfig, build_robot_model
from smplsim_tpu_torch.motion import converter
from tests._torch_port import models, rel_err
from tests._torch_synthetic_body import make_synthetic_body

NAMES = ["mpjpe_global", "mpjpe_local", "p_mpjpe", "compute_vel", "compute_accel",
         "compute_error_vel", "compute_error_accel", "compute_penetration",
         "compute_skate", "frobenius_root_error", "compute_metrics_lite"]


def t64(x):
    return torch.as_tensor(np.array(x, np.float64))


def _seq(rng, B=None, T=9, J=24):
    shape = (T, J, 3) if B is None else (B, T, J, 3)
    gt = np.cumsum(rng.randn(*shape) * 0.02, axis=-3) + rng.randn(*shape[:-3], 1, J, 3) * 0.3
    pred = gt + rng.randn(*shape) * 0.01
    gt[..., 2] = np.abs(gt[..., 2]) - 0.05       # some vertices below the floor
    pred[..., 2] = gt[..., 2] + rng.randn(*shape[:-1]) * 0.01
    return pred, gt


def _poses(rng, T):
    """(T,4,4) homogeneous root poses."""
    q = rng.randn(T, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    from smplsim_tpu_torch import transforms as Tr
    R = Tr.quat_to_matrix(t64(q)).numpy()
    out = np.tile(np.eye(4), (T, 1, 1))
    out[:, :3, :3], out[:, :3, 3] = R, rng.randn(T, 3)
    return out


def _args(name, pred, gt, rng):
    if name in ("compute_vel", "compute_accel", "compute_penetration", "compute_skate"):
        return (gt,)
    if name in ("compute_error_vel", "compute_error_accel"):
        return (gt, pred)
    if name == "frobenius_root_error":
        return _poses(rng, pred.shape[-3]), _poses(rng, pred.shape[-3])
    return pred, gt


def _cmp(ref, out):
    if isinstance(ref, dict):
        assert set(ref) == set(out)
        for k in ref:
            if k == "ttr":
                assert (np.asarray(ref[k]) == out[k].numpy()).all()
            else:
                assert rel_err(ref[k], out[k]) < 1e-9, k
    else:
        assert rel_err(ref, out) < 1e-9


@pytest.mark.parametrize("name", NAMES)
def test_metric_matches_jax(name):
    rng = np.random.RandomState(NAMES.index(name))
    pred, gt = _seq(rng)
    args = _args(name, pred, gt, rng)
    ref = getattr(jax_metrics, name)(*[jnp.asarray(a) for a in args])
    _cmp(ref, getattr(metrics, name)(*[t64(a) for a in args]))


def test_p_mpjpe_aligned_errors():
    """A rotated, scaled, shifted copy aligns to ~0; a reflected one does
    not (the det-sign correction), and both agree with JAX."""
    rng = np.random.RandomState(11)
    gt = rng.randn(4, 24, 3)
    q = rng.randn(4)
    from smplsim_tpu_torch import transforms as Tr
    R = Tr.quat_to_matrix(t64(q / np.linalg.norm(q))).numpy()
    moved = 1.7 * gt @ R.T + rng.randn(3)
    refl = moved * np.array([1.0, 1.0, -1.0])
    for pred in (moved, refl, gt + rng.randn(*gt.shape) * 0.05):
        ref = jax_metrics.p_mpjpe(jnp.asarray(pred), jnp.asarray(gt))
        out = metrics.p_mpjpe(t64(pred), t64(gt))
        assert rel_err(ref, out) < 1e-9
    assert metrics.p_mpjpe(t64(moved), t64(gt)).abs().max() < 1e-9
    assert metrics.p_mpjpe(t64(refl), t64(gt)).abs().max() > 1e-2


def test_metrics_lite_batched_matches_vmap():
    rng = np.random.RandomState(12)
    pred, gt = _seq(rng, B=3)
    ref = jax.vmap(jax_metrics.compute_metrics_lite)(jnp.asarray(pred), jnp.asarray(gt))
    _cmp(ref, metrics.compute_metrics_lite(t64(pred), t64(gt)))
    # one sequence still works and equals its row of the batch
    one = metrics.compute_metrics_lite(t64(pred[1]), t64(gt[1]))
    both = metrics.compute_metrics_lite(t64(pred), t64(gt))
    for k in one:
        assert rel_err(both[k][1].double().numpy(), one[k].double()) < 1e-12, k
    vb = metrics.compute_skate(t64(gt))
    assert rel_err(jax.vmap(jax_metrics.compute_skate)(jnp.asarray(gt)), vb) < 1e-9
    X, Y = (np.stack([_poses(rng, 5) for _ in range(3)]) for _ in range(2))
    fr = jax.vmap(jax_metrics.frobenius_root_error)(jnp.asarray(X), jnp.asarray(Y))
    assert rel_err(fr, metrics.frobenius_root_error(t64(X), t64(Y))) < 1e-9


# --------------------------------------------------------------- converter
@dataclasses.dataclass
class _Names:
    """The JAX converter reads body names and sizes only."""

    body_names: tuple

    @property
    def nbody(self):
        return len(self.body_names)

    @property
    def nq(self):
        return 7 + 3 * (self.nbody - 1)

    @property
    def nv(self):
        return 6 + 3 * (self.nbody - 1)


@pytest.fixture(scope="module")
def humanoids():
    jm, tm = models()
    parser = SMPLParser(data=make_synthetic_body(np.random.default_rng(1), "smplh"),
                        model_type="smplh")
    th = build_robot_model(parser, cfg=RobotConfig(model="smplh"), dtype=torch.float64,
                           device="cpu")[0]
    return jm, tm, th


@pytest.mark.parametrize("target", ["smpl", "smplh"])
def test_converter_matches_jax(humanoids, target):
    jm, tm, th = humanoids
    new = tm if target == "smpl" else th
    if target == "smplh":
        assert new.nbody == 52 and new.nq == 7 + 3 * 51
    kind = "smpl" if target == "smpl" else "smplh"
    ours = converter.SMPLConverter(tm, new, smpl_model=kind)
    ref = jax_conv.SMPLConverter(jm, _Names(tuple(new.body_names)), smpl_model=kind)
    assert converter.body_qpos_addr(new) == jax_conv.body_qpos_addr(_Names(tuple(new.body_names)))
    assert converter.body_qvel_addr(tm) == jax_conv.body_qvel_addr(jm)
    rng = np.random.default_rng(2)
    for batch in ((), (4,)):
        qpos, qvel = rng.normal(size=batch + (tm.nq,)), rng.normal(size=batch + (tm.nv,))
        q_new = ours.qpos_smpl_2_new(qpos)
        assert np.array_equal(q_new, ref.qpos_smpl_2_new(qpos))
        assert np.array_equal(ours.qvel_smpl_2_new(qvel), ref.qvel_smpl_2_new(qvel))
        if target == "smpl":
            assert np.array_equal(ours.qpos_new_2_smpl(q_new), qpos)
            assert np.array_equal(ours.qvel_new_2_smpl(ours.qvel_smpl_2_new(qvel)), qvel)
    jpos = rng.normal(size=(3, new.nbody, 3))
    if target == "smpl":
        assert np.array_equal(ours.jpos_new_2_smpl(jpos), ref.jpos_new_2_smpl(jpos))
    else:
        # SMPLH has fingers where SMPL has hands: the subsets back raise in both
        for conv in (ours, ref):
            with pytest.raises((KeyError, ValueError)):
                conv.qpos_new_2_smpl(q_new)
            with pytest.raises((KeyError, ValueError)):
                conv.jpos_new_2_smpl(jpos)
    for fn in ("get_new_qpos_lim", "get_new_qvel_lim", "get_new_body_lim",
               "get_new_diff_weight", "get_new_jkp", "get_new_jkd", "get_new_a_scale",
               "get_new_torque_limit"):
        assert np.array_equal(getattr(ours, fn)(), getattr(ref, fn)()), fn


def test_normalize_smpl_pose_matches_jax():
    rng = np.random.RandomState(3)
    pose = rng.randn(6, 72) * 0.4
    trans = rng.randn(6, 3)
    a = converter.normalize_smpl_pose(pose, trans)
    b = jax_conv.normalize_smpl_pose(pose, trans)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    a = converter.normalize_smpl_pose(pose, trans, random_root=True, rng=np.random.default_rng(4))
    b = jax_conv.normalize_smpl_pose(pose, trans, random_root=True, rng=np.random.default_rng(4))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(converter.vertizalize_smpl_root(pose, [0.1, 0.2, 0.3]),
                          jax_conv.vertizalize_smpl_root(pose, [0.1, 0.2, 0.3]))
