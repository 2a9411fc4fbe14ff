"""PyTorch port: the body model (LBS, SMPLParser, the joint-name tables),
the numpy-only synthetic bodies, and the SMPLX humanoid built from them
through a control step, against the JAX package in float64.

The synthetic bodies of tests/synthetic_body.py stand in for the licensed
SMPL files; tests/_torch_synthetic_body.py is the copy chip_smoke.py uses,
and must make the same arrays bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smplsim_tpu.body_model import SMPLParser as JaxParser
from smplsim_tpu.body_model import smpl as jax_smpl
from smplsim_tpu.body_model.lbs import blend_shapes as jax_blend_shapes
from smplsim_tpu.body_model.lbs import lbs as jax_lbs
from smplsim_tpu.models import builder as jax_builder
from smplsim_tpu.motion import joint_names as jax_names
from smplsim_tpu.physics import engine as jax_engine
from smplsim_tpu_torch.body_model import SMPLParser, lbs, load_smpl_data
from smplsim_tpu_torch.body_model.lbs import blend_shapes
from smplsim_tpu_torch.models import builder
from smplsim_tpu_torch.motion import joint_names
from smplsim_tpu_torch.physics import engine
from tests import _torch_synthetic_body as port_body
from tests import synthetic_body as jax_body
from tests._torch_port import T, rel_err, states

TOL = 1e-9
SEEDS = {"smpl": lambda: np.random.RandomState(0), "smplh": lambda: np.random.default_rng(1),
         "smplx": lambda: np.random.default_rng(1)}


def _data(model_type):
    return port_body.make_synthetic_body(SEEDS[model_type](), model_type)


@pytest.mark.parametrize("model_type", ["smpl", "smplh", "smplx"])
def test_synthetic_body_copy_is_bit_equal(model_type):
    ref = jax_body.make_synthetic_body(SEEDS[model_type](), model_type)
    got = _data(model_type)
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert ref[k].dtype == got[k].dtype and np.array_equal(ref[k], got[k]), k


def test_joint_name_tables_equal():
    for name in ("SMPL_BONE_ORDER_NAMES", "SMPLH_BONE_ORDER_NAMES", "MANO_LEFT_BONE_ORDER_NAMES",
                 "MANO_RIGHT_BONE_ORDER_NAMES", "SMPL_MUJOCO_NAMES", "SMPLH_MUJOCO_NAMES",
                 "SMPLH_MUJOCO_PARENTS"):
        assert getattr(joint_names, name) == getattr(jax_names, name), name
    for t in ("smpl", "smplh", "smplx"):
        assert joint_names.smpl_to_mujoco_perm(t) == jax_names.smpl_to_mujoco_perm(t)
        assert joint_names.mujoco_to_smpl_perm(t) == jax_names.mujoco_to_smpl_perm(t)


def test_lbs_matches_jax():
    d = _data("smpl")
    rng = np.random.RandomState(4)
    betas = rng.randn(3, 10)
    pose = rng.randn(3, 72) * 0.4
    p = JaxParser(data=d)
    args_j = (jnp.asarray(betas), jnp.asarray(pose), p.v_template, p.shapedirs, p.posedirs,
              p.J_regressor, p.parents, p.lbs_weights)
    args_t = tuple(T(a) for a in args_j[:6]) + (p.parents, T(p.lbs_weights))
    for r, v in zip(jax_lbs(*args_j), lbs(*args_t)):
        assert rel_err(r, v) < TOL
    # without the pose blend shapes, and the pieces on their own
    r = jax_lbs(*args_j[:4], None, *args_j[5:])
    v = lbs(*args_t[:4], None, *args_t[5:])
    assert rel_err(r[0], v[0]) < TOL
    assert rel_err(jax_blend_shapes(args_j[0], args_j[3]), blend_shapes(args_t[0], args_t[3])) < TOL


@pytest.mark.parametrize("model_type", ["smpl", "smplh", "smplx"])
def test_parser_matches_jax(model_type):
    d = _data(model_type)
    pj = JaxParser(data=d, model_type=model_type)
    pt = SMPLParser(data=d, model_type=model_type)
    assert pt.parents == pj.parents and pt.joint_names == pj.joint_names
    assert np.array_equal(pt.parents_to_use, pj.parents_to_use)
    assert pt.joint_range.keys() == pj.joint_range.keys()
    for k in pj.joint_range:
        assert np.array_equal(pt.joint_range[k], pj.joint_range[k]), k

    rng = np.random.RandomState(7)
    nj = len(pj.parents)
    betas = rng.randn(2, 10) * 0.8
    poses = [rng.randn(2, nj * 3) * 0.3]
    if model_type == "smplx":
        poses.append(rng.randn(2, 156) * 0.3)      # the SMPLH pose layout
    for pose in poses:
        trans = rng.randn(2, 3)
        ref = pj.get_joints_verts(jnp.asarray(pose), jnp.asarray(betas), jnp.asarray(trans))
        got = pt.get_joints_verts(pose, betas, trans)
        for r, v in zip(ref, got):
            assert v.dtype == torch.float64 and rel_err(r, v) < TOL

    ref = pj.get_offsets(betas=jnp.asarray(betas[:1]))
    got = pt.get_offsets(betas=betas[:1])
    for i in (0, 1, 2):
        assert rel_err(ref[i], got[i]) < TOL
    assert got[3] == ref[3] and got[5] == ref[5] and got[6] == ref[6]
    assert got[4].keys() == ref[4].keys()
    for k in ref[4]:
        assert rel_err(ref[4][k], got[4][k]) < TOL, k
    # the upright zero pose of the builder
    zp = np.zeros((1, nj * 3))
    zp[0, :3] = 1.2091996
    assert rel_err(pj.get_offsets(zero_pose=jnp.asarray(zp))[0], pt.get_offsets(zero_pose=zp)[0]) < TOL


def test_load_smpl_data_npz(tmp_path):
    d = _data("smpl")
    path = str(tmp_path / "smpl_neutral.npz")
    np.savez(path, **d)
    ref, got = jax_smpl.load_smpl_data(path), load_smpl_data(path)
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert np.array_equal(ref[k], got[k]), k
    # the parser finds the file by its naming convention
    p = SMPLParser(model_path=str(tmp_path), gender="neutral")
    assert np.array_equal(p.v_template.numpy(), d["v_template"])
    with pytest.raises(FileNotFoundError):
        SMPLParser()


def test_smplx_control_step_matches_jax():
    """The 52-body humanoid (nv = 159) through one uhc_pd control step of 2
    substeps, B = 2 (one env in the air, one lying on the floor)."""
    d = _data("smplx")
    jm = jax_builder.build_robot_model(JaxParser(data=d, model_type="smplx"),
                                       cfg=jax_builder.RobotConfig(model="smplx"),
                                       dtype=jnp.float64)[0]
    tm = builder.build_robot_model(SMPLParser(data=d, model_type="smplx"),
                                   cfg=builder.RobotConfig(model="smplx"),
                                   dtype=torch.float64, device="cpu")[0]
    assert tm.nbody == 52 and tm.nv == 159
    q, v, a = states(jm, 2, "air", seed=5)
    lying = states(jm, 1, "contact", seed=5)
    q[1], v[1] = lying[0][0], lying[1][0]
    step = jax.jit(jax.vmap(lambda q_, v_, a_: jax_engine.control_step(
        jm, jax_engine.PhysicsState(q_, v_), a_, control_freq_inv=2)))
    st_j, info_j, power_j, cache_j = step(jnp.asarray(q), jnp.asarray(v), jnp.asarray(a))
    st, info, power, cache = engine.control_step(tm, engine.PhysicsState(T(q), T(v)), T(a),
                                                 control_freq_inv=2)
    for r, x in zip((st_j.qpos, st_j.qvel, power_j, *cache_j), (st.qpos, st.qvel, power, *cache)):
        assert rel_err(r, x) < TOL
    np.testing.assert_array_equal(info.nactive_max.numpy(), np.asarray(info_j.nactive_max))
