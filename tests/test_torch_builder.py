"""PyTorch port: the β -> humanoid builder, MJCF in and out, model
serialization, stack_models, the mesh asset writer and the design space,
against the JAX package in float64.

Bodies come from the synthetic stand-ins (tests/_torch_synthetic_body.py).
The capsule radii follow the hull volumes, and the native hull and scipy's
round differently, so both packages must build with their native library.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad as fwAD

from smplsim_tpu import native as jax_native
from smplsim_tpu.body_model import SMPLParser as JaxParser
from smplsim_tpu.models import builder as jax_builder
from smplsim_tpu.models import mesh_builder as jax_mesh
from smplsim_tpu.models import mjcf as jax_mjcf
from smplsim_tpu.models import registry as jax_registry
from smplsim_tpu.models.design import DesignSpace as JaxDesignSpace
from smplsim_tpu.physics import engine as jax_engine
from smplsim_tpu_torch import native
from smplsim_tpu_torch.body_model import SMPLParser
from smplsim_tpu_torch.models import (builder, export_mjcf, mesh_builder, model_from_dict,
                                      model_to_dict, parse_mjcf, registry, stack_models,
                                      tile_model)
from smplsim_tpu_torch.models.design import DesignSpace
from smplsim_tpu_torch.models.spec import ARRAY_FIELDS, STATIC_FIELDS
from smplsim_tpu_torch.physics import engine
from tests._torch_port import T, models, rel_err
from tests._torch_synthetic_body import make_synthetic_body

TOL = 1e-9
SEEDS = {"smpl": lambda: np.random.RandomState(0), "smplh": lambda: np.random.default_rng(1),
         "smplx": lambda: np.random.default_rng(1)}
_BETAS = np.random.RandomState(3).randn(3, 1, 10) * 0.8
CASES = {
    "beta0": ("smpl", None, {}),
    "beta1": ("smpl", _BETAS[0], {}),
    "beta2": ("smpl", _BETAS[1], {}),
    "beta3": ("smpl", _BETAS[2], {}),
    "upright": ("smpl", None, {"upright_start": True}),
    "smplh": ("smplh", None, {"model": "smplh"}),
    "smplx": ("smplx", None, {"model": "smplx"}),
}


def _parsers(model_type):
    d = make_synthetic_body(SEEDS[model_type](), model_type)
    return JaxParser(data=d, model_type=model_type), SMPLParser(data=d, model_type=model_type)


def _build(case):
    model_type, betas, cfg = CASES[case]
    pj, pt = _parsers(model_type)
    ref = jax_builder.build_robot_model(
        pj, betas=None if betas is None else jnp.asarray(betas),
        cfg=jax_builder.RobotConfig(**cfg), dtype=jnp.float64)
    got = builder.build_robot_model(pt, betas=betas, cfg=builder.RobotConfig(**cfg),
                                    dtype=torch.float64, device="cpu")
    return ref, got


def assert_models_close(jm, tm, tol=TOL):
    for f in STATIC_FIELDS:
        assert getattr(tm, f) == getattr(jm, f), f
    for f in ARRAY_FIELDS:
        assert rel_err(getattr(jm, f), getattr(tm, f)) < tol, (f, rel_err(getattr(jm, f),
                                                                         getattr(tm, f)))


def test_native_available_and_equal():
    assert native.available() and jax_native.available()
    pts = np.random.RandomState(0).randn(200, 3)
    fj, vj = jax_native.convex_hull(pts)
    ft, vt = native.convex_hull(pts)
    assert np.array_equal(fj, ft) and vj == vt
    assert native.hull_volume(pts) == vt


@pytest.mark.parametrize("case", list(CASES))
def test_build_robot_model_matches_jax(case):
    (jm, jxml, jh), (tm, txml, th) = _build(case)
    assert txml == jxml and th == jh
    assert tm.dtype == torch.float64 and tm.device.type == "cpu" and not tm.stacked
    assert_models_close(jm, tm)
    if CASES[case][0] != "smpl":
        assert tm.nbody == 52 and tm.nv == 159


def test_float32_build_matches_jax():
    pj, pt = _parsers("smpl")
    jm = jax_builder.build_robot_model(pj, dtype=jnp.float32)[0]
    tm = builder.build_robot_model(pt, dtype=torch.float32, device="cpu")[0]
    assert tm.dtype == torch.float32
    assert_models_close(jm, tm, 1e-6)


def test_mjcf_export_and_round_trip():
    jm, tm = models()
    xml = export_mjcf(tm)
    assert xml == jax_mjcf.export_mjcf(jm)
    # parse_mjcf reads geoms, not <inertial>, and reads ranges in degrees
    # whatever the compiler's angle, in both packages: the round trip keeps
    # the kinematics and the geoms, and equals the JAX package's
    back = parse_mjcf(xml, dtype=torch.float64, device="cpu")
    assert_models_close(jax_mjcf.parse_mjcf(xml, dtype=jnp.float64), back)
    assert back.body_names == tm.body_names and back.parents == tm.parents
    for f in ("body_pos", "body_quat", "geom_size", "geom_pos", "gear"):
        assert rel_err(getattr(tm, f).numpy(), getattr(back, f)) < 1e-8, f
    # a built humanoid's own MJCF parses to the JAX package's model
    (_, jxml, _), (built, txml, _) = _build("beta1")
    assert_models_close(jax_mjcf.parse_mjcf(jxml, dtype=jnp.float64),
                        parse_mjcf(txml, dtype=torch.float64, device="cpu"))
    assert export_mjcf(built) == jax_mjcf.export_mjcf(
        jax_registry.model_from_dict(model_to_dict(built), dtype=jnp.float64))


def test_model_dict_across_packages(tmp_path):
    jm, tm = models()
    d = model_to_dict(tm)
    assert d == jax_registry.model_to_dict(jm)
    assert_models_close(jm, model_from_dict(d, torch.float64, device="cpu"))
    path = str(tmp_path / "m.json.gz")
    registry.save_model(tm, path)
    assert_models_close(jax_registry.load_model(path, dtype=jnp.float64),
                        registry.load_model(path, torch.float64, device="cpu"))


def test_stack_and_tile_models():
    _, tm = models()
    (_, _, _), (b1, _, _) = _build("beta1")
    (_, _, _), (b2, _, _) = _build("beta2")
    s = stack_models([b1, b2])
    assert s.stacked and s.num_stacked == 2 and not b1.stacked and b1.num_stacked is None
    for f in ARRAY_FIELDS:
        assert getattr(s, f).shape == (2,) + getattr(b1, f).shape, f
    assert s.parents == b1.parents and s.nbody == 24 and s.nv == 75
    assert torch.equal(s.body_mass[1], b2.body_mass)
    t = tile_model(s, 5)
    assert t.num_stacked == 5 and torch.equal(t.body_pos[4], b1.body_pos)
    assert torch.equal(t.body_pos[3], b2.body_pos)
    import dataclasses
    with pytest.raises(ValueError, match="static field 'humanoid_type'"):
        stack_models([b1, dataclasses.replace(b2, humanoid_type="smplx")])
    with pytest.raises(ValueError, match="static field"):
        stack_models([tm, _build("smplh")[1][0]])
    with pytest.raises(ValueError):
        tile_model(b1, 4)


def test_mesh_builder_matches_jax(tmp_path):
    pj, pt = _parsers("smpl")
    xml_j, hull_j = jax_mesh.build_mesh_robot(pj, geom_dir=str(tmp_path / "jax"))
    xml_t, hull_t = mesh_builder.build_mesh_robot(pt, geom_dir=str(tmp_path / "torch"))
    assert xml_t == xml_j and hull_t.keys() == hull_j.keys()
    for name in hull_j:
        for k in ("faces", "dec_verts", "dec_faces"):
            assert np.array_equal(hull_j[name][k], hull_t[name][k]), (name, k)
        assert hull_j[name]["volume"] == hull_t[name]["volume"]
        with open(hull_j[name]["stl"], "rb") as a, open(hull_t[name]["stl"], "rb") as b:
            assert a.read() == b.read(), name
        assert os.path.dirname(hull_t[name]["stl"]) == str(tmp_path / "torch")


def test_design_space_matches_jax():
    jm, tm = models()
    js, ts = JaxDesignSpace(jm), DesignSpace(tm)
    assert ts.dim == js.dim and ts.names() == js.names()
    vec = np.random.RandomState(0).uniform(-0.9, 0.9, js.dim)
    mj = js.unflatten(jm, jnp.asarray(vec))
    mt = ts.unflatten(tm, T(vec))
    assert_models_close(mj, mt)
    assert rel_err(js.flatten(mj), ts.flatten(mt)) < TOL
    # a batch of vectors is a stacked model, row by row the shared ones
    vecs = np.random.RandomState(1).uniform(-0.5, 0.5, (3, js.dim))
    stacked = ts.unflatten(None, T(vecs))
    assert stacked.stacked and stacked.num_stacked == 3
    for i in range(3):
        mj = js.unflatten(None, jnp.asarray(vecs[i]))
        for f in ARRAY_FIELDS:
            assert rel_err(getattr(mj, f), getattr(stacked, f)[i]) < TOL, f
    assert rel_err(np.stack([js.flatten(js.unflatten(None, jnp.asarray(v))) for v in vecs]),
                   ts.flatten(stacked)) < TOL


def test_design_tangent_through_a_control_step_matches_jacfwd():
    """d(sum qvel^2 after one substep)/d(design vector) along one direction,
    against the JAX package's jax.jacfwd (its test_design.py loss), over the
    gains and the geom sizes (the contacts)."""
    jm, tm = models()
    spec = {"gains": {"jkp": {"lb": 0.5, "ub": 2.0, "log": True}},
            "geom": {"size": {"lb": 0.7, "ub": 1.43, "log": True}}}
    js, ts = JaxDesignSpace(jm, spec), DesignSpace(tm, spec)

    def loss(vec):
        m = js.unflatten(jm, vec)
        st = jax_engine.init_state(m)
        st = st.replace(qpos=st.qpos.at[2].set(1.0))
        st2 = jax_engine.control_step(m, st, jnp.full(m.nu, 0.1, jnp.float64),
                                      control_freq_inv=1)[0]
        return jnp.sum(st2.qvel ** 2)

    rng = np.random.RandomState(0)
    v0 = rng.uniform(-0.3, 0.3, js.dim)
    d = rng.randn(js.dim)
    jac = np.asarray(jax.jacfwd(loss)(jnp.asarray(v0)))
    with fwAD.dual_level():
        m = ts.unflatten(None, fwAD.make_dual(T(v0), T(d)))
        st = engine.init_state(m, 1)
        st.qpos[:, 2] = 1.0
        st2 = engine.control_step(m, st, torch.full((1, m.nu), 0.1, dtype=torch.float64),
                                  control_freq_inv=1)[0]
        out = fwAD.unpack_dual((st2.qvel ** 2).sum())
    assert rel_err(loss(jnp.asarray(v0)), out.primal) < TOL
    assert rel_err(jac @ d, out.tangent) < TOL
    assert abs(float(out.tangent)) > 0
