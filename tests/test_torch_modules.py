"""PyTorch port, module by module, against the JAX package's batched
(vmapped) functions in float64: kinematics, dynamics, constraint rows and
self-contacts at the 1e-9 relative bar of tests/test_substep_lanes.py."""
import jax
import numpy as np
import pytest
import torch

from smplsim_tpu.physics import collision_pairs as jax_cp
from smplsim_tpu.physics import constraints as jax_con
from smplsim_tpu.physics import dynamics as jax_dyn
from smplsim_tpu.physics import kinematics as jax_kin
from smplsim_tpu_torch.physics import collision_pairs, constraints, dynamics, kinematics
from tests._torch_port import T, models, rel_err, states

TOL = 1e-9
B = 6
KINDS = ["air", "contact", "tangled"]


@pytest.fixture(scope="module")
def pair():
    return models()


@pytest.fixture(scope="module")
def jax_fns(pair):
    jm, _ = pair

    def one(q, v):
        kin = jax_kin.fk(jm, q)
        return (kin, jax_kin.body_quats(jm, q), jax_dyn.mass_matrix(jm, kin),
                jax_dyn.bias_forces(jm, kin, v), jax_con.make_efc(jm, kin, q, v))

    return jax.jit(jax.vmap(one))


@pytest.mark.parametrize("kind", KINDS)
def test_fk_dynamics_efc_match(pair, jax_fns, kind):
    jm, tm = pair
    qpos, qvel, _ = states(jm, B, kind, seed=1)
    kin_j, quats_j, M_j, C_j, efc_j = jax_fns(qpos, qvel)
    q, v = T(qpos), T(qvel)
    kin = kinematics.fk(tm, q)
    for name in ("xpos", "xmat", "S", "com", "inertia_w"):
        assert rel_err(getattr(kin_j, name), getattr(kin, name)) < TOL, name
    assert rel_err(quats_j, kinematics.body_quats(tm, q)) < TOL
    assert rel_err(M_j, dynamics.mass_matrix(tm, kin)) < TOL
    assert rel_err(C_j, dynamics.bias_forces(tm, kin, v)) < TOL

    efc = constraints.make_efc(tm, kin, q, v)
    np.testing.assert_array_equal(efc.active.numpy(), np.asarray(efc_j.active))
    np.testing.assert_array_equal(efc.geom_floor_contact.numpy(),
                                  np.asarray(efc_j.geom_floor_contact))
    act4 = np.asarray(efc_j.active)[:, constraints.MAX_LIMITS:].reshape(B, -1, 4)[..., 0]
    for name in ("body1", "body2"):
        np.testing.assert_array_equal(
            np.where(act4, getattr(efc, name).numpy(), 0),
            np.where(act4, np.asarray(getattr(efc_j, name)), 0), err_msg=name)
    for name in ("l_J", "l_aref", "l_R", "W6", "aref", "R"):
        assert rel_err(getattr(efc_j, name), getattr(efc, name)) < TOL, name
    if kind == "contact":
        assert act4.sum() > 0


def _self_contacts_jax(jm):
    """The per-env reference (collision_pairs), env by env. Under vmap the
    JAX package reroutes to its lanes twin (collision_lanes), whose
    capsule-box routine departs from the reference on deep penetrations."""
    one = jax.jit(lambda q: jax_cp.self_contacts(jm, jax_kin.fk(jm, q)))

    def run(qpos):
        outs = [one(q) for q in qpos]
        return jax_cp.SelfContacts(*(np.stack([np.asarray(o[i]) for o in outs])
                                     for i in range(len(outs[0]))))

    return run


def _check_self_contacts(sc_j, sc):
    act = np.asarray(sc_j.active)
    np.testing.assert_array_equal(sc.active.numpy(), act)
    # the selected sets, then (float64) their order slot by slot
    for b in range(act.shape[0]):
        key = lambda b1, b2, d: sorted(zip(b1, b2, np.round(d, 9)))
        ref = key(*(np.asarray(x)[b][act[b]] for x in (sc_j.body1, sc_j.body2, sc_j.dist)))
        val = key(*(x.numpy()[b][act[b]] for x in (sc.body1, sc.body2, sc.dist)))
        assert ref == val, b
    for name in ("body1", "body2"):
        np.testing.assert_array_equal(np.where(act, getattr(sc, name).numpy(), 0),
                                      np.where(act, np.asarray(getattr(sc_j, name)), 0))
    for name in ("dist", "pos", "normal", "friction", "margin"):
        r = np.asarray(getattr(sc_j, name))
        v = getattr(sc, name).numpy()
        m = act.reshape(act.shape + (1,) * (r.ndim - 2))
        assert rel_err(np.where(m, r, 0.0), np.where(m, v, 0.0)) < TOL, name


@pytest.mark.parametrize("seed", [2, 5])
def test_self_contacts_match_wide_keeps(pair, seed):
    """conftest pins the KEEPs to 4096 (no cull): the port gets the same."""
    jm, tm = pair
    qpos, _, _ = states(jm, B, "tangled", seed=seed)
    sc_j = _self_contacts_jax(jm)(qpos)
    sc = collision_pairs.self_contacts(tm, kinematics.fk(tm, T(qpos)),
                                       keeps=(jax_cp.CC_KEEP, jax_cp.CB_KEEP, jax_cp.BB_KEEP))
    assert int(np.asarray(sc_j.active).sum()) > 2 * B
    _check_self_contacts(sc_j, sc)


def test_self_contacts_match_product_keeps(pair, monkeypatch):
    """The product operating point culls each pair family to 24/16/8."""
    jm, tm = pair
    monkeypatch.setattr(jax_cp, "CC_KEEP", 24)
    monkeypatch.setattr(jax_cp, "CB_KEEP", 16)
    monkeypatch.setattr(jax_cp, "BB_KEEP", 8)
    qpos, _, _ = states(jm, B, "tangled", seed=3)
    sc_j = _self_contacts_jax(jm)(qpos)
    sc = collision_pairs.self_contacts(tm, kinematics.fk(tm, T(qpos)), keeps=(24, 16, 8))
    _check_self_contacts(sc_j, sc)


def test_top_k_ties_and_nan():
    """First index wins ties, NaN ranks last (constraints.top_k_onehot)."""
    score = torch.tensor([[1.0, 3.0, float("nan"), 3.0, -2.0, 1.0]], dtype=torch.float64)
    vals, idx, _ = collision_pairs.top_k(score, 6)
    assert idx.tolist() == [[1, 3, 0, 5, 4, 2]]
    _, onehot = jax_con.top_k_onehot(np.asarray(score[0]), 6)
    np.testing.assert_array_equal(np.asarray(onehot).argmax(1), idx[0].numpy())
    assert vals[0, -1].item() == -collision_pairs.BIG
