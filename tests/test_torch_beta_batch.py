"""PyTorch port: stacked models (each env its own body) through the physics,
and the SMPLX humanoid, against the JAX package.

  * a stacked model of identical copies computes what the shared model
    computes (float64): the mass matrix, the bias forces and the constraint
    rows bit for bit from one FK, FK itself to a few ulps (the shared
    model's frame products are BLAS's, the stacked model's batched ones)
    and a control step at 1e-9; HumanoidGetup with its Fall init,
    HumanoidReach with observation v2 and both perturbation hooks on such
    copies as on the shared model;
  * 4 β bodies (the synthetic SMPL body, β ~ N(0, 0.8²)) through one uhc_pd
    control step of 3 substeps against jax.vmap(engine.control_step) with
    the model mapped, in the "air" and "contact" states of
    tests/_torch_port.py (float64 at 1e-9, float32 at 5e-3; SMPLX's control
    step is in tests/test_torch_body_model.py);
  * Kernel A's shape dispatch: no n <= 176, m <= 65 goes to the column
    kernel, and the plain version at the chunked shapes of the SMPLX path.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smplsim_tpu.body_model import SMPLParser as JaxParser
from smplsim_tpu.models import builder as jax_builder
from smplsim_tpu.models import stack_models as jax_stack
from smplsim_tpu.physics import engine as jax_engine
from smplsim_tpu.physics import substep_lanes
from smplsim_tpu_torch.body_model import SMPLParser
from smplsim_tpu_torch.models import builder, stack_models
from smplsim_tpu_torch.ops import linalg
from smplsim_tpu_torch.physics import constraints, dynamics, engine, kinematics
from tests._torch_port import T, models, rel_err, states
from tests._torch_synthetic_body import make_synthetic_body

TOL = 1e-9
TOL32 = 5e-3
N = 4
SUBSTEPS = 3


def _same(a, b):
    """Bit-for-bit equality of tensors in nested dataclasses and tuples."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if dataclasses.is_dataclass(a):
        return all(_same(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_stacked_copies_equal_the_shared_model():
    jm, tm = models()
    sm = stack_models([tm] * N)
    assert sm.stacked and sm.num_stacked == N and sm.nv == tm.nv
    qpos, qvel, act = (T(x) for x in states(jm, N, "contact", seed=3))
    qpos[1] = T(states(jm, 1, "tangled", seed=3)[0])[0]
    k1, k2 = kinematics.fk(tm, qpos), kinematics.fk(sm, qpos)
    for f in dataclasses.fields(k1):
        assert rel_err(getattr(k1, f.name), getattr(k2, f.name)) < 1e-14, f.name
    assert _same(dynamics.mass_matrix(tm, k1), dynamics.mass_matrix(sm, k1))
    assert _same(dynamics.bias_forces(tm, k1, qvel), dynamics.bias_forces(sm, k1, qvel))
    assert _same(constraints.make_efc(tm, k1, qpos, qvel), constraints.make_efc(sm, k1, qpos, qvel))
    st = engine.PhysicsState(qpos, qvel)
    out1 = engine.control_step(tm, st, act, control_freq_inv=SUBSTEPS)
    out2 = engine.control_step(sm, st, act, control_freq_inv=SUBSTEPS)
    for r, v in zip((out1[0].qpos, out1[0].qvel, out1[2], *out1[3]),
                    (out2[0].qpos, out2[0].qvel, out2[2], *out2[3])):
        assert rel_err(r.numpy(), v) < TOL
    assert engine.reset_reference(sm)[0].shape == (N, tm.nq)
    with pytest.raises(ValueError, match="exactly 4"):
        kinematics.fk(sm, qpos[:3])


@pytest.fixture(scope="module")
def beta_bodies():
    d = make_synthetic_body(np.random.RandomState(0), "smpl")
    pj, pt = JaxParser(data=d), SMPLParser(data=d)
    rng = np.random.RandomState(11)
    betas = [rng.randn(1, 10) * 0.8 for _ in range(N)]
    jms = [jax_builder.build_robot_model(pj, betas=jnp.asarray(b), dtype=jnp.float64)[0]
           for b in betas]
    tms = [builder.build_robot_model(pt, betas=b, dtype=torch.float64, device="cpu")[0]
           for b in betas]
    return jms, tms


def _jax_step(substeps):
    def one(m, q, v, a):
        st, info, power, cache = jax_engine.control_step(
            m, jax_engine.PhysicsState(q, v), a, control_freq_inv=substeps)
        return st.qpos, st.qvel, power, cache[0], cache[1], cache[2], info.nactive_max
    return jax.jit(jax.vmap(one))


def _port_step(model, q, v, a, substeps):
    st, info, power, cache = engine.control_step(model, engine.PhysicsState(q, v), a,
                                                 control_freq_inv=substeps)
    return (st.qpos, st.qvel, power, *cache), info.nactive_max


@pytest.fixture(scope="module")
def jax_step64():
    return _jax_step(SUBSTEPS)


@pytest.mark.parametrize("kind", ["air", "contact"])
def test_beta_batch_step_matches_jax_vmap(beta_bodies, jax_step64, kind):
    jms, tms = beta_bodies
    jm, tm = jax_stack(jms), stack_models(tms)
    # the bodies differ
    assert float(tm.body_mass.sum(1).std()) > 1e-3
    q, v, a = states(jms[0], N, kind, seed=2)
    ref = jax_step64(jm, jnp.asarray(q), jnp.asarray(v), jnp.asarray(a))
    got, nact = _port_step(tm, T(q), T(v), T(a), SUBSTEPS)
    for r, x in zip(ref[:6], got):
        assert rel_err(r, x) < TOL
    np.testing.assert_array_equal(nact.numpy(), np.asarray(ref[6]))
    # each env ran its own body: the rows differ from one body's batch
    alone, _ = _port_step(tms[0], T(q), T(v), T(a), SUBSTEPS)
    assert (alone[0][1:] - got[0][1:]).abs().max() > 1e-6


def test_beta_batch_step_float32(beta_bodies):
    jms, tms = beta_bodies
    jm = jax_stack([m.astype(jnp.float32) for m in jms])
    tm = stack_models([m.to(torch.float32) for m in tms])
    q, v, a = states(jms[0], N, "air", seed=4)
    ref = _jax_step(SUBSTEPS)(jm, *(jnp.asarray(x, jnp.float32) for x in (q, v, a)))
    got, _ = _port_step(tm, *(T(x, torch.float32) for x in (q, v, a)), SUBSTEPS)
    for r, x in zip(ref[:3], got):
        assert x.dtype == torch.float32 and rel_err(r, x) < TOL32


def test_chol_solve_tiled_route_for_every_shape_up_to_176():
    for itemsize in (4, 8):
        for n in range(1, 177):
            for m in range(1, 66):
                assert linalg.chol_solve_route(n, m, itemsize) != "column", (n, m, itemsize)
    assert linalg.chol_solve_route(177, 1, 4) == linalg.chol_solve_route(180, 65, 8) == "column"
    # the SMPLX path in float64 at the default QP: two chunks of 64 columns
    assert linalg.chol_solve_tiled_layout(159, 65, 8, "thread") == (192128, 64)
    assert linalg.chol_solve_tiled_layout(176, 65, 8, "thread") == (222592, 64)
    # where the columns fit, one chunk as wide as the unchunked solve
    assert linalg.chol_solve_tiled_layout(159, 65, 4, "thread") == (116544, 96)
    assert linalg.chol_solve_tiled_layout(75, 33, 4, "thread")[1] == 64


@pytest.mark.parametrize("m", [1, 33, 65])
def test_chol_solve_plain_at_the_smplx_shapes(m):
    """The plain version (the CPU path, and the kernel's yardstick) on
    SMPLX mass matrices, n = 159, against the JAX package's dispatch."""
    d = make_synthetic_body(np.random.default_rng(1), "smplx")
    tm = builder.build_robot_model(SMPLParser(data=d, model_type="smplx"),
                                   cfg=builder.RobotConfig(model="smplx"),
                                   dtype=torch.float64, device="cpu")[0]
    q, _, _ = states(tm, 3, "tangled", seed=m)
    M = dynamics.mass_matrix(tm, kinematics.fk(tm, T(q)))
    rng = np.random.RandomState(m)
    b = T(rng.randn(3, tm.nv, m))
    diag = T(rng.uniform(0.0, 0.1, (3, tm.nv))) if m == 1 else None
    lanes = lambda x: jnp.moveaxis(jnp.asarray(x.numpy()), 0, -1)
    ref = np.moveaxis(np.asarray(substep_lanes._chol_solve_dispatch(
        lanes(M), lanes(b), None if diag is None else lanes(diag))), -1, 0)
    assert rel_err(ref, linalg.chol_solve(M, b, diag)) < TOL


def test_stacked_copies_tasks_and_hooks():
    """The Fall init (per reset), HumanoidGetup, HumanoidReach with
    observation v2 and both perturbation hooks run on a stacked model as on
    the shared one: identical copies from the same draws agree to 1e-9."""
    from smplsim_tpu_torch.envs import GetupConfig, HumanoidGetup, HumanoidReach, ReachConfig

    _, tm = models()
    sm = stack_models([tm] * N)
    act = torch.zeros(N, tm.nu, dtype=torch.float64)
    for make in (lambda m: HumanoidGetup(m, GetupConfig(control_frequency_inv=2)),
                 lambda m: HumanoidReach(m, ReachConfig(self_obs_v=2, control_frequency_inv=2))):
        out = []
        for m in (tm, sm):
            env = make(m)
            s = env.reset(N, torch.Generator().manual_seed(4))
            out.append(env.step_autoreset(s, act + 0.1))
        for r, v in ((out[0].phys.qpos, out[1].phys.qpos), (out[0].obs, out[1].obs),
                     (out[0].reward, out[1].reward)):
            assert rel_err(r.numpy(), v) < TOL

    q, v, a = (T(x) for x in states(models()[0], N, "air", seed=8))
    push = torch.zeros(N, tm.nbody, 3, dtype=torch.float64)
    push[:, 0, 0] = 50.0
    ball = (q[:, None, :3] + torch.tensor([0.25, 0.0, 0.0], dtype=torch.float64),
            torch.tensor([[[-10.0, 0.0, 0.0]]] * N, dtype=torch.float64),
            torch.full((N, 1), 0.12, dtype=torch.float64),
            torch.full((N, 1), 0.5, dtype=torch.float64))
    res = [engine.control_step(m, engine.PhysicsState(q, v), a, control_freq_inv=2,
                               ext_force=push, proj=ball) for m in (tm, sm)]
    for r, x in zip((res[0][0].qpos, res[0][0].qvel, *res[0][4]),
                    (res[1][0].qpos, res[1][0].qvel, *res[1][4])):
        assert rel_err(r.numpy(), x) < TOL
