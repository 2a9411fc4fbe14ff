"""PyTorch port: the per-env path's linear algebra, and the substep built on
it, against the JAX package's vmapped functions on the CPU, on systems
taken from real substeps.

  * linalg.cho_factor_solve (Kernel C's plain version) vs
    jax.vmap(physics.linalg.cho_factor_solve): both L and x;
  * linalg.tri_solve_lower / cho_solve (Kernel D's plain version) vs
    jax.vmap(tri_solve_lower) at m = 32 and 64 and jax.vmap(cho_solve) at
    m = 1;
  * linalg.solve_lower in both directions vs jax.vmap(solve_lower) and
    jax.vmap(solve_lower_t) at every shape Kernel D's dispatch tells apart,
    and linalg.cho_factor_solve vs jax.vmap(cho_factor_solve), on random
    SPD systems with 7.0 or NaN above the diagonal of the port's input:
    only the lower triangle is read;
  * linalg.cholesky (Kernel E's plain version) vs
    jax.vmap(physics.linalg._cholesky_ref) on both sides of every boundary
    of linalg.cholesky_route, in float64 and float32, and with 7.0 or NaN
    above the diagonal of the port's input; the route at its boundaries;
  * dynamics.smooth_dynamics vs jax.vmap(dynamics.smooth_dynamics);
  * solver.solve_constraints_gram vs jax.vmap(solver.solve_constraints) at
    K = 32 and 64, cold and warm started;
  * engine.step vs jax.vmap(engine.step): one substep from a cold contact
    start, in the air and lying at the floor.

Tolerances, relative (|ref - val| / (1 + |ref|)): float64 at 1e-9, the bar
of tests/test_substep_lanes.py, with integer and bool channels exact;
float32 at 5e-3, the float32 bar of the same file. On a CPU tensor the
wrappers run these plain versions; the CUDA kernels are held to them on the
card by chip_smoke.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smplsim_tpu.physics import constraints as jax_con
from smplsim_tpu.physics import dynamics as jax_dyn
from smplsim_tpu.physics import engine as jax_engine
from smplsim_tpu.physics import kinematics as jax_kin
from smplsim_tpu.physics import linalg as jax_linalg
from smplsim_tpu.physics import solver as jax_solver
from smplsim_tpu_torch.ops import linalg, qp
from smplsim_tpu_torch.physics import constraints, dynamics, engine, kinematics, solver
from tests._torch_port import T, TORCH_DTYPE, models, rel_err, states

TOLS = {jnp.float64: 1e-9, jnp.float32: 5e-3}
B = 4


@pytest.fixture(scope="module")
def substeps():
    """(q, v, tau) of 8 envs, 4 in the air and 4 lying at the floor, and the
    port's kinematics, mass matrices and constraint rows there (float64)."""
    jm, tm = models()
    qs, vs, acts = zip(*(states(jm, B, kind, seed=9) for kind in ("air", "contact")))
    q, v = np.concatenate(qs), np.concatenate(vs)
    tau = 0.5 * np.concatenate(acts) * np.asarray(jm.torque_lim)
    kin = kinematics.fk(tm, T(q))
    M = dynamics.mass_matrix(tm, kin)
    efc = constraints.make_efc(tm, kin, T(q), T(v))
    return jm, tm, q, v, tau, kin, M, efc


def _jt(M, kin, tm, efc, K):
    """The Gram-form right-hand side J^T (B,nv,K) of the compact rows."""
    rows = solver.select_rows(tm, kin.S, efc, torch.zeros(
        M.shape[0], constraints.NEFC, dtype=M.dtype), K)
    assert int(rows.actf.sum()) > K
    return rows.J.transpose(1, 2).contiguous()


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32], ids=["f64", "f32"])
def test_cho_factor_solve_plain_matches_jax(substeps, dtype):
    jm, tm, q, v, tau, kin, M, efc = substeps
    tdt, tol = TORCH_DTYPE[dtype], TOLS[dtype]
    rhs = T(np.random.RandomState(3).randn(M.shape[0], tm.nv), tdt)
    L, x = linalg.cho_factor_solve(M.to(tdt), rhs[..., None])
    assert linalg.cho_factor_solve.launches == 0
    L_j, x_j = jax.jit(jax.vmap(jax_linalg.cho_factor_solve))(
        jnp.asarray(M.numpy(), dtype), jnp.asarray(rhs.numpy(), dtype))
    assert L.dtype == tdt and L.shape == M.shape and x.shape == rhs.shape + (1,)
    assert rel_err(L_j, L) < tol
    assert rel_err(x_j, x[..., 0]) < tol
    # the factor as the downstream solves read it: exact zeros above the diagonal
    assert bool((torch.triu(L, 1) == 0).all())
    np.testing.assert_array_equal(np.triu(np.asarray(L_j), 1), 0.0)


@pytest.mark.parametrize("K", [32, 64])
@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32], ids=["f64", "f32"])
def test_tri_solve_lower_plain_matches_jax(substeps, dtype, K):
    jm, tm, q, v, tau, kin, M, efc = substeps
    tdt, tol = TORCH_DTYPE[dtype], TOLS[dtype]
    Lf = linalg.cholesky_plain(M).to(tdt)
    Jt = _jt(M, kin, tm, efc, K).to(tdt)
    Y = linalg.tri_solve_lower(Lf, Jt)
    assert Y.shape == Jt.shape and linalg.solve_lower.launches == 0
    Y_j = jax.jit(jax.vmap(jax_linalg.tri_solve_lower))(
        jnp.asarray(Lf.numpy()), jnp.asarray(Jt.numpy()))
    assert rel_err(Y_j, Y) < tol
    # only the lower triangle is read
    garbage = Lf + torch.triu(torch.full_like(Lf, 7.0), 1)
    assert torch.equal(linalg.tri_solve_lower(garbage, Jt), Y)


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32], ids=["f64", "f32"])
def test_cho_solve_plain_matches_jax(substeps, dtype):
    jm, tm, q, v, tau, kin, M, efc = substeps
    tdt, tol = TORCH_DTYPE[dtype], TOLS[dtype]
    Lf = linalg.cholesky_plain(M).to(tdt)
    rhs = T(np.random.RandomState(4).randn(M.shape[0], tm.nv), tdt)
    x = linalg.cho_solve(Lf, rhs[..., None])[..., 0]
    x_j = jax.jit(jax.vmap(jax_linalg.cho_solve))(jnp.asarray(Lf.numpy()),
                                                  jnp.asarray(rhs.numpy()))
    assert rel_err(x_j, x) < tol
    # each direction on its own
    y = linalg.solve_lower(Lf, rhs[..., None])
    np.testing.assert_array_equal(
        linalg.solve_lower(Lf, y, trans=True).numpy(), linalg.cho_solve(Lf, rhs[..., None]).numpy())
    assert float((Lf @ y - rhs[..., None]).abs().max()) < tol * float(rhs.abs().max())


def _spd(n, seed):
    """(A, its lower factor, b) numpy float64, 3 random SPD systems."""
    rng = np.random.RandomState(seed)
    G = rng.randn(3, n, n)
    A = G @ G.transpose(0, 2, 1) / n + np.eye(n)
    return A, np.linalg.cholesky(A), rng.randn(3, n, 2)


def _garbage(M, fill):
    return torch.tril(M) + torch.triu(torch.full_like(M, fill), 1)


# (n, m): one warp per system at m = 1 (rows per lane 1 and 3), one warp
# per column at m = 2, a thread per column at m = 75
@pytest.mark.parametrize("trans", [False, True], ids=["L", "LT"])
@pytest.mark.parametrize("n,m", [(32, 1), (75, 1), (75, 2), (75, 75)])
def test_solve_lower_plain_matches_jax_at_dispatch_shapes(n, m, trans):
    _, L, _ = _spd(n, n + m)
    b = np.random.RandomState(m).randn(3, n, m)
    fn = jax_linalg.solve_lower_t if trans else jax_linalg.solve_lower
    x_j = jax.jit(jax.vmap(fn))(jnp.asarray(L), jnp.asarray(b))
    for fill in (7.0, float("nan")):
        x = linalg.solve_lower(_garbage(T(L), fill), T(b), trans)
        assert x.shape == (3, n, m) and rel_err(x_j, x) < 1e-9


@pytest.mark.parametrize("fill", [7.0, float("nan")], ids=["7", "nan"])
@pytest.mark.parametrize("n", [32, 75])
def test_cho_factor_solve_plain_reads_only_the_lower_triangle(n, fill):
    A, _, b = _spd(n, n)
    L_j, x_j = jax.jit(jax.vmap(jax_linalg.cho_factor_solve))(jnp.asarray(A), jnp.asarray(b))
    L, x = linalg.cho_factor_solve(_garbage(T(A), fill), T(b))
    assert rel_err(L_j, L) < 1e-9 and rel_err(x_j, x) < 1e-9
    assert bool((torch.triu(L, 1) == 0).all())


def test_cholesky_route_boundaries():
    route = linalg.cholesky_route
    for itemsize in (4, 8):
        assert route(1, itemsize) == route(64, itemsize) == "warp"
        assert route(65, itemsize) == route(176, itemsize) == "tiled"
        assert route(177, itemsize) == "column"
    assert linalg.CHOLESKY_WARP_MAX_N == 64


# n: one and two rows per lane of the warp form at its edges (32, 33, 64),
# the tiled form's first (65) and the column kernel's first (177)
@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n", [32, 33, 64, 65, 177])
def test_cholesky_plain_matches_jax_at_dispatch_shapes(n, dtype):
    A, _, _ = _spd(n, 100 + n)
    A = A.astype(np.float32 if dtype == jnp.float32 else np.float64)
    launches = linalg.cholesky.launches
    L = linalg.cholesky(T(A, TORCH_DTYPE[dtype]))
    L_j = jax.jit(jax.vmap(jax_linalg._cholesky_ref))(jnp.asarray(A, dtype))
    assert linalg.cholesky.launches == launches
    assert L.dtype == TORCH_DTYPE[dtype] and rel_err(L_j, L) < TOLS[dtype]
    assert bool((torch.triu(L, 1) == 0).all())


@pytest.mark.parametrize("fill", [7.0, float("nan")], ids=["7", "nan"])
@pytest.mark.parametrize("n", [32, 75])
def test_cholesky_plain_reads_only_the_lower_triangle(n, fill):
    A, _, _ = _spd(n, n)
    L_j = jax.jit(jax.vmap(jax_linalg._cholesky_ref))(jnp.asarray(A))
    L = linalg.cholesky(_garbage(T(A), fill))
    assert rel_err(L_j, L) < 1e-9
    assert torch.equal(L, linalg.cholesky(T(A)))


def test_smooth_dynamics_matches_jax(substeps):
    jm, tm, q, v, tau, kin, M, efc = substeps
    sm = dynamics.smooth_dynamics(tm, kin, T(v), T(tau))

    def one(q_, v_, c_):
        return jax_dyn.smooth_dynamics(jm, jax_kin.fk(jm, q_), v_, c_)

    sm_j = jax.jit(jax.vmap(one))(q, v, tau)
    for name in ("M", "chol", "qfrc_smooth", "qacc_smooth"):
        assert rel_err(getattr(sm_j, name), getattr(sm, name)) < 1e-9, name
    assert torch.equal(sm.M, M)
    assert rel_err(dynamics.actuator_forces(tm, T(tau))[:, 6:], tm.gear * T(tau)) == 0.0


@pytest.mark.parametrize("K", [32, 64])
def test_solve_constraints_gram_matches_jax(substeps, monkeypatch, K):
    jm, tm, q, v, tau, kin, M, efc = substeps
    monkeypatch.setattr(jax_solver, "COMPACT_ROWS", K)   # read when traced

    def one(q_, v_, c_, fw):
        kin_j = jax_kin.fk(jm, q_)
        sm = jax_dyn.smooth_dynamics(jm, kin_j, v_, c_)
        return jax_solver.solve_constraints(jm, kin_j, sm, jax_con.make_efc(jm, kin_j, q_, v_), fw)

    fn = jax.jit(jax.vmap(one))
    sm = dynamics.smooth_dynamics(tm, kin, T(v), T(tau))
    rng = np.random.RandomState(K)
    cold = np.zeros((q.shape[0], constraints.NEFC))
    warm = rng.uniform(0.0, 50.0, cold.shape) * np.asarray(efc.active)
    for fw in (cold, warm):
        sol_j = fn(q, v, tau, fw)
        sol = solver.solve_constraints_gram(tm, kin.S, sm, efc, T(fw), K=K)
        assert qp.newton_qp.launches == 0 and linalg.solve_lower.launches == 0
        for name in ("qacc", "efc_force", "qfrc_constraint"):
            assert rel_err(getattr(sol_j, name), getattr(sol, name)) < 1e-9, name
        for name in ("nactive", "overflow", "stalled"):
            np.testing.assert_array_equal(getattr(sol, name).numpy(),
                                          np.asarray(getattr(sol_j, name)), err_msg=name)
    assert sol.nactive.dtype == torch.int32
    # lying envs overflow K (the truncation is part of what is compared)
    assert int(sol.nactive[B:].min()) > 0 and bool(sol.overflow.any())
    assert not bool(sol.overflow.all())


def test_solve_constraints_gram_without_warm_start_is_cold(substeps):
    jm, tm, q, v, tau, kin, M, efc = substeps
    sm = dynamics.smooth_dynamics(tm, kin, T(v), T(tau))
    a = solver.solve_constraints_gram(tm, kin.S, sm, efc, K=32)
    b = solver.solve_constraints_gram(tm, kin.S, sm, efc,
                                      torch.zeros(q.shape[0], constraints.NEFC,
                                                  dtype=torch.float64), K=32)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


@pytest.mark.parametrize("kind", ["air", "contact"])
def test_step_matches_jax(kind):
    jm, tm = models()
    qpos, qvel, act = states(jm, B, kind, seed=21)
    tau = 0.5 * act * np.asarray(jm.torque_lim)

    @jax.jit
    @jax.vmap
    def step_j(q, v, c):
        st, info = jax_engine.step(jm, jax_engine.PhysicsState(q, v), c)
        return (st.qpos, st.qvel, info.sol.qacc, info.sol.efc_force, info.smooth.chol,
                info.smooth.qacc_smooth, info.nactive_max, info.stalled_any,
                info.efc.geom_floor_contact)

    st, info = engine.step(tm, engine.PhysicsState(T(qpos), T(qvel)), T(tau))
    assert linalg.cho_factor_solve.launches == 0 and linalg.solve_lower.launches == 0
    out = (st.qpos, st.qvel, info.sol.qacc, info.sol.efc_force, info.smooth.chol,
           info.smooth.qacc_smooth, info.nactive_max, info.stalled_any,
           info.efc.geom_floor_contact)
    names = ["qpos", "qvel", "qacc", "efc_force", "chol", "qacc_smooth", "nactive",
             "stalled", "gfc"]
    for name, r, v in zip(names, step_j(qpos, qvel, tau), out):
        assert v.shape == r.shape, name
        if np.asarray(r).dtype.kind in "biu":
            np.testing.assert_array_equal(v.numpy(), np.asarray(r), err_msg=name)
        else:
            assert rel_err(r, v) < 1e-9, (name, rel_err(r, v))
    if kind == "contact":
        assert int(info.nactive_max.min()) > 0



def test_new_wrappers_check_their_inputs():
    A = torch.eye(4, dtype=torch.float64).expand(2, 4, 4).contiguous()
    b = torch.ones(2, 4, 3, dtype=torch.float64)
    for fn in (linalg.cho_factor_solve, linalg.solve_lower, linalg.tri_solve_lower,
               linalg.cho_solve):
        with pytest.raises(ValueError):
            fn(A, b[:, :3])
        with pytest.raises(ValueError):
            fn(A[..., :3], b)
        with pytest.raises(ValueError):
            fn(A[0], b[0])
        with pytest.raises(TypeError):
            fn(A, b.float())
        with pytest.raises(TypeError):
            fn(A.to(torch.int64), b.to(torch.int64))
        with pytest.raises(ValueError):
            fn(A.to("meta"), b.to("meta"))
    with pytest.raises(ValueError):
        linalg.solve_lower(A, b.to("meta"))
    L, x = linalg.cho_factor_solve(A, b)
    assert torch.equal(L, A) and torch.equal(x, b)
    for trans in (False, True):
        assert torch.equal(linalg.solve_lower(2.0 * A, b, trans), 0.5 * b)
