"""PyTorch port: the plain versions of the two hand-written kernels against
the JAX package's CPU paths, on systems taken from real substeps.

  * linalg.chol_solve  vs substep_lanes._chol_solve_dispatch (its CPU
    fallback: _cholesky_ref + _cho_solve_ref), with and without the diagonal
    shift, at m = 1 (stable-PD) and m = 33 (smooth + Delassus, K = 32);
  * qp.newton_qp       vs vmap(qp_kernel.newton_qp_reference) on Delassus
    systems of contact-rich substeps, K = 32 and 64, 16 and 40 iterations.

and, at every shape the kernels' dispatch tells apart:

  * linalg.chol_solve  vs _chol_solve_dispatch on random SPD systems with
    7.0 or NaN above the diagonal of the port's input (only the lower
    triangle is read), at (n, m, d) = (32, 1, d), (75, 1, d), (75, 2, -),
    (75, 33, -), (75, 75, d);
  * qp.newton_qp       vs vmap(newton_qp_reference) at K = 8 and 33 (one
    and two rows per lane of the warp form);
  * the shape-dispatch helpers (linalg.chol_solve_route, qp.newton_qp_route)
    at their boundaries, and the QP's degenerate inputs: iters = 0, a huge
    tol, no active row, a NaN system in a batch.

float64 throughout, 1e-9 relative. On a CPU tensor the wrappers run these
plain versions; the CUDA kernels are held to them on the card by
chip_smoke.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smplsim_tpu.ops import qp_kernel as jax_qp
from smplsim_tpu.physics import substep_lanes
from smplsim_tpu_torch.ops import linalg, qp
from smplsim_tpu_torch.physics import constraints, dynamics, kinematics, solver
from tests._torch_port import T, models, rel_err, states

TOL = 1e-9


@pytest.fixture(scope="module")
def substeps():
    """Mass matrices, smooth forces and constraint rows of 8 substeps: 4 in
    the air, 4 lying at the floor (float64, port modules)."""
    jm, tm = models()
    out = []
    for kind in ("air", "contact"):
        qpos, qvel, _ = states(jm, 4, kind, seed=7)
        q, v = T(qpos), T(qvel)
        kin = kinematics.fk(tm, q)
        M = dynamics.mass_matrix(tm, kin)
        C = dynamics.bias_forces(tm, kin, v)
        efc = constraints.make_efc(tm, kin, q, v)
        out.append((kin, M, -tm.dof_damping * v - C, efc))
    cat = lambda i: torch.cat([o[i] for o in out])
    kin = kinematics.Kin(*(torch.cat([getattr(o[0], f) for o in out])
                           for f in ("xpos", "xmat", "S", "com", "inertia_w")))
    efc = constraints.EFC(*(torch.cat([getattr(o[3], f.name) for o in out])
                            for f in dataclasses.fields(constraints.EFC)))
    return tm, kin, cat(1), cat(2), efc


def _jax_chol(M, rhs, diag):
    lanes = lambda x: jnp.moveaxis(jnp.asarray(x.numpy()), 0, -1)
    x = substep_lanes._chol_solve_dispatch(
        lanes(M), lanes(rhs), None if diag is None else lanes(diag))
    return np.moveaxis(np.asarray(x), -1, 0)


@pytest.mark.parametrize("m,with_diag", [(1, True), (1, False), (33, True), (33, False)])
def test_chol_solve_plain_matches_jax(substeps, m, with_diag):
    tm, kin, M, qfrc, efc = substeps
    rng = np.random.RandomState(m)
    B, nv = qfrc.shape
    rhs = T(rng.randn(B, nv, m))
    diag = T(rng.uniform(0.0, 2.0, (B, nv))) if with_diag else None
    x = linalg.chol_solve(M, rhs, diag)
    assert x.shape == (B, nv, m) and linalg.chol_solve.launches == 0
    assert rel_err(_jax_chol(M, rhs, diag), x) < TOL


def test_chol_solve_plain_on_the_substep_rhs(substeps):
    """The fused smooth + Delassus right-hand side [qfrc | J^T] (m = 1 + K)
    solves to the JAX result, and H x = b holds in float32 as well."""
    tm, kin, M, qfrc, efc = substeps
    rows = solver.select_rows(tm, kin.S, efc, torch.zeros(
        qfrc.shape[0], constraints.NEFC, dtype=qfrc.dtype), 32)
    rhs = solver.smooth_rhs(qfrc, rows)
    assert rhs.shape[-1] == 33
    x = linalg.chol_solve_plain(M, rhs)
    assert rel_err(_jax_chol(M, rhs, None), x) < TOL
    x32 = linalg.chol_solve_plain(M.float(), rhs.float()).double()
    res = (M @ x32 - rhs).abs().amax() / (M.abs().amax() * x32.abs().amax() + rhs.abs().amax())
    assert res < 1e-5


def _delassus(tm, kin, M, qfrc, efc, K):
    rows = solver.select_rows(tm, kin.S, efc, torch.zeros(
        qfrc.shape[0], constraints.NEFC, dtype=qfrc.dtype), K)
    A, b = solver.delassus(rows, linalg.chol_solve_plain(M, solver.smooth_rhs(qfrc, rows)))
    return A, b, rows.actf


@pytest.mark.parametrize("K,iters", [(32, 16), (32, 40), (64, 16), (64, 40)])
def test_newton_qp_plain_matches_reference(substeps, K, iters):
    tm, kin, M, qfrc, efc = substeps
    A, b, actf = _delassus(tm, kin, M, qfrc, efc, K)
    assert int(actf.sum()) > 2 * K
    rng = np.random.RandomState(K + iters)
    cold = torch.zeros_like(b)
    warm = T(rng.uniform(0.0, 1.0, b.shape)) * b.abs().amax(-1, keepdim=True)
    ref = jax.jit(jax.vmap(lambda a, bb, m, w: jax_qp.newton_qp_reference(
        a, bb, m > 0.5, w, iters)))
    for f0 in (cold, warm):
        f = qp.newton_qp(A, b, actf, f0, iters, qp.tol_for(torch.float64))
        assert qp.newton_qp.launches == 0
        f_ref = ref(*(np.asarray(x.numpy()) for x in (A, b, actf, f0)))
        assert rel_err(f_ref, f) < TOL
    assert (f >= 0).all() and (f[actf == 0] == 0).all()


def test_newton_qp_plain_converges_to_kkt(substeps):
    tm, kin, M, qfrc, efc = substeps
    A, b, actf = _delassus(tm, kin, M, qfrc, efc, 64)
    f = qp.newton_qp_plain(A, b, actf, torch.zeros_like(b), 40, 1e-12)
    assert (qp.kkt_residual(A, b, f, actf) <= 1e-12 * (1 + b.abs().amax(-1))).all()


def test_wrappers_check_their_inputs():
    A = torch.eye(4, dtype=torch.float64).expand(2, 4, 4).contiguous()
    b = torch.ones(2, 4, 1, dtype=torch.float64)
    with pytest.raises(ValueError):
        linalg.chol_solve(A, b[:, :3])
    with pytest.raises(TypeError):
        linalg.chol_solve(A, b.float())
    with pytest.raises(ValueError):
        qp.newton_qp(A, b[..., 0], b[..., 0], b[:, :3, 0], 4, 1e-9)
    with pytest.raises(TypeError):
        qp.newton_qp(A, b[..., 0].float(), b[..., 0], b[..., 0], 4, 1e-9)
    np.testing.assert_allclose(linalg.chol_solve(A, b).numpy(), b.numpy())


def _spd(B, n, seed):
    rng = np.random.RandomState(seed)
    G = rng.randn(B, n, n)
    return G @ G.transpose(0, 2, 1) / n + np.eye(n)


def _garbage(M, fill):
    return torch.tril(M) + torch.triu(torch.full_like(M, fill), 1)


# (n, m, diag): Kernel A's warp form at rows per lane 1 and 3 and at m = 2,
# its thread-per-column form at m = 33 and 75
@pytest.mark.parametrize("n,m,with_diag", [(32, 1, True), (75, 1, True), (75, 2, False),
                                           (75, 33, False), (75, 75, True)])
def test_chol_solve_plain_matches_jax_at_dispatch_shapes(n, m, with_diag):
    A = _spd(3, n, n + m)
    rng = np.random.RandomState(m)
    b = rng.randn(3, n, m)
    d = rng.uniform(0.0, 2.0, (3, n)) if with_diag else None
    x_j = _jax_chol(T(A), T(b), None if d is None else T(d))
    for fill in (7.0, float("nan")):
        x = linalg.chol_solve(_garbage(T(A), fill), T(b), None if d is None else T(d))
        assert x.shape == (3, n, m) and rel_err(x_j, x) < TOL


def test_chol_solve_route_boundaries():
    route = linalg.chol_solve_route
    assert route(75, 1, 4) == route(75, linalg.CHOL_SOLVE_WARP_MAX_M, 4) == "warp"
    assert route(75, linalg.CHOL_SOLVE_WARP_MAX_M + 1, 4) == "thread"
    assert route(75, 33, 4) == route(75, 33, 8) == "thread"
    # the tiles hold n <= 176; above, and at m = 0, the column kernel
    assert route(176, 1, 8) == "warp" and route(177, 1, 4) == "column"
    assert route(75, 0, 4) == "column"
    # a right-hand side whose columns do not fit the tiled form's shared
    # memory at once is solved in chunks of column slots, in the same launch
    assert linalg.chol_solve_tiled_layout(32, 800, 4, "thread")[0] <= linalg._SMEM_MAX
    assert route(32, 800, 4) == "thread"
    assert linalg.chol_solve_tiled_layout(32, 800, 4, "thread")[1] == 1024
    smem, chunk = linalg.chol_solve_tiled_layout(32, 800, 8, "thread")
    assert smem <= linalg._SMEM_MAX and chunk % 32 == 0 and 800 <= chunk < 1024
    assert route(32, 800, 8) == "thread"
    # the shared memory the kernel takes at the main path's shapes (float32):
    # the factor's scratch, the triangle, and at m = 33 the row-aligned
    # triangle and the columns of y and x
    assert linalg.chol_solve_tiled_layout(75, 1, 4, "warp")[0] == 4 * (16 + 16 * 19 + 2850)
    assert (linalg.chol_solve_tiled_layout(75, 33, 4, "thread")[0]
            == 4 * (16 + 16 * 19 + 3360 + 80 * 64))


def test_newton_qp_route_boundaries():
    assert qp.newton_qp_route(1) == qp.newton_qp_route(qp.QP_WARP_MAX_K) == "warp"
    assert qp.newton_qp_route(qp.QP_WARP_MAX_K + 1) == "block"


@pytest.mark.parametrize("K", [8, 33])
def test_newton_qp_plain_matches_reference_at_warp_shapes(substeps, K):
    """Rows per lane 1 (K = 8, padded to a warp) and 2 (K = 33) of the warp
    form, on Delassus systems, cold and warm started."""
    tm, kin, M, qfrc, efc = substeps
    A, b, actf = _delassus(tm, kin, M, qfrc, efc, K)
    warm = T(np.random.RandomState(K).uniform(-0.2, 1.0, b.shape)) * b.abs().amax(-1, keepdim=True)
    ref = jax.jit(jax.vmap(lambda a, bb, m, w: jax_qp.newton_qp_reference(a, bb, m > 0.5, w, 16)))
    for f0 in (torch.zeros_like(b), warm):
        f = qp.newton_qp(A, b, actf, f0, 16, qp.tol_for(torch.float64))
        f_ref = ref(*(np.asarray(x.numpy()) for x in (A, b, actf, f0)))
        assert rel_err(f_ref, f) < TOL


def _qp_batch(K, seed):
    rng = np.random.RandomState(seed)
    J = rng.randn(6, K, 12)
    A = J @ J.transpose(0, 2, 1) / 12 + 1e-3 * np.eye(K)
    act = (rng.uniform(size=(6, K)) < 0.8).astype(np.float64)
    return T(A), T(rng.randn(6, K)), T(act), T(rng.uniform(-0.5, 1.0, (6, K)))


def test_newton_qp_degenerate_cases():
    A, b, act, f0 = _qp_batch(8, 0)
    start = f0.clamp_min(0.0) * act
    assert torch.equal(qp.newton_qp(A, b, act, f0, 0, 1e-12), start)
    assert torch.equal(qp.newton_qp(A, b, act, f0, 16, 1e30), start)
    f = qp.newton_qp(A, b, torch.zeros_like(act), f0, 16, 1e-12)
    assert torch.equal(f, torch.zeros_like(f))


def test_newton_qp_nan_system_stays_in_its_system():
    A, b, act, f0 = _qp_batch(33, 1)
    f = qp.newton_qp(A, b, act, f0, 16, 1e-12)
    An = A.clone()
    An[2] = float("nan")
    fn = qp.newton_qp(An, b, act, f0, 16, 1e-12)
    keep = torch.arange(6) != 2
    assert torch.equal(fn[keep], f[keep])
    # its own KKT residual is NaN: it stops at its warm start
    assert torch.equal(fn[2], f0[2].clamp_min(0.0) * act[2])
