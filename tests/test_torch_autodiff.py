"""PyTorch port: forward-mode derivatives against the JAX package's rules.

  * the jvps of physics/linalg.py's four Functions and of ops/qp.py's
    newton_qp_ad against jax.jvp of smplsim_tpu/physics/linalg.py's
    custom_jvp ops and of qp_kernel.newton_qp (small n and K, batch 3, the
    JAX side vmapped);
  * a QP stopped at its iteration cap gets the implicit-function rule
    evaluated at the port's own f, not the derivative of the unrolled
    iterations;
  * every raw kernel wrapper raises on an input that carries a derivative,
    and the Functions raise in reverse mode;
  * df/dx and df/du of the uhc_pd control step (control_freq_inv=1, an air
    and a contact state, actions at 10% of full scale) against
    jax.jit(jax.vmap(jax.jacfwd(dyn, argnums=(0, 1)))): the port takes the
    per-env reference loop under forward AD, as the JAX op's custom_jvp
    does.

Tolerances: float64, |ref - val| / (1 + |ref|) <= 1e-9, the bar of the
other port tests. On the CPU every wrapper runs its plain version; the
kernels' rules run the same arithmetic on the card (chip_smoke.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

from smplsim_tpu.ops import qp_kernel as jax_qp
from smplsim_tpu.physics import collision_pairs as jax_cp
from smplsim_tpu.physics import engine as jax_engine
from smplsim_tpu.physics import linalg as jax_linalg
from smplsim_tpu.physics import solver as jax_solver
from smplsim_tpu_torch.control import jacobians
from smplsim_tpu_torch.ops import linalg, qp
from smplsim_tpu_torch.physics import engine, substep
from smplsim_tpu_torch.physics import linalg as ad_linalg
from tests._torch_port import T, models, rel_err, states

TOL = 1e-9
NB, N, M, K = 3, 6, 2, 6


def _inputs(seed=0):
    """SPD A (NB,N,N), its factor L, b (NB,N,M) and tangents dA (not
    symmetric: the rules read its lower triangle), dL, db."""
    rng = np.random.RandomState(seed)
    G = rng.randn(NB, N, N)
    A = G @ G.transpose(0, 2, 1) + N * np.eye(N)
    L = np.linalg.cholesky(A)
    b = rng.randn(NB, N, M)
    return A, L, b, rng.randn(NB, N, N), np.tril(rng.randn(NB, N, N)), rng.randn(NB, N, M)


def _qp_inputs(seed=1, k=K, shift=0.5):
    """A QP batch with rows at zero force and an inactive row."""
    rng = np.random.RandomState(seed)
    G = rng.randn(NB, k, k)
    A = G @ G.transpose(0, 2, 1) + shift * np.eye(k)
    b = rng.randn(NB, k)
    active = np.ones((NB, k))
    active[:, -1] = 0.0
    b = b * active
    return A, b, active, np.zeros((NB, k)), rng.randn(NB, k, k), rng.randn(NB, k)


def _port_jvp(fn, primals, tangents):
    """Primal outputs and tangents of fn on dual CPU tensors."""
    with forward_ad.dual_level():
        duals = [forward_ad.make_dual(T(p), T(t)) if t is not None else T(p)
                 for p, t in zip(primals, tangents)]
        out = fn(*duals)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [forward_ad.unpack_dual(o) for o in outs]
        return [p.primal for p in pairs], [p.tangent for p in pairs]


def _case(name):
    A, L, b, dA, dL, db = _inputs()
    if name == "cholesky":
        return (ad_linalg.cholesky, jax_linalg.cholesky, (A,), (dA,))
    if name == "tri_solve_lower":
        return (ad_linalg.tri_solve_lower, jax_linalg.tri_solve_lower, (L, b), (dL, db))
    if name == "cho_factor_solve":
        return (ad_linalg.cho_factor_solve, jax_linalg.cho_factor_solve, (A, b), (dA, db))
    if name == "cho_solve":
        return (ad_linalg.cho_solve, jax_linalg.cho_solve, (L, b), (dL, db))
    Aq, bq, act, f0, dAq, dbq = _qp_inputs()
    port = lambda A_, b_, a_, f_: qp.newton_qp_ad(A_, b_, a_, f_, jax_qp.NEWTON_ITERS, 1e-12)
    ref = lambda A_, b_, a_, f_: jax_qp.newton_qp(A_, b_, a_ > 0.5, f_)
    return (port, ref, (Aq, bq, act, f0), (dAq, dbq, None, None))


@pytest.mark.parametrize("name", ["cholesky", "tri_solve_lower", "cho_factor_solve",
                                  "cho_solve", "newton_qp"])
def test_jvp_matches_jax(name):
    port, ref, primals, tangents = _case(name)

    def jvp_one(*args):
        p = args[:len(primals)]
        t = [x if x is not None else jnp.zeros_like(pp)
             for x, pp in zip(args[len(primals):], p)]
        nondiff = [i for i, x in enumerate(tangents) if x is None]
        if not nondiff:
            return jax.jvp(ref, tuple(p), tuple(t))
        # active and f0 enter as closed-over constants, as in the solver
        diff = [i for i in range(len(p)) if i not in nondiff]

        def f(*xs):
            full = list(p)
            for i, x in zip(diff, xs):
                full[i] = x
            return ref(*full)
        return jax.jvp(f, tuple(p[i] for i in diff), tuple(t[i] for i in diff))

    tj = [jnp.asarray(t) if t is not None else None for t in tangents]
    out_j, tan_j = jax.vmap(jvp_one)(*[jnp.asarray(p) for p in primals], *tj)
    out_j = out_j if isinstance(out_j, tuple) else (out_j,)
    tan_j = tan_j if isinstance(tan_j, tuple) else (tan_j,)
    outs, tans = _port_jvp(port, primals, tangents)
    assert len(outs) == len(out_j)
    for o, oj, t, tjj in zip(outs, out_j, tans, tan_j):
        assert rel_err(oj, o) < TOL
        assert t is not None and rel_err(tjj, t) < TOL, rel_err(tjj, t)
    if name == "newton_qp":
        # some rows sit at zero force, so the active set is a proper subset
        assert 0 < int((outs[0] > 0).sum()) < outs[0].numel()


def test_stalled_qp_takes_the_implicit_rule():
    """At the iteration cap the derivative is the implicit-function rule at
    the port's own (unconverged) f, qp_kernel.py:462-467, not the
    derivative of the unrolled iterations."""
    # 24 rows from a cold start: one Newton iteration leaves every system
    # short of its tolerance
    A, b, act, f0, dA, db = _qp_inputs(seed=0, k=24, shift=0.1)
    fn = lambda A_, b_, a_, f_: qp.newton_qp_ad(A_, b_, a_, f_, 1, 1e-12)
    (f,), (df,) = _port_jvp(fn, (A, b, act, f0), (dA, db, None, None))
    f = f.numpy()
    assert bool((qp.kkt_residual(T(A), T(b), T(f), T(act)) > 0.1).all())   # stalled
    ref = np.zeros_like(f)
    for i in range(NB):
        am = ((f[i] > 0) & (act[i] > 0.5)).astype(np.float64)
        H = A[i] * np.outer(am, am) + np.diag(1.0 - am)
        ref[i] = np.linalg.solve(H, (db[i] - dA[i] @ f[i]) * am) * am
    assert rel_err(ref, df) < TOL
    # the unrolled derivative of the same iteration is another function
    unrolled = lambda A_, b_, a_, f_: qp.newton_qp_plain(A_, b_, a_, f_, 1, 1e-12)
    _, (du,) = _port_jvp(unrolled, (A, b, act, f0), (dA, db, None, None))
    assert rel_err(ref, du) > 1e-3


def test_raw_wrappers_raise_on_a_derivative():
    A, L, b, dA, dL, db = _inputs()
    Aq, bq, act, f0, _, _ = _qp_inputs()
    calls = {
        "chol_solve": lambda A_, b_: linalg.chol_solve(A_, b_),
        "cho_factor_solve": lambda A_, b_: linalg.cho_factor_solve(A_, b_),
        "solve_lower": lambda A_, b_: linalg.solve_lower(A_, b_, True),
        "tri_solve_lower": lambda A_, b_: linalg.tri_solve_lower(A_, b_),
        "cho_solve": lambda A_, b_: linalg.cho_solve(A_, b_),
        "cholesky": lambda A_, b_: linalg.cholesky(A_),
    }
    for name, fn in calls.items():
        with forward_ad.dual_level():
            with pytest.raises(RuntimeError, match="derivative"):
                fn(forward_ad.make_dual(T(A), T(dA)), T(b))
            if name != "cholesky":
                with pytest.raises(RuntimeError, match="derivative"):
                    fn(T(A), forward_ad.make_dual(T(b), T(db)))
        with pytest.raises(RuntimeError, match="derivative"):
            fn(T(A).requires_grad_(), T(b))
        fn(T(A), T(b))   # plain tensors pass
    for i in range(4):
        args = [T(x) for x in (Aq, bq, act, f0)]
        with forward_ad.dual_level():
            args[i] = forward_ad.make_dual(args[i], torch.ones_like(args[i]))
            with pytest.raises(RuntimeError, match="derivative"):
                qp.newton_qp(*args, 4, 1e-9)
    # reverse mode is not implemented: it fails loudly
    Ag = T(A).requires_grad_()
    for out in (ad_linalg.cholesky(Ag), ad_linalg.cho_factor_solve(Ag, T(b))[1],
                ad_linalg.cho_solve(Ag, T(b)), ad_linalg.tri_solve_lower(Ag, T(b)),
                qp.newton_qp_ad(T(Aq).requires_grad_(), T(bq), T(act), T(f0))):
        with pytest.raises(NotImplementedError):
            out.sum().backward()


@functools.lru_cache(maxsize=None)
def _jax_jacobian():
    """jit(vmap(jacfwd)) of one uhc_pd control step of the JAX package: the
    one compile of this file."""
    jm, _ = models()
    nq = jm.nq

    def dyn(x, u):
        st = jax_engine.PhysicsState(qpos=x[:nq], qvel=x[nq:])
        st2, _, _, _ = jax_engine.control_step(jm, st, u, control_freq_inv=1)
        return jnp.concatenate([st2.qpos, st2.qvel])

    return jax.jit(jax.vmap(jax.jacfwd(dyn, argnums=(0, 1))))


def test_control_step_jacobian_matches_jax():
    """One air and one contact state; the port's Jacobians come from one
    forward-AD pass over the replicated batch (control.jacobians)."""
    jm, tm = models()
    (qa, va, aa), (qc, vc, ac) = (states(jm, 1, kind, seed=13) for kind in ("air", "contact"))
    x = np.concatenate([np.concatenate([qa, va], 1), np.concatenate([qc, vc], 1)])
    u = 0.1 * np.concatenate([aa, ac])
    knobs = dict(qp_iters=jax_qp.NEWTON_ITERS, qp_rows=jax_solver.COMPACT_ROWS,
                 qp_tol=jax_qp._tol_for(jnp.float64),
                 keeps=(jax_cp.CC_KEEP, jax_cp.CB_KEEP, jax_cp.BB_KEEP))

    def dyn(x_, u_):
        st = engine.PhysicsState(x_[:, :tm.nq], x_[:, tm.nq:])
        st2 = engine.control_step(tm, st, u_, control_freq_inv=1, **knobs)[0]
        return torch.cat([st2.qpos, st2.qvel], 1)

    A_j, B_j = _jax_jacobian()(jnp.asarray(x), jnp.asarray(u))
    A, B = jacobians(dyn, T(x), T(u))
    assert A.shape == (2, tm.nq + tm.nv, tm.nq + tm.nv) and B.shape == (2, tm.nq + tm.nv, tm.nu)
    assert rel_err(A_j, A) < TOL, rel_err(A_j, A)
    assert rel_err(B_j, B) < TOL, rel_err(B_j, B)
    # the contact state's Jacobian runs through the contact QP's rule
    assert float(np.abs(np.asarray(A_j[1]) - np.asarray(A_j[0])).max()) > 1.0


def test_tangent_routes_control_step_to_the_reference_loop():
    """With a tangent on any input, control_step's primal is the reference
    loop's; without one, the spine's (the two agree only to rounding)."""
    jm, tm = models()
    q, v, a = states(jm, 2, "contact", seed=3)
    st = engine.PhysicsState(T(q), T(v))
    cache = engine.pd_cache(tm, st)
    f_w = torch.zeros(2, engine.constraints.NEFC, dtype=torch.float64)
    ref = substep.control_loop(tm, st.qpos, st.qvel, *cache, f_w,
                               engine.pd_target_from_action(tm, 0.1 * T(a)),
                               engine.reset_reference(tm), 2, reference=True)
    for i in range(3):
        args = [st.qpos, st.qvel, 0.1 * T(a)]
        with forward_ad.dual_level():
            args[i] = forward_ad.make_dual(args[i], torch.ones_like(args[i]))
            out = engine.control_step(tm, engine.PhysicsState(args[0], args[1]), args[2],
                                      control_freq_inv=2)
            qpos = forward_ad.unpack_dual(out[0].qpos)
        assert torch.equal(qpos.primal, ref[0])
        assert qpos.tangent is not None and bool(torch.isfinite(qpos.tangent).all())
    spine = engine.control_step(tm, st, 0.1 * T(a), control_freq_inv=2)
    assert rel_err(ref[0], spine[0].qpos) < TOL and not torch.equal(ref[0], spine[0].qpos)
