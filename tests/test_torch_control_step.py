"""PyTorch port: the batched control step against jax.vmap(engine.control_step)
on the dense mass-matrix path (SMPLSIM_ABA=0; float64 never takes ABA).

Two control steps of 3 substeps each, the second continuing from the first's
(M, C, efc_force) cache, in the air and lying at the floor: float64 at the
1e-9 bar of tests/test_substep_lanes.py with integer and bool channels
exact; float32 in the air at 5e-3 (the f32 closed loop is chaotic, so it is
kept to a few control steps).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smplsim_tpu.ops import qp_kernel as jax_qp
from smplsim_tpu.physics import collision_pairs as jax_cp
from smplsim_tpu.physics import engine as jax_engine
from smplsim_tpu.physics import solver as jax_solver
from smplsim_tpu_torch.physics import engine
from tests._torch_port import T, TORCH_DTYPE, models, rel_err, states

B = 4
CFI = 3


@functools.lru_cache(maxsize=None)
def _jax_fns(dtype):
    """Jitted vmapped (pd_cache, control_step) of the JAX package, one
    compile per dtype for the whole file."""
    jm, _ = models(dtype)

    def pdc(q, v):
        M, C = jax_engine.pd_cache(jm, jax_engine.PhysicsState(q, v))
        return M, C, jnp.zeros(jax_engine.constraints.NEFC, q.dtype)

    def step(q, v, M, C, fw, a):
        st, info, power, cache = jax_engine.control_step(
            jm, jax_engine.PhysicsState(q, v), a, control_freq_inv=CFI, cache=(M, C, fw))
        return (st.qpos, st.qvel, power, info.nactive_max, info.stalled_any,
                info.geom_floor_contact) + tuple(cache)

    return jax.jit(jax.vmap(pdc)), jax.jit(jax.vmap(step))


@pytest.mark.parametrize("dtype,tol,kind", [
    (jnp.float64, 1e-9, "air"),
    (jnp.float64, 1e-9, "contact"),
    (jnp.float32, 5e-3, "air"),
], ids=["f64-air", "f64-contact", "f32-air"])
def test_control_step_matches_jax(monkeypatch, dtype, tol, kind):
    monkeypatch.setenv("SMPLSIM_ABA", "0")   # read when the JAX step is traced
    jm, tm = models(dtype)
    tdt = TORCH_DTYPE[dtype]
    qpos, qvel, act = states(jm, B, kind, seed=11)
    pdc, step = _jax_fns(dtype)
    J = lambda x: jnp.asarray(x, dtype)

    carry_j = (J(qpos), J(qvel)) + tuple(pdc(J(qpos), J(qvel)))
    state = engine.PhysicsState(T(qpos, tdt), T(qvel, tdt))
    cache = engine.pd_cache(tm, state)
    knobs = dict(qp_iters=jax_qp.NEWTON_ITERS, qp_rows=jax_solver.COMPACT_ROWS,
                 qp_tol=jax_qp._tol_for(dtype),
                 keeps=(jax_cp.CC_KEEP, jax_cp.CB_KEEP, jax_cp.BB_KEEP))
    names = ["qpos", "qvel", "power", "nact", "stall", "gfc", "M", "C", "fw"]
    for k in range(2):
        a = act * (1.0 - 0.5 * k)
        out_j = step(*carry_j, J(a))
        state, info, power, cache = engine.control_step(
            tm, state, T(a, tdt), control_freq_inv=CFI, cache=cache, **knobs)
        out = (state.qpos, state.qvel, power, info.nactive_max, info.stalled_any,
               info.geom_floor_contact) + tuple(cache)
        for name, r, v in zip(names, out_j, out):
            assert v.shape == r.shape and v.device.type == "cpu", name
            assert rel_err(r, v) < tol, (k, name, rel_err(r, v))
        if dtype == jnp.float64:
            for i in (3, 4, 5):
                np.testing.assert_array_equal(out[i].numpy(), np.asarray(out_j[i]),
                                              err_msg=names[i])
            assert out[3].dtype == torch.int32
        assert all(torch.isfinite(x).all() for x in (state.qpos, state.qvel) + tuple(cache))
        carry_j = (out_j[0], out_j[1]) + tuple(out_j[6:])
    if kind == "contact":
        assert int(info.nactive_max.min()) > 0


def test_default_cache_and_cold_start_agree():
    """cache=None primes (M, C) at the state; a 2-tuple starts cold; both
    equal the explicit 3-tuple with a zero warm start."""
    jm, tm = models()
    qpos, qvel, act = states(jm, 2, "air", seed=4)
    st = engine.PhysicsState(T(qpos), T(qvel))
    M, C = engine.pd_cache(tm, st)
    fw = torch.zeros(2, engine.constraints.NEFC, dtype=torch.float64)
    outs = [engine.control_step(tm, st, T(act), control_freq_inv=1, cache=c)
            for c in (None, (M, C), (M, C, fw))]
    for o in outs[1:]:
        assert torch.equal(o[0].qpos, outs[0][0].qpos)
        assert torch.equal(o[3][2], outs[0][3][2])
