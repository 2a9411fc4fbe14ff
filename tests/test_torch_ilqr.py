"""PyTorch port: iLQR (smplsim_tpu_torch/control/ilqr.py) against the JAX
package's ilqr_plan.

  * the double integrator of tests/test_control.py: xs, us and J match the
    JAX planner's in float64 at 1e-9, J reaches the finite-horizon Riccati
    optimum, and the replicated-batch Jacobians are the system matrices;
  * the humanoid (T=2 control steps of 2 substeps, one iteration, the
    root-velocity cost of tests/test_control.py): the plan does not raise
    the cost. The Jacobians come from one forward-AD pass over 2 x 220
    replicated systems through the reference uhc_pd loop.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from smplsim_tpu.control import ILQRConfig as JaxILQRConfig
from smplsim_tpu.control import ilqr_plan as jax_ilqr_plan
from smplsim_tpu_torch.control import ILQRConfig, ilqr_plan, jacobians
from smplsim_tpu_torch.envs import HumanoidSpeed, SpeedConfig
from smplsim_tpu_torch.physics import engine
from tests._torch_port import T, models, rel_err

DT, HORIZON = 0.1, 20
A_DI = np.array([[1.0, DT], [0.0, 1.0]])
B_DI = np.array([[0.0], [DT]])


def _riccati_optimum(x0):
    Q, R, QT = np.eye(2), np.eye(1), 10.0 * np.eye(2)
    P = QT.copy()
    for _ in range(HORIZON):
        K = np.linalg.solve(R + B_DI.T @ P @ B_DI, B_DI.T @ P @ A_DI)
        P = Q + A_DI.T @ P @ A_DI - A_DI.T @ P @ B_DI @ K
    return float(x0 @ P @ x0)


def test_ilqr_matches_jax_on_the_double_integrator():
    x0 = np.array([1.0, 0.0])
    A, B = T(A_DI), T(B_DI)
    xs, us, J = ilqr_plan(
        lambda x, u: x @ A.T + u @ B.T,
        lambda x, u, t: (x * x).sum(1) + (u * u).sum(1),
        lambda x: 10.0 * (x * x).sum(1),
        T(x0), torch.zeros(HORIZON, 1, dtype=torch.float64), ILQRConfig(iterations=10))
    Aj, Bj = jnp.asarray(A_DI), jnp.asarray(B_DI)
    xs_j, us_j, J_j = jax_ilqr_plan(
        lambda x, u: Aj @ x + Bj @ u, lambda x, u, t: x @ x + u @ u,
        lambda x: 10.0 * (x @ x), jnp.asarray(x0), jnp.zeros((HORIZON, 1)),
        JaxILQRConfig(iterations=10))
    assert xs.shape == (HORIZON + 1, 2) and us.shape == (HORIZON, 1) and J.dim() == 0
    for ref, val in ((xs_j, xs), (us_j, us), (J_j, J)):
        assert rel_err(ref, val) < 1e-9, rel_err(ref, val)
    assert float(J) < _riccati_optimum(x0) * 1.02 + 1e-6
    assert float(us.abs().max()) <= 1.0
    # the replicated-batch Jacobians of a linear map are its matrices
    Ja, Jb = jacobians(lambda x, u: x @ A.T + u @ B.T, xs[:3], us[:3])
    assert torch.equal(Ja, A.expand(3, 2, 2)) and torch.equal(Jb, B.expand(3, 2, 1))


def test_ilqr_does_not_raise_the_humanoid_cost():
    _, tm = models(jnp.float64)
    env = HumanoidSpeed(tm, SpeedConfig(control_frequency_inv=2))
    nq = tm.nq
    cfi = env.config.control_frequency_inv

    def dyn(x, u):
        st = engine.control_step(tm, engine.PhysicsState(x[:, :nq], x[:, nq:]), u,
                                 control_freq_inv=cfi)[0]
        return torch.cat([st.qpos, st.qvel], 1)

    cost = lambda x, u, t: (x[:, nq] - 1.0) ** 2 + 1e-3 * (u * u).sum(1)
    term = lambda x: 5.0 * (x[:, nq] - 1.0) ** 2
    st = env.reset(1, torch.Generator().manual_seed(0))
    x0 = torch.cat([st.phys.qpos, st.phys.qvel], 1)[0]
    u0 = torch.zeros(2, tm.nu, dtype=torch.float64)
    xs, us, J = ilqr_plan(dyn, cost, term, x0, u0, ILQRConfig(iterations=1))
    x, J0 = x0[None], 0.0
    for t in range(2):
        J0 = J0 + cost(x, u0[t][None], None)
        x = dyn(x, u0[t][None])
    J0 = float(J0 + term(x))
    assert np.isfinite(float(J)) and float(J) <= J0 + 1e-12, (float(J), J0)
    assert bool(torch.isfinite(xs).all()) and float(us.abs().max()) <= 1.0
