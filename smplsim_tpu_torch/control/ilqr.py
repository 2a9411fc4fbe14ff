"""iLQR trajectory optimization over the differentiable physics step.

Port of smplsim_tpu/control/ilqr.py: a backward Riccati pass with Levenberg
regularization and a forward line search, a fixed number of iterations,
over any batch-first dynamics f(x (B,n), u (B,m)) -> x' (B,n), with the
same arguments and outputs (xs (T+1,n), us (T,m), J).

A = df/dx and B = df/du at the T trajectory points come from ONE
forward-mode AD pass over a replicated batch (`jacobians`): each point is
repeated n + m times and replica j carries the j-th one-hot tangent of
[x, u]. That is jax.jacfwd with the primal recomputed for every column:
the same numbers, at (n + m) times the primal work (220 systems per point
for the humanoid, nq + nv = 151 and nu = 69). For the physics step the
tangents make control_step run the per-env reference loop and the
derivative rules of physics/linalg.py and ops/qp.py.

The cost derivatives take torch.func on the user's cost, and the m x m
Riccati solve torch.linalg.cholesky_ex / cholesky_solve: both are library
calls outside any TPU kernel in the JAX package too. The line search runs
its alphas as one batch of rollouts and picks as the JAX scan does: the
first alpha whose finite cost is the strict minimum below the current J.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.autograd import forward_ad
from torch.func import grad, hessian, jacfwd, vmap


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    iterations: int = 5
    reg_init: float = 1e-6
    reg_factor: float = 10.0
    reg_max: float = 1e6
    line_search_steps: tuple = (1.0, 0.5, 0.25, 0.1, 0.03)


def jacobians(dynamics: Callable, xs: torch.Tensor, us: torch.Tensor):
    """(A (T,n,n), B (T,n,m)): df/dx and df/du of the batch-first dynamics
    at the points xs (T,n), us (T,m), from one forward-AD pass over the
    T * (n + m) replicated points."""
    T, n = xs.shape
    m = us.shape[1]
    eye = torch.eye(n + m, dtype=xs.dtype, device=xs.device)
    X = xs.repeat_interleave(n + m, 0)
    U = us.repeat_interleave(n + m, 0)
    with forward_ad.dual_level():
        out = dynamics(forward_ad.make_dual(X, eye[:, :n].repeat(T, 1)),
                       forward_ad.make_dual(U, eye[:, n:].repeat(T, 1)))
        tangent = forward_ad.unpack_dual(out).tangent
    if tangent is None:
        tangent = torch.zeros_like(X)
    jac = tangent.reshape(T, n + m, n).mT            # (T, n, n + m)
    return jac[..., :n], jac[..., n:]


def _row(fn):
    """The per-row form of a batch-first cost c(x (B,n), u (B,m), t (B,))."""
    return lambda x, u, t: fn(x[None], u[None], t[None])[0]


def ilqr_plan(
    dynamics: Callable,       # f(x (B,n), u (B,m)) -> x' (B,n)
    cost: Callable,           # c(x (B,n), u (B,m), t (B,) int64) -> (B,)
    terminal_cost: Callable,  # cT(x (B,n)) -> (B,)
    x0: torch.Tensor,         # (n,)
    u_init: torch.Tensor,     # (T, m)
    config: ILQRConfig | None = None,
):
    """Returns (xs (T+1,n), us (T,m), total cost (0-dim tensor))."""
    cfg = config or ILQRConfig()
    T, m = u_init.shape
    n = x0.shape[0]
    dtype, dev = x0.dtype, x0.device
    ts = torch.arange(T, device=dev)
    alphas = torch.tensor(cfg.line_search_steps, dtype=dtype, device=dev)
    c_row = _row(cost)
    cT_row = lambda x: terminal_cost(x[None])[0]
    c_x = vmap(grad(c_row, argnums=0))
    c_u = vmap(grad(c_row, argnums=1))
    c_xx = vmap(hessian(c_row, argnums=0))
    c_uu = vmap(hessian(c_row, argnums=1))
    c_ux = vmap(jacfwd(grad(c_row, argnums=1), argnums=0))
    eye_m = torch.eye(m, dtype=dtype, device=dev)

    def total_cost(xs, us):
        """xs (S,T+1,n), us (S,T,m) -> (S,) for S trajectories at once."""
        S = xs.shape[0]
        cs = cost(xs[:, :-1].reshape(S * T, n), us.reshape(S * T, m), ts.repeat(S))
        return cs.reshape(S, T).sum(1) + terminal_cost(xs[:, -1])

    def backward(xs, us, reg):
        """Riccati sweep: K (T,m,n), k (T,m)."""
        A, B = jacobians(dynamics, xs[:-1], us)
        x_, t_ = xs[:-1], ts
        lx, lu = c_x(x_, us, t_), c_u(x_, us, t_)
        lxx, luu, lux = c_xx(x_, us, t_), c_uu(x_, us, t_), c_ux(x_, us, t_)
        Vx = grad(cT_row)(xs[-1])
        Vxx = hessian(cT_row)(xs[-1])
        K = torch.empty((T, m, n), dtype=dtype, device=dev)
        k = torch.empty((T, m), dtype=dtype, device=dev)
        for t in range(T - 1, -1, -1):
            At, Bt = A[t], B[t]
            Qx = lx[t] + At.T @ Vx
            Qu = lu[t] + Bt.T @ Vx
            Qxx = lxx[t] + At.T @ Vxx @ At
            Quu = luu[t] + Bt.T @ Vxx @ Bt
            Qux = lux[t] + Bt.T @ Vxx @ At
            chol, info = torch.linalg.cholesky_ex(Quu + reg * eye_m)
            # a failed factor falls back to the identity, as the JAX
            # version's NaN test does
            if bool(info != 0) or bool(torch.isnan(chol).any()):
                chol = eye_m
            kk = -torch.cholesky_solve(Qu[:, None], chol)[:, 0]
            KK = -torch.cholesky_solve(Qux, chol)
            Vx = Qx + KK.T @ Quu @ kk + KK.T @ Qu + Qux.T @ kk
            Vxx = Qxx + KK.T @ Quu @ KK + KK.T @ Qux + Qux.T @ KK
            Vxx = 0.5 * (Vxx + Vxx.T)
            K[t], k[t] = KK, kk
        return K, k

    def forward(xs, us, K, k):
        """The line search's rollouts, one per alpha, as one batch."""
        S = alphas.shape[0]
        x = x0.expand(S, n)
        xs2, us2 = [x], []
        for t in range(T):
            u = us[t] + alphas[:, None] * k[t] + (x - xs[t]) @ K[t].T
            u = u.clamp(-1.0, 1.0)
            x = dynamics(x, u)
            xs2.append(x)
            us2.append(u)
        return torch.stack(xs2, 1), torch.stack(us2, 1)

    xs = [x0]
    for t in range(T):
        xs.append(dynamics(xs[-1][None], u_init[t][None])[0])
    xs, us = torch.stack(xs), u_init
    J = total_cost(xs[None], us[None])[0]
    reg = cfg.reg_init
    for _ in range(cfg.iterations):
        K, k = backward(xs, us, reg)
        xs_a, us_a = forward(xs, us, K, k)
        J_a = total_cost(xs_a, us_a)
        best, bJ = None, J
        for i in range(alphas.shape[0]):
            if bool(torch.isfinite(J_a[i])) and bool(J_a[i] < bJ):
                best, bJ = i, J_a[i]
        improved = best is not None
        if improved:
            xs, us, J = xs_a[best], us_a[best], bJ
        reg = (max(reg / cfg.reg_factor, cfg.reg_init) if improved
               else min(reg * cfg.reg_factor, cfg.reg_max))
    return xs, us, J
