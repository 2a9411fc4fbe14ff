"""Batched contact QP: projected Newton on min 1/2 f^T A f - b^T f, f >= 0
over the active rows (Kernel B).

`newton_qp` replaces the TPU kernel smplsim_tpu/ops/qp_kernel.py::_qp_kernel
(entry _newton_qp_pallas_lanes, reached through newton_qp_twophase_lanes);
the main path calls it once per substep. Its semantics are those of the
reference smplsim_tpu/ops/qp_kernel.py::newton_qp_reference, which both the
kernel and `newton_qp_plain` follow, with two deliberate departures from the
TPU kernel: each system stops on its own KKT test (as the reference's
batched while_loop does; the TPU kernel iterates a 128-lane block until all
its lanes converge, hence its lane sort, which is not ported), and the line
search takes the FIRST minimum over [1, .5, .25, .0625, .015625, stay] (the
TPU kernel keeps "stay" on ties).

On a CUDA tensor it launches a hand-written kernel of csrc/newton_qp.cu,
chosen by `newton_qp_route` on K alone: up to K = 64 (COMPACT_ROWS' default;
32 on the main path) the warp form, a warp per system with several systems
per block, A in shared memory read in 16-byte vectors, the masked factor
warp-synchronous with each lane's rows in registers, butterfly reductions
and no block barrier after the load; above K = 64 the block form, one thread
block per system and one thread per row. What bounds it on the H100: a
system moves (K^2 + 4K) values, 4.6 KB at K=32 in float32, and an iteration
needs K^3/3 + ~26 K^2 flops, so for 4096 systems at ~2 iterations each the
byte bound is ~0.006 ms; the work of one system is serial (K dependent
pivots and 2K substitution steps an iteration), so the kernel's time is the
latency of one iteration times the iterations of the slowest system in each
wave of resident systems. Both forms keep every iteration in shared memory
and registers (device memory is touched once on entry and once on exit) and
let converged systems leave at once; PERF.md has the measured times against
the bound. On a CPU tensor it runs `newton_qp_plain`.

The same call, on (B,K,K) batch-first systems, is also the port of the
batch-major entries the per-env solver reaches under vmap
(qp_kernel.py::_newton_qp_pallas, _newton_qp_twophase, _newton_qp_chunked):
one launch with the full iteration budget for every system. Twophase's
straggler pass and chunked's outer loop exist because a TPU block of 128
lanes exits only when all of them converge; here each system exits on its
own, so the result is the one of vmap(newton_qp_reference), which the JAX
package computes off the TPU. Twophase's truncation of the systems beyond
its straggler budget at their phase-1 forces is a TPU departure and is not
reproduced: SMPLSIM_QP_PHASE1 and SMPLSIM_QP_STRAGGLER_DIV are not read.

Knobs (the JAX package's, same defaults): SMPLSIM_QP_ITERS is the iteration
cap, SMPLSIM_QP_TOL the float32 KKT tolerance relative to 1 + max|b|;
float64 uses 1e-12.

`newton_qp` is not differentiable and raises on an input that carries a
derivative. `newton_qp_ad` is the differentiable form (the custom_jvp of
qp_kernel.py::newton_qp): its primal is `newton_qp`, and its forward-mode
derivative is the implicit-function rule at the returned active set
S = {i : f_i > 0, active}, where A_SS f_S = b_S, so
df_S = A_SS^-1 (db_S - dA_S f) (qp_kernel.py:452-468), not the derivative of
the unrolled iterations; the two coincide only where the QP converged. The
rule factors the masked system H = A o (a a^T) + diag(1 - a) with
`linalg.cholesky` (Kernel E) and solves with `linalg.cho_solve` (Kernel D,
twice). f0 and `active` get no tangent.
"""
from __future__ import annotations

import os

import torch

from smplsim_tpu_torch.ops import _build, linalg
from smplsim_tpu_torch.ops.linalg import (
    _SMEM_MAX, check_no_derivative, cholesky_plain, solve_lower_plain, solve_lower_t_plain)

NEWTON_ITERS = int(os.environ.get("SMPLSIM_QP_ITERS", 40))
# the largest K the warp-per-system form takes (two rows per lane)
QP_WARP_MAX_K = 64
_LS_STEPS = (1.0, 0.5, 0.25, 0.0625, 0.015625)
_TOLS = {
    torch.float32: float(os.environ.get("SMPLSIM_QP_TOL", 1e-6)),
    torch.float64: 1e-12,
}


def tol_for(dtype: torch.dtype) -> float:
    return _TOLS.get(dtype, 1e-6)


def kkt_residual(A, b, f, actf):
    """Per-system projected-gradient KKT residual max|f - max(f - g, 0)|."""
    g = (A @ f[..., None])[..., 0] - b
    return ((f - (f - g).clamp_min(0.0)).abs() * actf).amax(-1)


def _newton_iter(A, b, act, f, steps):
    dtype = A.dtype
    K = A.shape[-1]
    # projected-gradient step
    g = (A @ f[..., None])[..., 0] - b
    d = torch.where(((f > 0) | (g < 0)) & act, -g, torch.zeros_like(g))
    dAd = (d * (A @ d[..., None])[..., 0]).sum(-1)
    dd = (d * d).sum(-1)
    alpha = torch.where(dAd > 1e-30, dd / dAd.clamp_min(1e-30), torch.zeros_like(dd))
    f = (f + alpha[:, None] * d).clamp_min(0.0)
    # masked Newton direction
    g = (A @ f[..., None])[..., 0] - b
    am = (((f > 0) | (g < 0)) & act).to(dtype)
    eye = torch.eye(K, dtype=dtype, device=A.device)
    H = A * am[:, :, None] * am[:, None, :] + eye * (1.0 - am)[:, None, :]
    L = cholesky_plain(H)
    y = solve_lower_t_plain(L, solve_lower_plain(L, (b * am)[..., None]))[..., 0]
    d = (y * am).clamp_min(0.0) - f
    # projected-arc line search; the first minimum wins
    cands = (f[:, None, :] + steps[None, :, None] * d[:, None, :]).clamp_min(0.0)
    cands = torch.cat([cands, f[:, None, :]], dim=1)           # (B,6,K)
    vals = 0.5 * ((cands @ A) * cands).sum(-1) - (cands * b[:, None, :]).sum(-1)
    best = torch.argmin(vals, dim=1)
    return cands[torch.arange(f.shape[0], device=f.device), best]


def newton_qp_plain_counted(A, b, active, f0, iters: int, tol: float):
    """Plain PyTorch version of `newton_qp`, A (B,K,K), b/active/f0 (B,K).
    Returns (f (B,K), the Newton iterations each system ran (B,) int64)."""
    act = active > 0.5
    actf = act.to(A.dtype)
    tol_sys = tol * (1.0 + b.abs().amax(-1))
    steps = torch.tensor(_LS_STEPS, dtype=A.dtype, device=A.device)
    f = f0.clamp_min(0.0) * actf
    its = torch.zeros(A.shape[0], dtype=torch.long, device=A.device)
    for _ in range(iters):
        run = kkt_residual(A, b, f, actf) > tol_sys
        if not bool(run.any()):
            break
        f = torch.where(run[:, None], _newton_iter(A, b, act, f, steps), f)
        its += run
    return f, its


def newton_qp_plain(A, b, active, f0, iters: int, tol: float):
    """Plain PyTorch version of `newton_qp` (the CPU path and the yardstick
    the kernel is held to)."""
    return newton_qp_plain_counted(A, b, active, f0, iters, tol)[0]


def newton_qp_route(K: int) -> str:
    """Which kernel `newton_qp` launches for K x K systems: "warp" (a warp
    per system) up to QP_WARP_MAX_K, "block" (a block per system) above. A
    dispatch on shape only."""
    return "warp" if K <= QP_WARP_MAX_K else "block"


def _check(A, b, active, f0):
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"newton_qp: A {tuple(A.shape)} must be (B,K,K)")
    for t in (b, active, f0):
        if t.shape != A.shape[:2]:
            raise ValueError(f"newton_qp: vectors must be (B,K), got {tuple(t.shape)}")
        if t.dtype != A.dtype or t.device != A.device:
            raise TypeError("newton_qp: inputs must share dtype and device")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError("newton_qp: float32 or float64 only")
    check_no_derivative("newton_qp", A, b, active, f0)


def newton_qp(A: torch.Tensor, b: torch.Tensor, active: torch.Tensor,
              f0: torch.Tensor, iters: int | None = None,
              tol: float | None = None) -> torch.Tensor:
    """f (B,K) >= 0 minimizing 1/2 f^T A f - b^T f over the rows where
    `active` (float 0/1) is set, warm-started from f0."""
    _check(A, b, active, f0)
    iters = NEWTON_ITERS if iters is None else int(iters)
    tol = tol_for(A.dtype) if tol is None else float(tol)
    if A.device.type == "cpu":
        return newton_qp_plain(A, b, active, f0, iters, tol)
    if A.device.type != "cuda":
        raise ValueError(f"newton_qp: unsupported device {A.device}")
    if not all(t.is_contiguous() for t in (A, b, active, f0)):
        raise ValueError("newton_qp: the kernel takes contiguous tensors")
    Bn, K = b.shape
    route = newton_qp_route(K)
    if route == "block" and (
            K > 1024 or A.element_size() * (2 * K * (K + 1) + 2 * K + 33) > _SMEM_MAX):
        raise ValueError(f"newton_qp: K={K} exceeds a block's threads or shared memory")
    f = torch.empty_like(b)
    name = ("newton_qp_warp_" if route == "warp" else "newton_qp_") + (
        "f32" if A.dtype == torch.float32 else "f64")
    fn = _build.kernel("newton_qp.cu", name)
    with torch.cuda.device(A.device):
        status = fn(A.data_ptr(), b.data_ptr(), active.data_ptr(), f0.data_ptr(),
                    f.data_ptr(), Bn, K, iters, tol,
                    torch.cuda.current_stream(A.device).cuda_stream)
    _build.check(status, name)
    newton_qp.launches += 1
    return f


newton_qp.launches = 0


def implicit_system(A: torch.Tensor, f: torch.Tensor, active: torch.Tensor):
    """(am (B,K), H (B,K,K)) of the implicit-function rule at the solution f:
    am is 1 on the rows where f > 0 and the row is active, H the system A
    restricted to them with identity elsewhere."""
    am = ((f > 0) & (active > 0.5)).to(A.dtype)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return am, A * am[:, :, None] * am[:, None, :] + eye * (1.0 - am)[:, None, :]


class NewtonQP(torch.autograd.Function):
    """`newton_qp` with the implicit-function forward-mode rule."""

    @staticmethod
    def forward(A, b, active, f0, iters, tol):
        return newton_qp(A.detach(), b.detach(), active.detach(), f0.detach(), iters, tol)

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, _, active = inputs[:3]
        ctx.save_for_forward(A, active, output)

    @staticmethod
    def jvp(ctx, dA, db, *_):
        A, active, f = ctx.saved_tensors
        am, H = implicit_system(A, f, active)
        rhs = torch.zeros_like(f)
        if db is not None:
            rhs = rhs + db
        if dA is not None:
            rhs = rhs - (dA @ f[..., None])[..., 0]
        rhs = rhs * am
        return linalg.cho_solve(linalg.cholesky(H), rhs[..., None].contiguous())[..., 0] * am

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("newton_qp_ad: reverse mode is not implemented; "
                                  "use forward-mode AD (torch.autograd.forward_ad)")


def newton_qp_ad(A, b, active, f0, iters: int | None = None, tol: float | None = None):
    """`newton_qp` (same arguments) that forward-mode AD differentiates by the
    implicit-function rule; f0 and `active` get no tangent."""
    iters = NEWTON_ITERS if iters is None else int(iters)
    tol = tol_for(A.dtype) if tol is None else float(tol)
    return NewtonQP.apply(A, b, active, f0, iters, tol)
