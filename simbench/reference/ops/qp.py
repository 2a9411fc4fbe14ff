"""The contact QP's plain form (Kernel B's semantics), frozen: the
projected-gradient + masked-Newton iteration with the projected-arc line
search, stopping per system at the KKT tolerance or the iteration cap.
The harness always passes the cap and the tolerance explicitly.
"""
from __future__ import annotations

import torch

from simbench.reference.ops.linalg import cholesky_plain, solve_lower_plain, solve_lower_t_plain

NEWTON_ITERS = 40
# the largest K the warp-per-system form takes (two rows per lane)
QP_WARP_MAX_K = 64
_LS_STEPS = (1.0, 0.5, 0.25, 0.0625, 0.015625)
_TOLS = {torch.float32: 1e-6, torch.float64: 1e-12}


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


def newton_qp(A, b, active, f0, iters=None, tol=None):
    iters = NEWTON_ITERS if iters is None else iters
    tol = tol_for(A.dtype) if tol is None else tol
    return newton_qp_plain(A, b, active, f0, iters, tol)


newton_qp_ad = newton_qp
