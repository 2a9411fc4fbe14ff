"""The plain forms of the port's dense SPD kernels (A-E), frozen.

Each is the column recurrence of the kernel it stands for, in plain
PyTorch, batched over a leading dimension and reading only the lower
triangle: `chol_solve` for Kernel A, `cho_factor_solve` for C,
`solve_lower` for D, `cholesky` for E. They run in whatever dtype and
matrix-product precision the caller sets.
"""
from __future__ import annotations

import torch


def cholesky_plain(H: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each SPD (B,n,n) system (lower triangle read)."""
    n = H.shape[-1]
    idx = torch.arange(n, device=H.device)
    L = H.clone()
    for j in range(n):
        s = (L[:, :, :j] @ L[:, j, :j, None])[..., 0]       # (B,n)
        c = L[:, :, j] - s
        piv = torch.sqrt(c[:, j:j + 1])
        L[:, :, j] = torch.where(
            idx == j, piv, torch.where(idx > j, c / piv, torch.zeros_like(c)))
    return L


def solve_lower_plain(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Forward substitution L y = b, b (B,n,m)."""
    n = L.shape[-1]
    y = b.clone()
    for j in range(n):
        yj = y[:, j, :] / L[:, j, j, None]
        y[:, j + 1:, :] -= L[:, j + 1:, j, None] * yj[:, None, :]
        y[:, j, :] = yj
    return y


def solve_lower_t_plain(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Back substitution L^T x = b, b (B,n,m)."""
    n = L.shape[-1]
    x = b.clone()
    for j in range(n - 1, -1, -1):
        s = (L[:, j + 1:, j, None] * x[:, j + 1:, :]).sum(1)
        x[:, j, :] = (x[:, j, :] - s) / L[:, j, j, None]
    return x


def chol_solve_plain(A, b, diag=None):
    """Plain PyTorch version of `chol_solve` (the CPU path and the yardstick
    the kernel is held to)."""
    H = A if diag is None else A + torch.diag_embed(diag)
    L = cholesky_plain(H)
    return solve_lower_t_plain(L, solve_lower_plain(L, b))


def cho_factor_solve_plain(A, b):
    """Plain PyTorch version of `cho_factor_solve`."""
    L = cholesky_plain(A)
    return L, solve_lower_t_plain(L, solve_lower_plain(L, b))


def solve_lower_any_plain(L, b, trans: bool = False):
    """Plain PyTorch version of `solve_lower`."""
    return solve_lower_t_plain(L, b) if trans else solve_lower_plain(L, b)


def chol_solve(A, b, diag=None):
    """x (B,n,m) with (A + diag(d)) x = b (Kernel A's semantics)."""
    return chol_solve_plain(A, b, diag)


def cho_factor_solve(A, b):
    """(L, x) with L L^T = A and A x = b (Kernel C's semantics)."""
    return cho_factor_solve_plain(A, b)


def solve_lower(L, b, trans: bool = False):
    """L x = b, or L^T x = b with trans (Kernel D's semantics)."""
    return solve_lower_any_plain(L, b, trans)


def cholesky(A):
    """L with L L^T = A (Kernel E's semantics)."""
    return cholesky_plain(A)


def tri_solve_lower(L, b):
    return solve_lower_plain(L, b)


def cho_solve(L, b):
    return solve_lower_t_plain(L, solve_lower_plain(L, b))
