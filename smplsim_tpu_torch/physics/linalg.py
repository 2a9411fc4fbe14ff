"""Differentiable batched linear algebra: the kernels of ops/linalg.py with
the forward-mode rules of smplsim_tpu/physics/linalg.py.

Port of the four custom_jvp ops there, batch-first ((B,n,n) matrices,
(B,n,m) right-hand sides). Each is a `torch.autograd.Function` whose
forward is the kernel wrapper (a hand-written kernel on a CUDA tensor, its
plain version on a CPU tensor) and whose `jvp` is the JAX package's rule:

  * cholesky:          dL = L phi(L^-1 dA L^-T), phi = tril with halved diagonal
  * tri_solve_lower:   dx = L^-1 (db - tril(dL) x)
  * cho_factor_solve:  dL as above, dx = A^-1 (db - dA x)
  * cho_solve:         dx = A^-1 (db - (dL L^T + L dL^T) x)

The factorizations read only the lower triangle of A, so the tangent is
lifted to the symmetric matrix they effectively factor,
tril(dA) + tril(dA, -1)^T, as the JAX rules do. The rules' triangular
solves go through Kernel D (`ops.linalg.solve_lower`) on the card: the same
function as the plain `solve_lower` / `_cho_solve_ref` the JAX rules call
(which they call only to stay transposable for reverse mode).

Reverse mode is not implemented: `backward` raises.
"""
from __future__ import annotations

import torch

from smplsim_tpu_torch.ops import linalg as kernels


def _zeros_if_none(t, like):
    return torch.zeros_like(like) if t is None else t


def _no_backward(name):
    raise NotImplementedError(f"{name}: reverse mode is not implemented; use forward-mode AD "
                              "(torch.autograd.forward_ad)")


def _sym_lower(dA):
    """The symmetric matrix whose lower triangle is tril(dA)."""
    lo = torch.tril(dA, -1)
    return torch.tril(dA) + lo.mT


def _chol_tangent(L, dAs):
    """dL for the lower factor L of A along the symmetric tangent dAs."""
    T1 = kernels.solve_lower(L, dAs.contiguous())
    Z = kernels.solve_lower(L, T1.mT.contiguous()).mT
    phi = torch.tril(Z) - 0.5 * torch.diag_embed(torch.diagonal(Z, dim1=-2, dim2=-1))
    return L @ phi


class _Cholesky(torch.autograd.Function):
    @staticmethod
    def forward(A):
        return kernels.cholesky(A.detach())

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(output)

    @staticmethod
    def jvp(ctx, dA):
        (L,) = ctx.saved_tensors
        return _chol_tangent(L, _sym_lower(_zeros_if_none(dA, L)))

    @staticmethod
    def backward(ctx, *grads):
        _no_backward("cholesky")


class _TriSolveLower(torch.autograd.Function):
    @staticmethod
    def forward(L, b):
        return kernels.solve_lower(L.detach(), b.detach())

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(inputs[0].detach(), output)

    @staticmethod
    def jvp(ctx, dL, db):
        L, x = ctx.saved_tensors
        rhs = _zeros_if_none(db, x)
        if dL is not None:
            rhs = rhs - torch.tril(dL) @ x
        return kernels.solve_lower(L, rhs.contiguous())

    @staticmethod
    def backward(ctx, *grads):
        _no_backward("tri_solve_lower")


class _ChoFactorSolve(torch.autograd.Function):
    @staticmethod
    def forward(A, b):
        return kernels.cho_factor_solve(A.detach(), b.detach())

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*output)

    @staticmethod
    def jvp(ctx, dA, db):
        L, x = ctx.saved_tensors
        rhs = _zeros_if_none(db, x)
        if dA is None:
            dL = torch.zeros_like(L)
        else:
            dAs = _sym_lower(dA)
            dL = _chol_tangent(L, dAs)
            rhs = rhs - dAs @ x
        return dL, kernels.cho_solve(L, rhs.contiguous())

    @staticmethod
    def backward(ctx, *grads):
        _no_backward("cho_factor_solve")


class _ChoSolve(torch.autograd.Function):
    @staticmethod
    def forward(L, b):
        return kernels.cho_solve(L.detach(), b.detach())

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(inputs[0].detach(), output)

    @staticmethod
    def jvp(ctx, dL, db):
        L, x = ctx.saved_tensors
        rhs = _zeros_if_none(db, x)
        if dL is not None:
            # dA = dL L^T + L dL^T
            rhs = rhs - (dL @ (L.mT @ x) + L @ (dL.mT @ x))
        return kernels.cho_solve(L, rhs.contiguous())

    @staticmethod
    def backward(ctx, *grads):
        _no_backward("cho_solve")


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor (B,n,n) of SPD A (B,n,n): Kernel E."""
    return _Cholesky.apply(A)


def tri_solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (B,n,m) with L x = b (forward substitution): Kernel D."""
    return _TriSolveLower.apply(L, b)


def cho_factor_solve(A: torch.Tensor, b: torch.Tensor):
    """(L, x) with L L^T = A and A x = b, A (B,n,n), b (B,n,m): Kernel C."""
    return _ChoFactorSolve.apply(A, b)


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (B,n,m) with L L^T x = b given the lower factor L: Kernel D twice."""
    return _ChoSolve.apply(L, b)
