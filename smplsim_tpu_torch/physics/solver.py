"""Constraint forces through the compact active subsystem, batched.

Port of smplsim_tpu/physics/solver.py in the form of the batched spine
(substep_lanes.py::solve_constraints_lanes). The active rows are gathered
into K compact slots (active rows first in their original order, inactive
rows after them, the `_slot_rank` order); one fused factor+solve of M gives
both the smooth acceleration and W = M^-1 J^T from the right-hand side
[qfrc | J^T]; the Delassus system A = J W + diag(R) goes to the contact QP;
the compact forces scatter back to the full row layout.

`solve_constraints_gram` is the per-env form
(smplsim_tpu/physics/solver.py::solve_constraints, which the torque and
direct control modes run): M is factored once upstream (the smooth
dynamics' L), the Delassus matrix comes in Gram form, Y = L^-1 J^T and
A = Y^T Y + diag(R) (one triangular solve over K columns and a matrix
product), and the constraint acceleration is a second solve with L. The
Gram form and the fused form above agree only to rounding, so each is held
to its own JAX counterpart. The per-env form is differentiable: its solves
are the Functions of physics/linalg.py and its QP is `qp.newton_qp_ad`, so
forward-mode AD takes the JAX package's rules through it. The spine's
kernels raise on an input that carries a derivative.

Knob (the JAX package's, same default): SMPLSIM_QP_ROWS is K before the
min with NEFC.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from smplsim_tpu_torch.ops import linalg, qp
from smplsim_tpu_torch.physics import linalg as ad_linalg
from smplsim_tpu_torch.physics.constraints import EFC, MAX_LIMITS, NEFC
from smplsim_tpu_torch.physics.dynamics import Smooth
from smplsim_tpu_torch.physics.topology import mask_tensor

COMPACT_ROWS = int(os.environ.get("SMPLSIM_QP_ROWS", 64))


def compact_rows(active: torch.Tensor, K: int) -> torch.Tensor:
    """(B,K) row indices of the compact slots: active rows in their original
    order, then inactive rows in theirs."""
    order = torch.sort(active.to(torch.uint8), dim=1, descending=True, stable=True).indices
    return order[:, :K]


@dataclasses.dataclass
class Rows:
    """The K compact rows of a batch of constraint sets."""

    idx: torch.Tensor     # (B,K) row index in the full layout
    actf: torch.Tensor    # (B,K) 1.0 where the row is active
    J: torch.Tensor       # (B,K,nv) jacobian rows, zero where inactive
    aref: torch.Tensor    # (B,K)
    R: torch.Tensor       # (B,K)
    f0: torch.Tensor      # (B,K) warm start


def select_rows(model, S: torch.Tensor, efc: EFC, f_warm: torch.Tensor, K: int) -> Rows:
    """Gather the K compact rows and build their jacobians. S (B,nv,6) dof
    subspaces; f_warm (B,NEFC) previous forces in the full row layout."""
    B, nv = S.shape[0], S.shape[1]
    dtype = S.dtype
    idx = compact_rows(efc.active, K)
    actf = efc.active.gather(1, idx).to(dtype)
    aref = torch.cat([efc.l_aref, efc.aref.reshape(B, -1)], 1).gather(1, idx)
    R = torch.cat([efc.l_R, efc.R.reshape(B, -1)], 1).gather(1, idx)
    f0 = f_warm.gather(1, idx)

    # contact rows: (W6 S^T) * (body_dof[body2] - body_dof[body1]);
    # limit rows straight from l_J
    is_con = idx >= MAX_LIMITS
    ci = (idx - MAX_LIMITS).clamp_min(0)
    W6 = efc.W6.reshape(B, -1, 6).gather(1, ci[..., None].expand(B, K, 6))
    W6 = torch.where(is_con[..., None], W6, torch.zeros_like(W6))
    zero = torch.zeros_like(idx)
    b1 = torch.where(is_con, efc.body1.repeat_interleave(4, 1).gather(1, ci), zero)
    b2 = torch.where(is_con, efc.body2.repeat_interleave(4, 1).gather(1, ci), zero)
    body_dof = mask_tensor(model.parents, "body_dof", dtype, S.device)
    body_dof = torch.cat([torch.zeros_like(body_dof[:1]), body_dof], 0)  # row 0: world
    relmask = body_dof[b2 + 1] - body_dof[b1 + 1]                          # (B,K,nv)
    J_lim = efc.l_J.gather(1, idx.clamp_max(MAX_LIMITS - 1)[..., None].expand(B, K, nv))
    J_lim = torch.where(is_con[..., None], torch.zeros_like(J_lim), J_lim)
    J = ((W6 @ S.transpose(1, 2)) * relmask + J_lim) * actf[..., None]
    return Rows(idx=idx, actf=actf, J=J, aref=aref, R=R, f0=f0)


def smooth_rhs(qfrc: torch.Tensor, rows: Rows) -> torch.Tensor:
    """(B,nv,1+K) right-hand side [qfrc | J^T] of the fused solve with M."""
    return torch.cat([qfrc[..., None], rows.J.transpose(1, 2)], 2)


def delassus(rows: Rows, X: torch.Tensor):
    """QP system from X = M^-1 [qfrc | J^T]: A = J W + diag(R) (B,K,K) and
    b = (aref - J qacc_smooth) * active (B,K)."""
    qacc_smooth, W = X[:, :, 0], X[:, :, 1:]
    A = rows.J @ W + torch.diag_embed(rows.R)
    b = (rows.aref - (rows.J @ qacc_smooth[..., None])[..., 0]) * rows.actf
    return A, b


def solve_constraints(model, S, M, qfrc, efc: EFC, f_warm, iters=None, K=None, tol=None):
    """S (B,nv,6) dof subspaces; M the (B,nv,nv) mass matrix, or a solve
    closure solve(rhs) -> M^-1 rhs (substep.aba_solver: the articulated-body
    route, which launches no `chol_solve`); qfrc (B,nv) smooth force;
    f_warm (B,NEFC) previous forces in the full row layout.

    Returns (qacc (B,nv), efc_force (B,NEFC), nactive (B,) int32 active
    rows (past K, the later active rows in row order were left out),
    stalled (B,): the QP stopped short of its tolerance)."""
    K = min(COMPACT_ROWS, NEFC) if K is None else K
    tol = qp.tol_for(S.dtype) if tol is None else tol
    B = qfrc.shape[0]

    rows = select_rows(model, S, efc, f_warm, K)
    rhs = smooth_rhs(qfrc, rows)
    X = M(rhs) if callable(M) else linalg.chol_solve(M, rhs)
    A, b = delassus(rows, X)
    f = qp.newton_qp(A, b, rows.actf, rows.f0, iters, tol)

    qacc = X[:, :, 0] + (X[:, :, 1:] @ f[..., None])[..., 0]
    efc_force = torch.zeros((B, NEFC), dtype=S.dtype, device=S.device).scatter(1, rows.idx, f)
    nactive = efc.active.sum(1, dtype=torch.int32)
    stalled = qp.kkt_residual(A, b, f, rows.actf) > tol * (1.0 + b.abs().amax(-1))
    return qacc, efc_force, nactive, stalled


@dataclasses.dataclass
class ConstraintSolution:
    qacc: torch.Tensor             # (B,nv)
    efc_force: torch.Tensor        # (B,NEFC) in the full row layout
    qfrc_constraint: torch.Tensor  # (B,nv)
    nactive: torch.Tensor          # (B,) int32 active rows
    overflow: torch.Tensor         # (B,) nactive > K: the later rows were left out
    stalled: torch.Tensor          # (B,) the QP stopped short of its tolerance


def solve_constraints_gram(model, S, smooth: Smooth, efc: EFC, f_warm=None,
                           iters=None, K=None, tol=None) -> ConstraintSolution:
    """S (B,nv,6) dof subspaces; smooth from `dynamics.smooth_dynamics`;
    f_warm (B,NEFC) previous forces in the full row layout, None for a cold
    start. Kernels: three `solve_lower` launches (m=K, then m=1 twice) and
    one `newton_qp` launch; under forward AD their rules add five
    `solve_lower` launches and one `cholesky`."""
    K = min(COMPACT_ROWS, NEFC) if K is None else K
    tol = qp.tol_for(S.dtype) if tol is None else tol
    B = S.shape[0]
    if f_warm is None:
        f_warm = torch.zeros((B, NEFC), dtype=S.dtype, device=S.device)

    rows = select_rows(model, S, efc, f_warm, K)
    active = rows.actf > 0.5
    # the kernels take contiguous tensors: J^T is copied out of the row layout
    Jt = rows.J.transpose(1, 2).contiguous()                          # (B,nv,K)
    Y = ad_linalg.tri_solve_lower(smooth.chol, Jt)
    A = Y.transpose(1, 2) @ Y + torch.diag_embed(rows.R)
    b = rows.aref - (rows.J @ smooth.qacc_smooth[..., None])[..., 0]
    b = torch.where(active, b, torch.zeros_like(b))
    f = qp.newton_qp_ad(A, b, rows.actf, rows.f0, iters, tol)

    qfrc = Jt @ f[..., None]                                          # (B,nv,1)
    qacc = smooth.qacc_smooth + ad_linalg.cho_solve(smooth.chol, qfrc)[..., 0]
    efc_force = torch.zeros((B, NEFC), dtype=S.dtype, device=S.device).scatter(1, rows.idx, f)
    nactive = efc.active.sum(1, dtype=torch.int32)
    stalled = qp.kkt_residual(A, b, f, rows.actf) > tol * (1.0 + b.abs().amax(-1))
    return ConstraintSolution(qacc=qacc, efc_force=efc_force, qfrc_constraint=qfrc[..., 0],
                              nactive=nactive, overflow=nactive > K, stalled=stalled)
