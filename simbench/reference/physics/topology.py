"""Static topology masks derived from the kinematic tree (numpy only).

A copy of smplsim_tpu/physics/topology.py::tree_masks and ::aba_levels:
0/1 matrices that turn the tree recursions of the dynamics into dense
masked products, and the level schedule of the articulated-body solve.
They depend only on the parents tuple and are cached per topology.

Dof layout: 0-5 root free joint (3 translation + 3 rotation), then 3 hinge
dofs per non-root body in tree order.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=128)
def mask_tensor(parents: tuple[int, ...], name: str, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """One of `tree_masks(parents)` as a tensor, made once per dtype and
    device (`dof_body` stays int64)."""
    m = tree_masks(parents)[name]
    return torch.as_tensor(m, dtype=torch.long if name == "dof_body" else dtype,
                           device=device)


@functools.lru_cache(maxsize=32)
def tree_masks(parents: tuple[int, ...]):
    """Masks of one parents tuple:

    body_dof      (J, nv): dof i is on body b's root path (i moves b)
    dof_prefix    (nv, nv): dof j acts at or before dof i on i's chain
    dof_frame     (nv, nv): dofs whose motion carries dof i's axis frame
    subtree_body  (J, J): body d is in the subtree rooted at b
    dof_subtree_body (nv, J): body d is in the subtree of dof i's body
    dof_body      (nv,): owning body of each dof
    """
    J = len(parents)
    nv = 6 + 3 * (J - 1)

    anc: list[list[int]] = []
    for b in range(J):
        chain = [b]
        p = parents[b]
        while p >= 0:
            chain.append(p)
            p = parents[p]
        anc.append(chain[::-1])

    def dofs_of(b: int) -> list[int]:
        if b == 0:
            return [0, 1, 2, 3, 4, 5]
        s = 6 + 3 * (b - 1)
        return [s, s + 1, s + 2]

    dof_body = np.zeros(nv, dtype=np.int64)
    for b in range(J):
        for i in dofs_of(b):
            dof_body[i] = b

    body_dof = np.zeros((J, nv), dtype=np.float64)
    for b in range(J):
        for a in anc[b]:
            body_dof[b, dofs_of(a)] = 1.0

    dof_prefix = np.zeros((nv, nv), dtype=np.float64)
    for b in range(J):
        chain_dofs: list[int] = []
        for a in anc[b]:
            chain_dofs.extend(dofs_of(a))
        own = dofs_of(b)
        for k, i in enumerate(own):
            dof_prefix[i, chain_dofs[: len(chain_dofs) - len(own) + k + 1]] = 1.0

    # hinge axes ride the frame after the preceding dofs of their own stack;
    # the free root's rotation axes are body axes, moved by all six root dofs
    dof_frame = dof_prefix.copy()
    dof_frame[3:6, 0:6] = 1.0

    subtree_body = np.zeros((J, J), dtype=np.float64)
    for d in range(J):
        for a in anc[d]:
            subtree_body[a, d] = 1.0

    return dict(
        dof_body=dof_body,
        body_dof=body_dof,
        dof_prefix=dof_prefix,
        dof_frame=dof_frame,
        subtree_body=subtree_body,
        dof_subtree_body=subtree_body[dof_body],
    )


@functools.lru_cache(maxsize=32)
def aba_levels(parents: tuple[int, ...]):
    """Level schedule of the articulated-body solve (physics/aba.py), a copy
    of smplsim_tpu/physics/topology.py::aba_levels.

    Returns (levels, parent): `levels[d]` is a sorted numpy int array of the
    bodies at tree depth d (root body 0 is levels[0]); `parent` is the
    parents tuple as a numpy array. Bodies within a level are independent:
    the sweeps run one level at a time, so the sequential depth of the
    factorization and solve is the tree depth (about 9 for SMPL), not nv.
    """
    J = len(parents)
    depth = np.zeros(J, dtype=np.int64)
    for b in range(1, J):
        depth[b] = depth[parents[b]] + 1
    levels = [np.flatnonzero(depth == d) for d in range(int(depth.max()) + 1)]
    return levels, np.asarray(parents, dtype=np.int64)
