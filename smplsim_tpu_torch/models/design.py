"""Design-parameter space over RobotModels.

Port of smplsim_tpu/models/design.py (the reference's XML-rewriting param
objects, smpl_sim/smpllib/smpl_local_robot.py:322-1162, get_params /
set_params normalized to [-1, 1]) as a pair of pure functions on tensors:

    space = DesignSpace(model, spec)
    vec   = space.flatten(model)          # (D,) in [-1, 1]
    model2 = space.unflatten(model, vec)  # the RobotModel it describes

A batch of vectors (N, D) unflattens to a stacked model of N rows, which
the physics and the envs step as one batch (CEM over morphology), and a
forward-mode tangent on the vector flows through `unflatten` into the
physics (gradient-based co-design; the control step then runs its per-env
reference form, engine.control_step).

Parameter groups mirror the reference's tunables: joint damping and
armature, actuator gear, the gains jkp and jkd, a per-geom size scale and
an additive bone offset. The multiplicative quantities use log-scaled
ranges (the reference's "log" params).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from smplsim_tpu_torch.models.spec import ARRAY_FIELDS, RobotModel


def normalize_range(value, lb, ub):
    """value in [lb, ub] -> [-1, 1] (smpl_local_robot.py:49)."""
    return (value - lb) / (ub - lb) * 2.0 - 1.0


def denormalize_range(value, lb, ub):
    """value in [-1, 1] -> [lb, ub] (smpl_local_robot.py:53)."""
    return (value + 1.0) * 0.5 * (ub - lb) + lb


# default spec: {group: {param: {"lb": float, "ub": float, "log": bool}}}
# ranges follow the reference yaml conventions (relative multiplicative
# ranges for log params, absolute metres for offsets)
DEFAULT_SPEC: Dict[str, Dict[str, Dict[str, Any]]] = {
    "joint": {
        "damping": {"lb": 0.2, "ub": 5.0, "log": True},
        "armature": {"lb": 0.2, "ub": 5.0, "log": True},
    },
    "actuator": {
        "gear": {"lb": 0.2, "ub": 5.0, "log": True},
    },
    "gains": {
        "jkp": {"lb": 0.25, "ub": 4.0, "log": True},
        "jkd": {"lb": 0.25, "ub": 4.0, "log": True},
    },
    "geom": {
        "size": {"lb": 0.7, "ub": 1.43, "log": True},
    },
    "body": {
        "offset": {"lb": -0.05, "ub": 0.05, "log": False},
    },
}

# (group, param) -> (RobotModel field, per-element shape kind)
_FIELDS: Dict[Tuple[str, str], Tuple[str, str]] = {
    ("joint", "damping"): ("dof_damping", "vector"),
    ("joint", "armature"): ("armature", "vector"),
    ("actuator", "gear"): ("gear", "vector"),
    ("gains", "jkp"): ("jkp", "vector"),
    ("gains", "jkd"): ("jkd", "vector"),
    ("geom", "size"): ("geom_size", "matrix"),
    ("body", "offset"): ("body_pos", "matrix"),
}


@dataclasses.dataclass(frozen=True)
class _Entry:
    group: str
    param: str
    field: str
    kind: str          # "vector" (multiplicative per element) or "matrix"
    log: bool
    lb: float
    ub: float
    size: int          # flattened length


class DesignSpace:
    """Flatten/unflatten a RobotModel's tunable parameters to [-1, 1]."""

    def __init__(self, model: RobotModel, spec=None):
        if model.stacked:
            raise ValueError("DesignSpace takes a shared base model")
        spec = DEFAULT_SPEC if spec is None else spec
        self._base = model
        self.entries = []
        for group, params in spec.items():
            for pname, ps in params.items():
                field, kind = _FIELDS[(group, pname)]
                self.entries.append(_Entry(
                    group=group, param=pname, field=field, kind=kind,
                    log=bool(ps.get("log", False)), lb=float(ps["lb"]), ub=float(ps["ub"]),
                    size=getattr(model, field).numel()))
        self.dim = sum(e.size for e in self.entries)

    def names(self):
        """Per-dimension names (reference get_params(get_name=True))."""
        out = []
        for e in self.entries:
            shape = getattr(self._base, e.field).shape
            if len(shape) == 1:
                out += [f"{e.group}.{e.param}[{i}]" for i in range(shape[0])]
            else:
                out += [f"{e.group}.{e.param}[{i},{j}]"
                        for i in range(shape[0]) for j in range(shape[1])]
        return out

    def _ratio_to_norm(self, e: _Entry, ratio):
        if e.log:
            return normalize_range(torch.log(ratio), np.log(e.lb), np.log(e.ub))
        return normalize_range(ratio, e.lb, e.ub)

    def _norm_to_ratio(self, e: _Entry, v):
        if e.log:
            return torch.exp(denormalize_range(v, np.log(e.lb), np.log(e.ub)))
        return denormalize_range(v, e.lb, e.ub)

    def flatten(self, model: RobotModel) -> torch.Tensor:
        """(D,) design vector in [-1, 1] describing `model` relative to the
        base model this space was built with; (N, D) for a stacked model."""
        lead = (model.num_stacked,) if model.stacked else ()
        parts = []
        for e in self.entries:
            base = getattr(self._base, e.field)
            cur = getattr(model, e.field)
            if e.group == "body" and e.param == "offset":
                parts.append(normalize_range((cur - base).reshape(lead + (-1,)), e.lb, e.ub))
            else:
                zero = base == 0
                ratio = (cur / torch.where(zero, torch.ones_like(base), base)).reshape(lead + (-1,))
                ratio = torch.where(zero.reshape(-1), torch.ones_like(ratio), ratio)
                parts.append(self._ratio_to_norm(e, ratio))
        return torch.clamp(torch.cat(parts, dim=-1), -1.0, 1.0)

    def unflatten(self, model: RobotModel | None, vec: torch.Tensor) -> RobotModel:
        """Materialize a design vector in [-1, 1] as a RobotModel: (D,) gives
        a shared model, (N, D) a stacked model of N rows.

        Design vectors are ABSOLUTE with respect to the base model this space
        was built with: every spec'd field is computed from the base and the
        vector, so `unflatten(m, flatten(m2))` reproduces m2's spec'd fields
        whatever m is. `model` (the base by default) supplies the other
        fields of the result (for (N, D), a shared model's are repeated to
        N rows)."""
        if model is None:
            model = self._base
        lead = tuple(vec.shape[:-1])
        updates: Dict[str, Any] = {}
        off = 0
        for e in self.entries:
            base = getattr(self._base, e.field)
            v = vec[..., off:off + e.size].reshape(lead + tuple(base.shape))
            off += e.size
            if e.group == "body" and e.param == "offset":
                delta = denormalize_range(v, e.lb, e.ub)
                # the root body never moves (freejoint origin)
                delta = torch.cat([torch.zeros_like(delta[..., :1, :]), delta[..., 1:, :]], -2)
                updates[e.field] = base + delta.to(base.dtype)
            else:
                updates[e.field] = (base * self._norm_to_ratio(e, v)).to(base.dtype)
        if lead and not model.stacked:
            for f in ARRAY_FIELDS:
                if f not in updates:
                    x = getattr(model, f)
                    updates[f] = x.expand(lead + tuple(x.shape)).contiguous()
        return dataclasses.replace(model, **updates)
